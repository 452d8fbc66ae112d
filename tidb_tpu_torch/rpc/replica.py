"""Snapshot-consistent replica routing: the follower read tier's router.

Port of `tidb_tpu/rpc/replica.py`. Counterpart of the reference's
follower/stale reads (reference: tidb_replica_read = "follower" in
sessionctx/variable + the ReadIndex-checked follower read in store/tikv,
and the `tidb_read_staleness` / `AS OF TIMESTAMP` bounded-staleness
mode, executor/stale_txn_reader). Three pieces live here:

  * try_route — the session-layer router. An ELIGIBLE statement (a
    plain autocommit snapshot SELECT over base tables: no DML, no
    FOR UPDATE, no user variables, no nondeterministic functions, no
    system schemas) is sent to the least-loaded live replica whose
    closed timestamp can cover the statement's read_ts, with
    per-replica circuit-breaker awareness (an OPEN breaker skips the
    candidate without burning a Backoffer budget) and typed fallback
    to the leader on staleness, term fencing, or unreachability —
    never a wrong or failed query.
  * serve_replica_read — the replica-side handler (reached over the
    diag endpoint as `diag_replica_read`). It fences on the cluster
    TERM (a replica following a deposed leader answers StaleTermError,
    the raft-term analog), waits bounded for its applied/closed ts to
    cover read_ts (the ReadIndex analog; rpc/apply.py), then executes
    the SELECT at EXACTLY read_ts on its local engine — bit-identical
    to the leader's answer because it is the same fold at the same
    timestamp. DML and every non-SELECT statement are rejected typed.
  * the wire row codec — result values that the frame encoding cannot
    carry natively (Decimal, DATE, DATETIME) travel as tagged dicts.

Trust model: the serving endpoint answers unauthenticated, like every
other diag method and the WAL stream itself (rpc/diag.py docstring) —
the transport plane assumes a trusted segment, and the ROUTER performs
the privilege checks before shipping the SQL (the replica executes as
an internal session).

The port's differences, kept on purpose: a follower's serving sessions
run on the storage's `device` (the card unless the storage was made for
the CPU), so a routed read is answered by the follower's own coprocessor
client; and only `errors.survivable()` errors are survived where the
reference catches every exception (the membership read of
`_candidates`, `_range_spans`, the scrape of `debug_payload`). A torch
or CUDA error in serving is not answered over the wire: the diag
listener keeps it and its `close()` re-raises it, and the router sees a
dropped connection. The range gate (`_range_spans`, `_range_gate`) is
the reference's: it reads the range plane's published closed
timestamps (`RangePlane.closed_over`), and without a plane armed it
returns None, as the reference's does with `[ranges]` off.

Routing is observable end to end: the decision lands in the statement's
engine tags (`replica@host:port` in Session.last_engines and EXPLAIN
ANALYZE), a `replica_read` dispatch stage (slow log / Top SQL), the
`tidb_replica_reads_total{outcome=served|stale_fallback|
unreachable_fallback}` counter, and a session Note on every fallback.
"""

from __future__ import annotations

import datetime as _dt
import time
from dataclasses import dataclass
from typing import Any, Optional

from .. import obs
from .apply import ts_at_physical_ms
from .errors import ReplicaStaleError, RPCError, StaleTermError, survivable


@dataclass
class ReplicaReadState:
    """Per-storage replica-read settings. Field names/defaults MIRROR
    config.ReplicaReadConfig (the TOML owner; Config.seed_replica_read
    copies the knobs in) — mirrored rather than imported so an embedded
    Storage never parses config (the DiagnosticsState pattern)."""

    # master switch: the follower apply engine + the serving endpoint +
    # the router all gate on it
    enabled: bool = True
    # bounded-staleness cap: how stale a routed (or tidb_read_staleness)
    # read may be, and how far behind a replica may run and still be a
    # routing candidate
    max_staleness_ms: int = 5000
    # follower apply-engine cadence (closed-ts fetch + columnar fold)
    apply_interval_ms: int = 200
    # route eligible SELECTs to followers by default (seeds the
    # tidb_replica_read sysvar default; sessions override per-session)
    prefer_follower: bool = False
    # range-aware covering: before dispatching, require every range the
    # statement's table spans touch to have published closed_ts >=
    # read_ts (the per-range ledger floors, rpc/ranged.py). False keeps
    # today's single-closed-ts routing byte-for-byte
    range_aware: bool = False


# functions whose value depends on WHERE/WHEN they run: routing them
# would let a replica answer differently from the leader (reference:
# expression.UnCacheableFunctions / the stale-read restrictions)
NONROUTABLE_FUNCS = frozenset({
    "NOW", "CURRENT_TIMESTAMP", "LOCALTIME", "LOCALTIMESTAMP",
    "CURDATE", "CURRENT_DATE", "CURTIME", "CURRENT_TIME", "SYSDATE",
    "UNIX_TIMESTAMP", "UTC_DATE", "UTC_TIME", "UTC_TIMESTAMP",
    "RAND", "UUID", "UUID_SHORT", "CONNECTION_ID", "CURRENT_USER",
    "USER", "SESSION_USER", "SYSTEM_USER", "DATABASE", "SCHEMA",
    "FOUND_ROWS", "ROW_COUNT", "LAST_INSERT_ID", "VERSION",
    "GET_LOCK", "RELEASE_LOCK", "IS_FREE_LOCK", "IS_USED_LOCK",
    "RELEASE_ALL_LOCKS", "SLEEP", "BENCHMARK", "NAME_CONST",
})

# schemas whose tables are per-server memtables: their rows are about
# THIS server, so routing them would silently answer about another one
_SYSTEM_DBS = frozenset({
    "information_schema", "metrics_schema", "performance_schema",
    "mysql",
})


# ---- wire row codec ---------------------------------------------------------

def wire_value(v: Any) -> Any:
    """Result scalar -> frame-encodable value. Decimal/date/datetime
    travel as tagged dicts (the frame codec deliberately has no
    arbitrary-object escape hatch — rpc/frame.py)."""
    from ..types.value import Decimal, encode_date, encode_datetime
    if isinstance(v, Decimal):
        return {"__t": "dec", "u": v.unscaled, "s": v.scale}
    if isinstance(v, _dt.datetime):
        return {"__t": "dtm", "us": encode_datetime(v)}
    if isinstance(v, _dt.date):
        return {"__t": "date", "d": encode_date(v)}
    return v


def unwire_value(v: Any) -> Any:
    from ..types.value import Decimal, decode_date, decode_datetime
    if isinstance(v, dict):
        t = v.get("__t")
        if t == "dec":
            return Decimal(int(v["u"]), int(v["s"]))
        if t == "dtm":
            return decode_datetime(int(v["us"]))
        if t == "date":
            return decode_date(int(v["d"]))
    return v


# ---- replica-side serving ---------------------------------------------------

def _serving_session(storage):
    """A pooled internal Session for replica reads (sessions are not
    thread-safe; the pool keeps plan caches warm across requests)."""
    with storage._replica_pool_lock:
        if storage._replica_pool:
            return storage._replica_pool.pop()
    from ..session.session import Session
    sess = Session(storage, device=storage.device)
    sess._replica_serving = True  # never re-route from the serve path
    return sess

def _release_session(storage, sess) -> None:
    with storage._replica_pool_lock:
        if len(storage._replica_pool) < 8:
            storage._replica_pool.append(sess)


def serve_replica_read(storage, sql: str = "", db: str = "",
                       read_ts: int = 0, term: int = 0,
                       time_zone: str = "SYSTEM") -> dict:
    """Execute one routed snapshot SELECT at exactly `read_ts` on this
    FOLLOWER's local engine. Fences, in order: role, enabled switch,
    cluster term, closed-timestamp coverage (bounded wait). Rejections
    are typed so the router falls back instead of retrying blind."""
    if not getattr(storage, "remote", False):
        raise RPCError("replica read: this server is not a follower")
    st = storage.replica_read
    eng = storage.apply_engine
    if not st.enabled or eng is None:
        raise ReplicaStaleError(
            "replica read: serving disabled on this replica "
            "(replica-read.enabled = false)")
    my_term = int(getattr(storage._rpc_client, "term", 0) or 0)
    if term and my_term and int(term) != my_term:
        # either side living in a fenced epoch must refuse: a replica
        # mirroring a DEPOSED leader may hold a diverged prefix, and a
        # deposed leader's router must re-resolve, not read through us
        raise StaleTermError(
            f"replica read fenced: replica follows term {my_term}, "
            f"request carries term {int(term)}")
    read_ts = int(read_ts)
    # the ReadIndex analog: wait (bounded) for the apply engine to
    # close a leader timestamp covering read_ts; a stalled replica
    # times out typed and the router goes back to the leader
    wait_s = min(2.0, 0.25 + 2 * eng.interval_ms / 1000.0)
    if not eng.wait_for(read_ts, wait_s):
        raise ReplicaStaleError(
            f"replica not caught up: applied_ts {eng.applied_ts} < "
            f"read_ts {read_ts} after {wait_s:.2f}s "
            f"(apply lag {eng.lag_ms():.0f}ms)")
    from ..session.session import SQLError
    from ..sql import ast
    from ..sql.parser import ParseError, parse_sql
    from ..store.storage import Transaction
    try:
        stmts = parse_sql(sql)
    except ParseError as e:
        raise RPCError(f"replica read parse error: {e}") from None
    if len(stmts) != 1 or not isinstance(
            stmts[0], (ast.SelectStmt, ast.SetOpStmt)):
        raise RPCError("replica read accepts exactly one SELECT")
    stmt = stmts[0]
    if getattr(stmt, "for_update", False) or \
            getattr(stmt, "into_outfile", None) is not None:
        raise RPCError(
            "replica read: locking reads and INTO OUTFILE must run "
            "on the leader")
    sess = _serving_session(storage)
    txn = Transaction(storage, read_ts)
    sess.current_db = db or sess.current_db
    sess.vars["time_zone"] = time_zone or "SYSTEM"
    sess.txn = txn
    sess.in_explicit_txn = True  # _run_in_txn must not commit/retry
    # pin BEFORE building the snapshot so compaction cannot fold past
    # read_ts between the fence check and the read; released by the
    # rollback in the finally below
    storage.pin_snapshot_ts(read_ts)
    try:
        rs = sess._execute_observed(stmt, sql, digest_sql=sql)
    except SQLError as e:
        raise RPCError(f"replica read failed: {e}") from None
    finally:
        sess.in_explicit_txn = False
        sess.txn = None
        txn.rollback()  # releases the pinned snapshot ts
        _release_session(storage, sess)
    return {
        "cols": list(rs.column_names),
        "rows": [[wire_value(v) for v in row] for row in rs.rows],
        "applied_ts": int(eng.applied_ts),
        "term": my_term,
    }


# ---- the router -------------------------------------------------------------

@dataclass
class RoutedRead:
    rows: list
    cols: list
    addr: str
    read_ts: int
    wall_ms: float


def cluster_term(storage) -> int:
    if getattr(storage, "rpc_server", None) is not None:
        return int(storage.rpc_server.term)
    client = getattr(storage, "_rpc_client", None)
    return int(getattr(client, "term", 0) or 0)


def _has_nonroutable_funcs(stmt) -> bool:
    from ..sql import ast
    found = [False]

    def visit(n):
        if isinstance(n, ast.FuncCall) and \
                n.name.upper() in NONROUTABLE_FUNCS:
            found[0] = True
            return False
        return True

    ast.walk(stmt, visit)
    return found[0]


def _eligible(session, stmt, sql: Optional[str],
              has_vars: bool) -> bool:
    from ..sql import ast
    if sql is None or has_vars:
        return False
    if getattr(session, "_replica_serving", False):
        return False
    if session.in_explicit_txn:
        return False
    if getattr(stmt, "for_update", False) or \
            getattr(stmt, "into_outfile", None) is not None:
        return False
    tables = session._collect_table_names(stmt)
    if not tables:
        return False  # SELECT 1 / session-state reads stay local
    for t in tables:
        db = (t.db or session.current_db or "").lower()
        if db in _SYSTEM_DBS:
            return False
        # views stay on the leader: the eligibility walk sees only the
        # view NAME, so a view body could smuggle nondeterministic
        # functions or system memtables past the gate — and the replica
        # re-expands the body locally, evaluating them with ITS clock/
        # identity/state (a wrong answer, not a stale one)
        try:
            schema = session.catalog.schema(t.db or session.current_db)
        except KeyError:
            return False  # unresolvable reference: let the leader err
        if t.name.lower() in getattr(schema, "views", {}):
            return False
    if _has_nonroutable_funcs(stmt):
        return False
    return True


def _candidates(storage, read_ts: int, max_staleness_ms: int,
                self_addr: str) -> tuple[list[dict], int]:
    """(ordered routing candidates, serving-replica count). A follower
    is a candidate when it is serving, term-clean, and either already
    covers read_ts or is fresh enough (lag within the staleness cap)
    that its bounded ReadIndex-style wait will cover it."""
    from .diag import cluster_members
    try:
        members = cluster_members(storage, budget_ms=500)
    except survivable():  # membership trouble = no routing
        return [], 0
    serving = []
    for m in members:
        if not isinstance(m, dict) or m.get("down"):
            continue
        if m.get("role") != "follower" or not m.get("serving"):
            continue
        addr = str(m.get("addr") or "")
        if not addr or addr == self_addr:
            continue
        serving.append(m)
    cands = []
    for m in serving:
        applied = int(m.get("applied_ts") or 0)
        lag = m.get("apply_lag_ms")
        covered = applied >= read_ts
        fresh = lag is not None and float(lag) <= max_staleness_ms
        if covered or fresh:
            m = dict(m)
            m["_covered"] = covered
            cands.append(m)
    # replicas that ALREADY cover read_ts come first: an uncovered
    # candidate costs the serve-side bounded wait even on success, and
    # a lagging-but-"fresh" one may burn the whole wait before the
    # fallback — never pay that ahead of a replica that can answer now
    cands.sort(key=lambda m: (not m["_covered"],
                              int(m.get("load") or 0),
                              float(m.get("hb_age_s") or 0.0)))
    return cands, len(serving)


def _range_spans(session, stmt) -> Optional[list]:
    """[start, end) row-key spans of every base table the statement
    touches (kv/tablecodec.table_range), or None when one cannot be
    resolved — then the range gate is inapplicable and routing behaves
    exactly as without it (the leader errors on the real problem)."""
    from ..kv.tablecodec import table_range
    try:
        tables = session._collect_table_names(stmt)
    except survivable():  # the gate is advisory, never fatal
        return None
    spans = []
    for t in tables:
        try:
            schema = session.catalog.schema(t.db or session.current_db)
        except KeyError:
            return None
        info = schema.tables.get(t.name.lower())
        if info is None:
            return None
        spans.append(table_range(int(info.id)))
    return spans or None


def _range_gate(storage, spans, read_ts: int,
                budget_s: float = 1.0) -> Optional[dict]:
    """Range-aware coverage check: the statement's COVERED timestamp is
    the min published closed_ts over every range its spans touch; a
    read above it may observe a torn cross-range transaction on a
    replica (a participant range's secondaries not yet durable), so
    the router refuses to ship it. Waits bounded (heartbeats publish
    every lease tick) under the `covered_ts` wait state, then reports
    which ranges still gate. None = no range plane armed here."""
    plane = getattr(storage, "ranges", None)
    if plane is None:
        return None

    def probe() -> dict:
        per: dict[int, int] = {}
        for start, end in spans:
            for rid, closed in plane.closed_over(start, end):
                per[rid] = closed
        return per

    t0 = time.perf_counter()
    per = probe()
    if not per:
        return None
    gated = sorted((rid, ts) for rid, ts in per.items()
                   if ts < read_ts)
    waited = 0.0
    if gated:
        with obs.wait("covered_ts"):
            deadline = t0 + budget_s
            while time.perf_counter() < deadline:
                time.sleep(0.02)
                per = probe()
                gated = sorted((rid, ts) for rid, ts in per.items()
                               if ts < read_ts)
                if not gated:
                    break
        waited = (time.perf_counter() - t0) * 1e3
    return {"covered": not gated, "gated": gated, "n": len(per),
            "waited_ms": waited}


def try_route(session, stmt, sql: Optional[str],
              has_vars: bool = False,
              expect_cols: Optional[int] = None) -> Optional[RoutedRead]:
    """Route one SELECT to a replica, or return None to execute on the
    leader (the caller's unchanged local path). Never raises for
    transport/staleness reasons — fallback is the contract."""
    storage = session.storage
    st = getattr(storage, "replica_read", None)
    if st is None or not st.enabled:
        return None
    from ..session.session import SQLError

    def var(name, default):
        try:
            v = session._sysvar_value(name)
            return default if v is None or v == "" else v
        except (TypeError, ValueError, SQLError):
            return default

    mode = str(var("tidb_replica_read", "leader")).lower()
    try:
        staleness_s = int(var("tidb_read_staleness", 0))
    except (TypeError, ValueError):
        staleness_s = 0
    want = mode == "follower" or st.prefer_follower or staleness_s < 0
    if not want or not _eligible(session, stmt, sql, has_vars):
        return None
    txn = session._ensure_txn()
    read_ts = txn.start_ts
    if staleness_s < 0:
        # bounded staleness (tidb_read_staleness semantics: -5 = up to
        # 5s stale), capped by replica-read.max-staleness-ms; the LOCAL
        # fallback reads at the same ts so routed and leader answers
        # are the same snapshot either way
        stale_ms = min(-staleness_s * 1000, st.max_staleness_ms)
        stale_ts = ts_at_physical_ms(int(time.time() * 1000) - stale_ms)
        read_ts = min(read_ts, stale_ts)
        txn.stmt_read_ts = read_ts  # cleared by _exec_select's finally
    self_addr = getattr(storage, "diag_address", "") or ""
    cands, n_serving = _candidates(storage, read_ts,
                                   st.max_staleness_ms, self_addr)
    if n_serving == 0:
        return None  # no serving tier: not a replica-read situation
    term = cluster_term(storage)
    counter = storage.obs.replica_reads
    if getattr(st, "range_aware", False):
        spans = _range_spans(session, stmt)
        gate = _range_gate(storage, spans, read_ts) if spans else None
        if gate is not None and not gate["covered"]:
            # typed fallback, same contract as replica staleness: the
            # leader serves the identical snapshot. The gating ranges
            # land in the engine tags (EXPLAIN ANALYZE / last_engines)
            # so "why didn't this route" is answerable per statement.
            for rid, ts in gate["gated"][:8]:
                obs.note_engine(f"range#{rid}@gated")
            counter.inc(outcome="stale_fallback")
            why = ", ".join(f"range#{rid} closed_ts={ts}"
                            for rid, ts in gate["gated"][:4])
            session.add_warning(
                f"replica read fell back to the leader "
                f"(stale_fallback): read_ts {read_ts} uncovered on "
                f"{len(gate['gated'])}/{gate['n']} ranges: {why}"[:512],
                level="Note")
            return None
        if gate is not None and gate["waited_ms"] > 1.0:
            obs.note_engine(f"ranges@covered(n={gate['n']},"
                            f"wait={gate['waited_ms']:.0f}ms)")
    stale_reason: Optional[str] = None
    unreachable_reason: Optional[str] = None
    from .diag import _peer_client
    for m in cands:
        addr = str(m["addr"])
        client = _peer_client(storage, addr)
        if client.breaker_state == "open":
            # the satellite bugfix: an OPEN breaker means this peer
            # already burned its budgets — fail over to the next
            # candidate immediately instead of rediscovering it
            unreachable_reason = f"{addr}: rpc circuit breaker open"
            continue
        t0 = time.perf_counter()
        try:
            with obs.stage("replica_read", span_name="replica.read"):
                r = client.call(
                    "diag_replica_read", sql=sql,
                    db=session.current_db or "", read_ts=read_ts,
                    term=term,
                    time_zone=str(var("time_zone", "SYSTEM")),
                    _budget_ms=min(client.options.backoff_budget_ms,
                                   4000))
        except (ReplicaStaleError, StaleTermError) as e:
            stale_reason = f"{addr}: {e}"
            continue
        except RPCError as e:
            unreachable_reason = f"{addr}: {type(e).__name__}: {e}"
            continue
        from ..util import interrupt
        interrupt.check()  # a KILL during the remote wait lands here
        cols = list(r.get("cols", []))
        if expect_cols is not None and len(cols) != expect_cols:
            # result shape disagrees with the local plan (schema drift
            # mid-flight): treat like staleness and fail over — and do
            # it BEFORE counting/tagging, or the local re-execution
            # would read as a served replica read
            stale_reason = (f"{addr}: replica answered {len(cols)} "
                            f"columns, local plan expects {expect_cols}")
            continue
        rows = [tuple(unwire_value(v) for v in row)
                for row in r.get("rows", [])]
        counter.inc(outcome="served")
        obs.note_engine(f"replica@{addr}")
        return RoutedRead(rows=rows, cols=cols, addr=addr,
                          read_ts=read_ts,
                          wall_ms=(time.perf_counter() - t0) * 1e3)
    # typed fallback: the leader serves, the reason is queryable
    if unreachable_reason is not None and stale_reason is None:
        outcome, why = "unreachable_fallback", unreachable_reason
    else:
        outcome = "stale_fallback"
        why = stale_reason or \
            f"no replica closed past read_ts {read_ts} " \
            f"({n_serving} serving)"
    counter.inc(outcome=outcome)
    session.add_warning(
        f"replica read fell back to the leader ({outcome}): {why}"[:512],
        level="Note")
    return None


# ---- surfaces ---------------------------------------------------------------

def debug_payload(storage) -> dict:
    """The /debug/replicas JSON: router knobs, per-member serving
    state, the local apply engine (followers), and the outcome
    counters — the one page that answers 'why is nothing routing'."""
    st = getattr(storage, "replica_read", None)
    out: dict = {
        "enabled": bool(st is not None and st.enabled),
        "prefer_follower": bool(st is not None and st.prefer_follower),
        "max_staleness_ms": st.max_staleness_ms if st is not None else 0,
        "range_aware": bool(st is not None
                            and getattr(st, "range_aware", False)),
        "term": cluster_term(storage),
    }
    try:
        from .diag import cluster_members
        members = []
        for m in cluster_members(storage, budget_ms=500):
            m = dict(m)
            addr = str(m.get("addr") or "")
            c = storage._diag_clients.get(addr)
            if c is not None:
                m["breaker"] = c.breaker_state
            members.append(m)
        out["members"] = members
    except survivable() as e:  # the scrape survives
        out["members_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    eng = getattr(storage, "apply_engine", None)
    if eng is not None:
        out["apply"] = eng.info()
    out["reads"] = {
        outcome: storage.obs.replica_reads.get(outcome=outcome)
        for outcome in ("served", "stale_fallback",
                        "unreachable_fallback")}
    return out


__all__ = ["ReplicaReadState", "RoutedRead", "try_route",
           "serve_replica_read", "wire_value", "unwire_value",
           "cluster_term", "debug_payload", "NONROUTABLE_FUNCS"]
