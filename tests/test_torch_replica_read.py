"""The port's follower read tier held to the reference's.

Twins of the cases of tests/test_replica_read.py that need no range
plane: a leader (`Storage(path, shared=True, rpc_listen=...)`) and
socket followers of one package, the port's on `device="cpu"`. Each
scenario runs once over each package with the same statements, and the
outcomes are compared: rows (decimals as (unscaled, scale)), engine tag
kinds, stage names, `tidb_replica_reads_total` by outcome, Notes, error
classes and messages, terms, the cluster_info serving columns, the
`/debug/replicas` keys. Each scenario keeps the reference test's own
assertions and time bounds on both packages. The reference's three
range-aware cases (`test_range_aware_gate_serves_covered_reads`,
`test_range_gate_blocks_uncovered_read_and_recovers`,
`test_split_during_routed_read_never_wrong`) arm the range plane and run
through `torch_twins`: the reference's case on each package, its range
tables, terms, hosted ranges, events and range counters compared.

The port's own rules: a follower's serving sessions run on the
storage's `device`, and an error in serving that the RPC plane does not
survive (a `RuntimeError` standing for a torch or CUDA error) is not
answered over the wire: the follower's diag listener keeps it and its
`close()` re-raises it, while the router falls back typed.

Every fixture closes followers before the leader, and an autouse
fixture fails a test that leaves a live `titpu-*` thread behind.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import sys
import threading
import time
from contextlib import contextmanager

import pytest

sys.path.insert(0, os.path.dirname(__file__))

import tidb_tpu.config as ref_config  # noqa: E402
import tidb_tpu.obs_inspect as ref_inspect  # noqa: E402
import tidb_tpu.rpc.client as ref_client  # noqa: E402
import tidb_tpu.rpc.diag as ref_diag  # noqa: E402
import tidb_tpu.rpc.errors as ref_errors  # noqa: E402
import tidb_tpu.rpc.frame as ref_frame  # noqa: E402
import tidb_tpu.rpc.replica as ref_replica  # noqa: E402
import tidb_tpu.types.value as ref_value  # noqa: E402
import tidb_tpu.util.failpoint as ref_fp  # noqa: E402
import tidb_tpu_torch.config as port_config  # noqa: E402
import tidb_tpu_torch.obs_inspect as port_inspect  # noqa: E402
import tidb_tpu_torch.rpc.client as port_client  # noqa: E402
import tidb_tpu_torch.rpc.diag as port_diag  # noqa: E402
import tidb_tpu_torch.rpc.errors as port_errors  # noqa: E402
import tidb_tpu_torch.rpc.frame as port_frame  # noqa: E402
import tidb_tpu_torch.rpc.replica as port_replica  # noqa: E402
import tidb_tpu_torch.types.value as port_value  # noqa: E402
import tidb_tpu_torch.util.failpoint as port_fp  # noqa: E402
from tidb_tpu.session import Session as RefSession  # noqa: E402
from tidb_tpu.store.storage import Storage as RefStorage  # noqa: E402
from tidb_tpu_torch.session import Session as PortSession  # noqa: E402
from tidb_tpu_torch.store.storage import Storage as PortStorage  # noqa: E402

REF = {"name": "ref", "Storage": RefStorage, "Session": RefSession,
       "client": ref_client, "diag": ref_diag, "errors": ref_errors,
       "frame": ref_frame, "replica": ref_replica, "value": ref_value,
       "fp": ref_fp, "inspect": ref_inspect, "config": ref_config}
PORT = {"name": "port",
        "Storage": functools.partial(PortStorage, device="cpu"),
        "Session": lambda st: PortSession(st, device="cpu"),
        "client": port_client, "diag": port_diag, "errors": port_errors,
        "frame": port_frame, "replica": port_replica, "value": port_value,
        "fp": port_fp, "inspect": port_inspect, "config": port_config}


def _opts(P):
    """The reference test's budgets (OPTS)."""
    return P["client"].RpcOptions(
        connect_timeout_ms=1000, request_timeout_ms=4000,
        backoff_budget_ms=2500, lock_budget_ms=8000, lease_ms=2000)


BUDGET_MS = 2500


def both(fn, tmp_path):
    """fn(package, dir) over the reference, then the port: equal
    outcomes."""
    want = fn(REF, tmp_path / "ref")
    got = fn(PORT, tmp_path / "port")
    assert got == want
    return got


def _titpu_threads() -> set:
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("titpu-")}


@pytest.fixture(autouse=True)
def _no_leaked_threads():
    before = _titpu_threads()
    yield
    # the reference's reaper and connection threads end within a lease
    # tick of their close; the port's close joins its own
    deadline = time.monotonic() + 15.0
    while _titpu_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
    left = _titpu_threads() - before
    assert not left, sorted(t.name for t in left)


@pytest.fixture(autouse=True)
def _env_and_failpoints(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_REPLICA_APPLY_MS", "100")
    yield
    ref_fp.disable_all()
    port_fp.disable_all()


@contextmanager
def cluster(P, d, n_followers: int = 1):
    """A leader and socket followers of one package; the followers close
    first, the newest first."""
    opts = _opts(P)
    leader = P["Storage"](str(d / "leader"), shared=True,
                          rpc_listen="127.0.0.1:0", rpc_options=opts)
    followers = []
    try:
        for i in range(n_followers):
            followers.append(P["Storage"](
                str(d / f"f{i}"),
                remote=f"127.0.0.1:{leader.rpc_server.port}",
                rpc_options=opts))
        yield (leader, *followers)
    finally:
        try:
            for f in reversed(followers):
                f.close()
        finally:
            leader.close()


def _wait_serving(leader, n: int = 1, timeout: float = 10.0) -> None:
    """Until n followers advertise serving on the leader's registry
    (one apply tick + one heartbeat)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        serving = [m for m in leader.rpc_server.members()
                   if m["role"] == "follower" and m.get("serving")]
        if len(serving) >= n:
            return
        time.sleep(0.05)
    raise AssertionError(
        f"no serving follower within {timeout}s: "
        f"{leader.rpc_server.members()}")


def _served(storage) -> float:
    return storage.obs.replica_reads.get(outcome="served")


def _fallbacks(storage) -> dict:
    return {o: storage.obs.replica_reads.get(outcome=o)
            for o in ("stale_fallback", "unreachable_fallback")}


def _norm(rows) -> list:
    """Rows of either package in one form: a decimal as its (unscaled,
    scale) pair."""
    def v(x):
        if hasattr(x, "unscaled") and hasattr(x, "scale"):
            return ("dec", int(x.unscaled), int(x.scale))
        return x
    return [tuple(v(x) for x in r) for r in rows]


def _kinds(engines) -> list:
    """Engine tags without the address a routed read names."""
    return [e.split("@")[0] for e in engines]


def _notes(sess) -> list:
    return [(w[0], w[1]) for w in sess.warnings]


# ==================== config/state mirror pin ====================

def test_replica_state_mirrors_config():
    """config.ReplicaReadConfig and rpc.replica.ReplicaReadState are
    deliberate mirrors; a knob added to one must land in the other —
    in each package, and the port's knobs are the reference's."""
    out = []
    for P in (REF, PORT):
        st = {f.name: f.default
              for f in dataclasses.fields(P["replica"].ReplicaReadState)}
        cfg = {f.name: f.default for f in
               dataclasses.fields(P["config"].ReplicaReadConfig)}
        for name, default in cfg.items():
            assert name in st, f"knob {name} missing from runtime state"
            assert st[name] == default, name
        out.append((st, cfg))
    assert out[0] == out[1]


# ==================== the happy path ====================

def test_routed_read_bit_identical_and_observable(tmp_path):
    def run(P, d):
        with cluster(P, d, n_followers=2) as (leader, _f, _f2):
            sl = P["Session"](leader)
            sl.execute("create table t (id bigint primary key, v bigint, "
                       "name varchar(32), price decimal(10,2), d date)")
            sl.execute(
                "insert into t values "
                "(1, 10, 'alpha', 12.34, '2024-01-01'), "
                "(2, 20, 'beta', 0.05, '2024-06-15'), "
                "(3, 30, 'gamma', 999.99, '2025-12-31')")
            _wait_serving(leader, n=2)

            sql = ("select id, v, name, price, d, v * 2 from t "
                   "where v >= 10 order by id desc")
            want = sl.execute(sql).rows          # leader-local answer
            sl.execute("set tidb_replica_read = 'follower'")
            got = sl.execute(sql).rows
            assert got == want                   # bit-identical rows
            assert _served(leader) == 1.0
            assert sl.warnings == []             # served, not a fallback
            assert any(e.startswith("replica@") for e in sl.last_engines)
            assert "replica_read" in sl.last_stages
            out = {"rows": _norm(got), "engines": _kinds(sl.last_engines)}

            # aggregation routes too, and EXPLAIN ANALYZE shows the
            # routing decision as the plan's engine
            out["agg"] = sl.execute(
                "select sum(v), count(*) from t").rows
            assert out["agg"] == [(60, 3)]
            ea = sl.execute("explain analyze select sum(v) from t")
            assert ea.column_names[3] == "engine"
            assert ea.rows[0][3].startswith("replica@"), ea.rows
            assert ea.rows[0][4].startswith("replica_read:")
            out["ea"] = (list(ea.column_names),
                         [(r[0], r[1], _kinds([r[3]])) for r in ea.rows])

            # routed reads land in the statement's slow log stages
            sl.execute("set tidb_slow_log_threshold = 0")
            sl.execute("select v from t where id = 2")
            sl.execute("set tidb_slow_log_threshold = 100000")
            slow = leader.obs.slow_queries()[-1]
            assert "replica_read" in slow["stages"], slow

            # system-schema reads, table-less reads, and VIEWS never
            # route (a view body can smuggle NOW()/system memtables past
            # the top-level eligibility walk)
            before = _served(leader)
            sl.execute("select 1")
            sl.execute("select instance from "
                       "information_schema.cluster_info")
            sl.execute("create view vt as select id, v from t")
            assert sl.execute("select * from vt order by id").rows == \
                [(r[0], r[1]) for r in want][::-1]
            assert _served(leader) == before
            out["served"] = _served(leader)
            return out

    out = both(run, tmp_path)
    assert out["engines"] == ["replica"] and out["served"] == 4.0


def test_prefer_follower_state_routes_without_session_var(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, _follower):
            sl = P["Session"](leader)
            sl.execute("create table p (id bigint primary key, v bigint)")
            sl.execute("insert into p values (1, 1)")
            _wait_serving(leader)
            leader.replica_read.prefer_follower = True
            try:
                rows = sl.execute("select v from p").rows
                assert rows == [(1,)]
                assert _served(leader) >= 1.0
                return rows, _kinds(sl.last_engines)
            finally:
                leader.replica_read.prefer_follower = False

    assert both(run, tmp_path) == ([(1,)], ["replica"])


def test_cluster_info_carries_serving_columns(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, _follower):
            _wait_serving(leader)
            sl = P["Session"](leader)
            rows = sl.execute(
                "select instance, type, applied_ts, apply_lag_ms, "
                "serving, error from information_schema.cluster_info").rows
            by_role = {r[1]: r for r in rows}
            assert set(by_role) == {"leader", "follower"}
            lead, fol = by_role["leader"], by_role["follower"]
            assert lead[2] > 0 and lead[4] == 0     # leader never serves
            assert fol[2] > 0 and fol[4] == 1       # follower serves
            assert fol[3] >= 0.0
            assert all(r[5] is None for r in rows)
            mem = {m["role"]: m for m in leader.rpc_server.members()}
            assert mem["follower"]["serving"] is True
            assert mem["follower"]["applied_ts"] > 0
            return sorted((r[1], r[4], r[5]) for r in rows)

    assert both(run, tmp_path) == [("follower", 1, None),
                                   ("leader", 0, None)]


def test_range_aware_without_a_range_plane_gates_nothing(tmp_path):
    """`range_aware` with no range plane armed: the gate answers None
    and routing behaves as without it, in both packages (the cases
    with a plane armed are the range twins at the end of this file)."""
    def run(P, d):
        with cluster(P, d) as (leader, _follower):
            sl = P["Session"](leader)
            sl.execute("create table ra (id bigint primary key, v bigint)")
            sl.execute("insert into ra values (1, 2), (2, 3)")
            _wait_serving(leader)
            leader.replica_read.range_aware = True
            sl.execute("set tidb_replica_read = 'follower'")
            rows = sl.execute("select sum(v) from ra").rows
            assert _served(leader) == 1.0 and sl.warnings == []
            return (rows, _kinds(sl.last_engines),
                    P["replica"].debug_payload(leader)["range_aware"])

    assert both(run, tmp_path) == ([(5,)], ["replica"], True)


# ==================== staleness fence ====================

def test_stalled_replica_causes_typed_leader_fallback(tmp_path):
    def run(P, d):
        fp = P["fp"]
        with cluster(P, d) as (leader, _follower):
            sl = P["Session"](leader)
            sl.execute("create table s (id bigint primary key, v bigint)")
            sl.execute("insert into s values (1, 1), (2, 2)")
            _wait_serving(leader)
            sl.execute("set tidb_replica_read = 'follower'")
            assert sl.execute("select sum(v) from s").rows == [(3,)]
            assert _served(leader) == 1.0

            with fp.failpoint("replica/apply-stall", True):
                # the write advances the leader's timestamps; the
                # stalled replica can never close past it
                sl.execute("insert into s values (3, 4)")
                rows = sl.execute("select sum(v) from s").rows
                assert rows == [(7,)]               # correct, from leader
                engines = _kinds(sl.last_engines)
                assert fp.hits("replica/apply-stall") >= 1
            assert _served(leader) == 1.0           # not served stale
            assert _fallbacks(leader)["stale_fallback"] >= 1.0
            notes = [w for w in sl.warnings if "fell back" in w[2]]
            assert notes and notes[0][0] == "Note"
            assert "(stale_fallback)" in notes[0][2]
            # recovery: once the stall clears, routing resumes
            deadline = time.monotonic() + 8.0
            while time.monotonic() < deadline:
                if sl.execute("select sum(v) from s").rows == [(7,)] \
                        and _served(leader) >= 2.0:
                    break
                time.sleep(0.1)
            assert _served(leader) >= 2.0
            return rows, engines, (notes[0][0], notes[0][1])

    rows, engines, note = both(run, tmp_path)
    assert engines != ["replica"] and note == ("Note", 1105)


def test_bounded_staleness_read_routes(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, _follower):
            sl = P["Session"](leader)
            sl.execute("create table b (id bigint primary key, v bigint)")
            sl.execute("insert into b values (1, 5)")
            _wait_serving(leader)
            time.sleep(1.2)  # age the data past the staleness horizon
            sl.execute("set tidb_read_staleness = -1")
            try:
                rows = sl.execute("select v from b").rows
                assert rows == [(5,)]
                assert _served(leader) >= 1.0
                return rows, _kinds(sl.last_engines)
            finally:
                sl.execute("set tidb_read_staleness = 0")

    assert both(run, tmp_path) == ([(5,)], ["replica"])


# ==================== term fencing ====================

def test_term_fence_rejects_mismatched_epochs(tmp_path):
    def run(P, d):
        errors = P["errors"]
        with cluster(P, d) as (leader, follower):
            sl = P["Session"](leader)
            sl.execute("create table f (id bigint primary key, v bigint)")
            sl.execute("insert into f values (1, 1)")
            _wait_serving(leader)
            ts = follower.apply_engine.applied_ts
            assert ts > 0
            # a router living in a DEPOSED epoch
            with pytest.raises(errors.StaleTermError) as e:
                P["replica"].serve_replica_read(
                    follower, sql="select v from f", db="test",
                    read_ts=ts, term=follower._rpc_client.term + 1)
            msg = str(e.value)
            # a replica that adopted a NEWER epoch than this leader is
            # rejected typed and the leader serves the read itself
            follower._rpc_client.term += 7
            try:
                sl.execute("set tidb_replica_read = 'follower'")
                assert sl.execute("select v from f").rows == [(1,)]
                assert _served(leader) == 0.0
                assert _fallbacks(leader)["stale_fallback"] >= 1.0
                notes = [w[2] for w in sl.warnings]
                assert any("replica read fenced" in n for n in notes)
            finally:
                follower._rpc_client.term -= 7
            return msg, _notes(sl)

    msg, notes = both(run, tmp_path)
    assert msg == ("replica read fenced: replica follows term 1, "
                   "request carries term 2")


def test_serve_rejects_non_select_and_non_followers(tmp_path):
    def run(P, d):
        errors, serve = P["errors"], P["replica"].serve_replica_read
        out = []
        with cluster(P, d) as (leader, follower):
            sl = P["Session"](leader)
            sl.execute("create table w (id bigint primary key, v bigint)")
            sl.execute("insert into w values (1, 1)")
            _wait_serving(leader)
            ts = follower.apply_engine.applied_ts
            with pytest.raises(errors.RPCError,
                               match="exactly one SELECT") as e:
                serve(follower, sql="insert into w values (9, 9)",
                      db="test", read_ts=ts)
            out.append(str(e.value))
            with pytest.raises(errors.RPCError, match="leader") as e:
                serve(follower, sql="select * from w for update",
                      db="test", read_ts=ts)
            out.append(str(e.value))
            with pytest.raises(errors.RPCError,
                               match="not a follower") as e:
                serve(leader, sql="select 1", db="test", read_ts=1)
            out.append(str(e.value))
            # a replica with serving disabled answers typed staleness
            follower.replica_read.enabled = False
            follower.arm_replica_read()
            try:
                with pytest.raises(errors.ReplicaStaleError) as e:
                    serve(follower, sql="select v from w", db="test",
                          read_ts=ts)
                out.append(str(e.value))
            finally:
                follower.replica_read.enabled = True
                follower.arm_replica_read()
            # and a served one answers the wire shape
            r = serve(follower, sql="select id, v from w", db="test",
                      read_ts=ts, term=follower._rpc_client.term)
            out.append((r["cols"], r["rows"], r["term"],
                        r["applied_ts"] >= ts))
        return out

    assert both(run, tmp_path)[-1] == (["id", "v"], [[1, 1]], 1, True)


# ==================== unreachability ====================

def test_killed_replica_falls_back_typed_mid_statement(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl = P["Session"](leader)
            sl.execute("create table k (id bigint primary key, v bigint)")
            sl.execute("insert into k values (1, 1), (2, 2)")
            _wait_serving(leader)
            sl.execute("set tidb_replica_read = 'follower'")
            assert sl.execute("select sum(v) from k").rows == [(3,)]
            # kill-9 equivalent: the replica's endpoints vanish without
            # any deregistration; its membership entry (and serving
            # flag) survive until the lease horizon
            follower.diag_listener.close()
            follower._rpc_client.close()
            t0 = time.monotonic()
            rows = sl.execute("select sum(v) from k").rows
            elapsed = time.monotonic() - t0
            assert rows == [(3,)]                   # leader answered
            assert elapsed < BUDGET_MS / 1000.0 + 5.0
            assert _fallbacks(leader)["unreachable_fallback"] >= 1.0
            assert any("fell back" in w[2] for w in sl.warnings)
            return rows, _kinds(sl.last_engines), \
                _fallbacks(leader)["unreachable_fallback"]

    rows, engines, n = both(run, tmp_path)
    assert engines != ["replica"] and n == 1.0


def test_open_breaker_skips_peer_without_burning_budget(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl = P["Session"](leader)
            sl.execute("create table o (id bigint primary key, v bigint)")
            sl.execute("insert into o values (1, 1)")
            _wait_serving(leader)
            sl.execute("set tidb_replica_read = 'follower'")
            assert sl.execute("select v from o").rows == [(1,)]  # warm
            client = P["diag"]._peer_client(leader, follower.diag_address)
            # force the breaker OPEN
            with client._bk_lock:
                client._bk_streak = client.options.breaker_threshold
                client._bk_open_until = time.monotonic() + 30.0
            try:
                t0 = time.monotonic()
                assert sl.execute("select v from o").rows == [(1,)]
                assert time.monotonic() - t0 < 1.5
                assert _fallbacks(leader)["unreachable_fallback"] >= 1.0
                note = [w[2] for w in sl.warnings if "fell back" in w[2]]
                # the diag fan-out degrades to the error row at once too
                t0 = time.monotonic()
                rows = sl.execute("select instance, error from "
                                  "information_schema.cluster_info").rows
                assert time.monotonic() - t0 < 1.5
                bad = [r for r in rows if r[1] is not None]
                assert [r[0] for r in bad] == [follower.diag_address]
                assert "breaker" in bad[0][1]
                return note[-1].replace(follower.diag_address, "F")
            finally:
                client._breaker_reset()

    assert both(run, tmp_path) == (
        "replica read fell back to the leader (unreachable_fallback): "
        "F: rpc circuit breaker open")


# ==================== closed-timestamp protocol ====================

def test_closed_ts_capped_below_pending_remote_commit(tmp_path):
    """closed_info must never close past a commit timestamp whose
    records are still unpublished (the pending-commit ledger)."""
    def run(P, d):
        with cluster(P, d) as (_leader, follower):
            client = follower._rpc_client
            pending = int(client.call("tso_commit")["ts"])
            info = client.call("closed_info")
            assert info["closed_ts"] < pending
            # the retire is TS-MATCHED
            client.call("tso_commit_done", ts=pending + 1)
            assert client.call("closed_info")["closed_ts"] < pending
            client.call("tso_commit_done", ts=pending)
            info2 = client.call("closed_info")
            assert info2["closed_ts"] >= pending
            assert info2["wal_size"] >= info["wal_size"]
            return sorted(info2)

    both(run, tmp_path)


def test_follower_commit_does_not_freeze_closed_ts(tmp_path):
    """A follower that WRITES (tso_commit through the real 2PC path)
    retires its ledger entry: the write is immediately readable through
    a routed read."""
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table c (id bigint primary key, v bigint)")
            sf.execute("insert into c values (1, 41)")   # remote commit
            _wait_serving(leader)
            sl.execute("set tidb_replica_read = 'follower'")
            rows = sl.execute("select v from c where id = 1").rows
            assert rows == [(41,)]
            assert _served(leader) >= 1.0
            return rows, _kinds(sl.last_engines)

    assert both(run, tmp_path) == ([(41,)], ["replica"])


# ==================== wire codec ====================

def test_wire_codec_roundtrips_exact_types():
    out = []
    for P in (REF, PORT):
        Decimal, rep = P["value"].Decimal, P["replica"]
        values = [None, True, False, 7, -7, 3.5, "text", b"bytes",
                  Decimal(12345, 2), datetime.date(2024, 2, 29),
                  datetime.datetime(2024, 2, 29, 12, 34, 56, 789000)]
        wire = P["frame"].encode([rep.wire_value(v) for v in values])
        got = [rep.unwire_value(v) for v in P["frame"].decode(wire)]
        assert got == values
        d = got[8]
        assert isinstance(d, Decimal) and d.unscaled == 12345 \
            and d.scale == 2
        out.append(wire)
    assert out[0] == out[1]  # byte-equal on the wire


# ==================== inspection rule ====================

def test_follower_apply_lag_rule_grades_by_threshold():
    out = []
    for P in (REF, PORT):
        inspect = P["inspect"]

        class _Ctx:
            def __init__(self, members, warn=1000):
                self.cfg = inspect.DiagnosticsState(apply_lag_warn_ms=warn)
                self._members = members

            def members(self):
                return self._members

        rule = inspect.RULES["follower-apply-lag"]
        assert rule.reference
        fn = rule.fn
        assert fn(_Ctx([])) == []
        healthy = {"role": "follower", "serving": True, "addr": "a:1",
                   "apply_lag_ms": 120.0}
        assert fn(_Ctx([healthy])) == []
        lagging = dict(healthy, apply_lag_ms=1500.0)
        [f] = fn(_Ctx([lagging]))
        assert f.severity == "warning" and f.item == "a:1"
        stopped = dict(healthy, apply_lag_ms=3500.0)
        [g] = fn(_Ctx([stopped]))
        assert g.severity == "critical"
        assert fn(_Ctx([dict(lagging, serving=False)])) == []
        assert fn(_Ctx([dict(lagging, role="leader")])) == []
        assert fn(_Ctx([stopped], warn=0)) == []
        out.append([(x.severity, x.item, x.value, x.details)
                    for x in (f, g)])
    assert out[0] == out[1]


def test_replica_metrics_and_debug_surface(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            _wait_serving(leader)
            text = follower.obs.metrics.render()
            assert "# TYPE tidb_follower_apply_lag_seconds gauge" in text
            payload = P["replica"].debug_payload(leader)
            assert payload["enabled"] is True
            roles = {m["role"] for m in payload["members"]}
            assert roles == {"leader", "follower"}
            assert set(payload["reads"]) == {
                "served", "stale_fallback", "unreachable_fallback"}
            fol = follower.transport_health()
            assert fol["replica_apply"]["interval_ms"] == 100
            fpay = P["replica"].debug_payload(follower)
            return (sorted(payload), sorted(fpay), sorted(fpay["apply"]),
                    sorted(fol), payload["term"])

    out = both(run, tmp_path)
    assert "apply" in out[1] and out[4] == 1


# ==================== the port's own rules ====================

def test_serving_session_runs_on_the_storage_device(tmp_path):
    """The pooled internal session a follower serves a routed read on
    takes the follower storage's `device` (here the CPU, on the card by
    default) and runs the follower's own coprocessor client."""
    with cluster(PORT, tmp_path / "port") as (leader, follower):
        assert follower.device == "cpu"
        sl = PORT["Session"](leader)
        sl.execute("create table dv (id bigint primary key, v bigint)")
        sl.execute("insert into dv values (1, 3), (2, 4)")
        _wait_serving(leader)
        sl.execute("set tidb_replica_read = 'follower'")
        assert sl.execute("select sum(v), count(*) from dv").rows == \
            [(7, 2)]
        assert _served(leader) == 1.0
        [sess] = follower._replica_pool
        assert sess._replica_serving and sess._device == "cpu"
        assert sess.last_engines == ["device"]
        assert sess._cop is not None


def test_foreign_error_in_serving_is_kept_not_answered(tmp_path,
                                                       monkeypatch):
    """A RuntimeError in the follower's serving (a torch or CUDA error
    in its coprocessor) is not answered as a wire error: the follower's
    diag listener keeps it, drops the connection, and `close()`
    re-raises it; the router falls back typed (unreachable) and the
    leader answers exactly. The reference answers the error as an
    RPCError envelope (its fallback is the same)."""
    with cluster(PORT, tmp_path / "port") as (leader, follower):
        sl = PORT["Session"](leader)
        sl.execute("create table fe (id bigint primary key, v bigint)")
        sl.execute("insert into fe values (1, 3)")
        _wait_serving(leader)

        def boom(*_a, **_k):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(port_replica, "serve_replica_read", boom)
        sl.execute("set tidb_replica_read = 'follower'")
        assert sl.execute("select v from fe").rows == [(3,)]
        assert _fallbacks(leader)["unreachable_fallback"] == 1.0
        assert _served(leader) == 0.0
        assert isinstance(follower.diag_listener.error, RuntimeError)
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="illegal memory access"):
            follower.close()
        follower.close = lambda: None  # closed above


# ---- the range-aware gate (twins) ------------------------------------------

import torch_twins  # noqa: E402

_RR_REF, _RR_PORT = torch_twins.load("test_replica_read.py")

for _name in ("test_range_aware_gate_serves_covered_reads",
              "test_range_gate_blocks_uncovered_read_and_recovers",
              "test_split_during_routed_read_never_wrong"):
    globals()[_name] = torch_twins.twin(_RR_REF, _RR_PORT, _name)
