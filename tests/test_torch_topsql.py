"""Top SQL, the event log and their statement feed on the port, held to
the reference's.

Twins of every case of tests/test_topsql.py but those named below: each
scenario runs once over each package (`obs.TopSQL`, `obs.EventLog`, a
`Storage` with the port's sessions on `device="cpu"`), and the outcomes
are compared: buckets of the aggregator fed fixed timestamps (exact),
digests, digest texts, operators and exec counts of tidb_top_sql, event
kinds, severities and details, errnos. Times and byte counts are
excluded. TPC-H Q1, Q3 and Q18 at SF0.003 compare their Top SQL digests
and exec counts.

Also here, the twins of the profiler and wait-ledger cases of
tests/test_trace.py: the @@profiling ring (SHOW PROFILES, SHOW PROFILE,
information_schema.profiling; frame names are not compared, as each
package samples its own code), `Profile.tree_rows`, the wait ledger's
exclusive accounting (state names compared, seconds bounded by the
wall), the wait profile's statement surfaces, its zero cost while off,
and the Backoffer's typed waits. The dominant-wait rule is in
tests/test_torch_inspection.py.

Left out: the cluster_top_sql fan-outs (the diagnostics RPC plane), the
status-port routes of test_events_memtable_and_debug_routes, the /status
quick view (`TopSQL.top_by_device`) of the memtable case and the
debug-route cases of tests/test_trace.py (the status port); the memtable
halves of those cases are here.
"""

from __future__ import annotations

import threading
import time

import pytest

import tidb_tpu.obs as ref_obs
from tidb_tpu.kv import backoff as ref_backoff
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu.util.governor import AdmissionTimeout as RefAdmissionTimeout
from tidb_tpu_torch import obs
from tidb_tpu_torch.kv import backoff
from tidb_tpu_torch.obs import EventLog, TopSQL
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage
from tidb_tpu_torch.util.governor import AdmissionTimeout

PORT = {"obs": obs, "Storage": Storage, "shed": AdmissionTimeout,
        "backoff": backoff, "Session": lambda st: Session(st, device="cpu")}
REF = {"obs": ref_obs, "Storage": RefStorage, "shed": RefAdmissionTimeout,
       "backoff": ref_backoff, "Session": RefSession}


def both(fn):
    """fn(package) for the port and the reference; equal outcomes."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _buckets(t) -> list[dict]:
    """`t.snapshot()` less the reference's per-operator shard balance
    (`op_mesh`): the port has no mesh and keeps no such field."""
    snap = t.snapshot()
    for b in snap:
        for e in list(b["digests"].values()) + [b["other"]]:
            if e is not None:
                e.pop("op_mesh", None)
    return snap


# ==================== aggregator unit behavior ====================

def test_digest_cap_evicts_into_overflow_bucket():
    def run(pkg):
        t = pkg["obs"].TopSQL(enabled=True, window_s=60, digest_cap=2)
        for i in range(5):
            t.record(f"d{i}", f"select {i}", "test", 0.01, now=1000.0)
        first = _buckets(t)
        t.record("d9", "select 9", "test", 0.01, now=1001.0)
        return first, _buckets(t)

    first, after = both(run)
    b = first[0]
    assert len(first) == 1 and set(b["digests"]) == {"d0", "d1"}
    assert b["other"]["exec_count"] == 3
    assert b["other"]["digest"] == TopSQL.OTHER
    assert after[0]["other"]["exec_count"] == 4


def test_window_rotation_bounded_ring():
    def run(pkg):
        t = pkg["obs"].TopSQL(enabled=True, window_s=10, n_windows=3,
                              digest_cap=8)
        for i in range(6):
            t.record("d", "select 1", "test", 0.01, now=1000.0 + i * 10)
        first = _buckets(t)
        t.record("d", "select 1", "test", 0.02, now=1051.0)
        return first, _buckets(t)

    first, after = both(run)
    starts = [b["start"] for b in first]
    assert len(first) == 3 and starts == sorted(starts)
    assert starts[-1] == 1050
    assert after[-1]["digests"]["d"]["exec_count"] == 2


def test_concurrent_writers_conserve_counts():
    def run(pkg):
        t = pkg["obs"].TopSQL(enabled=True, window_s=3600, digest_cap=4)
        n_threads, per = 8, 200

        def work(k: int) -> None:
            for i in range(per):
                t.record(f"d{(k + i) % 6}", "q", "test", 0.001,
                         op_wall={"scan": 0.0005}, now=5000.0)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        b = t.snapshot()[0]
        total = sum(e["exec_count"] for e in b["digests"].values())
        if b["other"] is not None:
            total += b["other"]["exec_count"]
        return total

    assert both(run) == 8 * 200


def test_disabled_is_zero_allocation_and_zero_overhead():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("create table z (a int)")
        s.execute("insert into z values (1),(2)")
        topsql = st.obs.topsql
        assert not topsql.enabled
        calls = []
        topsql.record = lambda *a, **k: calls.append(1)
        s.query("select a from z")
        del topsql.record
        # a direct record on a disabled aggregator returns before its
        # lock: a lock that raises on entry proves it
        class Poison:
            def __enter__(self):
                raise AssertionError("lock taken while disabled")

            def __exit__(self, *exc):
                return False

        topsql._lock = Poison()
        topsql.record("d", "q", "test", 0.1)
        st.obs.waitprofile._lock = Poison()
        st.obs.waitprofile.record("d", "q", "test", 0.1, {"x": 1.0})
        return calls, list(topsql._buckets)

    assert both(run) == ([], [])


def test_statement_feed_and_attribution_coverage():
    """A join statement attributes the bulk of its wall time to named
    operators and stages, additive (never over the wall); the aggregator
    gets the same breakdown, with the reference's operator names."""
    def run(pkg):
        st = pkg["Storage"]()
        st.obs.topsql.configure(enabled=True, window_s=3600)
        s = pkg["Session"](st)
        s.execute("create table dim (k int primary key, tag varchar(8))")
        s.execute("create table fact (id int primary key, k int, v int)")
        s.execute("insert into dim values (1,'a'),(2,'b'),(3,'c')")
        s.execute("insert into fact values " + ",".join(
            f"({i},{i % 3 + 1},{i % 100})" for i in range(1, 4001)))
        sql = ("select dim.tag, sum(fact.v) from fact join dim "
               "on fact.k = dim.k group by dim.tag order by 2 desc "
               "limit 2")
        s.query(sql)  # warm: the reference compiles at the first call
        t0 = time.perf_counter()
        rows = s.query(sql)
        wall = time.perf_counter() - t0
        attributed = sum(s.last_op_wall.values()) + sum(
            s.last_op_stages.get("(session)", {}).values())
        assert attributed <= wall * 1.05
        assert attributed >= wall * 0.5, (attributed, wall)
        assert sum(s.last_stages.values()) <= wall * 1.05
        ent = next(e for b in st.obs.topsql.snapshot()
                   for e in b["digests"].values()
                   if "join" in e["digest_text"])
        assert ent["op_wall"]
        assert abs(sum(ent["op_wall"].values())
                   - 2 * sum(s.last_op_wall.values())) < 1.0
        return (rows, sorted(s.last_op_wall), ent["digest"],
                ent["exec_count"], sorted(ent["op_wall"]))

    rows, ops, digest, n, ent_ops = both(run)
    assert any("join" in o or o == "fragment" for o in ops), ops
    assert n == 2


def test_tidb_top_sql_memtable():
    def run(pkg):
        st = pkg["Storage"]()
        st.obs.topsql.configure(enabled=True, window_s=3600)
        s = pkg["Session"](st)
        s.execute("create table m (a int primary key, b int)")
        s.execute("insert into m values (1,10),(2,20),(3,30)")
        s.query("select sum(b) from m where a >= 1")
        rows = s.query(
            "select digest, operator, exec_count, sum_rows, "
            "admission_sheds, governor_kills "
            "from information_schema.tidb_top_sql where digest_text "
            "like 'select sum%'")
        return sorted(rows)

    rows = both(run)
    ops = {r[1] for r in rows}
    assert TopSQL.STMT in ops and len(ops) > 1
    assert next(r for r in rows if r[1] == TopSQL.STMT)[2] >= 1


def test_tpch_top_sql_digests_and_counts():
    """TPC-H Q1, Q3 and Q18 at SF0.003, twice each: equal digests, texts
    and exec counts in tidb_top_sql's statement rows."""
    from test_torch_sql_tpch import load_both
    from tidb_tpu.bench.tpch_queries import TPCH_QUERIES

    _, ref, port = load_both(0.003, 7)
    out = []
    for s in (port, ref):
        s.storage.obs.topsql.configure(enabled=True, window_s=3600)
        for q in ("q1", "q3", "q18", "q1"):
            s.query(TPCH_QUERIES[q])
        out.append(sorted(s.query(
            "select digest, digest_text, exec_count, sum_rows from "
            "information_schema.tidb_top_sql where operator = '(stmt)' "
            "and digest_text not like '%information_schema%'")))
    assert out[0] == out[1]
    assert sorted(r[2] for r in out[0]) == [1, 1, 2]


def test_no_threads_leaked_by_attribution_plane():
    def run(pkg):
        before = {t.ident for t in threading.enumerate()}
        st = pkg["Storage"]()
        st.obs.topsql.configure(enabled=True)
        s = pkg["Session"](st)
        s.execute("create table nt (a int)")
        s.execute("insert into nt values (1)")
        s.query("select a from nt")
        st.obs.events.record("governor_kill", detail="x")
        st.obs.topsql.snapshot()
        st.obs.events.snapshot()
        after = {t.ident for t in threading.enumerate()}
        st.close()
        return after <= before

    assert both(run) is True


# ==================== event log ====================

def test_event_ring_bounded_and_ordered():
    def run(pkg):
        ev = pkg["obs"].EventLog(cap=4)
        for i in range(10):
            ev.record("breaker_trip", detail=f"e{i}")
        snap = [(e["id"], e["kind"], e["detail"]) for e in ev.snapshot()]
        ev.configure(cap=2)
        return snap, len(ev.snapshot())

    snap, n = both(run)
    assert [d for _, _, d in snap] == ["e6", "e7", "e8", "e9"]
    assert snap[0][0] < snap[-1][0] and n == 2
    assert isinstance(EventLog(), EventLog)


def test_governor_kill_event_attributed():
    def run(pkg):
        st = pkg["Storage"]()
        st.governor.configure(limit_bytes=1, cooldown_ms=0)
        s = pkg["Session"](st)
        s.execute("create table gk (a int)")
        s.execute("insert into gk values (1),(2),(3)")
        try:
            s.query("select a from gk order by a")
            outcome = "ok"
        except Exception as e:  # the kill's typed error, compared
            outcome = getattr(e, "errno", None)
        ents = [e for e in st.obs.events.snapshot()
                if e["kind"] == "governor_kill"]
        assert ents and "server-memory-limit" in ents[0]["detail"]
        return outcome, [(e["kind"], e["severity"]) for e in ents]

    outcome, kinds = both(run)
    assert outcome == 8175 and kinds[0] == ("governor_kill", "warn")


def test_admission_shed_event_attributed():
    def run(pkg):
        st = pkg["Storage"]()
        st.admission.configure(tokens=1, timeout_ms=50)
        s1, s2 = pkg["Session"](st), pkg["Session"](st)
        s1.execute("create table sh (a int)")
        s1.execute("insert into sh values (1)")
        held, done = threading.Event(), threading.Event()

        def hog() -> None:
            with st.admission.admit(0):
                held.set()
                done.wait(5.0)

        th = threading.Thread(target=hog)
        th.start()
        held.wait(5.0)
        try:
            with pytest.raises(pkg["shed"]) as exc:
                s2.query("select a from sh")
        finally:
            done.set()
            th.join()
        ents = [e for e in st.obs.events.snapshot()
                if e["kind"] == "admission_shed"]
        assert ents and "select a from sh" in ents[0]["detail"]
        rows = pkg["Session"](st).query(
            "select kind from information_schema.tidb_events")
        return exc.value.errno, ("admission_shed",) in rows, \
            [e["severity"] for e in ents]

    assert both(run) == (9003, True, ["warn"])


def test_fsync_stall_event(tmp_path):
    def run(pkg):
        st = pkg["Storage"](str(tmp_path / pkg["obs"].__name__),
                            sync_log="commit")
        syncer = st.kv.kv._syncer
        assert syncer.on_stall is not None
        syncer.stall_ms = 0.0  # every fsync "stalls"
        s = pkg["Session"](st)
        s.execute("create table fs (a int)")
        s.execute("insert into fs values (1)")
        st.close()
        return "fsync_stall" in [e["kind"] for e in st.obs.events.snapshot()]

    assert both(run) is True


def test_events_memtable():
    def run(pkg):
        st = pkg["Storage"]()
        st.obs.topsql.configure(enabled=True)
        s = pkg["Session"](st)
        s.execute("create table ev (a int)")
        s.execute("insert into ev values (1)")
        st.obs.events.record("checkpoint_stall", detail="t", conn_id=3)
        return s.query("select id, kind, severity, conn_id, digest, "
                       "detail from information_schema.tidb_events")

    assert both(run) == [(1, "checkpoint_stall", "info", 3, "", "t")]


def test_slow_log_carries_operator_breakdown():
    def run(pkg):
        s = pkg["Session"](pkg["Storage"]())
        s.execute("create table slw (a int primary key, b int)")
        s.execute("insert into slw values (1,1),(2,2)")
        s.execute("set tidb_slow_log_threshold = 0")
        s.query("select sum(b) from slw")
        s.execute("set tidb_slow_log_threshold = 100000")
        rows = s.query(
            "select operators, plan_digest from "
            "information_schema.slow_query "
            "where query like '%sum(b) from slw%'")
        return [(sorted(p.split(":")[0] for p in r[0].split()), r[1])
                for r in rows]

    rows = both(run)
    assert rows and any(r[0] for r in rows)


# ==================== the sampling profiler (tests/test_trace.py) ======

Q6 = ("select sum(l_extendedprice * l_discount) from lineitem "
      "where l_quantity < 24 and l_discount >= 1 and l_discount <= 6")


def _q6_session(pkg):
    s = pkg["Session"](pkg["Storage"]())
    s.execute("create table lineitem (l_orderkey int primary key, "
              "l_quantity int, l_extendedprice int, l_discount int)")
    s.execute("insert into lineitem values " + ",".join(
        f"({i},{i % 50},{100 + i},{i % 10})" for i in range(1, 201)))
    return s


def _profiler_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == "titpu-profiler" and t.is_alive()]


def test_profiler_lifecycle_no_leaked_thread():
    def run(pkg):
        s = _q6_session(pkg)
        empty = s.query("show profiles")
        s.execute("set profiling = 1")
        s.execute("set tidb_profiler_sample_hz = 400")
        s.query(Q6)
        s.query("select count(*) from lineitem")
        s.execute("set profiling = 0")
        assert _profiler_threads() == []
        profiles = s.query("show profiles")
        assert all(p[1] > 0 for p in profiles)
        s.query(Q6)
        return empty, [(p[0], p[2]) for p in profiles], \
            len(s.query("show profiles"))

    empty, profiles, n = both(run)
    assert empty == [] and n == 2
    assert [p[0] for p in profiles] == [1, 2]
    assert "sum(l_extendedprice" in profiles[0][1]


def test_profiler_history_size_trims_ring():
    def run(pkg):
        s = _q6_session(pkg)
        s.execute("set profiling = 1")
        s.execute("set profiling_history_size = 3")
        for _ in range(5):
            s.query("select count(*) from lineitem")
        s.execute("set profiling = 0")
        return [p[0] for p in s.query("show profiles")]

    assert both(run) == [3, 4, 5]


def test_show_profile_names_host_frames():
    def run(pkg):
        s = _q6_session(pkg)
        s.execute("set profiling = 1")
        s.execute("set tidb_profiler_sample_hz = 997")
        s.execute("create table h (a int primary key, b int)")
        s.execute("insert into h values " + ",".join(
            f"({i},{i % 97})" for i in range(4000)))
        s.query("select b, count(*) from h group by b order by b")
        s.execute("set profiling = 0")
        rows = s.query("show profile")
        assert rows
        frames = " ".join(r[0] for r in rows)
        if "no samples" not in frames:
            assert "(" in frames and ".py:" in frames
            assert all(r[2] >= 0 for r in rows)
        qid = s.query("show profiles")[-1][0]
        assert s.query(f"show profile for query {qid}") is not None
        with pytest.raises(Exception, match="no profile") as exc:
            s.query("show profile for query 9999")
        return qid, type(exc.value).__name__, str(exc.value)

    both(run)


def test_information_schema_profiling_rows():
    def run(pkg):
        s = _q6_session(pkg)
        s.execute("set profiling = 1")
        s.execute("set tidb_profiler_sample_hz = 400")
        s.query(Q6)
        s.execute("set profiling = 0")
        rows = s.query("select query_id, seq, state, duration, samples "
                       "from information_schema.profiling")
        for qid, seq, state, duration, samples in rows:
            assert qid == 1 and seq >= 1 and samples >= 0
            assert isinstance(state, str) and state
        return [c for c in s.execute(
            "select * from information_schema.profiling").column_names]

    both(run)


def test_profile_tree_rows_aggregation():
    def run(pkg):
        p = pkg["obs"].Profile({("a (x.py:1)", "b (x.py:2)"): 3,
                                ("a (x.py:1)", "c (x.py:3)"): 1},
                               hz=100.0, duration_s=0.04)
        return p.tree_rows(), p.hot_frames(), p.total_samples, p.to_dict()

    rows, hot, total, _ = both(run)
    assert rows[0][0] == "a (x.py:1)" and rows[0][2] == 4
    assert rows[1][0] == "  b (x.py:2)" and rows[1][2] == 3
    assert hot[0] == ("b (x.py:2)", 3) and total == 4


def test_profile_process_samples_every_thread():
    def run(pkg):
        p = pkg["obs"].profile_process(seconds=0.05, hz=200.0)
        return p.hz, _profiler_threads()

    assert both(run) == (200.0, [])


# ==================== the wait ledger (tests/test_trace.py) ==========

def test_wait_ledger_exclusive_accounting_within_wall():
    def run(pkg):
        o = pkg["obs"]
        led = o.WaitLedger()
        prev = o.active_wait_ledger()
        o.install_wait_ledger(led)
        try:
            t0 = time.perf_counter()
            with o.wait("prewrite"):
                time.sleep(0.02)
                # a fallback frame inside an open frame is a no-op
                with o.wait("rpc_net", fallback=True):
                    time.sleep(0.005)
                time.sleep(0.01)
            o.note_wait("backoff.txnLock", 0.01)
            wall = time.perf_counter() - t0
        finally:
            o.install_wait_ledger(prev)
        assert led.totals["prewrite"] >= 0.03
        assert abs(led.totals["backoff.txnLock"] - 0.01) < 1e-9
        assert sum(led.totals.values()) <= wall * 1.05 + 0.01
        return sorted(led.totals), dict(led.counts)

    names, counts = both(run)
    assert "rpc_net" not in names and counts["prewrite"] == 1


def test_wait_ledger_nested_frames_are_exclusive():
    def run(pkg):
        o = pkg["obs"]
        led = o.WaitLedger()
        prev = o.active_wait_ledger()
        o.install_wait_ledger(led)
        try:
            t0 = time.perf_counter()
            with o.wait("commit_primary"):
                time.sleep(0.01)
                with o.wait("fsync_wait"):
                    time.sleep(0.02)
                time.sleep(0.005)
            wall = time.perf_counter() - t0
        finally:
            o.install_wait_ledger(prev)
        assert led.totals["fsync_wait"] >= 0.02
        assert led.totals["commit_primary"] >= 0.015
        # exclusive: the child's time is not in the parent's share
        assert led.totals["commit_primary"] + led.totals["fsync_wait"] \
            <= wall + 1e-6
        return sorted(led.totals)

    assert both(run) == ["commit_primary", "fsync_wait"]


def test_wait_profile_statement_surfaces():
    def run(pkg):
        o = pkg["obs"]
        s = _q6_session(pkg)
        st = s.storage
        st.obs.waitprofile.configure(enabled=True)
        s.execute("set tidb_slow_log_threshold = 0")
        s.execute("create table w (a int primary key, b int)")
        s.execute("insert into w values (1, 10), (2, 20)")
        waits = dict(s.last_waits)
        assert waits.get("prewrite", 0.0) > 0.0 and "tso_wait" in waits
        ent = next(e for e in st.obs.slow_queries()
                   if "insert into w" in e["sql"])
        assert ent["waits"].get("prewrite", 0) > 0
        assert sum(ent["waits"].values()) <= \
            ent["duration_ms"] * 1.05 + 1.0
        rs = s.execute("show slow queries")
        row = next(r for r in rs.rows if "insert into w" in r[3])
        assert "prewrite:" in row[-1]
        rows = s.query("select state, wait_ms, wait_frac "
                       "from information_schema.tidb_wait_profile")
        assert all(0.0 <= r[2] <= 1.0 for r in rows)
        sq = s.query("select wait_profile from information_schema."
                     "slow_query where query like '%insert into w%'")
        assert any("prewrite:" in (r[0] or "") for r in sq)
        rs2 = s.execute("explain analyze select * from w")
        led = o.WaitLedger()
        led.totals.update({"prewrite": 0.002, "tso_wait": 0.0005})
        prev = o.active_wait_ledger()
        o.install_wait_ledger(led)
        try:
            cell = s._wait_profile_cell()
        finally:
            o.install_wait_ledger(prev)
        s.execute("set tidb_slow_log_threshold = 100000")
        return (sorted(waits), rs.column_names[-1],
                sorted({r[0] for r in rows}), rs2.column_names[-1],
                [r[-1] for r in rs2.rows], cell)

    waits, slow_col, states, ea_col, cells, cell = both(run)
    assert slow_col == "Wait_profile" and ea_col == "wait_profile"
    assert "prewrite" in states and all(c == "" for c in cells)
    assert cell == "prewrite:2ms tso_wait:0.5ms"


def test_wait_profile_disabled_is_zero_cost(monkeypatch):
    def run(pkg):
        o = pkg["obs"]
        s = pkg["Session"](pkg["Storage"]())
        assert not s.storage.obs.waitprofile.enabled

        def _poison(self, *a, **kw):
            raise AssertionError("wait-profile machinery ran while off")

        before = o.WAIT_SECONDS_TOTAL.get(state="prewrite")
        monkeypatch.setattr(o.WaitLedger, "__init__", _poison)
        monkeypatch.setattr(o.WaitProfile, "record", _poison)
        s.execute("create table z (a int primary key)")
        s.execute("insert into z values (1)")
        monkeypatch.undo()
        # the histogram tier stays on: only the ledger is gated
        return s.last_waits, \
            o.WAIT_SECONDS_TOTAL.get(state="prewrite") > before

    assert both(run) == ({}, True)


def test_backoffer_sleep_reports_typed_wait():
    def run(pkg):
        o, bo_mod = pkg["obs"], pkg["backoff"]
        led = o.WaitLedger()
        prev = o.active_wait_ledger()
        o.install_wait_ledger(led)
        before = o.BACKOFF_EVENTS.get(kind="txnLock")
        try:
            bo = bo_mod.Backoffer(budget_ms=200)
            bo.sleep(bo_mod.BO_TXN_LOCK)
            bo.sleep(bo_mod.BO_REGION_MISS, wait_state="lease_wait")
        finally:
            o.install_wait_ledger(prev)
        assert all(v > 0 for v in led.totals.values())
        return o.BACKOFF_EVENTS.get(kind="txnLock") - before, \
            sorted(led.totals)

    assert both(run) == (1, ["backoff.txnLock", "lease_wait"])
