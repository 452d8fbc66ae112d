"""The memory governor and the admission gate of the port
(`util/governor.py`), held to the reference's.

Twins of the governor, admission and INSERT ... SELECT cases of
tests/test_overload.py: each scenario runs once over each package's
governor, gate or `Storage` (the port's sessions on `device="cpu"`),
with the same `governor/mem-pressure` failpoint values and seeded rows,
and compares the kill order, the gate's stats, the admission order,
errnos and messages, rows and event kinds. Besides: `plan_priority` of
the same statements' plans, and a kill at admission under the failpoint
followed by an exact read, as the smoke script's part m2 does on the
card.

Left out, with the planes they wait for: the connection-gate and wire
cases (1040, the flood and memory-bomb cases, wait_timeout, KILL
privileges) need the server process's config and status surfaces, the
breaker cases need the RPC plane, and the status and cluster_load cases
the status port and the diagnostics RPC plane.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from tidb_tpu.plan.builder import PlanBuilder as RefPlanBuilder
from tidb_tpu.plan.physical import optimize as ref_optimize
from tidb_tpu.session import Session as RefSession
from tidb_tpu.sql.parser import parse_sql as ref_parse_sql
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu.util import failpoint as ref_failpoint
from tidb_tpu.util import governor as ref_governor
from tidb_tpu.util.memory import MemTracker as RefMemTracker
from tidb_tpu_torch.plan.builder import PlanBuilder
from tidb_tpu_torch.plan.physical import optimize
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.sql.parser import parse_sql
from tidb_tpu_torch.store.storage import Storage
from tidb_tpu_torch.util import failpoint, governor
from tidb_tpu_torch.util.memory import MemTracker

PORT = {"gov": governor, "fp": failpoint, "Tracker": MemTracker,
        "Storage": Storage, "Session": lambda st: Session(st, device="cpu"),
        "plan": lambda s, sql: optimize(PlanBuilder(
            s.catalog, s.current_db).build_select(parse_sql(sql)[0]),
            s.storage.stats)}
REF = {"gov": ref_governor, "fp": ref_failpoint, "Tracker": RefMemTracker,
       "Storage": RefStorage, "Session": RefSession,
       "plan": lambda s, sql: ref_optimize(RefPlanBuilder(
           s.catalog, s.current_db).build_select(ref_parse_sql(sql)[0]),
           s.storage.stats)}


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    failpoint.disable_all()
    ref_failpoint.disable_all()


def both(fn):
    """fn(package) for the port and the reference; equal outcomes."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _error(e) -> tuple:
    return (type(e).__name__, getattr(e, "errno", None), str(e))


def _rows(seed: int) -> str:
    rng = np.random.default_rng(seed)
    return ",".join(f"({int(v)},'k{int(v) % 53}')"
                    for v in rng.integers(0, 100, 4000))


# ==================== parse_mem_limit ====================

@pytest.mark.parametrize("spec,total", [
    (0, None), ("0", None), ("", None), (None, None), (1 << 30, None),
    ("1073741824", None), ("50%", 1000), ("0.25", 1000), ("1.5GB", None),
    ("-1", None), ("150%", None), ("abc", None), (True, None),
    ("0.5.1", None)])
def test_parse_mem_limit_forms(spec, total):
    def run(pkg):
        try:
            return pkg["gov"].parse_mem_limit(spec, total=total)
        except ValueError as e:
            return ("ValueError", str(e))

    got = both(run)
    if spec in ("1.5GB", "-1", "150%", "abc", True, "0.5.1"):
        assert got[0] == "ValueError"


# ==================== memory governor (mock trackers) ====================

def _mock_entries(pkg, gov, weights, cancellable=None):
    killed: list[int] = []
    tokens = []
    for i, w in enumerate(weights):
        t = pkg["Tracker"](f"q{i}")
        t.consume(w)
        tokens.append(gov.register(
            t, kill=lambda i=i: killed.append(i), label=f"q{i}",
            cancellable=(cancellable[i] if cancellable else True)))
    return killed, tokens


def test_governor_kills_exactly_the_heaviest():
    def run(pkg):
        gov = pkg["gov"].MemoryGovernor(limit_bytes=1 << 40)
        killed, tokens = _mock_entries(pkg, gov, [100, 900, 500])
        out = [list(killed)]
        gov.configure(limit_bytes=1000, cooldown_ms=100)
        with pkg["fp"].failpoint("governor/mem-pressure", 5000):
            out.append((gov.check(), list(killed)))
            out.append((gov.check(), list(killed)))  # the cooldown holds
            gov._last_kill = -1e18
            out.append((gov.check(), list(killed)))
        for tok in tokens:
            gov.unregister(tok)
        return out, gov.stats()

    out, stats = both(run)
    assert out == [[], (True, [1]), (False, [1]), (True, [1, 2])]
    assert stats["statements"] == 0 and stats["kills"] == 2


def test_governor_respects_cancellable_and_pressure():
    def run(pkg):
        gov = pkg["gov"].MemoryGovernor(limit_bytes=1000, cooldown_ms=0)
        with pkg["fp"].failpoint("governor/mem-pressure", 500):
            killed, tokens = _mock_entries(
                pkg, gov, [900, 100], cancellable=[False, True])
            out = [list(killed)]
        with pkg["fp"].failpoint("governor/mem-pressure", 5000):
            out.append((gov.check(), list(killed)))
            out.append(gov.check())
        for tok in tokens:
            gov.unregister(tok)
        return out

    assert both(run) == [[], (True, [1]), False]


def test_governor_disabled_never_kills():
    def run(pkg):
        gov = pkg["gov"].MemoryGovernor(limit_bytes=0)
        killed, tokens = _mock_entries(pkg, gov, [1 << 30])
        with pkg["fp"].failpoint("governor/mem-pressure", 1 << 50):
            checked = gov.check()
        for tok in tokens:
            gov.unregister(tok)
        return checked, killed

    assert both(run) == (False, [])


def test_governor_consume_poll_triggers_check():
    def run(pkg):
        gov = pkg["gov"].MemoryGovernor(limit_bytes=1000, cooldown_ms=0)
        killed: list[str] = []
        root = pkg["Tracker"]("q")
        with pkg["fp"].failpoint("governor/mem-pressure", 500):
            gov.register(root, kill=lambda: killed.append("q"))
        with pkg["fp"].failpoint("governor/mem-pressure", 5000):
            root.child("sort").consume(8 << 20)
        return killed

    assert both(run) == ["q"]
    assert governor.GOV_POLL_BYTES == ref_governor.GOV_POLL_BYTES


def test_governor_kill_end_to_end_typed_8175():
    """A 3-way join killed at its first tracker poll answers 8175 with
    the server-scoped message; the other session goes on, and the
    victim's working set is in its statement summary."""
    def run(pkg):
        st = pkg["Storage"]()
        heavy_s, light_s = pkg["Session"](st), pkg["Session"](st)
        heavy_s.execute("create table s (a int, b varchar(10))")
        heavy_s.execute(f"insert into s values {_rows(3)}")
        errs: list = []

        def heavy():
            try:
                heavy_s.query("select count(*) from s a "
                              "join s b on a.a = b.a join s c on b.a = c.a")
                errs.append(None)
            except Exception as e:  # the kill's typed error, compared
                errs.append(_error(e))

        st.governor.configure(limit_bytes=1 << 20, cooldown_ms=60_000)
        pkg["fp"].enable("governor/mem-pressure", 2 << 20)
        real_check = st.governor.check
        seen = []

        def gated_check():
            # skip the registration-time check: the kill then fires at
            # the first consume poll, with the weight materialized
            if not seen:
                seen.append(1)
                return False
            return real_check()

        st.governor.check = gated_check
        t = threading.Thread(target=heavy)
        try:
            t.start()
            t.join(timeout=60)
        finally:
            del st.governor.check
            pkg["fp"].disable("governor/mem-pressure")
            st.governor.configure(limit_bytes=0)
        assert not t.is_alive() and heavy_s.last_mem_peak > 0
        mem = light_s.query(
            "select max_mem_bytes from information_schema."
            "statements_summary where query_sample_text like '%join s c%'")
        assert mem and mem[0][0] > 0
        return (errs, st.governor.kills.get(),
                light_s.query("select count(*) from s"),
                [e["kind"] for e in st.obs.events.snapshot()])

    errs, kills, rows, kinds = both(run)
    assert errs[0][1] == 8175 and "[server]" in errs[0][2]
    assert kills == 1.0 and rows == [(4000,)]
    assert kinds == ["governor_kill"]


def test_governor_kill_at_admission_then_exact_read():
    """Under the failpoint a statement is killed at its registration
    (8175, the kill in tidb_events); the next statement is exact."""
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("create table q (a int primary key, b int)")
        s.execute("insert into q values " + ",".join(
            f"({i},{i % 13})" for i in range(500)))
        st.governor.configure(limit_bytes=1 << 20, cooldown_ms=0)
        with pkg["fp"].failpoint("governor/mem-pressure", 2 << 20):
            with pytest.raises(Exception) as exc:
                s.query("select b, sum(a) from q group by b")
        st.governor.configure(limit_bytes=0)
        kinds = s.query("select kind, severity from "
                        "information_schema.tidb_events")
        return (_error(exc.value), kinds,
                s.query("select b, sum(a) from q group by b order by b"))

    err, kinds, rows = both(run)
    assert err[1] == 8175 and ("governor_kill", "warn") in kinds
    assert len(rows) == 13


# ==================== admission gate ====================

def test_admission_gate_unlimited_is_noop():
    def run(pkg):
        g = pkg["gov"]
        gate = g.AdmissionGate()
        held = gate.acquire(g.PRI_SCAN)
        with gate.admit(g.PRI_POINT):
            running = gate.stats()["running"]
        return held, running

    assert both(run) == (False, 0)


def test_admission_timeout_sheds_typed():
    def run(pkg):
        g = pkg["gov"]
        gate = g.AdmissionGate(tokens=1, timeout_ms=50)
        first = gate.acquire(g.PRI_SCAN)
        with pytest.raises(g.AdmissionTimeout) as ei:
            gate.acquire(g.PRI_SCAN)
        stats = gate.stats()
        gate.release()
        again = gate.acquire(g.PRI_SCAN)
        gate.release()
        return first, _error(ei.value), stats, again

    first, err, stats, again = both(run)
    assert first is True and again is True
    assert err[1] == 9003 and "busy" in err[2]
    assert stats["shed"] == 1 and stats["queue_depth"] == 0


def test_admission_priority_order():
    def run(pkg):
        g = pkg["gov"]
        gate = g.AdmissionGate(tokens=1, timeout_ms=10000)
        assert gate.acquire(g.PRI_SCAN) is True
        order: list[str] = []
        started = threading.Barrier(3)

        def waiter(name, pri):
            started.wait()
            if name == "dml":
                time.sleep(0.2)  # arrives LATER than the scan
            gate.acquire(pri)
            order.append(name)
            gate.release()

        ts = [threading.Thread(target=waiter, args=("scan", g.PRI_SCAN)),
              threading.Thread(target=waiter, args=("dml", g.PRI_DML))]
        for t in ts:
            t.start()
        started.wait()
        time.sleep(0.5)
        gate.release()
        for t in ts:
            t.join(timeout=10)
        return order

    assert both(run) == ["dml", "scan"]


def test_admission_end_to_end_shed_errno_9003():
    def run(pkg):
        st = pkg["Storage"]()
        s1, s2 = pkg["Session"](st), pkg["Session"](st)
        s1.execute("create table s (a int, b varchar(10))")
        s1.execute(f"insert into s values {_rows(7)}")
        st.admission.configure(tokens=1, timeout_ms=200)
        done: list = []
        held = threading.Event()
        release = threading.Event()

        def heavy():
            # hold the token for a while: the heavy read runs, then the
            # session keeps its slot until the shed was observed
            with st.admission.admit(0):
                held.set()
                release.wait(30)
            done.append(s1.query(
                "select count(*) from s a join s b on a.a = b.a "
                "join s c on b.a = c.a"))

        t = threading.Thread(target=heavy)
        t.start()
        try:
            assert held.wait(30)
            with pytest.raises(Exception) as ei:
                s2.query("select count(*) from s")
        finally:
            release.set()
            t.join(timeout=120)
            st.admission.configure(tokens=0)
        return (_error(ei.value), done, st.admission.stats()["shed"],
                s2.query("select count(*) from s"),
                [e["kind"] for e in st.obs.events.snapshot()])

    err, done, shed, rows, kinds = both(run)
    assert err[0] == "AdmissionTimeout" and err[1] == 9003
    assert done[0][0][0] >= 4000 and shed >= 1 and rows == [(4000,)]
    assert kinds == ["admission_shed"]


def test_insert_select_does_not_self_deadlock():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("create table a (x bigint)")
        s.execute("insert into a values (1),(2),(3)")
        s.execute("create table b (x bigint)")
        st.admission.configure(tokens=1, timeout_ms=500)
        try:
            n = s.execute("insert into b select x from a").affected
            return n, s.query("select count(*) from b"), \
                st.admission.stats()["shed"]
        finally:
            st.admission.configure(tokens=0)

    assert both(run) == (3, [(3,)], 0)


@pytest.mark.parametrize("sql", [
    "select * from p where a = 3",
    "select b from p where b = 2",
    "select count(*) from p",
    "select count(*) from p x join p y on x.b = y.b"])
def test_plan_priority_of_the_same_plans(sql):
    def run(pkg):
        s = pkg["Session"](pkg["Storage"]())
        s.execute("create table p (a int primary key, b int)")
        s.execute("insert into p values " + ",".join(
            f"({i},{i % 5})" for i in range(200)))
        s.execute("analyze table p")
        return pkg["gov"].plan_priority(pkg["plan"](s, sql))

    assert both(run) in (governor.PRI_POINT, governor.PRI_SMALL,
                         governor.PRI_SCAN)
