"""The workload history plane of the port (`obs_history.py`), held to the
reference's.

Twins of the cases of tests/test_history.py that need no RPC plane and
no `config.py`: each scenario runs once over each package's own
`WorkloadHistory` or `Storage` (the port's sessions on `device="cpu"`),
and the two outcomes are compared: durable records and live windows
(exact: the scenarios feed fixed timestamps), statements_summary_history
and tidb_plan_history rows, event kinds, severities, digests and
details, inspection rows, metric families. Real statements (a small
table, and TPC-H Q1, Q3 and Q18 at SF0.003) compare digests, plan
digests and exec counts, with times excluded. A child of each package
with the history plane on is killed with SIGKILL after two rotations,
and the reopened stores must read back the same records.

Left out, with the planes they wait for: the config-section mirror, the
[history] knob parsing and hot reload, `max-backups` validation and the
slow-log file rotation (`config.py`), the /debug/history payload (the
status port), and the cluster_ fan-out cases (the diagnostics RPC
plane).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import unittest.mock as mock

import pytest

import tidb_tpu.obs as ref_obs
import tidb_tpu.obs_history as ref_history
import tidb_tpu.obs_inspect as ref_inspect
from tidb_tpu.copr.client import CopClient as RefCopClient
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch import obs, obs_history, obs_inspect
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

W = obs_history.WorkloadHistory.DEFAULT_WINDOW_S
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = {"history": obs_history, "obs": obs, "inspect": obs_inspect,
        "Storage": Storage, "cop": CopClient,
        "Session": lambda st: Session(st, device="cpu")}
REF = {"history": ref_history, "obs": ref_obs, "inspect": ref_inspect,
       "Storage": RefStorage, "cop": RefCopClient, "Session": RefSession}


def both(fn):
    """fn(package) for the port and the reference; equal outcomes."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _feed(h, digest, wall_s, engines, win, n=1, text="select ?"):
    """n observations inside window index `win` (windows are W apart,
    anchored far from now so the clock never rotates them)."""
    for i in range(n):
        h.observe(digest, text, "test", wall_s, engines=engines,
                  now=1_000_000 + win * W + i % max(int(W - 1), 1))


def _digest_of(storage, sql: str) -> tuple[str, str]:
    norm = storage.obs.statements.normalize(sql)
    return hashlib.sha256(norm.encode()).hexdigest()[:32], norm


def _events(st, kind=None) -> list:
    return [(e["kind"], e["severity"], e["digest"], e["detail"])
            for e in st.obs.events.snapshot()
            if kind is None or e["kind"] == kind]


# ==================== zero work while disabled ====================

def test_disabled_does_zero_history_work(monkeypatch):
    def run(pkg):
        st = pkg["Storage"]()
        try:
            assert st.history.enabled is False

            def boom(*a, **k):
                raise AssertionError("history touched while disabled")

            monkeypatch.setattr(st.history, "observe", boom)
            monkeypatch.setattr(st.history, "_ensure_loaded", boom)
            s = pkg["Session"](st)
            s.execute("create table z (a int primary key)")
            s.execute("insert into z values (1)")
            s.execute("select a from z")
            rows = [s.execute(
                f"select * from information_schema.{t}").rows
                for t in ("statements_summary_history",
                          "tidb_plan_history")]
            return rows, st.history.enabled, \
                st.history.regression_findings()
        finally:
            st.close()

    assert both(run) == ([[], []], False, [])


# ==================== rotation + caps ====================

def test_rotation_caps_and_gauge():
    def run(pkg):
        st = pkg["Storage"]()
        h = st.history
        h.configure(enabled=True, history_cap=5)
        for win in range(9):
            _feed(h, f"d{win:02d}", 0.01, ["device"], win)
        snap = h.snapshot()
        gauge = st.obs.metrics.gauge("tidb_history_records").get()
        st.close()
        return snap, gauge

    snap, gauge = both(run)
    assert [r["digest"] for r in snap["records"]] == \
        [f"d{w:02d}" for w in range(3, 8)]
    assert len(snap["live"]) == 1 and snap["live"][0]["digest"] == "d08"
    assert gauge == 5


def test_window_aggregation_and_surfaces():
    def run(pkg):
        h = pkg["history"].WorkloadHistory()
        h.configure(enabled=True)
        _feed(h, "dd", 0.010, ["device[group]@mesh8"], 0, n=3)
        _feed(h, "dd", 0.020, ["device[group]@mesh8"], 1)
        return h.snapshot(), h.table_rows(), h.plan_rows()

    snap, rows, plans = both(run)
    rec = snap["records"][0]
    assert rec["exec_count"] == 3 and rec["modes"] == ["group"]
    assert abs(rec["sum_wall_ms"] - 30.0) < 1e-6
    assert len(rows) == 2 and rows[0][7] == "group"
    assert len(plans) == 1 and plans[0][13] == 1


# ==================== restart persistence ====================

def test_records_survive_restart_verbatim(tmp_path):
    def run(pkg):
        path = str(tmp_path / pkg["history"].__name__ / "db")
        st = pkg["Storage"](path)
        st.history.configure(enabled=True)
        _feed(st.history, "aa", 0.005, ["device[group]"], 0, n=2)
        _feed(st.history, "bb", 0.008, ["point"], 1)
        _feed(st.history, "bb", 0.009, ["point"], 2)
        want = st.history.snapshot()["records"]
        # no clean flush: the reopened store reads what the rotations'
        # atomic writes left
        st.history.flush = lambda *a, **k: None
        st.close()
        st2 = pkg["Storage"](path)
        try:
            st2.history.configure(enabled=True)
            got = st2.history.snapshot()["records"]
            assert got == want
            rows = pkg["Session"](st2).execute(
                "select digest, plan_digest, exec_count from "
                "information_schema.statements_summary_history").rows
        finally:
            st2.close()
        return got, sorted(rows)

    got, rows = both(run)
    assert len(got) == 2
    assert ("aa", obs_history.plan_digest_of(["device[group]"]), 2) in rows


_CHILD = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {root!r})
    pkg = sys.argv[1]
    mod = __import__(pkg + ".store.storage", fromlist=["Storage"])
    st = mod.Storage(sys.argv[2], sync_log="commit")
    h = st.history
    h.configure(enabled=True)
    W = h.DEFAULT_WINDOW_S
    for win, (dg, eng, n) in enumerate([("k1", ["device[agg]"], 3),
                                        ("k2", ["host(x)"], 1),
                                        ("k1", ["device[agg]"], 2)]):
        for i in range(n):
            h.observe(dg, "select ?", "test", 0.001 * (win + 1),
                      engines=eng, now=1_000_000 + win * W + i)
    # two windows rotated and persisted; the third is live: die now
    sys.stdout.write("ready\\n")
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)
""")


def test_kill9_child_reads_back_the_same_records(tmp_path):
    def run(pkg):
        name = "tidb_tpu_torch" if pkg is PORT else "tidb_tpu"
        path = str(tmp_path / name)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD.format(root=ROOT), name, path],
            capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == -signal.SIGKILL, proc.stderr
        assert proc.stdout.strip() == "ready"
        st = pkg["Storage"](path, sync_log="commit")
        try:
            st.history.configure(enabled=True)
            recs = st.history.snapshot()["records"]
            rows = sorted(pkg["Session"](st).execute(
                "select digest, plan_digest, exec_count from "
                "information_schema.tidb_plan_history").rows)
        finally:
            st.close()
        return recs, rows

    recs, rows = both(run)
    assert [(r["digest"], r["exec_count"]) for r in recs] == \
        [("k1", 3), ("k2", 1)]
    assert len(rows) == 2


def test_corrupt_history_file_degrades_to_empty(tmp_path):
    def run(pkg):
        path = tmp_path / pkg["history"].__name__ / "db"
        st = pkg["Storage"](str(path))
        st.history.configure(enabled=True)
        _feed(st.history, "aa", 0.005, ["device"], 0)
        _feed(st.history, "aa", 0.005, ["device"], 1)
        st.history.flush = lambda *a, **k: None
        st.close()
        (path / "history" / pkg["history"].RECORDS_FILE).write_text(
            "{torn", encoding="utf-8")
        st2 = pkg["Storage"](str(path))
        try:
            st2.history.configure(enabled=True)
            empty = st2.history.snapshot()["records"]
            _feed(st2.history, "cc", 0.001, ["device"], 5)
            _feed(st2.history, "cc", 0.001, ["device"], 6)
            return empty, st2.history.snapshot()["records"]
        finally:
            st2.close()

    empty, recs = both(run)
    assert empty == [] and len(recs) == 1


# ==================== plan-change detection ====================

def test_plan_change_event_fires_and_throttles():
    def run(pkg):
        st = pkg["Storage"]()
        try:
            h = st.history
            h.configure(enabled=True)
            _feed(h, "dg", 0.01, ["device[group]"], 0, n=2)
            _feed(h, "dg", 0.01, ["device[group]"], 1)
            quiet = _events(st, "plan_change")
            _feed(h, "dg", 0.10, ["host(fragment:group-space)"], 1, n=3)
            degraded = _events(st, "plan_change")
            _feed(h, "dg", 0.01, ["device[group]@mesh8"], 2)
            return (quiet, degraded, _events(st, "plan_change"),
                    st.obs.metrics.counter(
                        "tidb_history_plan_changes_total").samples())
        finally:
            st.close()

    quiet, degraded, events, counts = both(run)
    assert quiet == [] and len(degraded) == 1
    assert degraded[0][1] == "warn" and degraded[0][2] == "dg"
    assert "host(fragment:group-space)" in degraded[0][3]
    assert len(events) == 2 and events[-1][1] == "info"
    assert dict(counts)[(("kind", "degraded"),)] == 1


def test_intra_window_plan_flap_keeps_last_plan_current():
    def run(pkg):
        h = pkg["history"].WorkloadHistory()
        h.configure(enabled=True)
        for t, eng in ((0, ["device"]), (10, ["device[group]"]),
                       (20, ["device"])):
            h.observe("fl", "q", "test", 0.01, engines=eng,
                      now=1_000_000 + t)
        return {r[0]: r[1] for r in h.plan_rows() if r[13] == 1}

    assert both(run) == {"fl": obs_history.plan_digest_of(["device"])}


def test_failed_statements_do_not_pollute_plan_history():
    def run(pkg):
        st = pkg["Storage"]()
        try:
            h = st.history
            h.configure(enabled=True)
            _feed(h, "fx", 0.01, ["device[group]"], 0, n=2)
            h.observe("fx", "q", "test", 5.0, engines=[], failed=True,
                      now=1_000_002)
            first = h.snapshot()
            h.observe("new", "q", "test", 5.0, engines=[], failed=True,
                      now=1_000_003)
            return first, h.snapshot(), _events(st, "plan_change")
        finally:
            st.close()

    first, after, events = both(run)
    ent = first["live"][0]
    assert ent["errors"] == 1 and ent["exec_count"] == 2
    assert abs(ent["sum_wall_ms"] - 20.0) < 1e-6
    assert events == [] and len(after["live"]) == 1


@pytest.mark.parametrize("tags", [
    ["host(x)", "device"], ["ranged"], ["device[agg]@mesh8"],
    ["replica@h:1"], ["point"], [], ["point", "device"],
    ["device[group]", "device[rows+semi]"]])
def test_engine_class_and_digest_of_tags(tags):
    assert obs_history.engine_class(tags) == ref_history.engine_class(tags)
    assert obs_history.plan_digest_of(tags) == \
        ref_history.plan_digest_of(tags)
    assert obs_history.fragment_modes(tags) == \
        ref_history.fragment_modes(tags)


def test_engine_class_ordering():
    assert obs_history.engine_class(["host(x)", "device"]) == 0
    assert obs_history.engine_class(["ranged"]) == 1
    assert obs_history.engine_class(["device[agg]@mesh8"]) == 2
    assert obs_history.engine_class(["point"]) == 3
    assert obs_history.engine_class([]) == 2


# ==================== regression rules ====================

RESULT_SQL = ("select rule, item, severity, value, details "
              "from information_schema.inspection_result")


def test_regression_rules_fire_on_synthetic_telemetry():
    def run(pkg):
        st = pkg["Storage"]()
        try:
            h = st.history
            h.configure(enabled=True, regression_ratio=1.5)
            for win in range(3):
                _feed(h, "pr", 0.010, ["device[group]"], win, n=2)
                _feed(h, "sp", 0.010, ["device"], win, n=2)
                _feed(h, "ok", 0.010, ["device"], win, n=2)
            _feed(h, "pr", 0.100, ["host(fragment:x)"], 3, n=2)
            _feed(h, "sp", 0.100, ["device"], 3, n=2)
            _feed(h, "ok", 0.010, ["device"], 3, n=2)
            return pkg["Session"](st).execute(RESULT_SQL).rows
        finally:
            st.close()

    rows = both(run)
    pr = [r for r in rows if r[0] == "plan-regression"]
    sp = [r for r in rows if r[0] == "stmt-perf-regression"]
    assert pr and pr[0][1] == "pr" and pr[0][2] == "critical"
    assert "historical p50" in pr[0][4]
    assert sp and sp[0][1] == "sp"
    assert not any(r[1] == "ok" for r in rows)


def test_regression_rules_silent_on_healthy_history():
    def run(pkg):
        st = pkg["Storage"]()
        try:
            st.history.configure(enabled=True)
            for win in range(4):
                _feed(st.history, "hh", 0.01, ["device"], win, n=2)
            return pkg["Session"](st).execute(RESULT_SQL).rows
        finally:
            st.close()

    assert both(run) == []


def test_forced_plan_degradation_fires_plan_change_and_regression():
    """A known digest's device plan degrading to the host path, through
    the real statement path, fires plan_change and a plan-regression
    finding in both packages."""
    def run(pkg):
        st = pkg["Storage"]()
        try:
            s = pkg["Session"](st)
            s.execute("create table f (a int primary key, b int)")
            s.execute("insert into f values (1, 10), (2, 20), (3, 30)")
            sql = "select sum(b) from f where a > 0"
            digest, norm = _digest_of(st, sql)
            st.history.configure(enabled=True, regression_ratio=1.5)
            _feed(st.history, digest, 0.0001, ["device"], 0, n=4,
                  text=norm)
            st.history.flush()

            def degrade(self, dag, snap, sparse_gate=True):
                return None, "forced-degradation"

            with mock.patch.object(pkg["cop"], "_prepare", degrade):
                rows = s.execute(sql).rows
            engines = list(s.last_engines)
            events = [e[:3] for e in _events(st, "plan_change")]
            found = [r[:3] for r in s.execute(RESULT_SQL).rows
                     if r[0] == "plan-regression" and r[1] == digest]
            ev_rows = s.execute(
                "select kind, digest from information_schema.tidb_events "
                "where kind = 'plan_change'").rows
            return rows, engines, events, found, ev_rows, digest
        finally:
            st.close()

    rows, engines, events, found, ev_rows, digest = both(run)
    assert rows and any(e.startswith("host(") for e in engines)
    assert events and events[-1] == ("plan_change", "warn", digest)
    assert found and ("plan_change", digest) in ev_rows


# ==================== the statement path ====================

def test_statement_path_history_digests_match():
    """Real statements with the plane on: the same digests, plan digests,
    engines and exec counts in both packages' tidb_plan_history and
    statements_summary_history."""
    def run(pkg):
        st = pkg["Storage"]()
        try:
            st.history.configure(enabled=True)
            s = pkg["Session"](st)
            s.execute("create table hp (a int primary key, b int, c int)")
            s.execute("insert into hp values " + ",".join(
                f"({i},{i % 7},{i % 3})" for i in range(300)))
            for _ in range(2):
                s.query("select c, sum(b) from hp group by c")
                s.query("select * from hp where a = 5")
                s.query("select b from hp where c = 1 order by b "
                        "limit 3")
            plans = s.execute(
                "select digest, plan_digest, engines, plan_strategy, "
                "exec_count, sum_errors, current_plan from "
                "information_schema.tidb_plan_history").rows
            hist = s.execute(
                "select digest, plan_digest, exec_count from "
                "information_schema.statements_summary_history").rows
            return sorted(plans), sorted(hist)
        finally:
            st.close()

    plans, hist = both(run)
    assert len(plans) >= 4 and hist


def test_tpch_plan_history_over_q1_q3_q18():
    """TPC-H Q1, Q3 and Q18 at SF0.003: equal digests and plan digests."""
    from test_torch_sql_tpch import load_both
    from tidb_tpu.bench.tpch_queries import TPCH_QUERIES

    _, ref, port = load_both(0.003, 7)
    out = []
    try:
        for s in (port, ref):
            s.storage.history.configure(enabled=True)
            for q in ("q1", "q3", "q18"):
                s.query(TPCH_QUERIES[q])
            out.append(sorted(s.query(
                "select digest, plan_digest, engines, exec_count from "
                "information_schema.tidb_plan_history "
                "where digest_text not like '%information_schema%'")))
    finally:
        port.storage.close()
        ref.storage.close()
    assert out[0] == out[1] and len(out[0]) == 3


# ==================== lints, debug payload ====================

def test_history_rules_and_metrics_pass_registry_lints():
    assert "plan-regression" in obs_inspect.RULES
    assert "stmt-perf-regression" in obs_inspect.RULES
    assert obs_inspect.lint_rules() == []
    for rule in ("plan-regression", "stmt-perf-regression"):
        assert obs_inspect.RULES[rule].reference == \
            ref_inspect.RULES[rule].reference

    def run(pkg):
        st = pkg["Storage"]()
        try:
            fams = [f for f in st.obs.metrics.families()
                    if f.startswith("tidb_history_")]
            return fams, pkg["obs"].lint_metrics([st.obs.metrics])
        finally:
            st.close()

    fams, findings = both(run)
    assert len(fams) == 4 and findings == []


def test_snapshot_shape():
    def run(pkg):
        st = pkg["Storage"]()
        try:
            st.history.configure(enabled=True)
            _feed(st.history, "dp", 0.01, ["device"], 0)
            _feed(st.history, "dp", 0.01, ["device"], 1)
            snap = st.history.snapshot()
            json.dumps(snap)
            return snap, st.history.regression_findings()
        finally:
            st.close()

    snap, regressions = both(run)
    assert regressions == []
    assert len(snap["records"]) == 1 and len(snap["live"]) == 1
