"""The inspection engine, metrics_schema and the metrics history of the
port, held to the reference's.

Twins of the cases of tests/test_inspection.py that need no RPC plane,
no `config.py` and no mesh client: each scenario runs once over each
package's `Storage` (the port's sessions on `device="cpu"`), and the
rule names, items, severities, values, reference texts and details of
inspection_result, the rows of inspection_summary, the inspection_finding
events and the metrics_schema table set (the reference's less
`metrics_schema.UNPORTED_FAMILIES`) are compared. Counter values that
other tests in the process move are compared as deltas.

Every rule is registered in both packages under the same name, severity
and reference; the rules over planes the port does not have (mesh, RPC
breaker, members, replicas, ranges, heat, the lock checker) stay silent
in both on an embedded store, which is what the reference returns with
those planes off.

Left out: the config-section mirror and seed_diagnostics (`config.py`),
the breaker and heartbeat rules over a live transport and the two
cluster_inspection_result cases (the RPC plane), the three mesh-rule
cases (the mesh plane) and the status-port routes (`status_section`,
`debug_payload`).

Teardown: a port server started over a store runs that store's
metrics-history sampler (`titpu-metrics-history`); closing the server and
the store leaves no such thread.
"""

from __future__ import annotations

import threading
import time

import pytest

import tidb_tpu.obs as ref_obs
import tidb_tpu.obs_inspect as ref_inspect
from tidb_tpu.catalog import metrics_schema as RefMS
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch import obs, obs_inspect
from tidb_tpu_torch.catalog import metrics_schema as MS
from tidb_tpu_torch.server.server import Server
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

PORT = {"obs": obs, "inspect": obs_inspect, "ms": MS, "Storage": Storage,
        "Session": lambda st: Session(st, device="cpu")}
REF = {"obs": ref_obs, "inspect": ref_inspect, "ms": RefMS,
       "Storage": RefStorage, "Session": RefSession}

RESULT_SQL = ("select rule, item, severity, value, reference, details "
              "from information_schema.inspection_result")

# the rules whose planes the port does not have
PLANELESS = ("mesh-shard-skew", "mesh-recompile-storm",
             "mesh-hbm-watermark", "rpc-breaker-open",
             "follower-heartbeat-stale", "follower-apply-lag",
             "range-leader-flap", "range-split-flap",
             "range-closed-ts-stall", "lock-order-inversion",
             "config-sync-log", "hot-range", "range-split-advisory")


def both(fn):
    """fn(package) for the port and the reference; equal outcomes."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _rows_for_rule(session, rule: str):
    return [r for r in session.execute(RESULT_SQL).rows if r[0] == rule]


# ==================== the registry ====================

def test_rule_registry_is_the_reference_registry():
    assert sorted(obs_inspect.RULES) == sorted(ref_inspect.RULES)
    for name, r in ref_inspect.RULES.items():
        mine = obs_inspect.RULES[name]
        assert (mine.severity, mine.reference) == (r.severity, r.reference)
    assert obs_inspect.lint_rules() == []


@pytest.mark.parametrize("rule", PLANELESS)
def test_planeless_rule_silent_as_reference_with_plane_off(rule):
    def run(pkg):
        st = pkg["Storage"]()
        try:
            return [f for f in pkg["inspect"].inspect(st) if f.rule == rule]
        finally:
            st.close()

    assert both(run) == []


# ==================== healthy server: silence ====================

def test_healthy_server_has_no_findings():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("create table h (a int primary key)")
        s.execute("insert into h values (1),(2)")
        s.execute("select count(*) from h")
        res = s.execute(RESULT_SQL).rows
        summary = s.execute(
            "select rule, severity, findings, items, reference from "
            "information_schema.inspection_summary").rows
        st.close()
        return res, summary

    res, summary = both(run)
    assert res == [] and {r[0] for r in summary} == set(obs_inspect.RULES)
    assert all(r[2] == 0 for r in summary)


# ==================== per-rule firing (synthetic telemetry) =========

def test_fsync_stall_rule_fires_with_reference():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        for i in range(st.diagnostics.fsync_stall_threshold):
            st.obs.events.record("fsync_stall", severity="warn",
                                 detail=f"wal fsync took 150.0ms #{i}")
        rows = _rows_for_rule(s, "wal-fsync-stall")
        st2 = pkg["Storage"]()
        st2.obs.events.record("fsync_stall", severity="warn", detail="x")
        quiet = _rows_for_rule(pkg["Session"](st2), "wal-fsync-stall")
        return rows, quiet

    rows, quiet = both(run)
    rule, item, sev, value, ref, details = rows[0]
    assert item == "wal" and sev == "warning" and int(value) >= 3
    assert "sync-log" in ref and "150.0ms" in details
    assert quiet == []


def test_governor_kill_and_admission_shed_rules():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        st.obs.events.record("governor_kill", severity="warn", conn_id=7,
                             detail="usage 100 > server-memory-limit 50")
        st.obs.events.record("admission_shed", severity="warn", conn_id=8,
                             detail="queue wait exceeded")
        kills = _rows_for_rule(s, "governor-kill")
        sheds = _rows_for_rule(s, "admission-shed")
        for _ in range(3):
            st.obs.events.record("governor_kill", severity="warn",
                                 detail="more")
        crit = _rows_for_rule(s, "governor-kill")
        warnings = list(s.warnings)
        # the critical finding is edge-triggered into the event ring once
        _rows_for_rule(s, "governor-kill")
        events = [(e["kind"], e["severity"])
                  for e in st.obs.events.snapshot()
                  if e["kind"] == "inspection_finding"]
        return kills, sheds, crit, warnings, events

    kills, sheds, crit, warnings, events = both(run)
    assert kills[0][2] == "warning" and sheds[0][2] == "warning"
    assert crit[0][2] == "critical"
    assert any("governor-kill critical" in w[2] for w in warnings)
    assert events == [("inspection_finding", "critical")]


def test_host_fallback_rule_reads_topsql():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        st.obs.topsql.configure(enabled=True, window_s=3600)
        st.obs.topsql.record(
            "cafe" * 8, "select slow ( ? )", "test", 1.0,
            stages={"host_fallback": 0.9, "plan_build": 0.1}, rows=10)
        st.obs.topsql.record(
            "beef" * 8, "select fast ( ? )", "test", 1.0,
            stages={"kernel": 0.9, "plan_build": 0.1}, rows=10)
        rows = _rows_for_rule(s, "top-sql-host-fallback")
        st.obs.topsql.configure(enabled=False)
        return rows, _rows_for_rule(s, "top-sql-host-fallback")

    rows, off = both(run)
    assert len(rows) == 1 and rows[0][1] == "cafe" * 8
    assert "host_fallback" in rows[0][5] and off == []


def test_registry_row_eval_rule_fires_after_fallback():
    """The rule reads the port's `tidb_registry_row_eval_total`: a
    row-wise builtin (INSERT) counts, the dictionary path
    (SUBSTRING_INDEX, REGEXP_LIKE over a string column) does not."""
    def run(pkg):
        o = pkg["obs"]
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("create table rr (a int primary key, b varchar(16))")
        s.execute("insert into rr values (1,'a.b.c'),(2,'d.e.f')")
        st.metrics_history.sample_now()  # window baseline
        before = {f: o.REGISTRY_ROW_EVALS.get(func=f)
                  for f in ("SUBSTRING_INDEX", "REGEXP_LIKE", "INSERT")}
        s.execute("select substring_index(b, '.', 1) from rr")
        s.execute("select a from rr where regexp_like(b, '^a')")
        s.execute("select insert(b, 1, 1, 'Z') from rr")
        deltas = {f: o.REGISTRY_ROW_EVALS.get(func=f) - v
                  for f, v in before.items()}
        rows = [r for r in _rows_for_rule(s, "registry-row-eval")
                if r[1] == 'func="INSERT"']
        return deltas, [(r[0], r[1], r[2], r[3]) for r in rows]

    deltas, rows = both(run)
    assert deltas == {"SUBSTRING_INDEX": 0, "REGEXP_LIKE": 0, "INSERT": 2}
    assert rows and int(rows[0][3]) >= 2


def test_metric_cardinality_rule_promotes_lint():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        g = st.obs.metrics.gauge("tidb_test_wide_bytes", "per-device")
        for i in range(64):
            g.set(1.0, device=f"dev{i}")
        return [r for r in _rows_for_rule(s, "metric-cardinality")
                if "tidb_test_wide_bytes" in r[1]]

    assert both(run)


def test_dominant_wait_inspection_rule():
    def run(pkg):
        st = pkg["Storage"]()
        wp = st.obs.waitprofile
        wp.configure(enabled=True)
        insp = pkg["inspect"]

        def dom():
            return [(f.item, f.severity, f.value, f.details)
                    for f in insp.inspect(st) if f.rule == "dominant-wait"]

        wp.record("d" * 32, "update hot set v = v + 1 where k = 9",
                  "test", 1.0, {"backoff.txnLock": 0.8, "prewrite": 0.1})
        first = dom()
        wp.clear()
        wp.record("e" * 32, "select 1", "test", 1.0,
                  {"backoff.txnLock": 0.2})
        below = dom()
        wp.record("f" * 32, "select 2", "test", 1.0,
                  {"backoff.txnLock": 0.99})
        wp.configure(enabled=False)
        return first, below, dom()

    first, below, off = both(run)
    assert len(first) == 1 and "backoff.txnLock" in first[0][3]
    assert below == [] and off == []


# ==================== the zero-work contract, hygiene ================

def test_disabled_does_zero_inspection_work(monkeypatch):
    def run(pkg):
        insp = pkg["inspect"]
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        st.obs.events.record("fsync_stall", severity="warn", detail="x")
        st.diagnostics.enabled = False

        def _boom(*a, **k):
            raise AssertionError("inspection built a context while off")

        monkeypatch.setattr(insp.InspectionContext, "__init__", _boom)
        out = (s.execute(RESULT_SQL).rows,
               s.execute("select * from "
                         "information_schema.inspection_summary").rows,
               [e for e in st.obs.events.snapshot()
                if e["kind"] == "inspection_finding"])
        monkeypatch.undo()
        return out

    res, summary, events = both(run)
    assert res == [] and summary == [] and events == []


def test_inspection_runs_no_threads():
    def run(pkg):
        st = pkg["Storage"]()
        before = {t.ident for t in threading.enumerate()}
        for _ in range(3):
            st.obs.events.record("fsync_stall", severity="warn",
                                 detail="x")
        found = sorted(f.rule for f in pkg["inspect"].inspect(st))
        after = {t.ident for t in threading.enumerate()}
        st.close()
        return found, after <= before

    assert both(run) == (["wal-fsync-stall"], True)


def test_broken_rule_degrades_to_info_finding():
    def run(pkg):
        insp = pkg["inspect"]
        st = pkg["Storage"]()

        def _explode(ctx):
            raise RuntimeError("rule bug")

        insp.RULES["test-broken"] = insp.Rule("test-broken", "warning",
                                              "ref", _explode)
        try:
            return [(f.item, f.severity, f.value, f.details)
                    for f in insp.inspect(st) if f.rule == "test-broken"]
        finally:
            del insp.RULES["test-broken"]

    found = both(run)
    assert found and found[0][1] == "info" and "RuntimeError" in found[0][3]


# ==================== metrics_schema and the metrics history ==========

def test_metrics_schema_point_and_time_range_rows():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("create table mt (a int primary key)")
        s.execute("insert into mt values (1)")
        s.execute("select * from mt")
        st.metrics_history.sample_now()
        time.sleep(0.02)
        st.metrics_history.sample_now()
        rows = s.execute(
            "select time, ts, labels, value from "
            "metrics_schema.tidb_queries_total "
            "where labels = 'type=\"Select\"'").rows
        ts = [r[1] for r in rows]
        assert ts == sorted(ts)
        total = s.execute(
            "select max(value) from metrics_schema.tidb_queries_total "
            "where labels = 'type=\"Select\"'").rows[0][0]
        return [(r[2], r[3]) for r in rows], total

    rows, total = both(run)
    assert len(rows) == 3 and all(v >= 1 for _, v in rows)
    assert total >= rows[-1][1]


def test_metrics_schema_show_tables_and_unknown_table():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("use metrics_schema")
        tables = {r[0] for r in s.execute("show tables").rows}
        assert tables == set(pkg["ms"].families(st))
        with pytest.raises(Exception) as exc:
            s.execute("select * from metrics_schema.tidb_no_such_family")
        st.close()
        return tables, type(exc.value).__name__, \
            getattr(exc.value, "errno", None)

    got, want = run(PORT), run(REF)
    assert got[0] == want[0] - MS.UNPORTED_FAMILIES
    assert MS.UNPORTED_FAMILIES <= want[0]
    assert got[1:] == want[1:]
    assert {"tidb_queries_total", "tidb_registry_row_eval_total",
            "tidb_copr_column_cache_total",
            "tidb_device_buffer_bytes"} <= got[0]


def test_metrics_schema_serves_process_and_server_registries():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        for t in ("tidb_commits_total", "tidb_process_rss_bytes"):
            assert s.execute(f"select value from metrics_schema.{t}").rows \
                is not None
        rss = s.execute("select max(value) from "
                        "metrics_schema.tidb_process_rss_bytes").rows[0][0]
        st.close()
        return rss > 0

    assert both(run) is True


def test_metrics_summary_reads_without_sampling():
    def run(pkg):
        st = pkg["Storage"]()
        s = pkg["Session"](st)
        s.execute("create table ms (a int)")
        st.metrics_history.sample_now()
        rows = s.execute(
            "select metric_name, samples, min_value, last_value from "
            "information_schema.metrics_summary "
            "where metric_name = 'tidb_queries_total{type=\"CreateTable\"}'"
        ).rows
        ring = len(st.metrics_history.snapshot())
        st.close()
        return rows, ring

    assert both(run) == (
        [('tidb_queries_total{type="CreateTable"}', 2, 1.0, 1.0)], 1)


def test_server_close_and_store_close_leave_no_sampler_thread():
    """The sampler a port server starts is gone once the server and its
    store are closed: no `titpu-metrics-history` thread outlives them
    (threads other tests of the process left are not this test's)."""
    def sampler_threads() -> set:
        return {t for t in threading.enumerate() if t.is_alive()
                and t.name == "titpu-metrics-history"}

    before = sampler_threads()
    st = Storage()
    srv = Server(st, port=0, device="cpu")
    srv.start()
    try:
        assert st.metrics_history.running
        mine = st.metrics_history._thread
        assert mine in sampler_threads() - before
    finally:
        srv.close(drain_timeout=0.2)
        st.close()
    assert not st.metrics_history.running and not mine.is_alive()
    deadline = time.monotonic() + 10.0
    while sampler_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert sampler_threads() - before == set()
