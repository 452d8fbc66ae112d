"""The config-knob and status-route cases of the observability planes'
tests, held to the reference.

The cases of tests/test_topsql.py, test_history.py, test_inspection.py,
test_overload.py, test_trace.py and test_observability.py that waited on
the server process: each runs once over each package (its `Config`, its
`Storage`, its `Server` with a status port; the port's sessions on
`device="cpu"`) and the two outcomes must be equal. The config sections
mirror their runtime owners (`HistoryConfig` and `WorkloadHistory`,
`DiagnosticsConfig` and `DiagnosticsState` but the thresholds of rules
over unported planes); the [history] and [diagnostics] seeds apply and
keep the edge memory; `/debug/history`'s payload, `/debug/inspection`
and the /status inspection section (cached, reset by a reseed), Top
SQL's /status view, `/debug/topsql` and `/debug/events`, the admission
and governor sections, the TRACE ring over `/debug/trace/<conn>` and
`/debug/profile`; the slow-log file sink rotating at log.file.max-size.
Every server is closed and its store's sampler joined. Tolerance: none.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import urllib.error
import urllib.request

import pytest

from test_torch_server import _close
from tidb_tpu import config as RC
from tidb_tpu import obs_history as ref_history
from tidb_tpu import obs_inspect as ref_inspect
from tidb_tpu.server import Server as RefServer
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch import config as PC
from tidb_tpu_torch import obs_history, obs_inspect
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

PORT = {"config": PC, "history": obs_history, "inspect": obs_inspect,
        "Storage": Storage, "Server": Server,
        "Session": lambda st: Session(st, device="cpu"),
        "server_kw": {"device": "cpu"}, "logger": "tidb_tpu_torch"}
REF = {"config": RC, "history": ref_history, "inspect": ref_inspect,
       "Storage": RefStorage, "Server": RefServer, "Session": RefSession,
       "server_kw": {}, "logger": "tidb_tpu"}
W = obs_history.WorkloadHistory.DEFAULT_WINDOW_S


def both(fn):
    """fn(package) for the port and the reference; equal outcomes."""
    got, want = fn(PORT), fn(REF)
    assert got == want
    return got


def _served(P, fn):
    """fn(server, session, base url) over a fresh server of package P
    with a status port; the server closed and its sampler stopped."""
    st = P["Storage"]()
    srv = P["Server"](st, host="127.0.0.1", port=0, status_port=0,
                      **P["server_kw"])
    srv.start()
    try:
        return fn(srv, P["Session"](st),
                  f"http://127.0.0.1:{srv.status_port}")
    finally:
        _close(srv)


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


# ==================== tests/test_history.py ====================

def test_history_state_mirrors_config_section():
    h = obs_history.WorkloadHistory()
    for f in dataclasses.fields(PC.HistoryConfig):
        assert getattr(h, f.name) == f.default, f.name


def test_history_knobs_parse_seed_and_reload():
    def run(P):
        C = P["config"]
        cfg = C.Config()
        cfg.apply({"history": {"enabled": True, "window-seconds": 5,
                               "history-cap": 7, "regression-ratio": 2.5}})
        cfg.validate()
        st = P["Storage"]()
        cfg.seed_history(st)
        try:
            h = st.history
            got = (h.enabled, h.window_seconds, h.history_cap,
                   h.regression_ratio)
        finally:
            st.close()
        bad = C.Config()
        bad.history.regression_ratio = 0.5
        with pytest.raises(C.ConfigError, match="regression-ratio"):
            bad.validate()
        return got, sorted(k for k in C.Config.RELOADABLE
                           if k.startswith("history."))
    assert both(run)[0] == (True, 5, 7, 2.5)


def test_history_debug_payload_shape():
    def run(P):
        st = P["Storage"]()
        try:
            off = st.history.debug_payload()
            st.history.configure(enabled=True)
            for win in (0, 1):
                st.history.observe("dp", "select ?", "test", 0.01,
                                   engines=["device"],
                                   now=1_000_000 + win * W)
            p = st.history.debug_payload()
            json.dumps(p)  # the /debug/history route serves exactly this
            return (off, sorted(p), p["enabled"], len(p["records"]),
                    len(p["live"]), p["regressions"])
        finally:
            st.close()
    got = both(run)
    assert got[2:] == (True, 1, 1, [])


@pytest.mark.parametrize("max_size,files", [(1, 3), (0, 1)])
def test_slow_log_file_rotation(tmp_path, max_size, files):
    """log.file.max-size rotates the slow-log sink keeping max-backups
    files; max-size 0 never rotates; a second apply does not stack a
    second sink."""
    def run(P):
        d = tmp_path / P["logger"]
        d.mkdir()
        cfg = P["config"].Config()
        cfg.log.slow_query_file = str(d / "slow.log")
        cfg.log.file.max_size = max_size
        cfg.log.file.max_backups = 2
        cfg.apply_log_level()
        cfg.apply_log_level()
        slow = logging.getLogger(P["logger"] + ".slowlog")
        sinks = [h for h in slow.handlers
                 if getattr(h, "_titpu_slow_sink", False)]
        try:
            for i in range(2000):
                slow.warning("slow query #%d %s", i, "x" * 2048)
            return len(sinks), sorted(os.listdir(d))
        finally:
            for h in sinks:
                slow.removeHandler(h)
                h.close()
    n, names = both(run)
    assert n == 1 and len(names) == files


# ==================== tests/test_inspection.py ====================

def test_inspection_state_mirrors_config_section():
    """Every [diagnostics] knob exists on the port's DiagnosticsState
    with the config's default (the mesh-shard-skew rule's threshold
    too, since the mesh plane was ported)."""
    state = {f.name: f for f in
             dataclasses.fields(obs_inspect.DiagnosticsState)}
    unported = set()
    for f in dataclasses.fields(PC.DiagnosticsConfig):
        if f.name in state:
            assert f.default == state[f.name].default, f.name
        else:
            unported.add(f.name)
    assert unported == set()


def test_seed_diagnostics_applies_and_keeps_edge_memory():
    def run(P):
        st = P["Storage"]()
        st.diagnostics.seen_critical = {("a", "b")}
        st.diagnostics._status_cache = (0.0, {})
        cfg = P["config"].Config()
        cfg.diagnostics.enabled = False
        cfg.diagnostics.fsync_stall_threshold = 9
        cfg.diagnostics.dominant_wait_threshold = 0.75
        cfg.seed_diagnostics(st)
        d = st.diagnostics
        return (d.enabled, d.fsync_stall_threshold,
                d.dominant_wait_threshold, d.seen_critical,
                d._status_cache)
    assert both(run) == (False, 9, 0.75, {("a", "b")}, None)


def test_debug_inspection_route_and_status_section(monkeypatch):
    # the cache's 5 s TTL lengthened, so a slow host cannot expire it
    # between two scrapes
    for mod in (obs_inspect, ref_inspect):
        monkeypatch.setattr(mod, "STATUS_CACHE_TTL_S", 3600.0)

    def run(P):
        def probe(srv, s, base):
            st = srv.storage
            for i in range(st.diagnostics.fsync_stall_threshold):
                st.obs.events.record("fsync_stall", severity="warn",
                                     detail=f"stall {i}")
            insp = _get_json(base + "/debug/inspection")
            sec = _get_json(base + "/status")["inspection"]
            # cached within the TTL: one more stall does not move them
            st.obs.events.record("fsync_stall", severity="warn",
                                 detail="late")
            cached = _get_json(base + "/status")["inspection"]
            # a reseed (SIGHUP) clears the cache
            P["config"].Config().seed_diagnostics(st)
            fresh = _get_json(base + "/status")["inspection"]
            return (insp["enabled"], insp["rules"],
                    sorted({f["rule"] for f in insp["findings"]}),
                    sorted(r["rule"] for r in insp["summary"]),
                    sec, cached == sec, fresh)
        return _served(P, probe)
    got = both(run)
    assert got[0] is True and "wal-fsync-stall" in got[2]
    assert got[4]["rules"] == len(obs_inspect.RULES)
    assert got[4]["findings"]["warning"] >= 1 and got[5] is True


def test_inspection_disabled_does_no_rule_work():
    def run(P):
        st = P["Storage"]()
        st.diagnostics.enabled = False
        try:
            return (P["inspect"].status_section(st),
                    P["inspect"].debug_payload(st))
        finally:
            st.close()
    sec, payload = both(run)
    assert sec["enabled"] is False and "findings" not in sec
    assert set(payload) == {"enabled", "rules"}


# ==================== tests/test_topsql.py ====================

def _top_statements(s) -> None:
    s.execute("create table m (a int primary key, b int)")
    s.execute("insert into m values (1,10),(2,20),(3,30)")
    for _ in range(3):
        s.execute("select sum(b) from m where a >= 1")


def test_tidb_top_sql_status_view():
    def run(P):
        st = P["Storage"]()
        st.obs.topsql.configure(enabled=True, window_s=3600)
        _top_statements(P["Session"](st))
        top = st.obs.topsql.top_by_device(3)
        st.close()
        return [(t["digest"], t["exec_count"], sorted(t)) for t in top]
    top = both(run)
    assert len(top) == 3 and {t[1] for t in top} == {1, 3}


def test_events_memtable_and_debug_routes():
    def run(P):
        def probe(srv, s, base):
            srv.storage.obs.topsql.configure(enabled=True)
            _top_statements(s)
            srv.storage.obs.events.record("checkpoint_stall", detail="t",
                                          conn_id=3)
            top = _get_json(base + "/debug/topsql")
            evs = _get_json(base + "/debug/events")
            status = _get_json(base + "/status")
            return (top["enabled"], sorted(d for w in top["windows"]
                                           for d in w["digests"]),
                    [e["kind"] for e in evs],
                    sorted(e for e in evs[-1] if e not in ("ts", "seq")),
                    status["top_sql"]["enabled"],
                    len(status["top_sql"]["by_device_time"]))
        return _served(P, probe)
    got = both(run)
    assert got[0] is True and "checkpoint_stall" in got[2]


# ==================== tests/test_overload.py ====================

def test_status_exposes_admission_and_governor():
    def run(P):
        def probe(srv, s, base):
            srv.storage.admission.configure(tokens=7, timeout_ms=1234)
            srv.storage.governor.configure(limit_bytes=1 << 30)
            status = _get_json(base + "/status")
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=10) as r:
                text = r.read().decode()
            return (status["admission"]["token_limit"],
                    status["admission"]["timeout_ms"],
                    status["governor"]["limit_bytes"],
                    sorted(status["admission"]),
                    sorted(status["governor"]),
                    "tidb_admission_queue_depth" in text,
                    "tidb_governor_memory_usage_bytes" in text)
        return _served(P, probe)
    assert both(run)[:3] == (7, 1234, 1 << 30)


# ==================== tests/test_trace.py ====================

def test_debug_routes_trace_and_profile():
    def run(P):
        def probe(srv, s, base):
            s.conn_id = 5
            s.execute("create table d (a int primary key)")
            s.execute("insert into d values (1),(2)")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + "/debug/trace/5", timeout=10)
            missing = e.value.code
            s.execute("trace select count(*) from d")
            tr = _get_json(base + "/debug/trace/5")
            prof = _get_json(base + "/debug/profile?seconds=0.1&hz=200")
            return (missing, tr["spans"][0][0], sorted(tr),
                    prof["hz"], sorted(prof))
        return _served(P, probe)
    got = both(run)
    assert got[:2] == (404, "session.run") and got[3] == 200


def test_mesh_route_is_not_in_slice():
    """/debug/mesh is served on both packages since the mesh plane was
    ported: the same top-level keys, and a payload that never builds a
    mesh."""
    got = _served(PORT, lambda srv, s, base: _get_json(base + "/debug/mesh"))
    ref = _served(REF, lambda srv, s, base: _get_json(base + "/debug/mesh"))
    assert set(got) == set(ref) == {"status", "dispatches", "compiles",
                                    "storage"}
    assert set(got["status"]) <= set(ref["status"])
