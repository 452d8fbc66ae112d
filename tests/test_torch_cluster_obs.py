"""The cluster diagnostics plane on the port, held to the reference's.

Twins of every case of tests/test_cluster_obs.py: a leader and a socket
follower (no shared disk) answer `information_schema.cluster_*` with rows
from both servers, a TRACE across the wire stitches the peer's spans, and
a dead or slow peer degrades to an error row and a warning. Each scenario
runs over each package (the port's sessions on `device="cpu"`) with the
same statements; instance addresses differ between the two runs, so they
are compared as the role they stand for ("leader", "follower"), and the
outcomes compared are member counts, roles, error-row shapes, warning
counts, digest texts, metric names and device/host labels, span names
and nesting. Each scenario also keeps the reference test's own
assertions and time bounds, on both packages.

Every fixture closes the follower before the leader, and an autouse
fixture fails a test that leaves a live `titpu-*` thread behind — the
port must add no cause to the reference's unsteady
`test_shutdown_leaves_no_diag_threads`.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from mysql_client import MiniClient  # noqa: E402

import tidb_tpu.obs as ref_obs  # noqa: E402
import tidb_tpu.rpc.client as ref_client  # noqa: E402
import tidb_tpu.server.server as ref_server  # noqa: E402
import tidb_tpu.util.failpoint as ref_fp  # noqa: E402
import tidb_tpu_torch.obs as port_obs  # noqa: E402
import tidb_tpu_torch.rpc.client as port_client  # noqa: E402
import tidb_tpu_torch.server.server as port_server  # noqa: E402
import tidb_tpu_torch.util.failpoint as port_fp  # noqa: E402
from tidb_tpu.session import Session as RefSession  # noqa: E402
from tidb_tpu.store.storage import Storage as RefStorage  # noqa: E402
from tidb_tpu_torch.session import Session as PortSession  # noqa: E402
from tidb_tpu_torch.store.storage import Storage as PortStorage  # noqa: E402

REF = {"name": "ref", "Storage": RefStorage, "Session": RefSession,
       "client": ref_client, "fp": ref_fp, "obs": ref_obs,
       "Server": ref_server.Server, "kw": {}}
PORT = {"name": "port", "Storage": PortStorage,
        "Session": lambda st: PortSession(st, device="cpu"),
        "client": port_client, "fp": port_fp, "obs": port_obs,
        "Server": port_server.Server, "kw": {"device": "cpu"}}

BUDGET_MS = 3000


def _opts(P):
    return P["client"].RpcOptions(
        connect_timeout_ms=1000, request_timeout_ms=4000,
        backoff_budget_ms=BUDGET_MS, lock_budget_ms=8000, lease_ms=2000)


def both(fn, tmp_path):
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
    deadline = time.monotonic() + 15.0
    while _titpu_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
    left = _titpu_threads() - before
    assert not left, sorted(t.name for t in left)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    ref_fp.disable_all()
    port_fp.disable_all()


@contextmanager
def cluster(P, d):
    leader = P["Storage"](str(d / "leader"), shared=True,
                          rpc_listen="127.0.0.1:0", rpc_options=_opts(P))
    try:
        follower = P["Storage"](
            str(d / "follower"),
            remote=f"127.0.0.1:{leader.rpc_server.port}",
            rpc_options=_opts(P))
        try:
            yield leader, follower
        finally:
            follower.close()
    finally:
        leader.close()


def _roles(leader, follower):
    return {leader.diag_address: "leader", follower.diag_address: "follower"}


def _close_server(srv) -> None:
    """Close a server and join its accept thread (the reference's close
    leaves it blocked in accept(), so its listener is shut down first)."""
    if isinstance(srv, ref_server.Server) and srv._listener is not None:
        try:
            srv._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        srv._accept_thread.join(timeout=5.0)
    srv.close()
    srv._accept_thread.join(timeout=5.0)


# ==================== cluster_* memtables ====================

def test_cluster_info_rows_from_both_servers(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            role = _roles(leader, follower)
            out = []
            for s in (P["Session"](leader), P["Session"](follower)):
                rows = s.execute(
                    "select instance, type, server_id, uptime_s, error "
                    "from information_schema.cluster_info").rows
                assert {r[1] for r in rows} == {"leader", "follower"}
                assert {r[0] for r in rows} == set(role)
                for r in rows:
                    assert r[4] is None
                    assert r[3] >= 0
                out.append(sorted((role[r[0]], r[1], r[2], r[4])
                                  for r in rows))
            return out

    both(run, tmp_path)


def test_cluster_statements_and_slow_query_fan_out(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            role = _roles(leader, follower)
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table t (id bigint primary key, v bigint)")
            sl.execute("insert into t values (1, 10)")
            sl.execute("set tidb_slow_log_threshold = 0")
            sf.execute("set tidb_slow_log_threshold = 0")
            sl.execute("select v from t where id = 1")
            sf.execute("select sum(v) from t")
            sl.execute("set tidb_slow_log_threshold = 100000")
            sf.execute("set tidb_slow_log_threshold = 100000")
            rows = sl.execute(
                "select instance, digest_text from "
                "information_schema.cluster_statements_summary").rows
            by_inst: dict = {}
            for inst, text in rows:
                by_inst.setdefault(role[inst], []).append(text)
            assert any("select v from t" in t for t in by_inst["leader"])
            assert any("select sum ( v ) from t" in t
                       for t in by_inst["follower"])
            slow = sf.execute(
                "select instance, query, error from "
                "information_schema.cluster_slow_query").rows
            insts = {role[r[0]] for r in slow if r[2] is None}
            assert insts == {"leader", "follower"}
            return [{k: sorted(v) for k, v in by_inst.items()},
                    sorted((role[r[0]], r[1]) for r in slow)]

    both(run, tmp_path)


def test_cluster_processlist_shows_both_servers_connections(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            role = _roles(leader, follower)
            srv_l = P["Server"](leader, host="127.0.0.1", port=0, **P["kw"])
            srv_f = P["Server"](follower, host="127.0.0.1", port=0,
                                **P["kw"])
            srv_l.start()
            srv_f.start()
            cl = cf = None
            try:
                cl = MiniClient("127.0.0.1", srv_l.port)
                cf = MiniClient("127.0.0.1", srv_f.port)
                cl.query("select 1")
                cf.query("select 1")
                rows = P["Session"](leader).execute(
                    "select instance, id, user, command, error "
                    "from information_schema.cluster_processlist").rows
                good = [r for r in rows if r[4] is None]
                assert {r[0] for r in good} == set(role)
                assert all(r[1] is not None for r in good)
                return sorted((role[r[0]], r[1] >> 24, r[2], r[3])
                              for r in good)
            finally:
                for c in (cl, cf):
                    if c is not None:
                        c.close()
                _close_server(srv_f)
                _close_server(srv_l)

    both(run, tmp_path)


def test_cluster_load_reports_device_telemetry(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            role = _roles(leader, follower)
            sl = P["Session"](leader)
            sl.execute("create table t (id bigint primary key, v bigint)")
            sl.execute("insert into t values (1, 1), (2, 2)")
            sl.execute("select sum(v) from t")
            rows = sl.execute(
                "select instance, device_type, name, value from "
                "information_schema.cluster_load").rows
            names = {r[2] for r in rows}
            for want in ("tidb_device_transfer_bytes",
                         "tidb_device_buffer_bytes",
                         "tidb_jit_cache_entries", "tidb_process_rss_bytes"):
                assert want in names, want
            rss = [r for r in rows if r[2] == "tidb_process_rss_bytes"]
            assert {r[0] for r in rss} == set(role)
            assert all(r[3] > 0 for r in rss)
            assert all(r[1] == "host" for r in rss)
            dev = [r for r in rows if r[2] == "tidb_device_transfer_bytes"]
            assert all(r[1] == "device" for r in dev)
            # the device/host label of every family both packages have
            return {(r[2].split("{")[0], r[1]) for r in rows}

    got = {}
    for P in (REF, PORT):
        got[P["name"]] = run(P, tmp_path / P["name"])
    common = {n for n, _ in got["port"]} & {n for n, _ in got["ref"]}
    assert {x for x in got["port"] if x[0] in common} == \
        {x for x in got["ref"] if x[0] in common}


# ==================== cross-server trace stitching ====================

def test_cross_server_trace_contains_stitched_remote_spans(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl = P["Session"](leader)
            rows = sl.execute("trace select instance from "
                              "information_schema.cluster_info").rows
            ops = [(r[0].strip(), r[0], r[1], r[2]) for r in rows
                   if r[1] is not None]
            rpc_rows = [r for r in ops if r[0].startswith("rpc.diag_info")]
            remote_rows = [r for r in ops
                           if r[0].startswith("remote.diag_info")]
            assert rpc_rows, [r[0] for r in ops]
            assert remote_rows, "no remote span subtree was stitched"
            root_end = rows[0][1] + rows[0][2]
            rpc, remote = rpc_rows[0], remote_rows[0]
            assert remote[2] >= rpc[2] - 0.001
            assert remote[2] + remote[3] <= rpc[2] + rpc[3] + 1.0
            assert rpc[2] + rpc[3] <= root_end + 1.0
            depth_rpc = len(rpc[1]) - len(rpc[0])
            depth_remote = len(remote[1]) - len(remote[0])
            assert depth_rpc < depth_remote
            return [len(rpc_rows), len(remote_rows),
                    depth_remote - depth_rpc]

    both(run, tmp_path)


def test_follower_trace_shows_rpc_spans_for_coordination(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table t (id bigint primary key, v bigint)")
            sl.execute("insert into t values (1, 10)")
            rows = sf.execute("trace select v from t").rows
            ops = [r[0].strip() for r in rows if r[1] is not None]
            assert any(o.startswith("rpc.") for o in ops), ops
            return sorted({o.split(" ")[0] for o in ops
                           if o.startswith("rpc.")})

    both(run, tmp_path)


# ==================== degradation: dead / slow peers ====================

def test_peer_down_failpoint_degrades_to_error_row(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            role = _roles(leader, follower)
            sl = P["Session"](leader)
            with P["fp"].failpoint("diag/peer-down", True):
                t0 = time.monotonic()
                rows = sl.execute(
                    "select instance, type, error "
                    "from information_schema.cluster_info").rows
                assert time.monotonic() - t0 < BUDGET_MS / 1000.0 + 2.0
                warnings = sl.execute("show warnings").rows
            assert P["fp"].hits("diag/peer-down") >= 1
            good = [r for r in rows if r[2] is None]
            bad = [r for r in rows if r[2] is not None]
            assert [r[0] for r in good] == [leader.diag_address]
            assert [r[0] for r in bad] == [follower.diag_address]
            assert "diag/peer-down" in bad[0][2]
            assert len(warnings) == 1 and warnings[0][0] == "Warning"
            assert follower.diag_address in warnings[0][2]
            out = [[(role[r[0]], r[1], r[2] is None) for r in rows],
                   bad[0][2].replace(follower.diag_address, "F"),
                   [(w[0], w[1]) for w in warnings]]
            out.append(sl.execute("select @@warning_count").rows)
            sl.execute("select * from information_schema.engines")
            out.append(sl.execute("show warnings").rows)
            out.append(sl.execute("select @@warning_count").rows)
            return out

    got = both(run, tmp_path)
    assert got[3:] == [[(1,)], [], [(0,)]]


def test_slow_peer_failpoint_still_answers(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            role = _roles(leader, follower)
            sl = P["Session"](leader)
            with P["fp"].failpoint("diag/slow-peer", 0.05):
                rows = sl.execute(
                    "select instance, error "
                    "from information_schema.cluster_info").rows
            assert P["fp"].hits("diag/slow-peer") >= 1
            return sorted((role[r[0]], r[1]) for r in rows)

    assert both(run, tmp_path) == [("follower", None), ("leader", None)]


def test_killed_peer_degrades_within_budget(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl = P["Session"](leader)
            fol_addr = follower.diag_address
            out = [sl.execute("select count(*) from "
                              "information_schema.cluster_info").rows]
            follower.diag_listener.close()
            follower._rpc_client.close()
            t0 = time.monotonic()
            rows = sl.execute(
                "select instance, error "
                "from information_schema.cluster_info").rows
            assert time.monotonic() - t0 < BUDGET_MS / 1000.0 + 5.0
            bad = [r for r in rows if r[1] is not None]
            assert [r[0] for r in bad] == [fol_addr]
            good = [r for r in rows if r[1] is None]
            assert [r[0] for r in good] == [leader.diag_address]
            out.append([len(good), len(bad)])
            return out

    assert both(run, tmp_path) == [[(2,)], [1, 1]]


def test_cleanly_closed_peer_leaves_membership(tmp_path):
    def run(P, d):
        leader = P["Storage"](str(d / "leader"), shared=True,
                              rpc_listen="127.0.0.1:0",
                              rpc_options=_opts(P))
        try:
            follower = P["Storage"](
                str(d / "follower"),
                remote=f"127.0.0.1:{leader.rpc_server.port}",
                rpc_options=_opts(P))
            sl = P["Session"](leader)
            out = [sl.execute("select count(*) from "
                              "information_schema.cluster_info").rows]
            follower.close()
            t0 = time.monotonic()
            rows = sl.execute(
                "select instance, error "
                "from information_schema.cluster_info").rows
            assert time.monotonic() - t0 < 2.0
            assert rows == [(leader.diag_address, None)]
            out.append(len(rows))
            out.append(sl.execute("show warnings").rows)
            return out
        finally:
            leader.close()

    assert both(run, tmp_path) == [[(2,)], 1, []]


def test_leader_down_surfaces_error_row_on_follower(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            leader_addr = leader.diag_address
            sf = P["Session"](follower)
            out = [len(sf.execute("select instance from "
                                  "information_schema.cluster_info").rows)]
            leader.rpc_server.close()
            t0 = time.monotonic()
            rows = sf.execute(
                "select instance, type, error "
                "from information_schema.cluster_info").rows
            assert time.monotonic() - t0 < 4 * BUDGET_MS / 1000.0 + 5.0
            bad = {r[0]: r for r in rows if r[2] is not None}
            assert leader_addr in bad
            good = [r for r in rows if r[2] is None]
            assert [r[0] for r in good] == [follower.diag_address]
            warns = sf.execute("show warnings").rows
            assert warns
            out += [len(good), len(bad), len(warns)]
            leader.rpc_server = None  # closed above
            return out

    assert both(run, tmp_path) == [2, 1, 1, 1]


# ==================== membership on /status ====================

def test_transport_health_and_status_carry_members(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            h = leader.transport_health()
            assert h["mode"] == "socket-leader"
            roles = {m["role"]: m for m in h["members"]}
            assert roles["leader"]["addr"] == leader.diag_address
            assert roles["follower"]["addr"] == follower.diag_address
            assert roles["follower"]["hb_age_s"] < 3 * 2.0
            assert roles["follower"]["id"] == follower.coord.node_id
            hf = follower.transport_health()
            assert hf["diag_address"] == follower.diag_address
            assert {m["role"] for m in hf["members"]} == \
                {"leader", "follower"}
            srv = P["Server"](follower, host="127.0.0.1", port=0,
                              status_port=0, status_host="127.0.0.1",
                              **P["kw"])
            srv.start()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.status_port}/status",
                        timeout=10) as resp:
                    status = json.load(resp)
                members = status["transport"]["members"]
                assert {m["role"] for m in members} == \
                    {"leader", "follower"}
            finally:
                _close_server(srv)
            return [sorted(h), sorted(roles["follower"]), sorted(hf),
                    sorted(m["role"] for m in members)]

    both(run, tmp_path)


# ==================== metrics history / metrics_summary ====================

def test_metrics_summary_and_history_route(tmp_path):
    def run(P, d):
        storage = P["Storage"]()
        srv = P["Server"](storage, host="127.0.0.1", port=0,
                          status_port=0, **P["kw"])
        srv.start()
        try:
            s = P["Session"](storage)
            s.execute("create table m (a bigint primary key, v bigint)")
            s.execute("insert into m values (1, 1), (2, 2)")
            s.execute("select sum(v) from m")
            rows = s.execute(
                "select metric_name, samples, min_value, avg_value, "
                "max_value, last_value from "
                "information_schema.metrics_summary").rows
            names = {r[0] for r in rows}
            assert "tidb_process_rss_bytes" in names
            assert any(n.startswith("tidb_queries_total") for n in names)
            for name, samples, mn, avg, mx, last in rows:
                assert samples >= 1
                assert mn <= avg <= mx
            base = f"http://127.0.0.1:{srv.status_port}"
            hist = json.loads(urllib.request.urlopen(
                base + "/debug/metrics/history", timeout=10).read())
            assert hist["interval_s"] > 0
            assert hist["samples"], "history ring is empty"
            assert "tidb_process_rss_bytes" in hist["samples"][-1]["values"]
            text = urllib.request.urlopen(
                base + "/metrics", timeout=10).read().decode()
            assert "# TYPE tidb_process_rss_bytes gauge" in text
            assert "# TYPE tidb_device_buffer_bytes gauge" in text
            return sorted(hist)
        finally:
            _close_server(srv)
            storage.close()

    both(run, tmp_path)


def test_metrics_summary_read_does_not_mutate_ring(tmp_path):
    def run(P, d):
        storage = P["Storage"]()
        try:
            s = P["Session"](storage)
            assert storage.metrics_history.snapshot() == []
            s.execute("select * from information_schema.metrics_summary")
            s.execute("select * from information_schema.metrics_summary")
            return storage.metrics_history.snapshot()
        finally:
            storage.close()

    assert both(run, tmp_path) == []


def test_history_ring_is_bounded(tmp_path):
    def run(P, d):
        o = P["obs"]
        h = o.MetricsHistory([o.PROCESS_METRICS], interval_s=3600, cap=3)
        for _ in range(7):
            h.sample_now()
        out = [len(h.snapshot())]
        h.configure(cap=2)
        out.append(len(h.snapshot()))
        assert all(st["samples"] <= 2 for st in h.summary().values())
        return out

    assert both(run, tmp_path) == [3, 2]


# ==================== lifecycle: no leaked threads ====================

def test_shutdown_leaves_no_diag_threads(tmp_path):
    """The port's leader and follower join every thread they started
    (the reference test's check, on the threads each package's stores
    started here)."""
    def run(P, d):
        before = _titpu_threads()
        leader = P["Storage"](str(d / "leader"), shared=True,
                              rpc_listen="127.0.0.1:0",
                              rpc_options=_opts(P))
        follower = P["Storage"](
            str(d / "follower"),
            remote=f"127.0.0.1:{leader.rpc_server.port}",
            rpc_options=_opts(P))
        s = P["Session"](leader)
        n = len(s.execute("select instance from "
                          "information_schema.cluster_info").rows)
        names = sorted({t.name for t in _titpu_threads() - before})
        assert "titpu-diag-accept" in names
        follower.close()
        leader.close()
        deadline = time.monotonic() + 15.0
        while _titpu_threads() - before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _titpu_threads() - before == set()
        return n

    assert both(run, tmp_path) == 2
    # the port joins them in close() itself: nothing is left to wait on
    before = _titpu_threads()
    d = tmp_path / "port2"
    leader = PortStorage(str(d / "leader"), shared=True,
                         rpc_listen="127.0.0.1:0", rpc_options=_opts(PORT))
    follower = PortStorage(str(d / "follower"),
                           remote=f"127.0.0.1:{leader.rpc_server.port}",
                           rpc_options=_opts(PORT))
    follower.close()
    leader.close()
    assert _titpu_threads() - before == set()
