"""The socket transport of the multi-process plane on the port, held to
the reference's.

Twins of every case of tests/test_rpc_transport.py: a leader that owns
the durable directory and serves the coordination RPC tier, a follower
that joins it over a socket with a private working dir. Each scenario
runs once over each package (the port's sessions on `device="cpu"`) with
the same statements, and the outcomes are compared: rows, errnos, error
classes, failpoint hits, lease grants, WAL offsets and the /status
transport keys. Each scenario also keeps the reference test's own
assertions and time bounds, on both packages.

Also here: the pin of the reference's behaviour for a bulk-loaded table
(its rows live only in the leader's epoch file, which a follower's
private directory does not have, so the follower reads none of them),
and the port's one difference: an error that is not the RPC plane's
own (a `RuntimeError` standing for a torch or CUDA error) raised in the
follower's apply fold or in a leader's RPC handler is kept and
re-raised by `close()`, not turned into a wire error.

Every fixture closes the follower before the leader, and an autouse
fixture fails a test that leaves a live `titpu-*` thread behind.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import struct
import sys
import threading
import time
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from mysql_client import MiniClient, MySQLError  # noqa: E402

import tidb_tpu.errno as ref_errno  # noqa: E402
import tidb_tpu.kv.backoff as ref_backoff  # noqa: E402
import tidb_tpu.rpc.client as ref_client  # noqa: E402
import tidb_tpu.rpc.errors as ref_errors  # noqa: E402
import tidb_tpu.server.server as ref_server  # noqa: E402
import tidb_tpu.util.failpoint as ref_fp  # noqa: E402
import tidb_tpu_torch.errno as port_errno  # noqa: E402
import tidb_tpu_torch.kv.backoff as port_backoff  # noqa: E402
import tidb_tpu_torch.rpc.client as port_client  # noqa: E402
import tidb_tpu_torch.rpc.errors as port_errors  # noqa: E402
import tidb_tpu_torch.server.server as port_server  # noqa: E402
import tidb_tpu_torch.util.failpoint as port_fp  # noqa: E402
from tidb_tpu.session import Session as RefSession  # noqa: E402
from tidb_tpu.store.storage import Storage as RefStorage  # noqa: E402
from tidb_tpu_torch.session import Session as PortSession  # noqa: E402
from tidb_tpu_torch.store.storage import Storage as PortStorage  # noqa: E402

REF = {"name": "ref", "Storage": RefStorage, "Session": RefSession,
       "client": ref_client, "errors": ref_errors, "fp": ref_fp,
       "Server": ref_server.Server, "CodedError": ref_errno.CodedError,
       "BackoffExhausted": ref_backoff.BackoffExhausted, "kw": {}}
PORT = {"name": "port",
        "Storage": functools.partial(PortStorage, device="cpu"),
        "Session": lambda st: PortSession(st, device="cpu"),
        "client": port_client, "errors": port_errors, "fp": port_fp,
        "Server": port_server.Server, "CodedError": port_errno.CodedError,
        "BackoffExhausted": port_backoff.BackoffExhausted,
        "kw": {"device": "cpu"}}

RPC_FAILPOINTS = ["rpc/conn-drop", "rpc/delay", "rpc/partial-write",
                  "rpc/stale-response"]


def _opts(P, **kw):
    """The reference test's tight budgets (OPTS)."""
    base = dict(connect_timeout_ms=1000, request_timeout_ms=4000,
                backoff_budget_ms=3000, lock_budget_ms=8000, lease_ms=2000)
    base.update(kw)
    return P["client"].RpcOptions(**base)


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
def _clean_failpoints():
    yield
    ref_fp.disable_all()
    port_fp.disable_all()


@contextmanager
def cluster(P, d, opts=None):
    """A leader and a socket follower of one package; the follower
    closes first."""
    opts = opts or _opts(P)
    leader = P["Storage"](str(d / "leader"), shared=True,
                          rpc_listen="127.0.0.1:0", rpc_options=opts)
    try:
        follower = P["Storage"](
            str(d / "follower"),
            remote=f"127.0.0.1:{leader.rpc_server.port}", rpc_options=opts)
        try:
            yield leader, follower
        finally:
            follower.close()
    finally:
        leader.close()


def _close_server(srv) -> None:
    """Close a server and join its accept thread. The reference's close
    leaves that thread blocked in accept() on the closed listener, so
    its listener is shut down first, as the port's close does."""
    if isinstance(srv, ref_server.Server) and srv._listener is not None:
        try:
            srv._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        srv._accept_thread.join(timeout=5.0)
    srv.close()
    srv._accept_thread.join(timeout=5.0)


def _fire_on_test_thread(n, effect):
    """A failpoint value firing `effect` for the first `n` hits on the
    test thread only — background pollers (heartbeat, kill mailbox,
    the apply engine) must not eat the chaos aimed at the statement
    path."""
    state = {"left": n}

    def fire():
        if threading.current_thread() is not threading.main_thread():
            return None
        if state["left"] <= 0:
            return None
        state["left"] -= 1
        return effect()

    return fire


def _raise_reset():
    raise ConnectionResetError("chaos conn-drop")


# ---- the multiproc scenarios, over the socket ------------------------------
def test_ddl_and_data_visible_over_socket(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table t (id bigint primary key, v bigint)")
            sl.execute("insert into t values (1, 10), (2, 20)")
            out = [sf.execute("select id, v from t order by id").rows]
            sf.execute("insert into t values (3, 30)")
            out.append(sl.execute("select sum(v) from t").rows)
            sf.execute("alter table t add column w bigint")
            sl.execute("update t set w = id * 100 where id = 1")
            out.append(sf.execute("select w from t where id = 1").rows)
            return out

    assert both(run, tmp_path) == [[(1, 10), (2, 20)], [(60,)], [(100,)]]


def test_conflicting_writes_over_socket(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table c (id bigint primary key, v bigint)")
            sl.execute("insert into c values (1, 0)")
            for i in range(6):
                (sl if i % 2 == 0 else sf).execute(
                    "update c set v = v + 1 where id = 1")
            return [sl.execute("select v from c").rows,
                    sf.execute("select v from c").rows]

    assert both(run, tmp_path) == [[(6,)], [(6,)]]


def test_stale_schema_commit_aborts_over_socket(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table f (id bigint primary key, v bigint)")
            sl.execute("insert into f values (1, 1)")
            sf.execute("begin")
            sf.execute("update f set v = 2 where id = 1")
            sl.execute("alter table f add column extra bigint")
            with pytest.raises(P["CodedError"]) as exc:
                sf.execute("commit")
            msg = str(exc.value)
            assert "schema" in msg.lower() or "try again" in msg.lower()
            return [exc.value.errno, msg, sl.execute("select v from f").rows]

    assert both(run, tmp_path)[2] == [(1,)]


def test_strict_si_over_socket(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table t (id bigint primary key, v bigint)")
            sl.execute("insert into t values (1, 10)")
            out = [sf.execute("select v from t").rows]
            sf.execute("begin")
            out.append(sf.execute("select v from t").rows)
            sl.execute("update t set v = 99 where id = 1")
            out.append(sf.execute("select v from t").rows)
            sf.execute("commit")
            out.append(sf.execute("select v from t").rows)
            return out

    assert both(run, tmp_path) == [[(10,)], [(10,)], [(10,)], [(99,)]]


def test_cross_server_kill_over_socket(tmp_path):
    """KILL QUERY issued on the leader lands on a follower connection via
    the RPC kill mailbox."""
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            srv_l = P["Server"](leader, host="127.0.0.1", port=0, **P["kw"])
            srv_f = P["Server"](follower, host="127.0.0.1", port=0,
                                **P["kw"])
            srv_l.start()
            srv_f.start()
            cl = cf = None
            try:
                cl = MiniClient("127.0.0.1", srv_l.port)
                cf = MiniClient("127.0.0.1", srv_f.port)
                conn_id = int(cf.query("select connection_id()")[0][0])
                errs: list = []

                def long_query():
                    try:
                        cf.query("select sleep(25)")
                    except MySQLError as e:
                        errs.append(e)

                t = threading.Thread(target=long_query)
                t.start()
                time.sleep(1.0)
                t0 = time.time()
                cl.execute(f"kill query {conn_id}")
                t.join(timeout=20)
                assert not t.is_alive(), "query was not killed"
                assert time.time() - t0 < 15, "cross-server kill too long"
                assert errs and "interrupt" in str(errs[0]).lower()
                return [conn_id >> 24, errs[0].code,
                        cf.query("select 1")]
            finally:
                for c in (cl, cf):
                    if c is not None:
                        c.close()
                _close_server(srv_f)
                _close_server(srv_l)

    assert both(run, tmp_path)[2] == [("1",)]


# ---- the same round-trip with every transport failpoint armed --------------
@pytest.mark.parametrize("fp", RPC_FAILPOINTS)
def test_replication_roundtrip_under_failpoint(tmp_path, fp):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table c (id bigint primary key, v bigint)")
            sl.execute("insert into c values (0, 0)")
            out = [sf.execute("select v from c").rows]
            if fp == "rpc/conn-drop":
                value = _fire_on_test_thread(2, _raise_reset)
            elif fp == "rpc/delay":
                value = _fire_on_test_thread(3, lambda: 0.05)
            else:  # partial-write, stale-response
                value = _fire_on_test_thread(2, lambda: True)
            with P["fp"].failpoint(fp, value):
                sf.execute("insert into c values (1, 11)")
                out.append(sl.execute("select v from c where id = 1").rows)
                sf.execute("update c set v = v + 1 where id = 1")
                out.append(sf.execute("select v from c where id = 1").rows)
            assert P["fp"].hits(fp) > 0, f"{fp} never fired"
            sl.execute("insert into c values (2, 22)")
            out.append(sf.execute("select sum(v) from c").rows)
            out.append(sl.execute("select sum(v) from c").rows)
            return out

    assert both(run, tmp_path) == [[(0,)], [(11,)], [(12,)], [(34,)],
                                   [(34,)]]


def test_ddl_visibility_under_conn_drop(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            value = _fire_on_test_thread(3, _raise_reset)
            with P["fp"].failpoint("rpc/conn-drop", value):
                sf.execute("create table d (id bigint primary key, "
                           "v bigint)")
                sf.execute("insert into d values (1, 1)")
            assert P["fp"].hits("rpc/conn-drop") > 0
            out = [sl.execute("select v from d").rows]
            sl.execute("alter table d add column w bigint")
            out.append(sf.execute("select w from d where id = 1").rows)
            return out

    assert both(run, tmp_path) == [[(1,)], [(None,)]]


# ---- degraded mode / typed failure surface ---------------------------------
def test_leader_down_degrades_to_readonly(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table t (id bigint primary key, v bigint)")
            sl.execute("insert into t values (1, 10)")
            out = [sf.execute("select v from t").rows]
            leader.rpc_server.close()
            t0 = time.time()
            out.append(sf.execute("select v from t").rows)
            assert time.time() - t0 < 20, "degraded read took too long"
            t0 = time.time()
            out.append(sf.execute("select v from t").rows)
            assert time.time() - t0 < 2, "degraded fast-path not engaged"
            t0 = time.time()
            with pytest.raises(P["CodedError"]) as exc:
                sf.execute("insert into t values (2, 2)")
            assert "read" in str(exc.value).lower()
            assert time.time() - t0 < 10
            out.append(exc.value.errno)
            with pytest.raises(P["CodedError"]) as exc2:
                sf.execute("create table nope (id bigint primary key)")
            out.append(exc2.value.errno)
            # the leader store closes with its RPC server already closed
            leader.rpc_server = None
            return out

    assert both(run, tmp_path)[:4] == [[(10,)], [(10,)], [(10,)], 9001]


def test_backoff_exhaustion_surfaces_typed_history(tmp_path):
    def run(P, d):
        client = P["client"].RpcClient(
            "127.0.0.1:1", P["client"].RpcOptions(
                connect_timeout_ms=200, request_timeout_ms=200,
                backoff_budget_ms=400))
        t0 = time.time()
        with pytest.raises((P["errors"].LeaderUnavailable,
                            P["BackoffExhausted"])) as exc:
            client.call("ping")
        assert time.time() - t0 < 10
        assert "tikvRPC" in str(exc.value), "typed history missing"
        client.close()
        return [type(exc.value).__name__, exc.value.errno]

    assert both(run, tmp_path) == ["LeaderUnavailable", 9001]


# ---- protocol-level protections --------------------------------------------
def _record(key: bytes, val: bytes) -> bytes:
    """A well-formed engine WAL record (put into CF 2 = data)."""
    return struct.pack("<BBII", 1, 2, len(key), len(val)) + key + val


def test_wal_append_dedup_and_fencing(tmp_path):
    def run(P, d):
        leader = P["Storage"](str(d / "leader"), shared=True,
                              rpc_listen="127.0.0.1:0",
                              rpc_options=_opts(P))
        E = P["errors"]
        try:
            client = P["client"].RpcClient(
                f"127.0.0.1:{leader.rpc_server.port}", _opts(P))
            client.call("hello")
            grant = client.call("lock_acquire", name="mutation")
            assert grant["granted"]
            token = grant["token"]
            wal = os.path.join(str(d / "leader"), "kv", "wal.log")
            base = os.path.getsize(wal)
            rec = _record(b"zz-chaos-key", b"v1")
            r1 = client.call("wal_append", seq=7, expected=base, data=rec,
                             token=token)
            r2 = client.call("wal_append", seq=7, expected=base, data=rec,
                             token=token)
            assert r1["offset"] == r2["offset"] == base + len(rec)
            assert os.path.getsize(wal) == base + len(rec)
            out = [token, r1["offset"] - base]
            with pytest.raises(E.StaleLeaseError) as e1:
                client.call("wal_append", seq=8, expected=base + len(rec),
                            data=_record(b"zz-chaos-key", b"v2"),
                            token=token + 999)
            with pytest.raises(E.WalOffsetMismatch) as e2:
                client.call("wal_append", seq=9, expected=base,
                            data=_record(b"zz-chaos-key", b"v3"),
                            token=token)
            assert os.path.getsize(wal) == base + len(rec)
            out += [(e1.value.errno, str(e1.value)),
                    (e2.value.errno, str(e2.value).replace(str(base), "B")
                     .replace(str(base + len(rec)), "B+n"))]
            client.call("lock_release", name="mutation", token=token)
            client.close()
            return out
        finally:
            leader.close()

    both(run, tmp_path)


def test_chunked_bootstrap_and_tail(tmp_path):
    big = "x" * 300

    def run(P, d):
        small = _opts(P, tail_chunk=64)
        pre = P["Storage"](str(d / "leader"))
        sp = P["Session"](pre)
        sp.execute("create table big (id bigint primary key, "
                   "s varchar(500))")
        for i in range(8):
            sp.execute(f"insert into big values ({i}, '{big}')")
        pre.close()
        assert os.path.getsize(
            str(d / "leader" / "kv" / "snapshot.kv")) > 10 * 64
        with cluster(P, d, small) as (leader, follower):
            sf, sl = P["Session"](follower), P["Session"](leader)
            out = [sf.execute(
                "select count(*), max(length(s)) from big").rows]
            sl.execute(f"insert into big values (100, '{big}')")
            out.append(sf.execute("select count(*) from big").rows)
            sf.execute(f"insert into big values (101, '{big}')")
            out.append(sl.execute("select count(*) from big").rows)
            return out

    assert both(run, tmp_path) == [[(8, 300)], [(9,)], [(10,)]]


def test_mutation_lease_blocks_second_client(tmp_path):
    def run(P, d):
        leader = P["Storage"](str(d / "leader"), shared=True,
                              rpc_listen="127.0.0.1:0",
                              rpc_options=_opts(P))
        try:
            addr = f"127.0.0.1:{leader.rpc_server.port}"
            a = P["client"].RpcClient(addr, _opts(P))
            b = P["client"].RpcClient(addr, _opts(P))
            ga = a.call("lock_acquire", name="mutation")
            out = [ga["granted"],
                   b.call("lock_acquire", name="mutation")["granted"]]
            a.call("lock_release", name="mutation", token=ga["token"])
            gb = b.call("lock_acquire", name="mutation")
            out += [gb["granted"], gb["token"] != ga["token"]]
            b.call("lock_release", name="mutation", token=gb["token"])
            a.close()
            b.close()
            return out
        finally:
            leader.close()

    assert both(run, tmp_path) == [True, False, True, True]


def test_status_port_reports_transport_health(tmp_path):
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            srv = P["Server"](follower, host="127.0.0.1", port=0,
                              status_port=0, status_host="127.0.0.1",
                              **P["kw"])
            srv.start()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.status_port}/status",
                        timeout=10) as resp:
                    status = json.load(resp)
                t = status["transport"]
                assert t["calls"] > 0
                return [t["mode"], t["degraded"], sorted(t),
                        leader.transport_health()["mode"],
                        sorted(leader.transport_health())]
            finally:
                _close_server(srv)

    assert both(run, tmp_path)[:2] == ["socket-follower", False]


# ---- the reference's behaviour a CPU comparison pins -----------------------
def test_follower_reads_no_rows_of_a_bulk_loaded_table(tmp_path):
    """A bulk load bypasses the KV (`TableStore.bulk_load`): its rows
    live in the leader's columnar epoch (and epoch file) only. A socket
    follower replicates the WAL into a private directory with no epoch
    files, so it sees the table's schema and none of the loaded rows —
    only rows written later through the KV. Both packages answer so."""
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            sl, sf = P["Session"](leader), P["Session"](follower)
            sl.execute("create table bl (id bigint primary key, v bigint)")
            tid = leader.catalog.table("test", "bl").id
            ids = np.arange(100, dtype=np.int64)
            leader.table_store(tid).bulk_load([ids, ids * 3])
            leader.checkpoint()  # the epoch file, as a server's close
            sl.execute("insert into bl values (1000, 7)")
            out = [sl.execute("select count(*), sum(v) from bl").rows,
                   sf.execute("select count(*), sum(v) from bl").rows]
            return out

    assert both(run, tmp_path) == [[(101, 14857)], [(1, 7)]]


# ---- the port's own error policy -------------------------------------------
def test_foreign_error_in_apply_fold_is_reraised_by_close(tmp_path,
                                                          monkeypatch):
    """A RuntimeError in the follower's background fold (where the port
    stages nothing but runs its columnar apply) ends the apply loop and
    is re-raised by `close()`; the reference's loop swallows it."""
    with cluster(PORT, tmp_path / "port") as (leader, follower):
        sl = PORT["Session"](leader)
        sl.execute("create table t (id bigint primary key, v bigint)")
        eng = follower.apply_engine
        assert eng is not None

        def boom():
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(follower, "_drain_refresh", boom)
        sl.execute("insert into t values (1, 1)")
        deadline = time.monotonic() + 10
        while eng.error is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert isinstance(eng.error, RuntimeError)
        assert not eng._thread.is_alive()
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="illegal memory access"):
            follower.close()
        follower.close = lambda: None  # closed above


def test_foreign_error_in_rpc_handler_is_kept_not_answered(tmp_path,
                                                           monkeypatch):
    """A RuntimeError in a leader's handler is not answered as a wire
    error: the connection drops (the caller sees a transport failure
    and exhausts its budget typed) and the leader's `close()` re-raises
    the error. The reference answers it as an RPCError envelope."""
    d = tmp_path / "port"
    leader = PortStorage(str(d / "leader"), shared=True,
                         rpc_listen="127.0.0.1:0",
                         rpc_options=_opts(PORT))
    try:
        srv = leader.rpc_server

        def boom(client_id):
            raise RuntimeError("CUDA error: device-side assert")

        monkeypatch.setattr(srv, "_h_tso_next", boom, raising=False)
        client = port_client.RpcClient(
            f"127.0.0.1:{srv.port}",
            _opts(PORT, backoff_budget_ms=300, breaker_threshold=0))
        with pytest.raises(port_errors.LeaderUnavailable):
            client.call("tso_next")
        client.close()
        assert isinstance(srv.error, RuntimeError)
    finally:
        with pytest.raises(RuntimeError, match="device-side assert"):
            leader.close()
    ref = RefStorage(str(tmp_path / "ref" / "leader"), shared=True,
                     rpc_listen="127.0.0.1:0", rpc_options=_opts(REF))
    try:
        monkeypatch.setattr(ref.rpc_server, "_h_tso_next",
                            lambda client_id: 1 / 0, raising=False)
        client = ref_client.RpcClient(
            f"127.0.0.1:{ref.rpc_server.port}", _opts(REF))
        with pytest.raises(ref_errors.RPCError, match="ZeroDivisionError"):
            client.call("tso_next")
        client.close()
    finally:
        ref.close()


@pytest.mark.parametrize("stmt", [
    "set tidb_replica_read = 'follower'",
    "set session tidb_replica_read = 'follower'",
    "set tidb_read_staleness = -5",
    "set global tidb_read_staleness = -5",
])
def test_replica_read_variables_wait_for_routing(stmt, tmp_path):
    """Follower reads and bounded staleness route SELECTs to a serving
    follower: after the SET, the leader's SELECT is served by the
    follower (engine `replica@...`, one `served`) with the leader's own
    answer, on both packages. The staleness cap is lowered to 1.5 s so
    a -5 s read sees rows written 1.6 s before it (a later commit keeps
    the follower's closed timestamp fresh); the leader defaults route
    nothing."""
    def run(P, d):
        with cluster(P, d) as (leader, follower):
            leader.replica_read.max_staleness_ms = 1500
            sl = P["Session"](leader)
            sl.execute("create table rr (id bigint primary key, v bigint)")
            sl.execute("create table bump (id bigint primary key)")
            sl.execute("insert into rr values (1, 5), (2, 7)")
            t_rows = time.monotonic()
            sl.execute("set tidb_replica_read = 'leader'")
            sl.execute("set tidb_read_staleness = 0")
            local = sl.execute("select sum(v), count(*) from rr").rows
            assert not sl.last_engines[0].startswith("replica@")
            # the rows older than the staleness horizon
            time.sleep(max(0.0, t_rows + 1.6 - time.monotonic()))
            # a later commit moves the closed timestamp: the follower
            # covers it once its apply engine has folded it
            sl.execute("insert into bump values (1)")
            bump_ts = leader.tso.current()
            deadline = time.monotonic() + 10
            while not any(m.get("serving") and m["applied_ts"] >= bump_ts
                          for m in leader.rpc_server.members()
                          if m["role"] == "follower"):
                assert time.monotonic() < deadline
                time.sleep(0.05)
            sl.execute(stmt)
            # a GLOBAL value reaches the sessions opened after it
            sr = P["Session"](leader) if "global" in stmt else sl
            got = sr.execute("select sum(v), count(*) from rr").rows
            out = (local, got,
                   [e.split("@")[0] for e in sr.last_engines],
                   leader.obs.replica_reads.get(outcome="served"),
                   sr.execute("select @@tidb_replica_read, "
                              "@@tidb_read_staleness").rows,
                   sr.warnings)
            if "global" in stmt:
                sl.execute("set global tidb_read_staleness = 0")
            return out

    local, got, engines, served, vars_, warnings = both(run, tmp_path)
    assert got == local == [(12, 2)]
    assert engines == ["replica"] and served == 1.0 and warnings == []
    assert vars_ == ([("follower", 0)] if "replica_read" in stmt
                     else [("leader", -5)])
