"""The port's leader failover held to the reference's.

Twins of every case of tests/test_failover.py. The fast cases drive the
promotion protocol in process on each package (the port's stores and
sessions on `device="cpu"`) with the same statements, and compare the
outcomes: rows, terms, modes, error classes, the winner's position in
the election (longest replicated WAL, ties to the lowest node id), the
mirror's byte-prefix property. The four `slow` cases (as the
reference's, and only those) run real child server processes of each
package and SIGKILL the leader, or kill a child at an armed failpoint,
and check that no acknowledged commit is lost.

The port's own rule: an error the RPC plane does not survive (a
`RuntimeError` standing for a torch or CUDA error) inside the failover
watcher or a promotion ends the watcher and is re-raised by
`Storage.close()`; the reference's watcher records it and goes on.

Every fixture closes followers before the leader, and an autouse
fixture fails a test that leaves a live `titpu-*` thread behind.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from mysql_client import MiniClient, MySQLError  # noqa: E402

import tidb_tpu.rpc.client as ref_client  # noqa: E402
import tidb_tpu.rpc.diag as ref_diag  # noqa: E402
import tidb_tpu.rpc.errors as ref_errors  # noqa: E402
import tidb_tpu_torch.rpc.client as port_client  # noqa: E402
import tidb_tpu_torch.rpc.diag as port_diag  # noqa: E402
import tidb_tpu_torch.rpc.errors as port_errors  # noqa: E402
from tidb_tpu.session import Session as RefSession  # noqa: E402
from tidb_tpu.store.storage import Storage as RefStorage  # noqa: E402
from tidb_tpu_torch.session import Session as PortSession  # noqa: E402
from tidb_tpu_torch.store.storage import Storage as PortStorage  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = {"name": "ref", "Storage": RefStorage, "Session": RefSession,
       "client": ref_client, "diag": ref_diag, "errors": ref_errors,
       "pkg": "tidb_tpu", "device_kw": ""}
PORT = {"name": "port",
        "Storage": functools.partial(PortStorage, device="cpu"),
        "Session": lambda st: PortSession(st, device="cpu"),
        "client": port_client, "diag": port_diag, "errors": port_errors,
        "pkg": "tidb_tpu_torch", "device_kw": ", device='cpu'"}

# tight lease so leader loss is detected fast; election disabled by
# default (tests that want automatic failover opt in)
OPTS = dict(connect_timeout_ms=500, request_timeout_ms=2000,
            backoff_budget_ms=1500, lock_budget_ms=8000, lease_ms=1000)


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
    # the reference's failover watcher, reaper and connection threads
    # end within a tick of their close; the port's close joins its own
    deadline = time.monotonic() + 15.0
    while _titpu_threads() - before and time.monotonic() < deadline:
        time.sleep(0.05)
    left = _titpu_threads() - before
    assert not left, sorted(t.name for t in left)


def _cluster(P, d, n_followers=2, election_ms=0):
    opts = P["client"].RpcOptions(**OPTS)
    leader = P["Storage"](str(d / "leader"), shared=True,
                          rpc_listen="127.0.0.1:0", rpc_options=opts)
    followers = []
    for i in range(n_followers):
        fopts = P["client"].RpcOptions(
            **{**OPTS, "election_timeout_ms": election_ms})
        followers.append(P["Storage"](
            str(d / f"f{i}"),
            remote=f"127.0.0.1:{leader.rpc_server.port}",
            rpc_options=fopts))
    return leader, followers


def _close_all(leader, followers) -> None:
    """Followers first, the newest first, then the leader; every close
    runs, and the first error is raised after them."""
    errors = []
    for st in [*reversed(followers), leader]:
        try:
            st.close()
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
    if errors:
        raise errors[0]


def _promoted(st) -> bool:
    return not st.remote and st.rpc_server is not None


def _write(P, sess, sql: str) -> None:
    """A write on a follower that has just repointed: a call of its that
    exhausted its budget against the dead leader (the reference's
    heartbeat too, see test_failed_ping_to_a_left_leader_is_not_leader_
    loss) marks it degraded until its next successful call, and a write
    then fails typed (9001); retried, within 5 s."""
    until = time.monotonic() + 5
    while True:
        try:
            sess.execute(sql)
            return
        except P["errors"].LeaderUnavailable:
            if time.monotonic() > until:
                raise
            time.sleep(0.1)


# ==================== fast, in-process protocol tests ====================

def test_manual_promotion_preserves_acked_commits(tmp_path):
    def run(P, d):
        leader, (fa, fb) = _cluster(P, d)
        try:
            sl, sa, sb = (P["Session"](x) for x in (leader, fa, fb))
            sl.execute("create table t (id bigint primary key, v bigint)")
            for i in range(10):
                sa.execute(f"insert into t values ({i}, {i * 10})")
            assert sb.execute("select count(*) from t").rows == [(10,)]
            old_term = fa._rpc_client.term
            P["diag"].cluster_members(fa)
            P["diag"].cluster_members(fb)  # warm the voter roll
            # leader dies without ceremony
            leader.rpc_server.close()
            addr = fa.promote_to_leader(listen="127.0.0.1:0")
            assert fa.rpc_server.term == old_term + 1
            assert not fa.remote and fa.shared
            # every commit acked through the follower survived
            assert sa.execute("select count(*) from t").rows == [(10,)]
            # writes resume on the new leader...
            sa.execute("insert into t values (100, 1000)")
            # ...and on the repointed survivor
            fb.repoint_leader(addr, fa.rpc_server.term)
            _write(P, sb, "insert into t values (101, 1010)")
            assert sa.execute("select count(*) from t").rows == [(12,)]
            assert sb.execute("select count(*) from t").rows == [(12,)]
            return (fa.rpc_server.term, fb._rpc_client.term,
                    fa.transport_health()["mode"],
                    fb.transport_health()["mode"],
                    sb.execute("select sum(v) from t").rows,
                    [e["kind"] for e in fa.obs.events.snapshot()
                     if e["kind"].startswith("leader_")],
                    [e["kind"] for e in fb.obs.events.snapshot()
                     if e["kind"].startswith("leader_")])
        finally:
            _close_all(leader, [fa, fb])

    assert both(run, tmp_path)[:5] == (
        2, 2, "socket-leader", "socket-follower", [(2460,)])


def test_automatic_election_and_repoint(tmp_path):
    """Leader loss alone must resolve the cluster: the follower with
    the longest replicated WAL promotes within the election window and
    the other follower repoints — no operator in the loop."""
    def run(P, d):
        leader, (fa, fb) = _cluster(P, d, election_ms=1500)
        try:
            sl, sa, sb = (P["Session"](x) for x in (leader, fa, fb))
            sl.execute("create table t (id bigint primary key, v bigint)")
            sa.execute("insert into t values (1, 1)")
            assert sb.execute("select v from t").rows == [(1,)]
            time.sleep(1.2)  # a failover tick refreshes the voter roll
            # the candidacies the watchers will compare (the leader is
            # idle: every mirror has caught up)
            votes = [(f.kv.kv._applied_off, f.coord.node_id)
                     for f in (fa, fb)]
            leader.rpc_server.close()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if _promoted(fa) or _promoted(fb):
                    break
                time.sleep(0.25)
            promoted = fa if _promoted(fa) else fb
            survivor = fb if promoted is fa else fa
            assert _promoted(promoted), "no follower promoted in time"
            assert promoted.rpc_server.term == 2
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                if survivor._rpc_client.term == 2 and \
                        not survivor._rpc_client.degraded:
                    break
                time.sleep(0.25)
            sp, ss = P["Session"](promoted), P["Session"](survivor)
            sp.execute("insert into t values (2, 2)")
            _write(P, ss, "insert into t values (3, 3)")
            assert sp.execute("select count(*) from t").rows == [(3,)]
            assert ss.execute("select count(*) from t").rows == [(3,)]
            h = promoted.transport_health()
            assert h["mode"] == "socket-leader" and h["term"] == 2
            # the winner is the longest replicated WAL, ties to the
            # lowest node id — what every voter computes
            win = max(votes, key=lambda v: (v[0], -v[1]))
            assert promoted is (fa, fb)[votes.index(win)]
            fo = survivor.transport_health()["failover"]
            return (["fa", "fb"][promoted is fb], h["term"],
                    fo["last_result"].split(" ")[0], fo["elections"] >= 1,
                    ss.execute("select id from t order by id").rows)
        finally:
            _close_all(leader, [fa, fb])

    out = both(run, tmp_path)
    assert out[1:] == (2, "repointed", True, [(1,), (2,), (3,)])


def test_stale_term_mutations_fenced(tmp_path):
    """A zombie of the old epoch — any client still carrying the
    deposed term — has its mutation attempts rejected typed."""
    def run(P, d):
        errors = P["errors"]
        leader, (fa,) = _cluster(P, d, n_followers=1)
        try:
            sl = P["Session"](leader)
            sl.execute("create table t (id bigint primary key)")
            P["diag"].cluster_members(fa)
            leader.rpc_server.close()
            addr = fa.promote_to_leader(listen="127.0.0.1:0")
            zombie = P["client"].RpcClient(
                addr, P["client"].RpcOptions(**OPTS))
            out = []
            try:
                zombie.call("hello")
                zombie.term = 1  # the dead leader's epoch
                with pytest.raises(errors.StaleTermError) as e:
                    zombie.call("lock_acquire", name="mutation", term=1)
                out.append((type(e.value).__name__, e.value.errno))
                with pytest.raises(errors.StaleTermError) as e:
                    zombie.call("wal_append", seq=1, expected=0,
                                data=b"x", token=0, term=1)
                out.append((type(e.value).__name__, e.value.errno,
                            str(e.value)))
            finally:
                zombie.close()
            return out
        finally:
            _close_all(leader, [fa])

    both(run, tmp_path)


def test_deposed_leader_answers_are_rejected(tmp_path):
    """A restarted OLD leader serves its stale term; a client that has
    seen the new epoch treats its answers as leader loss, not
    liveness — the other half of split-brain prevention."""
    def run(P, d):
        opts = P["client"].RpcOptions(**OPTS)
        leader = P["Storage"](str(d / "leader"), shared=True,
                              rpc_listen="127.0.0.1:0", rpc_options=opts)
        try:
            client = P["client"].RpcClient(
                f"127.0.0.1:{leader.rpc_server.port}", opts)
            try:
                client.call("hello")
                assert client.term == 1
                client.term = 2  # this client lived through a failover
                with pytest.raises(P["errors"].StaleTermError) as e:
                    client.call("hello")
                return str(e.value).replace(
                    f"127.0.0.1:{leader.rpc_server.port}", "L")
            finally:
                client.close()
        finally:
            leader.close()

    both(run, tmp_path)


def test_follower_mirror_is_byte_prefix_of_leader_wal(tmp_path):
    """The promotion substrate: every follower's on-disk mirror is a
    byte-for-byte prefix of the leader's WAL, through both tailed
    replication and the follower's own publishes."""
    def run(P, d):
        leader, (fa,) = _cluster(P, d, n_followers=1)
        try:
            sl, sa = P["Session"](leader), P["Session"](fa)
            sl.execute("create table m (id bigint primary key, v bigint)")
            sl.execute("insert into m values (1, 1)")
            sa.execute("insert into m values (2, 2)")  # follower publish
            sl.execute("insert into m values (3, 3)")
            assert sa.execute("select count(*) from m").rows == [(3,)]
            with open(d / "leader" / "kv" / "wal.log", "rb") as f:
                leader_wal = f.read()
            with open(d / "f0" / "kv" / "wal.log", "rb") as f:
                mirror = f.read()
            assert len(mirror) > 0
            assert leader_wal[:len(mirror)] == mirror
            return fa.kv.kv._applied_off == len(mirror)
        finally:
            _close_all(leader, [fa])

    assert both(run, tmp_path) is True


def test_torn_wal_tail_truncates_cleanly(tmp_path):
    """Garbage (a half-written record) at the WAL tail must truncate at
    recovery, not hide or corrupt the committed prefix."""
    def run(P, d):
        p = str(d / "db")
        st = P["Storage"](p, sync_log="commit")
        s = P["Session"](st)
        s.execute("create table t (id bigint primary key, v bigint)")
        for i in range(5):
            s.execute(f"insert into t values ({i}, {i})")
        st.kv.kv.close()  # crash without checkpoint
        wal = os.path.join(p, "kv", "wal.log")
        size = os.path.getsize(wal)
        with open(wal, "ab") as f:
            f.write(b"\x01\x02" + b"\xff" * 7)  # torn header + junk
        st2 = P["Storage"](p)
        s2 = P["Session"](st2)
        out = [s2.execute("select count(*) from t").rows]
        assert os.path.getsize(wal) <= size  # torn tail gone
        s2.execute("insert into t values (100, 100)")  # still appendable
        st2.kv.kv.close()
        st3 = P["Storage"](p)
        out.append(P["Session"](st3).execute(
            "select count(*) from t").rows)
        st3.close()
        return out

    assert both(run, tmp_path) == [[(5,)], [(6,)]]


def test_corrupt_epoch_snapshot_refolds_from_kv(tmp_path):
    """A half-written columnar epoch snapshot degrades to a refold from
    the KV truth instead of poisoning recovery."""
    def run(P, d):
        p = str(d / "db")
        st = P["Storage"](p)
        s = P["Session"](st)
        s.execute("create table e (id bigint primary key, v bigint)")
        s.execute("insert into e values (1, 10), (2, 20)")
        tid = st.catalog.table("test", "e").id
        st.close()  # checkpoint writes the epoch snapshot
        epoch = os.path.join(p, "epochs", f"t{tid}.npz")
        assert os.path.exists(epoch)
        with open(epoch, "wb") as f:
            f.write(b"PK\x03\x04 this is not a real archive")
        st2 = P["Storage"](p)
        rows = P["Session"](st2).execute(
            "select id, v from e order by id").rows
        st2.close()
        return rows

    assert both(run, tmp_path) == [(1, 10), (2, 20)]


def test_heartbeat_thread_joined_on_close(tmp_path):
    """RpcClient.close() must wake AND join the heartbeat thread — the
    no-leaked-threads contract extended to the keepalive."""
    def hb_threads():
        return [t for t in threading.enumerate()
                if t.is_alive() and t.name == "titpu-rpc-heartbeat"]

    def run(P, d):
        leader, (fa,) = _cluster(P, d, n_followers=1)
        try:
            assert hb_threads(), "follower heartbeat not running"
            # the hard case: the leader is unreachable, so a beat may be
            # blocked mid-connect/recv when close() lands
            leader.rpc_server.close()
            time.sleep(0.3)
            fa.close()
            deadline = time.monotonic() + 6.0
            while hb_threads() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert hb_threads() == [], "heartbeat leaked past close()"
            return True
        finally:
            fa.close = lambda: None  # closed above
            leader.close()

    assert both(run, tmp_path) is True


# ==================== a race of the reference ====================

def test_failed_ping_to_a_left_leader_is_not_leader_loss(tmp_path):
    """A heartbeat ping aimed at the old leader that fails after the
    client repointed to a new one: the reference marks the client
    degraded (so the next write fails 9001 until the next ping), the
    port leaves it alone. The ping's failure is injected on the
    heartbeat's own client, with the repoint inside it."""
    out = []
    for P in (REF, PORT):
        d = tmp_path / P["name"]
        opts = P["client"].RpcOptions(**OPTS)
        old, new = (P["Storage"](str(d / n), shared=True,
                                 rpc_listen="127.0.0.1:0",
                                 rpc_options=opts) for n in ("l1", "l2"))
        client = P["client"].RpcClient(old.rpc_server.address, opts)
        try:
            client.call("hello")
            client.start_heartbeat()
            hb = client._hb_client
            real, seen = hb.call, []

            def ping(method, **params):
                if not seen:
                    seen.append(None)
                    client.repoint(new.rpc_server.address)
                    raise P["errors"].LeaderUnavailable("ping lost")
                if len(seen) == 1:
                    seen.append(client.degraded)
                return real(method, **params)

            hb.call = ping
            deadline = time.monotonic() + 10
            while len(seen) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            out.append(seen[1])
            assert client.call("hello") and not client.degraded
        finally:
            client.close()
            new.close()
            old.close()
    assert out == [True, False]


# ==================== the port's own rule ====================

def test_foreign_error_in_promotion_is_reraised_by_close(tmp_path,
                                                         monkeypatch):
    """A RuntimeError inside an automatic promotion (a torch or CUDA
    error while the promoted store re-folds, say) ends the port's
    failover watcher (state `failed`) and is re-raised by the
    follower's `close()`; a survivable error there would only have
    been recorded. The reference's watcher records any error and goes
    on electing."""
    leader, (fa,) = _cluster(PORT, tmp_path / "port", n_followers=1,
                             election_ms=500)
    try:
        sl = PORT["Session"](leader)
        sl.execute("create table t (id bigint primary key)")
        time.sleep(1.2)  # a failover tick refreshes the voter roll

        def boom(listen="127.0.0.1:0"):
            raise RuntimeError("CUDA error: device-side assert")

        monkeypatch.setattr(fa, "promote_to_leader", boom)
        leader.rpc_server.close()
        fo = fa.failover
        deadline = time.monotonic() + 20.0
        while fo.error is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert isinstance(fo.error, RuntimeError)
        assert fo.state == "failed"
        assert not fo._thread.is_alive()
        with pytest.raises(RuntimeError, match="device-side assert"):
            fa.close()
    finally:
        fa.close = lambda: None  # closed above
        leader.close()


def test_survivable_error_in_election_is_retried(tmp_path, monkeypatch):
    """An RPC error inside an election round is the watcher's to
    survive: it records it and elects on the next tick."""
    leader, (fa,) = _cluster(PORT, tmp_path / "port", n_followers=1,
                             election_ms=500)
    try:
        sl = PORT["Session"](leader)
        sl.execute("create table t (id bigint primary key)")
        time.sleep(1.2)
        real = fa.promote_to_leader
        calls = []

        def flaky(listen="127.0.0.1:0"):
            calls.append(listen)
            if len(calls) == 1:
                raise port_errors.RPCError("transient")
            return real(listen=listen)

        monkeypatch.setattr(fa, "promote_to_leader", flaky)
        leader.rpc_server.close()
        deadline = time.monotonic() + 20.0
        while not _promoted(fa) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _promoted(fa) and len(calls) == 2
        assert fa.rpc_server.term == 2 and fa.failover.error is None
    finally:
        _close_all(leader, [fa])


# ==================== the kill-9 torture harness (slow) ====================

SERVER_SRC = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
from {pkg}.server.server import Server
from {pkg}.store.storage import Storage
from {pkg}.rpc.client import RpcOptions

kw = json.loads(os.environ["TIDB_TPU_TEST_STORAGE"])
opts = kw.pop("rpc_options", None)
if opts is not None:
    kw["rpc_options"] = RpcOptions(**opts)
storage = Storage(**kw{device_kw})
srv = Server(storage, host="127.0.0.1", port=0,
             status_port=0, status_host="127.0.0.1"{device_kw})
srv.start()
coord = storage.rpc_server.address if storage.rpc_server else ""
print(f"PORT={{srv.port}} STATUS={{srv.status_port}} COORD={{coord}}",
      flush=True)
while True:
    time.sleep(0.5)
"""


def _spawn_server(P, storage_kw: dict, failpoints: str = ""):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "TIDB_TPU_TEST_STORAGE": json.dumps(storage_kw)}
    if failpoints:
        env["TIDB_TPU_FAILPOINTS"] = failpoints
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVER_SRC.format(
            repo=REPO, pkg=P["pkg"], device_kw=P["device_kw"])],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    deadline = time.time() + 180
    info = {}
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith("PORT="):
            for tok in line.split():
                k, _, v = tok.partition("=")
                info[k.lower()] = v
            break
        if proc.poll() is not None:
            raise RuntimeError("server died during startup")
    assert info, "server did not report its ports"
    return proc, int(info["port"]), int(info["status"]), info["coord"]


def _status(status_port: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{status_port}/status", timeout=10) as r:
        return json.load(r)


def _eventually(fn, timeout_s: float = 30.0, desc: str = ""):
    """Retry `fn` until it stops raising — follower replication is
    ASYNC and the first statements after a failover may pay one backoff
    budget against a busy new leader."""
    deadline = time.time() + timeout_s
    while True:
        try:
            return fn()
        except (MySQLError, ConnectionError, OSError,
                AssertionError) as e:
            if time.time() >= deadline:
                raise AssertionError(f"{desc or 'condition'} not "
                                     f"reached in {timeout_s}s: {e}")
            time.sleep(0.5)


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=15)


FOLLOWER_OPTS = dict(connect_timeout_ms=500, request_timeout_ms=2000,
                     backoff_budget_ms=1500, lock_budget_ms=8000,
                     lease_ms=1000, election_timeout_ms=3000)


def _kill9_leader_failover(P, d) -> dict:
    procs = []
    try:
        lp, lport, _lstatus, lcoord = _spawn_server(
            P, {"path": str(d / "leader"), "shared": True,
                "rpc_listen": "127.0.0.1:0", "sync_log": "commit",
                "rpc_options": {**FOLLOWER_OPTS,
                                "election_timeout_ms": 0}})
        procs.append(lp)
        fkw = {"remote": lcoord, "sync_log": "commit",
               "rpc_options": FOLLOWER_OPTS}
        ap, aport, astatus, _ = _spawn_server(
            P, {**fkw, "path": str(d / "fa")})
        procs.append(ap)
        bp, bport, bstatus, _ = _spawn_server(
            P, {**fkw, "path": str(d / "fb")})
        procs.append(bp)

        cl = MiniClient("127.0.0.1", lport)
        ca = MiniClient("127.0.0.1", aport)
        cb = MiniClient("127.0.0.1", bport)
        cl.execute("create table t (id bigint primary key, v bigint)")
        assert ca.query("select count(*) from t") == [("0",)]
        assert cb.query("select count(*) from t") == [("0",)]

        # ---- phase 1: workload through follower A, kill the leader --
        acked = []
        for i in range(15):
            ca.execute(f"insert into t values ({i}, {i})")
            acked.append(i)
        time.sleep(1.5)  # a failover tick refreshes the voter roll
        os.kill(lp.pid, signal.SIGKILL)
        lp.wait(timeout=30)

        t0 = time.time()
        next_id = 100
        resumed = False
        while time.time() - t0 < 90:
            try:
                ca.execute(
                    f"insert into t values ({next_id}, {next_id})")
                acked.append(next_id)
                next_id += 1
                if resumed:
                    break
                resumed = True  # one more to prove it's stable
            except (MySQLError, ConnectionError, OSError):
                time.sleep(0.5)
        assert resumed, "writes never resumed after leader kill"

        deadline = time.time() + 30
        while True:
            roles, terms = {}, {}
            for name, sport in (("a", astatus), ("b", bstatus)):
                st = _status(sport)["transport"]
                roles[name] = st["mode"]
                terms[name] = st.get("term", 0)
            if sorted(roles.values()) == \
                    ["socket-follower", "socket-leader"] and \
                    all(t >= 2 for t in terms.values()):
                break
            assert time.time() < deadline, (roles, terms)
            time.sleep(0.5)

        def _check_acked(c):
            got = {int(r[0]) for r in c.query("select id from t")}
            missing = set(acked) - got
            assert not missing, f"acked commits lost: {missing}"

        for c in (ca, cb):
            _eventually(lambda: _check_acked(c), 30,
                        "acked commits on survivor")

        new_leader_status = astatus if roles["a"] == "socket-leader" \
            else bstatus
        new_coord = _status(new_leader_status)["transport"]["address"]

        # ---- phase 2: the old leader returns as a FOLLOWER ----------
        rp, rport, rstatus, _ = _spawn_server(
            P, {"path": str(d / "leader-reborn"),
                "remote": new_coord, "sync_log": "commit",
                "rpc_options": FOLLOWER_OPTS})
        procs.append(rp)
        cr = MiniClient("127.0.0.1", rport)

        def _check_rejoin():
            got = {int(r[0]) for r in cr.query("select id from t")}
            assert set(acked) <= got, "rejoined follower missing commits"

        _eventually(_check_rejoin, 30, "rejoined follower catch-up")
        assert _status(rstatus)["transport"]["mode"] == "socket-follower"

        # ---- phase 3: the zombie epoch is fenced --------------------
        zombie = P["client"].RpcClient(new_coord,
                                       P["client"].RpcOptions(**OPTS))
        try:
            zombie.call("hello")
            zombie.term = 1
            with pytest.raises(P["errors"].StaleTermError):
                zombie.call("lock_acquire", name="mutation", term=1)
        finally:
            zombie.close()

        for c in (ca, cb, cr):
            c.close()
        cl.close()
        return {"terms": sorted(terms.values()),
                "roles": sorted(roles.values())}
    finally:
        _reap(procs)


@pytest.mark.slow
def test_kill9_leader_failover_end_to_end(tmp_path):
    """SIGKILL the leader process mid-workload under sync-log=commit; a
    follower must promote within the election window with a bumped
    term, every acknowledged commit must be present, writes must resume
    on both survivors, and the restarted old leader must rejoin as a
    follower with its stale-term mutations rejected."""
    both(_kill9_leader_failover, tmp_path)


CRASH_SRC = """
import os, sys
sys.path.insert(0, {repo!r})
from {pkg}.store.storage import Storage
from {pkg}.session import Session
st = Storage({path!r}, sync_log="commit")
s = Session(st{device_kw})
s.execute("create table if not exists t (id bigint primary key, v bigint)")
for i in range({start}, {start} + {count}):
    s.execute(f"insert into t values ({{i}}, {{i}})")
    print(f"ACK={{i}}", flush=True)
{epilogue}
print("DONE", flush=True)
os._exit(0)
"""


def _run_crash_child(P, path: str, start: int, count: int,
                     failpoints: str, epilogue: str = "") -> list[int]:
    """Run a workload child until it exits (crash or DONE); returns the
    ids it ACKED before dying."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "TIDB_TPU_FAILPOINTS": failpoints}
    proc = subprocess.Popen(
        [sys.executable, "-c", CRASH_SRC.format(
            repo=REPO, pkg=P["pkg"], device_kw=P["device_kw"], path=path,
            start=start, count=count, epilogue=epilogue)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    acked = []
    try:
        for line in proc.stdout:
            if line.startswith("ACK="):
                acked.append(int(line.strip().split("=")[1]))
    finally:
        proc.wait(timeout=120)
    return acked


@pytest.mark.slow
@pytest.mark.parametrize("failpoints,epilogue", [
    ("kv/wal-torn-append=exit(9)@40", ""),
    ("storage/before-fold=exit(9)@12", ""),
    ("storage/mid-checkpoint=exit(9)@1", "st.checkpoint()"),
    ("kv/group-fsync=exit(9)@40", ""),
])
def test_kill9_no_acked_commit_loss(tmp_path, failpoints, epilogue):
    """sync-log=commit contract under SIGKILL at every storage-path
    failpoint: every acknowledged insert survives recovery, the store
    reopens clean, and stays writable."""
    def run(P, d):
        p = str(d / "db")
        acked = _run_crash_child(P, p, 0, 200, failpoints, epilogue)
        assert acked, "child crashed before acking anything"
        st = P["Storage"](p)
        s = P["Session"](st)
        got = {r[0] for r in s.execute("select id from t").rows}
        missing = set(acked) - got
        assert not missing, \
            f"acked commits lost under {failpoints}: {sorted(missing)}"
        s.execute("insert into t values (9999, 9999)")
        assert 9999 in {r[0] for r in s.execute("select id from t").rows}
        st.close()
        return True

    both(run, tmp_path)


CONCURRENT_CRASH_SRC = """
import os, sys, threading
sys.path.insert(0, {repo!r})
from {pkg}.store.storage import Storage
from {pkg}.session import Session
st = Storage({path!r}, sync_log="commit")
boot = Session(st{device_kw})
boot.execute("create table if not exists t (id bigint primary key, v bigint)")
print_lock = threading.Lock()
def writer(w):
    s = Session(st{device_kw})
    for j in range({per}):
        i = {start} + w * {per} + j
        s.execute(f"insert into t values ({{i}}, {{i}})")
        with print_lock:
            print(f"ACK={{i}}", flush=True)
threads = [threading.Thread(target=writer, args=(w,))
           for w in range({writers})]
for t in threads: t.start()
for t in threads: t.join()
print("DONE", flush=True)
os._exit(0)
"""


@pytest.mark.slow
@pytest.mark.parametrize("failpoints", [
    "kv/group-fsync=exit(9)@5",
    "kv/group-fsync=exit(9)@60",
])
def test_kill9_concurrent_group_commit_no_acked_loss(tmp_path,
                                                     failpoints):
    """sync-log=commit contract under CONCURRENT committers sharing
    group fsyncs: SIGKILL mid-group-fsync loses no acked commit, leaves
    no half-applied unacked commit visible, and the store reopens
    writable."""
    def run(P, d):
        p = str(d / "db")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "TIDB_TPU_FAILPOINTS": failpoints}
        proc = subprocess.Popen(
            [sys.executable, "-c", CONCURRENT_CRASH_SRC.format(
                repo=REPO, pkg=P["pkg"], device_kw=P["device_kw"], path=p,
                start=0, per=60, writers=8)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env)
        acked = []
        try:
            for line in proc.stdout:
                if line.startswith("ACK="):
                    acked.append(int(line.strip().split("=")[1]))
        finally:
            proc.wait(timeout=120)
        assert acked, "child crashed before acking anything"
        assert proc.returncode != 0, "failpoint never fired"
        st = P["Storage"](p)
        s = P["Session"](st)
        rows = s.execute("select id, v from t order by id").rows
        got = {r[0] for r in rows}
        missing = set(acked) - got
        assert not missing, \
            f"acked commits lost under {failpoints}: {sorted(missing)[:10]}"
        assert len(rows) == len(got)
        assert all(r[1] == r[0] for r in rows)
        s.execute("insert into t values (999999, 999999)")
        assert 999999 in {r[0] for r in s.execute("select id from t").rows}
        st.close()
        return True

    both(run, tmp_path)


@pytest.mark.slow
def test_kill9_recovery_idempotent_across_repeated_kills(tmp_path):
    """Crash -> recover -> crash again, rotating the kill site each
    round: recovery must be idempotent (acked set only grows, no
    duplicates, no resurrection)."""
    def run(P, d):
        p = str(d / "db")
        fps = ["kv/wal-torn-append=exit(9)@30",
               "storage/before-fold=exit(9)@8",
               "kv/wal-torn-append=exit(9)@55"]
        all_acked: set[int] = set()
        start = 0
        for fp in fps:
            acked = _run_crash_child(P, p, start, 100, fp)
            all_acked.update(acked)
            start += 100
            st = P["Storage"](p)
            rows = P["Session"](st).execute(
                "select id from t order by id").rows
            got = [r[0] for r in rows]
            assert len(got) == len(set(got)), "duplicate handles"
            missing = all_acked - set(got)
            assert not missing, f"acked commits lost at {fp}: {missing}"
            st.close()
        assert len(all_acked) > 50
        return True

    both(run, tmp_path)
