"""Two servers, one database, on the port, held to the reference's.

Twins of every case of tests/test_multiproc.py: real server processes
sharing one durable directory (`Storage(path, shared=True)`), one cluster
of each package, started together. Schema changes made through one
server are visible on the other without restart, a transaction planned
against a superseded schema aborts at commit, a server killed after
prewrite leaves locks the survivor resolves, DDL from both servers at
once converges, and a query on one server is killed from the other. The
same statements go to both clusters, and the outcomes are compared:
rows, errnos, the global connection id's node, the crash's exit code.
The shared TSO's cases run on both packages' `SharedTSO` with the same
frozen clock, and strict SI across two in-process siblings.

The port's servers run on `device="cpu"`. Every child is terminated and
reaped by its fixture, and an autouse fixture fails a test that leaves a
live `titpu-*` thread behind.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from contextlib import contextmanager

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from mysql_client import MiniClient, MySQLError  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVER_SRC = """
import os, sys
sys.path.insert(0, {repo!r})
from {pkg}.server.server import Server
from {pkg}.store.storage import Storage

fp = os.environ.get("TIDB_TPU_CRASH_FP")
if fp:  # hard-kill this server at a named 2PC point (crash testing)
    from {pkg}.util import failpoint
    failpoint.enable(fp, lambda: os._exit(9))
storage = Storage({path!r}, shared=True)
srv = Server(storage, host="127.0.0.1", port=0{kw})
srv.start()
print(f"PORT={{srv.port}}", flush=True)
import time
while True:
    time.sleep(1)
"""

PKGS = {"ref": ("tidb_tpu", ""), "port": ("tidb_tpu_torch",
                                          ", device='cpu'")}


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


def _start(name: str, path: str, crash_fp=None) -> subprocess.Popen:
    pkg, kw = PKGS[name]
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    if crash_fp:
        env["TIDB_TPU_CRASH_FP"] = crash_fp
    return subprocess.Popen(
        [sys.executable, "-c",
         SERVER_SRC.format(repo=REPO, pkg=pkg, path=path, kw=kw)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)


def _port_of(proc: subprocess.Popen) -> int:
    """The PORT= line; the deadline is a backstop sized for a loaded
    machine (the reference test's)."""
    deadline = time.time() + 180
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith("PORT="):
            return int(line.strip().split("=")[1])
        if proc.poll() is not None:
            raise RuntimeError("server died during startup")
    raise AssertionError("server did not report a port")


def _stop(procs) -> None:
    for p in procs:
        p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        p.stdout.close()


@contextmanager
def _clusters(tmp_path):
    """Two servers over one directory, for each package: the first of
    each pair starts before the second (it creates the store), the two
    packages side by side. -> {name: (client a, client b)}."""
    procs: list = []
    clients: list = []
    try:
        firsts = {n: _start(n, str(tmp_path / n)) for n in PKGS}
        procs += firsts.values()
        ports_a = {n: _port_of(p) for n, p in firsts.items()}
        seconds = {n: _start(n, str(tmp_path / n)) for n in PKGS}
        procs += seconds.values()
        out = {}
        for n in PKGS:
            ca = MiniClient("127.0.0.1", ports_a[n])
            clients.append(ca)
            cb = MiniClient("127.0.0.1", _port_of(seconds[n]))
            clients.append(cb)
            out[n] = (ca, cb)
        yield out
    finally:
        for c in clients:
            c.close()
        _stop(procs)


def _both(tmp_path, fn):
    """fn(client a, client b) over each package's cluster; equal."""
    with _clusters(tmp_path) as cl:
        got = {n: fn(*cl[n]) for n in ("ref", "port")}
    assert got["port"] == got["ref"]
    return got["port"]


def test_ddl_and_data_visible_across_servers(tmp_path):
    def run(ca, cb):
        ca.execute("create table t (id bigint primary key, v bigint)")
        ca.execute("insert into t values (1, 10), (2, 20)")
        out = [cb.query("select id, v from t order by id")]
        cb.execute("insert into t values (3, 30)")
        out.append(ca.query("select sum(v) from t"))
        cb.execute("alter table t add column w bigint")
        ca.execute("update t set w = id * 100 where id = 1")
        out.append(cb.query("select w from t where id = 1"))
        return out

    assert _both(tmp_path, run) == [[("1", "10"), ("2", "20")], [("60",)],
                                    [("100",)]]


def test_stale_schema_commit_aborts(tmp_path):
    def run(ca, cb):
        ca.execute("create table f (id bigint primary key, v bigint)")
        ca.execute("insert into f values (1, 1)")
        cb.execute("begin")
        cb.execute("update f set v = 2 where id = 1")
        ca.execute("alter table f add column extra bigint")
        with pytest.raises(MySQLError) as exc:
            cb.execute("commit")
        msg = str(exc.value).lower()
        assert "schema" in msg or "try again" in msg
        return [exc.value.code, str(exc.value), ca.query("select v from f")]

    assert _both(tmp_path, run)[2] == [("1",)]


def test_conflicting_writes_across_servers(tmp_path):
    def run(ca, cb):
        ca.execute("create table c (id bigint primary key, v bigint)")
        ca.execute("insert into c values (1, 0)")
        for i in range(6):
            (ca if i % 2 == 0 else cb).execute(
                "update c set v = v + 1 where id = 1")
        return [ca.query("select v from c"), cb.query("select v from c")]

    assert _both(tmp_path, run) == [[("6",)], [("6",)]]


def test_sibling_crash_mid_commit_recovers(tmp_path):
    """A server hard-killed AFTER PREWRITE must not wedge the database:
    the survivor resolves the orphaned locks once their TTL expires and
    rolls the transaction BACK. The two packages' pairs run side by
    side."""
    procs: list = []
    clients: list = []
    try:
        firsts = {n: _start(n, str(tmp_path / n)) for n in PKGS}
        procs += firsts.values()
        ca = {}
        for n, p in firsts.items():
            ca[n] = MiniClient("127.0.0.1", _port_of(p))
            clients.append(ca[n])
            ca[n].execute("create table r (id bigint primary key, "
                          "v bigint)")
            ca[n].execute("insert into r values (1, 1)")
        crash = {n: _start(n, str(tmp_path / n),
                           crash_fp="twopc/after-prewrite") for n in PKGS}
        procs += crash.values()
        out = {}
        for n, c in crash.items():
            cc = MiniClient("127.0.0.1", _port_of(c))
            clients.append(cc)
            with pytest.raises((MySQLError, ConnectionError, OSError)):
                cc.execute("update r set v = 2 where id = 1")
            c.wait(timeout=30)
            out[n] = [c.returncode]
        for n in PKGS:
            t0 = time.time()
            while True:
                try:
                    rows = ca[n].query("select v from r")
                    break
                except MySQLError:
                    assert time.time() - t0 < 30, "orphan lock unresolved"
                    time.sleep(0.5)
            ca[n].execute("update r set v = 7 where id = 1")
            out[n] += [rows, ca[n].query("select v from r")]
        assert out["port"] == out["ref"] == [9, [("1",)], [("7",)]]
    finally:
        for c in clients:
            c.close()
        _stop(procs)


def test_concurrent_ddl_from_both_servers(tmp_path):
    def run(ca, cb):
        errs: list = []

        def mk(cli, names):
            try:
                for nm in names:
                    cli.execute(f"create table {nm} (id bigint primary "
                                "key, v bigint)")
                    cli.execute(f"insert into {nm} values (1, 1)")
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        ta = threading.Thread(target=mk, args=(ca, ["ca0", "ca1", "ca2"]))
        tb = threading.Thread(target=mk, args=(cb, ["cb0", "cb1", "cb2"]))
        ta.start()
        tb.start()
        ta.join(timeout=120)
        tb.join(timeout=120)
        assert not errs, errs
        out = [[cli.query(f"select v from {nm}") for nm in
                ("ca0", "ca1", "ca2", "cb0", "cb1", "cb2")]
               for cli in (ca, cb)]
        ea: list = []

        def alter(cli, sql):
            try:
                cli.execute(sql)
            except BaseException as e:  # noqa: BLE001
                ea.append(e)

        t1 = threading.Thread(target=alter, args=(
            ca, "alter table ca0 add column w bigint"))
        t2 = threading.Thread(target=alter, args=(
            cb, "alter table cb0 add column w bigint"))
        t1.start()
        t2.start()
        t1.join(timeout=120)
        t2.join(timeout=120)
        assert not ea, ea
        got = ca.query("select w from cb0 where id = 1")
        assert got in ([("NULL",)], [(None,)]), got
        return out + [got]

    assert _both(tmp_path, run)[0] == [[("1",)]] * 6


def test_global_kill_from_sibling(tmp_path):
    def run(ca, cb):
        conn_id = int(cb.query("select connection_id()")[0][0])
        errs: list = []

        def long_query():
            try:
                cb.query("select sleep(25)")
            except MySQLError as e:
                errs.append(e)

        t = threading.Thread(target=long_query)
        t.start()
        time.sleep(1.0)
        t0 = time.time()
        ca.execute(f"kill query {conn_id}")
        t.join(timeout=20)
        assert not t.is_alive(), "query was not killed"
        assert time.time() - t0 < 15, "kill took too long"
        assert errs and "interrupt" in str(errs[0]).lower()
        return [conn_id >> 24, errs[0].code, cb.query("select 1")]

    assert _both(tmp_path, run)[2] == [("1",)]


class _FrozenClock:
    """Stand-in for tso.py's `time` module: the physical clock never
    advances, so EVERY timestamp lands in one millisecond."""

    @staticmethod
    def time() -> float:
        return 1_700_000_000.0


def _tso_mods():
    from tidb_tpu.kv import tso as ref_tso
    from tidb_tpu_torch.kv import tso as port_tso
    return {"ref": ref_tso, "port": port_tso}


def test_shared_tso_strictly_monotonic_same_millisecond(tmp_path,
                                                        monkeypatch):
    issued = {}
    for n, mod in _tso_mods().items():
        monkeypatch.setattr(mod, "time", _FrozenClock)
        (tmp_path / n).mkdir()
        a = mod.SharedTSO(str(tmp_path / n))
        b = mod.SharedTSO(str(tmp_path / n))
        last, got = 0, []
        for i in range(4000):
            t = (a if i % 2 else b).next_ts()
            assert t > last, "cross-allocator timestamp went backwards"
            last = t
            got.append(t)
        a.close()
        b.close()
        issued[n] = got
    assert issued["port"] == issued["ref"]


def test_shared_tso_crash_recovery_floors_above_window(tmp_path):
    for n, mod in _tso_mods().items():
        d = tmp_path / n
        d.mkdir()
        a = mod.SharedTSO(str(d))
        issued = [a.next_ts() for _ in range(10)]
        a.close()
        with open(d / "tso.mem", "r+b") as f:
            f.write(b"\0" * 8)
        b = mod.SharedTSO(str(d))
        t = b.next_ts()
        assert t > max(issued), "timestamp repeated after crash"
        b.close()


def test_strict_si_same_millisecond(tmp_path, monkeypatch):
    from tidb_tpu.session import Session as RefSession
    from tidb_tpu.store.storage import Storage as RefStorage
    from tidb_tpu_torch.session import Session as PortSession
    from tidb_tpu_torch.store.storage import Storage as PortStorage

    sides = {"ref": (RefStorage, RefSession),
             "port": (PortStorage,
                      lambda st: PortSession(st, device="cpu"))}
    out = {}
    for n, mod in _tso_mods().items():
        monkeypatch.setattr(mod, "time", _FrozenClock)
        Storage, Session = sides[n]
        s1 = Storage(str(tmp_path / n), shared=True)
        s2 = Storage(str(tmp_path / n), shared=True)
        try:
            sess1, sess2 = Session(s1), Session(s2)
            sess1.execute("create table t (id bigint primary key, "
                          "v bigint)")
            sess1.execute("insert into t values (1, 10)")
            rows = [sess2.execute("select v from t").rows]
            sess1.execute("begin")
            rows.append(sess1.execute("select v from t").rows)
            sess2.execute("update t set v = 99 where id = 1")
            rows.append(sess1.execute("select v from t").rows)
            sess1.execute("commit")
            rows.append(sess1.execute("select v from t").rows)
            out[n] = rows
        finally:
            s1.close()
            s2.close()
    assert out["port"] == out["ref"] == [[(10,)], [(10,)], [(10,)],
                                         [(99,)]]


def test_port_sibling_opens_a_native_engine_directory(tmp_path):
    """The shared mode's Python engine opens a durable directory that
    the port's C++ engine (or its Python twin) wrote, as the reference's
    does: a plain durable store, closed, reopened by two siblings."""
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import Storage

    d = str(tmp_path / "db")
    st = Storage(d, sync_log="commit")
    s = Session(st, device="cpu")
    s.execute("create table t (id bigint primary key, v bigint)")
    s.execute("insert into t values (1, 10), (2, 20)")
    s.execute("update t set v = 11 where id = 1")
    engine = type(st.kv.kv).__name__
    st.close()
    a, b = Storage(d, shared=True), Storage(d, shared=True)
    try:
        assert type(a.kv.kv).__name__ == "PyOrderedKV" and a.kv.kv._shared
        sa, sb = Session(a, device="cpu"), Session(b, device="cpu")
        assert sa.execute("select id, v from t order by id").rows == \
            [(1, 11), (2, 20)]
        sb.execute("insert into t values (3, 30)")
        assert sa.execute("select sum(v) from t").rows == [(61,)]
    finally:
        a.close()
        b.close()
    assert engine in ("NativeOrderedKV", "PyOrderedKV")


def test_partitioned_table_refreshes_across_siblings(tmp_path):
    """A partitioned table created and written by one sibling is read by
    the other after its refresh (each partition's store refolded from
    the KV), and rows the second inserts are read back by the first:
    the same rows on both packages."""
    from tidb_tpu.session import Session as RefSession
    from tidb_tpu.store.storage import Storage as RefStorage
    from tidb_tpu_torch.session import Session as PortSession
    from tidb_tpu_torch.store.storage import Storage as PortStorage

    sides = {"ref": (RefStorage, RefSession),
             "port": (PortStorage,
                      lambda st: PortSession(st, device="cpu"))}
    out = {}
    for n, (Storage, Session) in sides.items():
        s1 = Storage(str(tmp_path / n), shared=True)
        s2 = Storage(str(tmp_path / n), shared=True)
        try:
            a, b = Session(s1), Session(s2)
            a.execute("create table pt (id bigint primary key, v bigint) "
                      "partition by hash(id) partitions 4")
            a.execute("insert into pt values " + ",".join(
                f"({i}, {i * 3})" for i in range(40)))
            rows = [b.execute("select count(*), sum(v) from pt").rows]
            b.execute("insert into pt values (100, 1), (101, 2), (102, 3)")
            b.execute("update pt set v = v + 1 where id < 10")
            rows.append(a.execute("select id, v from pt where id < 12 or "
                                  "id > 99 order by id").rows)
            a.execute("insert into pt values (200, 5)")
            rows.append(b.execute("select count(*), sum(v), max(id) "
                                  "from pt").rows)
            out[n] = rows
        finally:
            s1.close()
            s2.close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == [(40, 2340)]
