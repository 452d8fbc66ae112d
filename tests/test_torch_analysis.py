"""The port's concurrency analysis plane (`tidb_tpu_torch/analysis/`) held
to the reference's.

Static half: every case of tests/test_analysis.py that builds a synthetic
tree (registry lint, the rule decorator, the baseline ratchet, the nine
rules' fire/silent trees) runs on both engines, its paths moved to the
port's package, and the findings each engine returned are equal (rule,
item, severity, message, with the package's name masked in messages).
`python -m tidb_tpu_torch.analysis --check` exits 0 on the real tree in a
child process that imports none of torch, jax and tidb_tpu.

Dynamic half: the reference's lock-checker cases run on the port's
checker (off: plain `threading` primitives; an injected inversion, a
consistent order, blocking under a hot lock, RLock re-entrancy across
threads, the held mirror, the inspection plane). The same durable-store
workload under each package's checker registers the same locks with the
same hot flags and records the same edges; a range-plane and heat-plane
run (cross-range 2PC, one split, heatmap on) does too. A cycle surfaces
through `information_schema.inspection_result` on both; `/debug/lockgraph`
and `[analysis] lock-check` work on a CPU server.

Native half: `TIDB_TPU_NATIVE_SANITIZE=1` selects the ASan build and
fails typed without the runtime preloaded; a slow-marked torture runs the
group-fsync workload against the ASan/UBSan build of csrc/kvstore.cpp.

Also the repairs the static rules asked for: one literal inject site per
`net/*` kind, and a foreign error in the cluster diagnostics fan-out
still re-raised. The reference's conftest guard sees only the reference's
checker, so an autouse fixture here fails a test that ends with a port
lock held and leaves the port's checker disarmed. Tolerance: none.
"""

from __future__ import annotations

import ast
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

sys.path.insert(0, os.path.dirname(__file__))

import torch_twins  # noqa: E402
from tidb_tpu.analysis import lockcheck as ref_lc  # noqa: E402
from tidb_tpu_torch.analysis import engine as port_eng  # noqa: E402
from tidb_tpu_torch.analysis import lockcheck as lc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))


def _load_twins():
    """tests/test_analysis.py as written, and moved to the port: imports
    and tree paths (`torch_twins.port_source`), and the TOML contract's
    aux key."""
    path = os.path.join(TESTS, "test_analysis.py")
    with open(path) as f:
        src = f.read()
    port = torch_twins.port_source(src).replace(
        '"config.toml.example"', repr(port_eng.TOML_CONTRACT))
    return (torch_twins._exec(src, path, "_twin_ref_test_analysis"),
            torch_twins._exec(port, path, "_twin_port_test_analysis"))


REF, PORT = _load_twins()


@pytest.fixture(autouse=True)
def _port_lock_guard():
    """A test that ends with a port lock held fails; the port's checker
    is left disarmed and empty either way."""
    yield
    try:
        if lc.enabled():
            held = lc.held_snapshot()
            deadline = time.monotonic() + 1.0
            while held and time.monotonic() < deadline:
                time.sleep(0.05)
                held = lc.held_snapshot()
            assert not held, \
                f"test ended with instrumented locks still held: {held}"
    finally:
        lc.disable()
        lc.reset()


@pytest.fixture
def checker():
    lc.reset()
    lc.enable()
    yield lc
    lc.disable()
    lc.reset()


# ==================== static half: the synthetic twins ====================

SYNTHETIC = ("test_rule_registry_lints_clean",
             "test_rule_decorator_rejects_bad_metadata",
             "test_baseline_ratchet",
             "test_blocking_call_under_hot_lock",
             "test_lock_order_inversion_static",
             "test_tls_frame_hygiene",
             "test_thread_discipline",
             "test_failpoint_registry",
             "test_bare_except",
             "test_engine_tag_enum",
             "test_metric_families",
             "test_config_knob_drift_synthetic")


def _masked(text: str) -> str:
    return re.sub(r"\btidb_tpu_torch/", "tidb_tpu/", str(text))


def _rows(findings) -> list:
    return [(f.rule, _masked(f.item), f.severity, _masked(f.message))
            for f in findings]


class _RecordingEngine:
    """The module's `eng`, with every run()/check()/lint_rules() result
    and every rule registration's outcome logged in the order the case
    made them."""

    def __init__(self, eng, log: list) -> None:
        self._eng = eng
        self._log = log

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def run(self, *a, **kw):
        out = self._eng.run(*a, **kw)
        self._log.append(("run", _rows(out)))
        return out

    def check(self, *a, **kw):
        new, stale = self._eng.check(*a, **kw)
        self._log.append(("check", _rows(new),
                          sorted(tuple(_masked(x) for x in k)
                                 for k in stale)))
        return new, stale

    def rule(self, *args):
        deco = self._eng.rule(*args)

        def logged(fn):
            try:
                out = deco(fn)
            except Exception as e:
                self._log.append(("rule", args, type(e).__name__,
                                  _masked(e)))
                raise
            self._log.append(("rule", args, None))
            return out
        return logged

    def lint_rules(self, *a, **kw):
        out = self._eng.lint_rules(*a, **kw)
        self._log.append(("lint", out, sorted(self._eng.RULES)))
        return out


def _run_logged(mod, name: str) -> list:
    log: list = []
    saved = mod.eng
    mod.eng = _RecordingEngine(saved, log)
    try:
        getattr(mod, name)()
    finally:
        mod.eng = saved
    return log


@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_case_twin(name):
    """The reference's case on each engine; every result it read equal."""
    want = _run_logged(REF, name)
    got = _run_logged(PORT, name)
    assert got == want
    assert want, "the case read no result"


def test_cli_check_clean_and_torch_free():
    """`python -m tidb_tpu_torch.analysis --check` exits 0 on the real tree
    and the process imports none of torch, jax and the reference."""
    code = (
        "import sys\n"
        "from tidb_tpu_torch.analysis.__main__ import main\n"
        "rc = main(['--check'])\n"
        "bad = [m for m in ('torch', 'jax', 'tidb_tpu') if m in "
        "sys.modules]\n"
        "assert not bad, f'analysis imported {bad}'\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(lc.ENV_VAR, None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis clean: 0 new findings, 1 baselined, 0 stale" \
        in r.stdout


def test_cli_list_names_the_nine_rules():
    r = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.analysis",
                        "--list"], cwd=REPO, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    names = [ln.split()[0] for ln in r.stdout.splitlines()]
    assert names == sorted(REF.eng.RULES) and len(names) == 9


def test_baseline_holds_only_the_promotion_fence():
    """The port's baseline is the reference's one entry, path moved: no
    port-only finding is baselined."""
    ref = REF.eng.load_baseline()
    port = port_eng.load_baseline()
    assert list(port) == [(r, _masked(p).replace("tidb_tpu/",
                                                 "tidb_tpu_torch/"), i)
                          for (r, p, i) in ref]
    assert list(port.values()) == list(ref.values())


def test_tree_is_the_ports_own():
    """The loaded tree holds the port's package, its tests and the smoke
    script, and nothing of the reference; the TOML contract is the port's
    `config.EXAMPLE`."""
    from tidb_tpu_torch import config

    tree = port_eng.SourceTree.load()
    paths = set(tree.files)
    assert "tidb_tpu_torch/store/storage.py" in paths
    assert "tests/test_torch_analysis.py" in paths
    assert "tests/torch_twins.py" in paths
    assert "chip_smoke.py" in paths
    assert not [p for p in paths if p.startswith("tidb_tpu/")
                or p in ("tests/test_analysis.py", "bench.py")]
    assert tree.aux == {port_eng.TOML_CONTRACT: config.EXAMPLE}
    products = {f.path for f in tree.product_files()}
    assert not [p for p in products
                if p.startswith("tidb_tpu_torch/analysis/")]


# ==================== dynamic half ====================

DYNAMIC = ("test_zero_overhead_when_off",
           "test_injected_lock_order_inversion",
           "test_consistent_order_is_clean",
           "test_blocking_under_hot_lock_dynamic",
           "test_rlock_reentrancy_and_cross_thread",
           "test_held_snapshot_mirror",
           "test_inspection_rule_surfaces_cycle",
           "test_instrumented_storage_runs_clean")


@pytest.mark.parametrize("name", DYNAMIC)
def test_dynamic_case_on_the_port(name, tmp_path):
    """The reference's lock-checker case, run on the port's checker."""
    fn = getattr(PORT, name)
    params = list(fn.__code__.co_varnames[:fn.__code__.co_argcount])
    gen = None
    kw = {}
    if "checker" in params:
        gen = torch_twins._fixture_fn(PORT, "checker")()
        kw["checker"] = next(gen)
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path
    try:
        fn(**kw)
    finally:
        if gen is not None:
            for _ in gen:
                pass


def test_factories_give_plain_primitives_when_off():
    """Off (the default), every lock the port makes through the checker's
    factories is a plain `threading` primitive."""
    from tidb_tpu_torch.kv.mvcc import MVCCStore, SyncPolicy
    from tidb_tpu_torch.kv.native import NativeOrderedKV, native_available
    from tidb_tpu_torch.obs_heat import RangeHeatRecorder
    from tidb_tpu_torch.store.storage import Storage

    assert not lc.enabled()
    plain, rplain = type(threading.Lock()), type(threading.RLock())
    st = Storage(device="cpu")
    try:
        assert type(st._commit_lock) is rplain
        assert type(st.infoschema_lock) is rplain
        assert type(st._lease_lock) is plain
        assert type(st.heat._mu) is plain
    finally:
        st.close()
    assert type(MVCCStore()._mu) is rplain
    assert type(SyncPolicy("off", 0, lambda: None)._lock) is plain
    assert type(RangeHeatRecorder()._mu) is plain
    if native_available():
        kv = NativeOrderedKV()
        try:
            assert type(kv._mu) is plain and type(kv._sync_mu) is plain
        finally:
            kv.close()


def _arm_empty(pkg_lc) -> None:
    """Arm one package's checker with an empty graph: `reset()` keeps the
    lock registry (its locks outlive a test), so it is emptied here to
    hold this run's registrations only."""
    pkg_lc.reset()
    with pkg_lc.GRAPH._mu:
        pkg_lc.GRAPH.locks.clear()
    pkg_lc.enable()


def _graph(pkg_lc) -> tuple:
    edges, blocking, locks = pkg_lc.GRAPH.snapshot()
    return locks, set(edges), pkg_lc.find_cycles(), blocking


def _store_workload(root: str, port: bool, maintenance: bool) -> tuple:
    """The durable-store workload (a CREATE TABLE, 5 INSERTs, an UPDATE,
    a read; with `maintenance`, then a maintenance tick and a checkpoint)
    under one package's checker: (locks, edges, cycles, blocking,
    answer)."""
    if port:
        from tidb_tpu_torch.session import Session
        from tidb_tpu_torch.store.storage import Storage
        pkg_lc, kw = lc, {"device": "cpu"}
    else:
        from tidb_tpu.session import Session
        from tidb_tpu.store.storage import Storage
        pkg_lc, kw = ref_lc, {}
    _arm_empty(pkg_lc)
    try:
        st = Storage(root, sync_log="commit", **kw)
        try:
            s = Session(st, **kw)
            s.execute("create table lc (a int primary key, b int)")
            for i in range(5):
                s.execute(f"insert into lc values ({i}, {i * 2})")
            s.execute("update lc set b = b + 1 where a = 2")
            answer = s.query("select sum(b), count(*) from lc")
            if maintenance:
                st.maintenance.tick()
                st.checkpoint()
            return (*_graph(pkg_lc), answer)
        finally:
            st.close()
    finally:
        pkg_lc.disable()
        pkg_lc.reset()


@pytest.mark.parametrize("maintenance", [False, True],
                         ids=["writes", "maintenance"])
def test_store_workload_same_locks_and_edges(tmp_path, maintenance):
    """The same workload on both packages: the same locks, hot flags and
    edges, no cycle and no blocking event on either."""
    ref = _store_workload(str(tmp_path / "ref"), False, maintenance)
    port = _store_workload(str(tmp_path / "port"), True, maintenance)
    assert port[4] == ref[4] == [(21, 5)]
    assert port[0] == ref[0]
    for name in ("Storage._commit_lock", "Storage.infoschema_lock",
                 "MVCCStore._mu"):
        assert port[0][name] is True
    assert port[1] == ref[1]
    assert ("Storage._commit_lock", "MVCCStore._mu") in port[1]
    # the checkpoint takes the native engine's fsync fence under the
    # store mutex, on both packages
    assert (("MVCCStore._mu", "NativeOrderedKV._sync_mu") in port[1]) \
        is maintenance
    assert port[2] == ref[2] == []
    assert port[3] == ref[3] == []


def _range_workload(root: str, port: bool) -> tuple:
    """A range plane of two ranges with an enabled heat recorder:
    cross-range 2PC commits, one split, reads through the router."""
    pkg = "tidb_tpu_torch" if port else "tidb_tpu"
    mods = {n: __import__(f"{pkg}.{n}", fromlist=["x"]) for n in (
        "kv.mvcc", "kv.rangeclient", "kv.rangemeta", "kv.tso", "kv.twopc",
        "obs_heat", "rpc.ranged")}
    pkg_lc = lc if port else ref_lc
    _arm_empty(pkg_lc)
    try:
        heat = mods["obs_heat"].RangeHeatRecorder()
        heat.configure(enabled=True, bucket_seconds=3600)
        srv = mods["rpc.ranged"].RangeServer(
            root, lease_ms=60_000,
            specs=mods["kv.rangemeta"].split_keyspace(2), heat=heat)
        router = None
        try:
            tso = mods["kv.tso"].TimestampOracle()
            router = mods["kv.rangeclient"].RangeRouter(root=root)
            committer = mods["kv.twopc"].TwoPhaseCommitter(router, tso)
            M = mods["kv.mvcc"]

            def commit(pairs):
                committer.commit([M.Mutation(M.OP_PUT, k, v)
                                  for k, v in sorted(pairs.items())],
                                 tso.ts())

            for i in range(12):
                commit({b"k%04d" % i: b"v%d" % i,
                        b"\xf0k%04d" % i: b"w%d" % i})
            srv.split_range(1, b"k0006")
            commit({b"k0001x": b"l", b"k0009x": b"r", b"\xf0z": b"z"})
            snap = mods["kv.twopc"].Snapshot(router, tso, tso.ts())
            answer = (snap.get(b"k0009x"), snap.get(b"\xf0z"),
                      len(snap.scan(b"", b"", -1)), sorted(srv.hosted_ids()))
            return (*_graph(pkg_lc), pkg_lc.findings(), answer)
        finally:
            if router is not None:
                router.close()
            srv.close()
    finally:
        pkg_lc.disable()
        pkg_lc.reset()


def test_range_and_heat_planes_under_the_checker(tmp_path):
    """Cross-range 2PC, one split and the heatmap on, under each package's
    checker: the hot range and heat locks register, the same locks and
    edges on both, and no finding."""
    ref = _range_workload(str(tmp_path / "ref"), port=False)
    port = _range_workload(str(tmp_path / "port"), port=True)
    assert port[5] == ref[5] == (b"r", b"z", 27, [1, 2, 3])
    assert port[0]["RangeServer._mu"] is True
    assert port[0]["RangeHeatRecorder._mu"] is True
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[4] == ref[4] == []


def test_follower_mirror_fsync_outside_hot_locks(checker, tmp_path):
    """A socket follower under sync-log=commit fsyncs its WAL mirror after
    the store mutex and the commit lock are released, before its refresh
    or commit returns: no blocking event under a hot lock (the
    reference's follower fsyncs the mirror under both)."""
    from tidb_tpu_torch.rpc.client import RpcOptions
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import Storage

    checker.disable()
    path = str(tmp_path / "leader")
    st = Storage(path, sync_log="commit", device="cpu")
    Session(st, device="cpu").execute(
        "create table m (id bigint primary key, k bigint)")
    st.close()
    leader = Storage(path, shared=True, rpc_listen="127.0.0.1:0",
                     sync_log="commit", device="cpu")
    fol = None
    try:
        sl = Session(leader, device="cpu")
        checker.enable()
        fol = Storage(str(tmp_path / "follower"),
                      remote=leader.rpc_server.address,
                      rpc_options=RpcOptions(election_timeout_ms=0),
                      sync_log="commit", device="cpu")
        sf = Session(fol, device="cpu")
        eng = fol.kv.kv
        synced = []
        real = eng._fsync_mirror
        eng._mirror_sync._fsync = lambda: (synced.append(1), real())
        sl.execute("insert into m values (1, 10), (2, 20)")
        assert sf.query("select sum(k), count(*) from m") == [(30, 2)]
        assert synced and eng._mirror_pending is False
        n = len(synced)
        sf.execute("update m set k = k + 1 where id = 1")
        assert len(synced) > n and eng._mirror_pending is False
        assert sl.query("select sum(k) from m") == [(31,)]
        edges, blocking, locks = checker.GRAPH.snapshot()
        assert locks["Storage._commit_lock"] is True
        assert blocking == [] and checker.find_cycles() == []
    finally:
        if fol is not None:
            fol.close()
        leader.close()


def test_cycle_surfaces_in_inspection_result_over_sql():
    """An injected inversion, read through information_schema on both
    packages: the same rows."""
    from tidb_tpu.session import Session as RefSession
    from tidb_tpu.store.storage import Storage as RefStorage
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import Storage

    sql = ("select rule, item, severity, value from "
           "information_schema.inspection_result "
           "where rule = 'lock-order-inversion'")
    rows = []
    for pkg_lc, St, Se, kw in ((ref_lc, RefStorage, RefSession, {}),
                               (lc, Storage, Session, {"device": "cpu"})):
        pkg_lc.reset()
        pkg_lc.enable()
        try:
            a = pkg_lc.lock("T.sql_a")
            b = pkg_lc.lock("T.sql_b")
            with a, b:
                pass
            with b, a:
                pass
            st = St(**kw)
            try:
                rows.append(Se(st, **kw).query(sql))
            finally:
                st.close()
        finally:
            pkg_lc.disable()
            pkg_lc.reset()
    assert rows[1] == rows[0]
    assert rows[1] == [("lock-order-inversion", "T.sql_a -> T.sql_b -> "
                        "T.sql_a", "critical", "cycle")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(port: int, route: str) -> tuple:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_lockgraph_route_on_an_armed_cpu_server(checker, tmp_path):
    """A server over a store made with the checker armed: /debug/lockgraph
    answers 200 with the reference's keys and the store's hot locks;
    /debug/mesh answers 200 (the mesh plane is ported)."""
    from mysql_client import MiniClient
    from tidb_tpu_torch.server.server import Server
    from tidb_tpu_torch.store.storage import Storage

    st = Storage(str(tmp_path / "db"), sync_log="commit", device="cpu")
    srv = Server(st, port=0, device="cpu", status_port=0)
    try:
        srv.start()
        c = MiniClient("127.0.0.1", srv.port)
        try:
            c.query("create table g (a int primary key)")
            c.query("insert into g values (1), (2)")
            assert c.query("select count(*) from g") == [("2",)]
        finally:
            c.close()
        code, payload = _get_json(srv.status_port, "/debug/lockgraph")
        assert code == 200
        assert sorted(payload) == ["blocking", "cycles", "edges",
                                   "enabled", "held", "locks"]
        assert payload["enabled"] is True
        hot = {x["name"] for x in payload["locks"] if x["hot"]}
        assert {"Storage._commit_lock", "Storage.infoschema_lock",
                "MVCCStore._mu"} <= hot
        assert payload["cycles"] == [] and payload["blocking"] == []
        assert payload["edges"]
        assert _get_json(srv.status_port, "/debug/mesh")[0] == 200
    finally:
        srv.close()
        st.close()


def test_lock_check_knob_arms_a_server_process(tmp_path):
    """`[analysis] lock-check = true` starts `python -m
    tidb_tpu_torch.server` (no NotInSlice) with every lock instrumented
    from start-up: /debug/lockgraph reports the armed store's hot locks,
    no cycle and no blocking event after writes and reads."""
    from mysql_client import MiniClient

    cfg = tmp_path / "c.toml"
    cfg.write_text('host = "127.0.0.1"\n[analysis]\nlock-check = true\n')
    status = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(lc.ENV_VAR, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.server", "--device", "cpu",
         "-P", "0", "--config", str(cfg), "--path", str(tmp_path / "db"),
         "--status", str(status)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("tidb-tpu-server listening on"), \
            line + (proc.stderr.read() if proc.poll() is not None else "")
        c = MiniClient("127.0.0.1", int(line.strip().rsplit(":", 1)[1]))
        try:
            c.query("create table k (a int primary key, b int)")
            c.query("insert into k values (1, 2), (3, 4)")
            c.query("update k set b = b + 1 where a = 1")
            assert c.query("select sum(b) from k") == [("7",)]
            assert c.query(
                "select * from information_schema.inspection_result "
                "where rule = 'lock-order-inversion'") == []
        finally:
            c.close()
        code, payload = _get_json(status, "/debug/lockgraph")
        assert code == 200 and payload["enabled"] is True
        locks = {x["name"]: x["hot"] for x in payload["locks"]}
        assert locks["Storage._commit_lock"] is True
        assert locks["MVCCStore._mu"] is True
        assert payload["cycles"] == [] and payload["blocking"] == []
    finally:
        proc.terminate()
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
            proc.stderr.close()
    assert rc == 0


# ==================== native half ====================

def test_sanitize_selects_the_asan_build_and_needs_the_preload(
        monkeypatch):
    """TIDB_TPU_NATIVE_SANITIZE=1 picks build/native/libtidbkv_asan.so;
    without libasan in the process the load fails typed, before any build
    (an ASan object dlopen'ed without its runtime ends the process)."""
    from tidb_tpu_torch.kv import native

    assert native._SO_ASAN == native.BUILD_DIR / "libtidbkv_asan.so"
    assert "-fsanitize=address,undefined" in native.SAN_FLAGS
    assert "-fno-sanitize-recover=undefined" in native.SAN_FLAGS
    for off in ("", "0", "false", "off"):
        monkeypatch.setenv(native.SANITIZE_ENV, off)
        assert not native._sanitize_requested()
    monkeypatch.setenv(native.SANITIZE_ENV, "1")
    assert native._sanitize_requested()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_asan_preloaded", lambda: False)
    built = []
    monkeypatch.setattr(native, "_build", lambda *a: built.append(a))
    with pytest.raises(native.NativeUnavailable,
                       match="ASan runtime must be preloaded"):
        native._load()
    assert built == []


_ASAN_CHILD = r"""
import tempfile, threading
from tidb_tpu_torch.kv import native
assert native._sanitize_requested()
kv = native.NativeOrderedKV(tempfile.mkdtemp(), sync_log="commit")
assert native._lib._name.endswith("libtidbkv_asan.so")
errors = []
def writer(i):
    try:
        for n in range(200):
            kv.put(0, b"k%d-%d" % (i, n), b"v" * 128)
            if n % 3 == 0:
                kv.delete(0, b"k%d-%d" % (i, n))
            kv.commit_sync()
    except Exception as e:
        errors.append(e)
def churner():
    try:
        for _ in range(20):
            kv.checkpoint()
            list(kv.scan(0, b"", b"\xff", limit=50))
    except Exception as e:
        errors.append(e)
threads = [threading.Thread(target=writer, args=(i,), name=f"titpu-w{i}")
           for i in range(4)]
threads.append(threading.Thread(target=churner, name="titpu-churn"))
for t in threads: t.start()
for t in threads: t.join()
assert not errors, errors
kv.close()
print("TORTURE_OK")
"""


@pytest.mark.slow
def test_native_sanitizer_group_fsync_torture():
    """The port's engine built under ASan/UBSan (through the port's own
    build, `TIDB_TPU_NATIVE_SANITIZE=1`), driven by the group-fsync
    workload: concurrent writers on commit_sync plus checkpoint and scan
    churn. Any error the sanitizers see fails the run."""
    gcc = subprocess.run(["gcc", "-print-file-name=libasan.so"],
                         capture_output=True, text=True)
    libasan = gcc.stdout.strip()
    if gcc.returncode != 0 or not os.path.isfile(libasan):
        pytest.skip("libasan not available")
    env = dict(os.environ, PYTHONPATH=REPO, LD_PRELOAD=libasan,
               TIDB_TPU_NATIVE_SANITIZE="1",
               # the interpreter never frees everything at exit; leaks
               # are not what this test hunts
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1")
    r = subprocess.run([sys.executable, "-c", _ASAN_CHILD],
                       capture_output=True, text=True, timeout=600,
                       env=env, cwd=REPO)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "TORTURE_OK" in r.stdout
    assert "AddressSanitizer" not in out
    assert "runtime error" not in out  # UBSan's report prefix


# ==================== the repairs ====================

def _literal_inject_sites(path: str) -> list:
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    return sorted(
        n.args[0].value for n in ast.walk(tree)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "inject" and n.args
        and isinstance(n.args[0], ast.Constant))


@pytest.mark.parametrize("kind", ("net/delay", "net/drop", "net/dup",
                                  "net/partition"))
def test_each_net_kind_has_a_literal_inject_site_that_fires(kind):
    """One literal `failpoint.inject("net/<kind>")` per kind (the
    failpoint-registry rule reads them), and an armed schedule is read
    through it."""
    from tidb_tpu_torch.rpc import netfault
    from tidb_tpu_torch.util import failpoint

    sites = _literal_inject_sites("tidb_tpu_torch/rpc/netfault.py")
    assert sites == sorted(netfault.KINDS)
    try:
        netfault.arm(kind, peer="nowhere", ms=1)
        before = failpoint.hits(kind)
        assert netfault._schedule(kind) == [{"peer": "nowhere", "ms": 1}]
        assert failpoint.hits(kind) == before + 1
    finally:
        netfault.heal()
    assert netfault._schedule(kind) == []


class _Foreign(Exception):
    """Stands for an error the diagnostics plane has no business
    surviving (a torch or CUDA error, a bug)."""


def test_foreign_error_in_diag_fanout_is_reraised(monkeypatch):
    """A member fetch that fails with a foreign error is kept and re-raised
    by the fan-out after the join; a survivable one stays an error row."""
    from tidb_tpu_torch.rpc import diag
    from tidb_tpu_torch.rpc.errors import RPCError
    from tidb_tpu_torch.store.storage import Storage

    st = Storage(device="cpu")
    try:
        tname = sorted(diag.TABLE_METHODS)[0]

        def foreign(*a, **kw):
            raise _Foreign("fan-out")

        monkeypatch.setattr(diag, "_call_member", foreign)
        with pytest.raises(_Foreign, match="fan-out"):
            diag.cluster_rows(st, tname, 4)

        def survivable(*a, **kw):
            raise RPCError("peer gone")

        monkeypatch.setattr(diag, "_call_member", survivable)
        rows = diag.cluster_rows(st, tname, 4)
        assert rows and all("peer gone" in r[-1] for r in rows)
    finally:
        st.close()
