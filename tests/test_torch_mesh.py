"""The port's mesh plane on 8 `cpu` shard slots against the reference's on
8 virtual CPU devices (tests/conftest.py), on the same seeded data.

Counterparts of tests/test_mesh.py, tests/test_parallel.py and
tests/test_device_path_lint.py::test_device_path_mesh: the rows of every
statement equal the reference mesh's, the reference's single device's and
the port's single device's; the engine tags (`@mesh8`) and the EXPLAIN
ANALYZE `mesh` cells (per-shard rows, skew, routed bytes) equal the
reference's. Where the reference inspects `arr.sharding` /
`addressable_shards`, the port's slot tensors are inspected instead: a
sharded tensor splits into 8 slot chunks of a multiple of 8 rows. Also
held: bench/tpch.py's arrays and texts against the reference's, the
process plane on this host (no card: inactive, a plain client), a `cpu`
session against a `cuda` plane (a plain `cpu` client), an error in one
slot (the statement fails with it, every slot thread ends, nothing reruns
on one device), `[mesh]` and its seed. Tolerance: none.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from torch_mesh_pairs import (
    CPU8,
    explain,
    q,
    lineitem_pair,
    port_plane,
    port_single,
    stages,
    tpch_pair,
)
from tidb_tpu import obs as RO
from tidb_tpu.bench import tpch as RT
from tidb_tpu_torch import obs as PO
from tidb_tpu_torch.bench import tpch as PT
from tidb_tpu_torch.copr import mesh as PM
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.parallel import dist as PD
from tidb_tpu_torch.session import Session

N_ROWS = 20_000

TOPN_SQL = ("SELECT l_orderkey, l_extendedprice FROM lineitem "
            "ORDER BY l_extendedprice DESC, l_orderkey LIMIT 7")
ROWS_SQL = ("SELECT l_orderkey, l_quantity FROM lineitem "
            "WHERE l_quantity < 5.00 ORDER BY l_orderkey, l_quantity")
LINT = ("q3", "q5", "q10", "q12", "q7", "q8")


@pytest.fixture(scope="module")
def li():
    return lineitem_pair(N_ROWS)


@pytest.fixture(scope="module")
def corpus():
    return tpch_pair(0.01, 29)


def sharded(client) -> list:
    with client._lock:
        vals = list(client._col_cache.values()) \
            + list(client._mask_cache.values())
    return [t for t in PM._walk_arrays(vals)
            if PD.placement_of(t) == "shard"]


def _same(ref, port, sql):
    """Rows equal on the four sessions; tags and mesh cells equal on the
    two meshes."""
    got = q(port.mesh, sql)
    assert got == q(ref.mesh, sql), sql
    assert got == q(port.single, sql) == q(ref.single, sql), sql
    assert explain(port.mesh, sql) == explain(ref.mesh, sql), sql


# ==================== bench/tpch.py ====================

def test_tpch_module_twin():
    for n, seed in ((4096, 42), (N_ROWS, 7)):
        a = RT.generate_lineitem_arrays(n, seed)
        b = PT.generate_lineitem_arrays(n, seed)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert (RT.LINEITEM_DDL, RT.TPCH_Q1, RT.TPCH_Q6, RT.ROWS_PER_SF) == \
        (PT.LINEITEM_DDL, PT.TPCH_Q1, PT.TPCH_Q6, PT.ROWS_PER_SF)
    assert PT.lineitem_ddl() == RT.lineitem_ddl()


def test_tpch_q1_q6_through_both_packages(li):
    ref, port = li
    for sql in (PT.TPCH_Q1, PT.TPCH_Q6):
        assert q(port.single, sql) == q(ref.single, sql)


# ==================== bit-identical answers ====================

def test_scan_agg(li):
    ref, port = li
    for sql in (PT.TPCH_Q6, PT.TPCH_Q1,
                "select count(*), sum(l_quantity) from lineitem"):
        _same(ref, port, sql)
    assert any("@mesh8" in e for e, _ in explain(port.mesh, PT.TPCH_Q6))


def test_topn_and_rows(li):
    ref, port = li
    for sql in (TOPN_SQL, ROWS_SQL):
        _same(ref, port, sql)


@pytest.mark.parametrize("qname", LINT)
def test_device_path_mesh(corpus, qname):
    """The lint set end to end on the mesh: every coprocessor read tagged
    device...@mesh8 as the reference's, a `mesh` cell on each, no
    host_fallback stage, rows equal."""
    from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
    ref, port = corpus
    sql = TPCH_QUERIES[qname]
    _same(ref, port, sql)
    cells = explain(port.mesh, sql)
    assert cells and all(e.startswith("device") and "@mesh8" in e
                         for e, _ in cells), cells
    assert all(m for _, m in cells), cells
    assert "host_fallback" not in stages(port.mesh, sql)


# ==================== sharded residency ====================

def test_epochs_sharded_across_all_slots(li):
    _, port = li
    port.mesh.query(PT.TPCH_Q6)
    arrs = sharded(port.mesh.cop)
    assert arrs, "no sharded epoch tensors resident"
    for t in arrs:
        assert t.shape[0] % (8 * 8) == 0, t.shape
        chunks = PD._split_for_slot(PD.P(PD.AXIS), t, 3, 8, t.device)
        assert chunks.shape[0] == t.shape[0] // 8
        # a view of the placed tensor when the slots share a device
        assert chunks.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()


def test_residency_persists_across_queries(li):
    _, port = li
    port.mesh.query(PT.TPCH_Q6)
    before = PO.DEVICE_TRANSFER_BYTES.get()
    port.mesh.query(PT.TPCH_Q6)
    assert PO.DEVICE_TRANSFER_BYTES.get() == before


def test_shard_stage_attributed():
    p = port_single()
    PT.load_lineitem(p, 4096)
    mesh = Session(p.storage, cop=port_plane().client_for(p.storage),
                   device="cpu")
    mesh.query(PT.TPCH_Q6)
    assert "shard" in mesh.last_stages, mesh.last_stages


def test_placement_report_and_gauges():
    """Fresh planes, one Q6 each: the same per-device bytes, sharded
    tensor counts and spec as the reference's report."""
    ref, port = lineitem_pair(4096)
    reps = []
    for side, M in ((ref, __import__("tidb_tpu.copr.mesh",
                                      fromlist=["m"])), (port, PM)):
        side.mesh.query(PT.TPCH_Q6)
        reps.append(M.placement_report(side.mesh.cop))
    r, p = reps
    assert sorted(p["device_bytes"].values()) == \
        sorted(r["device_bytes"].values())
    assert len(p["device_bytes"]) == 8 and \
        all(b > 0 for b in p["device_bytes"].values())
    assert (p["sharded_arrays"], p["replicated_arrays"],
            p["single_arrays"], p["shard_spec"]) == \
        (r["sharded_arrays"], r["replicated_arrays"],
         r["single_arrays"], r["shard_spec"])
    per = port.plane.device_bytes()
    assert len(per) == 8 and sum(per.values()) > 0


# ==================== joins: broadcast and partitioned builds ========

def test_small_builds_replicate(corpus):
    from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
    _, port = corpus
    base = PO.MESH_RESHARD_BYTES.get()
    fresh = Session(port.single.storage,
                    cop=port_plane().client_for(port.single.storage),
                    device="cpu")
    fresh.query(TPCH_QUERIES["q5"])
    with fresh.cop._lock:
        vals = list(fresh.cop._col_cache.values())
    reps = [t for t in PM._walk_arrays(vals)
            if PD.placement_of(t) == "rep"]
    assert reps, "no replicated build tensors resident"
    assert PO.MESH_RESHARD_BYTES.get() > base


def test_build_and_probe_placements_do_not_alias(corpus):
    from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
    ref, port = corpus
    port.mesh.query(TPCH_QUERIES["q12"])  # orders is a broadcast build
    sql = ("SELECT o_orderstatus, COUNT(*) FROM orders "
           "GROUP BY o_orderstatus ORDER BY o_orderstatus")
    _same(ref, port, sql)
    orders = next(st for st in port.single.storage.tables.values()
                  if st.table.name == "orders")
    eid = orders.epoch.epoch_id
    cop = port.mesh.cop
    with cop._lock:
        rep_keys = [k for k in cop._col_cache
                    if k[0] == eid and k[-1] == "rep"]
        plain = [v for k, v in cop._col_cache.items()
                 if k[0] == eid and len(k) == 3 and isinstance(k[1], int)]
    assert rep_keys, "replicated build staging keys missing"
    assert [t for t in PM._walk_arrays(plain)
            if PD.placement_of(t) == "shard"], \
        "solo scan of a build table must stay sharded"


def test_oversize_build_partitions(corpus):
    from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
    ref, port = corpus
    sql = TPCH_QUERIES["q12"]
    rp = ref.session(__import__("torch_mesh_pairs").ref_plane(
        replicate_threshold_bytes=1))
    pp = port.session(port_plane(replicate_threshold_bytes=1))
    assert q(pp, sql) == q(rp, sql) == q(port.single, sql)
    assert explain(pp, sql) == explain(rp, sql)
    assert any("partb" in str(k) for k in pp.cop._col_cache)


# ==================== invalidation ====================

def _refs_epoch(key, eid) -> bool:
    return any(p == eid for p in key if isinstance(p, int))


def test_dml_changes_results_and_fold_evicts():
    ref, port = lineitem_pair(4096)
    counts = []
    for side in (ref, port):
        n0 = side.mesh.query("select count(*) from lineitem")[0][0]
        side.mesh.execute("delete from lineitem where l_orderkey = 1")
        n1 = side.mesh.query("select count(*) from lineitem")[0][0]
        counts.append((n0, n1,
                       q(side.single, "select count(*) from lineitem")))
    assert counts[0] == counts[1] and counts[1][1] < counts[1][0] == 4096
    store = next(iter(port.single.storage.tables.values()))
    old = store.epoch.epoch_id
    cop = port.mesh.cop
    with cop._lock:
        assert any(_refs_epoch(k, old) for k in cop._col_cache)
    store.compact(port.single.storage.safe_ts())
    assert store.epoch.epoch_id != old
    with cop._lock:
        stale = [k for k in list(cop._col_cache) + list(cop._mask_cache)
                 if _refs_epoch(k, old)]
    assert not stale, stale
    assert port.mesh.query("select count(*) from lineitem")[0][0] == \
        counts[1][1]


def test_truncate_partition_keeps_epoch_listeners():
    s = Session(cop=CopClient("cpu"), device="cpu")
    mc = port_plane().client_for(s.storage)
    s.execute("CREATE TABLE pt (a INT NOT NULL PRIMARY KEY) "
              "PARTITION BY HASH(a) PARTITIONS 2")
    s.execute("INSERT INTO pt VALUES (1),(2),(3),(4)")
    s.execute("ALTER TABLE pt TRUNCATE PARTITION p0")
    for st in s.storage.tables.values():
        assert mc.on_epoch_replaced in st.evict_hooks, st.table.name


# ==================== the single-device path ====================

def test_disabled_plane_hands_out_plain_client():
    assert not port_plane(enabled=False).active
    old = PM.get_plane().cfg
    try:
        PM.configure(enabled=False)
        assert type(Session(device="cpu").cop) is CopClient
    finally:
        PM.configure(**dataclasses.asdict(old))


def test_single_axis_inactive():
    assert not port_plane(axis_size=1).active
    plane = PM.MeshPlane(PM.MeshConfig(axis_size=8),
                         devices=[torch.device("cpu")])
    # one device: `axis_size` slots on it
    assert plane.active and plane.mesh.devices == CPU8
    # a longer slot list is cut as the reference cuts its devices
    for k, n in ((4, 4), (16, 8), (0, 8)):
        plane = PM.MeshPlane(PM.MeshConfig(axis_size=k), devices=CPU8)
        assert plane.mesh.devices == CPU8[:n]


def test_slots_on_two_physical_devices_are_refused():
    """Slots on more than one physical device raise NotInSlice when the
    mesh is built (the multi-card path is not ported): the plane never
    reports itself active and hands out no client."""
    from tidb_tpu_torch.errors import NotInSlice
    for devs in ([torch.device("cpu"), torch.device("meta")],
                 [torch.device("cpu")] * 4 + [torch.device("meta")] * 4):
        plane = PM.MeshPlane(PM.MeshConfig(), devices=devs)
        with pytest.raises(NotInSlice, match="more than one physical"):
            _ = plane.active
        assert not plane.mesh_built and not plane.clients()


def test_process_plane_defaults_to_one_card(monkeypatch):
    """On a host with four cards the process plane's slot list is the
    first card: inactive by default, `axis_size` slots on cuda:0 when
    asked, never slots spread over the cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda0 = torch.device("cuda", 0)
    assert PD.default_devices() == [cuda0]
    assert not PM.MeshPlane(PM.MeshConfig()).active
    plane = PM.MeshPlane(PM.MeshConfig(axis_size=4))
    assert plane.active and plane.mesh.devices == [cuda0] * 4
    assert plane.device == cuda0


def test_session_on_another_card_gets_plain_client(monkeypatch):
    """A plane of slots on cuda:0 hands a session on cuda:1 a plain
    client of its own card, never the cuda:0 mesh client."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    plane = PM.MeshPlane(PM.MeshConfig(),
                         devices=[torch.device("cuda", 0)] * 8)
    monkeypatch.setattr(PM, "_PLANE", plane)
    made = []
    monkeypatch.setattr(PM, "CopClient",
                        lambda d: made.append(d) or CopClient("cpu"))
    storage = Session(device="cpu").storage
    PM.client_for(storage, torch.device("cuda", 1))
    assert made == [torch.device("cuda", 1)] and not plane.clients()
    shared = object()
    monkeypatch.setattr(plane, "client_for", lambda st: shared)
    assert PM.client_for(storage, torch.device("cuda", 0)) is shared


def test_below_threshold_single_device_exact():
    p = port_single()
    PT.load_lineitem(p, 2048)
    mesh = Session(p.storage, cop=port_plane(
        shard_threshold_rows=1 << 20).client_for(p.storage), device="cpu")
    assert q(mesh, PT.TPCH_Q6) == q(p, PT.TPCH_Q6)
    assert not sharded(mesh.cop)
    eng = explain(mesh, PT.TPCH_Q6)
    assert eng and all("@mesh" not in e for e, _ in eng)


def test_default_session_on_this_host_gets_plain_client():
    """Without a card the process plane has no slot: every Session gets
    its own plain client (the reference's 8 virtual devices give it a
    shared mesh client)."""
    s1 = Session(device="cpu")
    s2 = Session(s1.storage, device="cpu")
    assert not PM.get_plane().active
    assert type(s1.cop) is CopClient and s1.cop is not s2.cop


def test_cpu_session_gets_no_cuda_client(monkeypatch):
    """A plane of `cuda` slots hands a `cpu` session a plain client of its
    own device, never the card's mesh client."""
    plane = PM.MeshPlane(PM.MeshConfig(),
                         devices=[torch.device("cuda", 0)] * 8)
    monkeypatch.setattr(PM, "_PLANE", plane)
    assert plane.active and plane.device_type == "cuda"
    s = Session(device="cpu")
    assert type(s.cop) is CopClient and s.cop.device.type == "cpu"
    assert not plane.clients()


# ==================== one slot fails ====================

def test_error_in_one_slot_fails_the_statement(li, monkeypatch):
    """An error raised in slot 5 fails the statement with that error,
    and every slot thread of the mesh has ended when it does; the barrier
    is aborted, nothing reruns on one device, and the next statement
    starts new slot threads and runs clean."""
    _, port = li
    from tidb_tpu_torch.copr import client as PC
    real = PC.agg_partials
    calls = []

    class SlotFault(RuntimeError):
        pass

    def faulty(*a, **kw):
        calls.append(threading.current_thread().name)
        if PD.axis_index(PD.AXIS) == 5:
            raise SlotFault("injected in slot 5")
        return real(*a, **kw)

    sql = "select count(*), sum(l_quantity) from lineitem"
    port.mesh.query(sql)  # the mesh's slot threads are up
    mesh = port.plane.mesh
    threads = list(mesh._pool._threads)
    assert all(t.is_alive() for t in threads)
    monkeypatch.setattr(PC, "agg_partials", faulty)
    with pytest.raises(SlotFault, match="slot 5"):
        port.mesh.query(sql)
    # the slots take turns in slot order: 6 and 7 never start their body
    assert calls == [f"titpu-slot-{i}" for i in range(6)]
    assert not any(t.is_alive() for t in threads) and mesh._pool is None
    monkeypatch.undo()
    assert q(port.mesh, sql) == q(port.single, sql)
    mesh.close()
    assert mesh._pool is None


def test_dispatches_on_one_mesh_take_turns(li):
    """The shared client serves concurrent sessions: dispatches from 4
    threads on one mesh each get their own answer (the slot threads run
    one dispatch at a time)."""
    _, port = li
    sqls = [f"select count(*), sum(l_quantity) from lineitem "
            f"where l_orderkey > {k}" for k in (10, 2000, 4000, 4500)]
    want = {sql: q(port.single, sql) for sql in sqls}
    got: dict = {}

    def run(sql):
        s = Session(port.single.storage, cop=port.mesh.cop, device="cpu")
        got[sql] = [q(s, sql) for _ in range(3)]

    ts = [threading.Thread(target=run, args=(sql,)) for sql in sqls]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert got == {sql: [w] * 3 for sql, w in want.items()}


def test_collectives_need_a_slot_program():
    with pytest.raises(RuntimeError, match="outside a slot program"):
        PD.psum(torch.zeros(1), PD.AXIS)


# ==================== parallel/dist.py (tests/test_parallel.py) ======

@pytest.fixture(scope="module")
def dist(li):
    ref, port = li
    from tidb_tpu.parallel import DistCopClient as RDist
    from tidb_tpu.parallel import make_mesh as rmake
    from tidb_tpu_torch.parallel import DistCopClient, make_mesh
    rs = type(ref.single)(ref.single.storage, cop=RDist(rmake()))
    ps = Session(port.single.storage, cop=DistCopClient(make_mesh(CPU8)),
                 device="cpu")
    return ref, port, rs, ps


def test_dist_sharded_agg(dist):
    ref, port, rs, ps = dist
    for sql in (PT.TPCH_Q6, PT.TPCH_Q1, "select count(*) from lineitem"):
        assert q(ps, sql) == q(rs, sql) == q(port.single, sql)
    assert len(ps.query(PT.TPCH_Q1)) >= 4


def test_dist_mvcc_overlay(dist):
    ref, port, rs, ps = dist
    ins = ("insert into lineitem values (999999, 1, 1, 1, 10.00, 1000.00, "
           "0.05, 0.02, 'N', 'O', '1998-01-01', '1998-01-10', "
           "'1998-01-20')")
    got = []
    for s in (rs, ps):
        s.execute(ins)
        got.append(q(s, "select count(*), sum(l_quantity) "
                        "from lineitem"))
    assert got[0] == got[1] and got[1][0][0] == N_ROWS + 1


def _small(pkg_session, ddl_rows):
    s = pkg_session
    for sql in ddl_rows:
        s.execute(sql)
    safe = s.storage.safe_ts()
    for st in s.storage.tables.values():
        st.compact(safe)
    return s


def test_dist_fragment_join_agg_device_path(monkeypatch):
    from tidb_tpu.copr.client import CopClient as RCop
    from tidb_tpu.parallel import DistCopClient as RDist
    from tidb_tpu.parallel import make_mesh as rmake
    from tidb_tpu.session import Session as RSession
    from tidb_tpu_torch.copr import fragment as F
    from tidb_tpu_torch.parallel import DistCopClient, make_mesh
    rows = ",".join(f"({i},{(i % 3) + 1},{i % 40}.50)" for i in range(900))
    ddl = ["CREATE TABLE d (k INT NOT NULL PRIMARY KEY, g VARCHAR(4))",
           "CREATE TABLE f (id INT NOT NULL PRIMARY KEY, k INT, "
           "v DECIMAL(8,2))",
           "INSERT INTO d VALUES (1,'a'),(2,'b'),(3,'a')",
           "INSERT INTO f VALUES " + rows]
    r = _small(RSession(cop=RCop()), ddl)
    p = _small(Session(cop=CopClient("cpu"), device="cpu"), ddl)
    sql = ("SELECT g, SUM(v), COUNT(*), MIN(v), MAX(v) FROM f, d "
           "WHERE f.k = d.k GROUP BY g ORDER BY g")

    def boom(frag, snaps):
        raise AssertionError("host fragment fallback under mesh")

    monkeypatch.setattr(F, "_host_fragment", boom)
    got = q(Session(p.storage, cop=DistCopClient(make_mesh(CPU8)),
                    device="cpu"), sql)
    monkeypatch.undo()
    assert got == q(RSession(r.storage, cop=RDist(rmake())), sql) == \
        q(p, sql)


def test_dist_topn_and_rows():
    from tidb_tpu.copr.client import CopClient as RCop
    from tidb_tpu.parallel import DistCopClient as RDist
    from tidb_tpu.parallel import make_mesh as rmake
    from tidb_tpu.session import Session as RSession
    from tidb_tpu_torch.parallel import DistCopClient, make_mesh
    rows = ",".join(f"({i},{(i * 37) % 1000})" for i in range(2000))
    ddl = ["CREATE TABLE s (a INT NOT NULL PRIMARY KEY, b INT)",
           "INSERT INTO s VALUES " + rows]
    r = _small(RSession(cop=RCop()), ddl)
    p = _small(Session(cop=CopClient("cpu"), device="cpu"), ddl)
    rd = RSession(r.storage, cop=RDist(rmake()))
    pd = Session(p.storage, cop=DistCopClient(make_mesh(CPU8)),
                 device="cpu")
    for sql in ("SELECT a, b FROM s ORDER BY b DESC, a LIMIT 9",
                "SELECT a FROM s WHERE b < 50 ORDER BY a"):
        assert q(pd, sql) == q(rd, sql) == q(p, sql), sql


# ==================== [mesh] ====================

def test_mesh_section_and_seed(tmp_path):
    from tidb_tpu_torch.config import Config, ConfigError, MeshSection
    p = tmp_path / "c.toml"
    p.write_text("[mesh]\nenabled = false\naxis-size = 4\n"
                 "shard-threshold-rows = 123\n"
                 "replicate-threshold-bytes = 456\n")
    cfg = Config.load(str(p))
    cfg.validate()
    assert (cfg.mesh.enabled, cfg.mesh.axis_size,
            cfg.mesh.shard_threshold_rows,
            cfg.mesh.replicate_threshold_bytes) == (False, 4, 123, 456)
    old = PM.get_plane().cfg
    try:
        cfg.seed_mesh()
        assert PM.get_plane().cfg == PM.MeshConfig(
            enabled=False, axis_size=4, shard_threshold_rows=123,
            replicate_threshold_bytes=456)
        assert PM.status()["enabled"] is False
    finally:
        PM.configure(**dataclasses.asdict(old))
    p.write_text("[mesh]\naxis-size = -1\n")
    with pytest.raises(ConfigError):
        Config.load(str(p)).validate()
    mirror = {(f.name, f.default) for f in dataclasses.fields(MeshSection)}
    owner = {(f.name, f.default)
             for f in dataclasses.fields(PM.MeshConfig)}
    assert mirror == owner


def test_env_knobs_match_reference(monkeypatch):
    from tidb_tpu.copr import mesh as RM
    for k, v in (("TIDB_TPU_MESH", "0"), ("TIDB_TPU_MESH_DEVICES", "4"),
                 ("TIDB_TPU_MESH_SHARD_ROWS", "99"),
                 ("TIDB_TPU_MESH_SKEW_RATIO", "2.5"),
                 ("TIDB_TPU_MESH_RING_CAP", "x")):
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(PM._env_config()) == \
        dataclasses.asdict(RM._env_config())
    assert RO.MESH_DEVICES.name == PO.MESH_DEVICES.name
