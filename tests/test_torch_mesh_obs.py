"""The port's mesh flight recorder against the reference's, on 8 `cpu`
shard slots and 8 virtual CPU devices (tests/conftest.py).

Counterparts of tests/test_mesh_obs.py and of the mesh-rule cases of
tests/test_inspection.py, each run on both packages over the same seeded
data: the EXPLAIN ANALYZE `mesh` cells, the skew warnings and events
(under the `mesh/skew` failpoint and a natural hot range), the slow log's
`mesh_skew` and Top SQL's `max_shard_share`, the rows of
`tidb_mesh_shards` and `tidb_mesh_storage` and their cluster twins (plan
digests and device names masked), the inspection findings of
mesh-shard-skew, mesh-recompile-storm and mesh-hbm-watermark, and the
/debug/mesh payload. The port's own surfaces where the reference's read
JAX: per-slot popcounts of a concatenated bitmask, the watermark per
physical device (the `cpu` device under 8 slots, where the reference
counts 8 devices), and a scrape that never builds a mesh. Tolerance:
none.
"""

from __future__ import annotations

import json
import re
import threading
import time
import types

import numpy as np
import pytest

from torch_mesh_pairs import (
    Side,
    lineitem_pair,
    mask_devices,
    port_plane,
    port_single,
    q,
    ref_plane,
    ref_single,
)
from tidb_tpu import obs as RO
from tidb_tpu import obs_inspect as RI
from tidb_tpu.copr import mesh as RM
from tidb_tpu.util import failpoint as RF
from tidb_tpu_torch import obs as PO
from tidb_tpu_torch import obs_inspect as PI
from tidb_tpu_torch.bench.tpch import TPCH_Q6, load_lineitem
from tidb_tpu_torch.copr import mesh as PM
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.util import failpoint as PF

N_ROWS = 20_000

JOIN_SQL = ("select dim.tag, sum(fact.v) from fact join dim "
            "on fact.k = dim.k group by dim.tag order by dim.tag")
HOT_SQL = ("select count(*), sum(l_quantity) from lineitem "
           "where l_orderkey <= 500")
RESULT_SQL = ("select rule, item, severity, value, reference, details "
              "from information_schema.inspection_result")
MESH_CELL = re.compile(r"^shards=(\d+) skew=(\d+\.\d+) "
                       r"rows=\[(-?\d+(,-?\d+)*)?\]")
_HEX = re.compile(r"\b[0-9a-f]{16}\b")


def masked(v):
    """Device names and 16-hex plan digests masked (the port keys its
    digests on the plan identity alone, the reference adds its resolved
    payload signature)."""
    v = mask_devices(v)
    if isinstance(v, str):
        return _HEX.sub("<digest>", v)
    if isinstance(v, (list, tuple)):
        return type(v)(masked(x) for x in v)
    if isinstance(v, dict):
        return {k: masked(x) for k, x in v.items()}
    return v


def mesh_cells(session, sql):
    return [r[5] for r in session.execute("EXPLAIN ANALYZE " + sql).rows
            if r[5]]


def _join_side(pkg: str, **plane_kw) -> Side:
    single = ref_single() if pkg == "ref" else port_single()
    single.execute("create table dim (k int not null primary key, "
                   "tag varchar(8) not null)")
    single.execute("create table fact (id int not null primary key, "
                   "k int not null, v int not null)")
    single.execute("insert into dim values (1,'a'),(2,'b'),(3,'c')")
    vals = ",".join(f"({i},{i % 3 + 1},{i % 100})" for i in range(1, 6001))
    single.execute(f"insert into fact values {vals}")
    single.storage.flush()
    plane = ref_plane(**plane_kw) if pkg == "ref" else port_plane(**plane_kw)
    return Side(pkg, single, plane)


@pytest.fixture(scope="module")
def li():
    return lineitem_pair(N_ROWS)


@pytest.fixture(scope="module")
def joins():
    return _join_side("ref"), _join_side("port")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    RF.disable_all()
    PF.disable_all()


# ==================== EXPLAIN ANALYZE mesh column ====================

def test_sharded_scan_and_join_cells(li, joins):
    for (ref, port), sql in ((li, TPCH_Q6), (joins, JOIN_SQL)):
        assert q(port.mesh, sql) == q(ref.mesh, sql)
        got = mesh_cells(port.mesh, sql)
        assert got and got == mesh_cells(ref.mesh, sql), sql
        m = MESH_CELL.match(got[0])
        assert m and int(m.group(1)) == 8
        assert len(m.group(3).split(",")) == 8
    ref, port = li
    want = port.single.query(
        "select count(*) from lineitem where "
        "l_shipdate >= date '1994-01-01' and "
        "l_shipdate < date '1994-01-01' + interval '1' year and "
        "l_discount between 0.05 and 0.07 and l_quantity < 24")[0][0]
    rows = MESH_CELL.match(mesh_cells(port.mesh, TPCH_Q6)[0]).group(3)
    assert sum(int(x) for x in rows.split(",")) == want


def test_single_device_has_empty_mesh_cell(li):
    _, port = li
    rs = port.single.execute("EXPLAIN ANALYZE " + TPCH_Q6)
    assert rs.column_names[5] == "mesh"
    assert rs.column_names[-1] == "wait_profile"
    assert all(not r[5] for r in rs.rows), rs.rows


# ==================== skew detector ====================

def test_failpoint_skew_raises_warning_and_event():
    """Fresh join sides under `mesh/skew` = 64: the same warning text
    and event detail (digests masked), and tidb_events rows."""
    out = []
    for pkg, FP, O in (("ref", RF, RO), ("port", PF, PO)):
        side = _join_side(pkg)
        base = O.MESH_SKEW_WARNINGS.get()
        with FP.failpoint("mesh/skew", 64.0):
            side.mesh.query(JOIN_SQL)
        assert O.MESH_SKEW_WARNINGS.get() > base
        warns = [w[2] for w in side.mesh.warnings if "mesh skew" in w[2]]
        evs = [e["detail"] for e in side.single.storage.obs.events.snapshot()
               if e["kind"] == "mesh_skew"]
        rows = side.mesh.query("select kind, severity from "
                               "information_schema.tidb_events "
                               "where kind = 'mesh_skew'")
        out.append(masked((warns, evs, rows)))
    assert out[0] == out[1]
    warns, evs, rows = out[1]
    assert warns and "skew-warn-ratio" in warns[0]
    assert evs and "64.00" in evs[-1] and rows[0][1] == "warn"


def test_hot_range_skews_naturally(li):
    """Only the lowest orderkeys match: every survivor on shard 0, a skew
    of 8 past the default warn ratio, no failpoint."""
    got = []
    for side, O in zip(li, (RO, PO)):
        side.mesh.query(HOT_SQL)
        got.append(masked([w[2] for w in side.mesh.warnings
                           if "mesh skew" in w[2]]))
        assert O.MESH_SKEW_RATIO.get() >= side.plane.cfg.skew_warn_ratio
    assert got[0] == got[1] and got[1]


def test_skew_rides_topsql_and_slow_log(joins):
    got = []
    for side in joins:
        st = side.single.storage
        st.obs.topsql.configure(enabled=True, window_s=3600)
        side.mesh.execute("set tidb_slow_log_threshold = 0")
        try:
            side.mesh.query(JOIN_SQL)
        finally:
            side.mesh.execute("set tidb_slow_log_threshold = 100000")
        top = side.mesh.query(
            "select operator, max_shard_share from "
            "information_schema.tidb_top_sql "
            "where digest_text like '%fact join dim%' "
            "and operator <> '(stmt)' order by operator")
        # this statement's entry (an earlier one may have crossed the
        # default threshold on one package and not the other)
        slow = side.mesh.query(
            "select mesh_skew from information_schema.slow_query "
            "where query like '%fact join dim%'")[-1:]
        st.obs.topsql.configure(enabled=False)
        got.append((sorted(top), slow))
    assert got[0] == got[1]
    top, slow = got[1]
    assert any(r[1] and r[1] > 0 for r in top), top
    assert slow and any(r[0] >= 1.0 for r in slow), slow


# ==================== recorder surfaces ====================

_SHARD_COLS = ("kind, operator, dispatches, shards, last_shard_rows, "
               "last_skew, max_skew, in_rows, out_rows, routed_bytes")


def test_tidb_mesh_shards_and_storage_rows():
    """Fresh planes, the same statements: equal dispatch rings and
    ledgers, and their cluster twins (the local member). The ledger is
    read before any information_schema read of the meshed session: the
    reference stages a bare memtable scan on the device, the port stages
    no bare scan."""
    ref, port = lineitem_pair(4096)
    jr, jp = _join_side("ref"), _join_side("port")
    got = []
    for side, j, M in ((ref, jr, RM), (port, jp, PM)):
        side.mesh.query(TPCH_Q6)
        side.mesh.query("select l_orderkey from lineitem "
                        "where l_quantity < 3.00")
        j.mesh.query(JOIN_SQL)
        ledger = [[r[0], r[1], r[3], r[4], r[5], r[6]]
                  for r in M.storage_rows(j.mesh.storage)]
        cs = j.mesh.query("select instance, device, kind, bytes, error "
                          "from information_schema.cluster_mesh_storage")
        shards = side.mesh.query(
            f"select {_SHARD_COLS} from information_schema.tidb_mesh_shards "
            "order by kind")
        jshards = j.mesh.query(
            f"select {_SHARD_COLS} from information_schema.tidb_mesh_shards")
        cl = j.mesh.query("select instance, kind, error from "
                          "information_schema.cluster_mesh_shards")
        got.append(masked((shards, jshards, sorted(ledger, key=repr),
                           cl, sorted(cs, key=repr))))
    assert got[0] == got[1]
    shards = got[1][0]
    assert {r[0] for r in shards} == {"agg", "rows"}
    assert all(r[3] == 8 and len(r[4].split(",")) == 8 for r in shards)
    ledger = got[1][2]
    assert {"epoch", "replica", "perm"} <= {r[2] for r in ledger}
    assert "fact" in {r[1] for r in ledger}
    assert all(r[0] == "local" and r[2] is None for r in got[1][3])


def test_ledger_sums_to_device_buffer_gauge(li):
    _, port = li
    port.mesh.query(TPCH_Q6)
    totals = {r[0]: (r[5], r[6]) for r in PM.storage_rows(port.mesh.storage)
              if r[3] == "total"}
    per = port.plane.device_bytes()
    assert len(totals) == 8 and set(totals) == set(per)
    for dev, b in per.items():
        live, peak = totals[dev]
        assert live == b and peak >= live
        PO.DEVICE_BUFFER_BYTES.set(b, device=dev)
        assert PO.DEVICE_BUFFER_BYTES.get(device=dev) == b


def test_ring_is_bounded():
    p = port_single()
    load_lineitem(p, 4096)
    mesh = Session(p.storage, cop=port_plane(
        shard_ring_cap=3).client_for(p.storage), device="cpu")
    for i in range(6):
        mesh.query("select count(*), sum(l_quantity) from lineitem "
                   f"where l_orderkey > {i}")
    with mesh.cop.recorder._lock:
        assert len(mesh.cop.recorder._ring) <= 3


def test_failed_statement_discards_pending_stats(li):
    _, port = li
    rec = port.mesh.cop.recorder
    rec.note_pending("agg", "stalepending00ff",
                     np.asarray([[5, 5]] * 8, dtype=np.int32))
    with pytest.raises(Exception):
        port.mesh.execute("select no_such_col from lineitem")
    assert not getattr(rec._tls, "pending", None)
    port.mesh.query(TPCH_Q6)
    with rec._lock:
        assert "stalepending00ff" not in rec._ring


def test_bits_shard_counts():
    """A rows dispatch whose filter matches nothing is still an 8-way
    dispatch; per-slot popcounts read each slot's equal slice of the
    concatenated packed mask, in slot order."""
    rec = PM.MeshFlightRecorder(port_plane())
    rec.note_pending("frag-rows", "zeromatchbits000",
                     {"bits": np.zeros(32, np.uint8), "shards": 8})
    note = rec.collect()
    assert note["shards"] == 8 and note["rows"] == [0] * 8
    with rec._lock:
        assert rec._ring["zeromatchbits000"]["shards"] == 8
    bits = np.concatenate([np.asarray([0xFF] * i + [0] * (11 - i),
                                      dtype=np.uint8) for i in range(12)])
    assert PM._bits_shard_counts(bits, 12).tolist() == \
        [8 * i for i in range(12)]


def test_partitioned_join_counts_routed_bytes(joins):
    got = []
    for side, O, P in zip(joins, (RO, PO), (ref_plane, port_plane)):
        part = side.session(P(replicate_threshold_bytes=1))
        base = O.MESH_RESHARD_BYTES.get()
        rows = q(part, JOIN_SQL)
        assert any("partb" in str(k) for k in part.cop._col_cache)
        assert O.MESH_RESHARD_BYTES.get() > base
        routed = part.query("select routed_bytes from "
                            "information_schema.tidb_mesh_shards "
                            "where routed_bytes > 0")
        got.append((rows, routed, O.MESH_RESHARD_BYTES.get() - base))
    assert got[0] == got[1] and got[1][1]


def test_routed_payload_is_what_the_exchanges_are_handed(li, monkeypatch):
    """The port's exchange payload total (`dist.routed_payload_bytes`)
    grows by exactly the values, validity and row masks its hc exchange
    hands `route_rows`, over the 8 slots. The exchange routes the group
    key and the aggregate argument, widened to int32; the recorder's
    `routed_bytes` counts the reference's payload (the probe columns as
    staged, and the mask) and equals `MESH_RESHARD_BYTES`' growth."""
    from tidb_tpu_torch.parallel import dist as PD
    from tidb_tpu_torch.parallel import exchange as PEX
    _, port = li
    handed, widths = [], []
    route_rows, route_cols = PEX.route_rows, PEX.route_cols

    def spy_rows(dest, payload, *a):
        handed.append(sum(x.numel() * x.element_size() for x in payload))
        return route_rows(dest, payload, *a)

    def spy_cols(dest, cols, *a):
        widths.append(len(cols))
        return route_cols(dest, cols, *a)

    monkeypatch.setattr(PEX, "route_rows", spy_rows)
    monkeypatch.setattr(PEX, "route_cols", spy_cols)
    sql = ("select l_orderkey, sum(l_quantity) from lineitem "
           "group by l_orderkey order by l_orderkey limit 5")
    base = (PD.routed_payload_bytes(), PO.MESH_RESHARD_BYTES.get())
    cells = mesh_cells(port.mesh, sql)
    assert cells and "routed=" in cells[0], cells
    assert len(handed) == 8 and widths == [2] * 8
    assert PD.routed_payload_bytes() - base[0] == sum(handed) > 0
    routed = int(cells[0].rsplit("routed=", 1)[1])
    assert PO.MESH_RESHARD_BYTES.get() - base[1] == routed > 0


def test_recorder_has_no_background_thread():
    """No recorder thread (`titpu-mesh*`); the only threads of a mesh are
    its 8 slot threads, which `Mesh.close()` ends."""
    ref, port = lineitem_pair(4096)
    before = set(threading.enumerate())
    port.mesh.query(TPCH_Q6)
    new = set(threading.enumerate()) - before
    assert not [t for t in threading.enumerate()
                if t.name.startswith("titpu-mesh")]
    assert sorted(t.name for t in new) == \
        sorted(f"titpu-slot-{i}" for i in range(8))
    port.plane.mesh.close()
    assert not any(t.is_alive() for t in new)


def test_debug_payload(li, monkeypatch):
    """/debug/mesh's payload over each package's process plane serving
    one meshed Q6: the same keys and dispatch fields, JSON-clean."""
    got = []
    for side, M, P in ((li[0], RM, ref_plane), (li[1], PM, port_plane)):
        plane = P()
        monkeypatch.setattr(M, "_PLANE", plane)
        s = side.session(plane)
        s.query(TPCH_Q6)
        payload = json.loads(json.dumps(M.debug_payload()))
        disp = [masked({k: v for k, v in d.items()
                        if k not in ("last_seen", "last_warn",
                                     "skew_hits")})
                for d in payload["dispatches"]]
        got.append((sorted(payload), sorted(payload["status"]), disp,
                    [sorted(x) for x in payload["storage"]],
                    [c["kind"] for c in payload["compiles"]]))
    assert got[0][:4] == got[1][:4]
    assert got[1][2] and got[1][4]


# ==================== memory watermark ====================

def test_hbm_watermark_event_edge_triggered():
    """A 1 KiB capacity puts the slots' physical device over the
    watermark: one event naming it, and a second scrape above the line
    emits none."""
    p = port_single()
    load_lineitem(p, 4096)
    plane = port_plane(hbm_bytes=1024, hbm_watermark_fraction=0.5)
    mesh = Session(p.storage, cop=plane.client_for(p.storage),
                   device="cpu")
    mesh.query(TPCH_Q6)
    base = PO.MESH_HBM_WATERMARK.get(device="cpu")
    plane.device_bytes()
    evs = [e for e in p.storage.obs.events.snapshot()
           if e["kind"] == "mesh_hbm_watermark"]
    assert len(evs) == 1 and evs[0]["detail"].startswith("device cpu:")
    assert PO.MESH_HBM_WATERMARK.get(device="cpu") == base + 1
    plane.device_bytes()
    assert len([e for e in p.storage.obs.events.snapshot()
                if e["kind"] == "mesh_hbm_watermark"]) == 1
    # a CPU plane has no capacity of its own: the watermark is off
    assert port_plane().device_capacity_bytes("cpu") == 0


# ==================== program-build observability ====================

def test_compiles_counted_per_signature():
    p = port_single()
    load_lineitem(p, 4096)
    mesh = Session(p.storage, cop=port_plane().client_for(p.storage),
                   device="cpu")
    base = PO.MESH_COMPILES.get(kind="agg")
    mesh.query(TPCH_Q6)
    mesh.query(TPCH_Q6)
    comps = mesh.cop.recorder.snapshot()["compiles"]
    assert [c["count"] for c in comps if c["kind"] == "agg"] == [1]
    assert all(c["total_s"] >= 0 for c in comps)
    assert PO.MESH_COMPILES.get(kind="agg") == base + 1


def test_recompile_storm_and_ring_bound():
    from tidb_tpu_torch.store.storage import Storage
    got = []
    for M, O, S in ((RM, RO, None), (PM, PO, Storage)):
        rec = M.MeshFlightRecorder(ref_plane() if M is RM else port_plane())
        st = S(device="cpu") if S is not None else \
            __import__("tidb_tpu.store.storage", fromlist=["S"]).Storage()
        rec.obs = st.obs
        base = O.MESH_RECOMPILE_STORMS.get()
        for i in range(M.MeshFlightRecorder.STORM_COMPILES + 1):
            rec.note_compile("agg", "sig-abc", 0.01,
                             full_key=("shard", "agg", "k", 256 << i))
        evs = [e["detail"] for e in st.obs.events.snapshot()
               if e["kind"] == "mesh_compile_storm"]
        for i in range(M.MeshFlightRecorder.COMPILE_CAP + 32):
            rec.note_compile("agg", f"sig-{i}", 0.0)
        with rec._lock:
            n = len(rec._compiles)
        got.append((O.MESH_RECOMPILE_STORMS.get() - base,
                    [e.replace("XLA ", "") for e in evs], n))
        st.close()
    assert got[0] == got[1] and got[1][0] == 1 and "sig-abc" in got[1][1][0]


def test_telemetry_memoized_per_generation(li, monkeypatch):
    _, port = li
    port.mesh.query(TPCH_Q6)
    assert port.mesh.cop.telemetry() is port.mesh.cop.telemetry()
    walks = []
    orig = PM._walk_arrays

    def counting(o):
        walks.append(1)
        return orig(o)

    monkeypatch.setattr(PM, "_walk_arrays", counting)
    port.plane.device_bytes()
    assert not walks
    with port.mesh.cop._lock:
        port.mesh.cop._col_cache[("__probe__",)] = ()
    try:
        port.plane.device_bytes()
        assert walks
    finally:
        with port.mesh.cop._lock:
            del port.mesh.cop._col_cache[("__probe__",)]


def test_inactive_scrape_never_builds_a_mesh(monkeypatch):
    from tidb_tpu_torch.parallel import dist as PDist
    import dataclasses
    old = PM.get_plane().cfg
    try:
        PM.configure(enabled=False)

        def boom(*a, **k):
            raise AssertionError("scrape built a mesh")

        monkeypatch.setattr(PDist, "default_devices", boom)
        assert PM.status()["enabled"] is False
        PO.run_gauge_probes()
        PM.debug_payload()
    finally:
        monkeypatch.undo()
        PM.configure(**dataclasses.asdict(old))


def test_plain_client_statement_path_does_zero_recorder_work(monkeypatch):
    calls: list[str] = []
    for meth in ("note_pending", "collect", "note_compile"):
        orig = getattr(PM.MeshFlightRecorder, meth)

        def spy(self, *a, _m=meth, _o=orig, **k):
            calls.append(_m)
            return _o(self, *a, **k)

        monkeypatch.setattr(PM.MeshFlightRecorder, meth, spy)
    s = Session(cop=CopClient("cpu"), device="cpu")
    s.execute("create table z (a int primary key, b int)")
    s.execute("insert into z values (1,2),(2,3),(3,4)")
    s.query("select sum(b) from z where a >= 1")
    s.query("explain analyze select sum(b) from z where a >= 1")
    assert calls == []
    assert s.cop.take_mesh_note() is None
    assert s.cop.drain_mesh_warnings() == ()


# ==================== inspection rules ====================

def _rule_rows(session, rule):
    return [r for r in session.execute(RESULT_SQL).rows if r[0] == rule]


def test_mesh_skew_failpoint_fires_inspection():
    out = []
    for pkg, FP in (("ref", RF), ("port", PF)):
        side = _join_side(pkg)
        st = side.single.storage
        st.diagnostics.skew_min_dispatches = 1
        with FP.failpoint("mesh/skew", 64.0):
            side.mesh.query(JOIN_SQL)
        rows = _rule_rows(side.mesh, "mesh-shard-skew")
        warns = [str(w[2]) for w in side.mesh.execute("show warnings").rows
                 if "mesh-shard-skew" in str(w[2])]
        evs = [e["detail"] for e in st.obs.events.snapshot()
               if e["kind"] == "inspection_finding"]
        side.mesh.execute(RESULT_SQL)
        evs2 = [e for e in st.obs.events.snapshot()
                if e["kind"] == "inspection_finding"]
        out.append(masked((rows, warns, evs, len(evs2))))
    assert out[0] == out[1]
    rows, warns, evs, n = out[1]
    assert rows and rows[0][2] == "critical" and float(rows[0][3]) >= 4.0
    assert "skew-warn-ratio" in rows[0][4] and warns
    assert evs and "mesh-shard-skew" in evs[-1] and n == len(evs)


def test_mesh_skew_rule_ignores_transient_single_hit():
    NS = types.SimpleNamespace
    now = time.time()
    for I in (RI, PI):
        cfg = I.DiagnosticsState()
        cfg.skew_min_dispatches = 2
        client = NS(recorder=NS(plane=NS(cfg=NS(skew_warn_ratio=4.0))))
        ent = {"digest": "d" * 32, "kind": "frag", "op": "join",
               "dispatches": 100, "shards": 8, "last_rows": [1] * 8,
               "last_skew": 1.0, "max_skew": 9.0, "skew_hits": [(now, 9.0)],
               "in_rows": 800, "out_rows": 100, "routed_bytes": 0}
        ctx = NS(cfg=cfg, mesh_client=client, now=now, window_s=120.0,
                 mesh={"dispatches": [ent], "compiles": []})
        results = [I._r_mesh_skew(ctx)]
        for hits in ([(now - 1.0, 9.0), (now, 4.2)],
                     [(now - 3600.0, 9.0), (now - 3500.0, 9.0)],
                     [(now - 3600.0, 9.0), (now - 1.0, 4.2), (now, 4.2)]):
            ent["skew_hits"] = hits
            results.append([(f.severity, f.value, f.details)
                            for f in I._r_mesh_skew(ctx)])
        if I is RI:
            want = results
        else:
            assert results == want
    assert results[0] == [] and results[1][0][0] == "critical"
    assert results[2] == [] and results[3][0][:2] == ("warning", "4.20")


def test_mesh_recompile_storm_and_watermark_rules(joins):
    got = []
    for side, M in zip(joins, (RM, PM)):
        client = M.client_of(side.single.storage)
        for _ in range(client.recorder.STORM_COMPILES):
            client.recorder.note_compile("frag", "sig-hot", 0.2,
                                         full_key="k1")
        storm = _rule_rows(side.mesh, "mesh-recompile-storm")
        side.single.storage.obs.events.record(
            "mesh_hbm_watermark", severity="warn",
            detail="device cpu: 900 live buffer bytes >= 85% of "
                   "1000-byte capacity")
        hbm = _rule_rows(side.mesh, "mesh-hbm-watermark")
        got.append((storm, hbm))
    assert got[0] == got[1]
    storm, hbm = got[1]
    assert storm and storm[0][1] == "sig-hot" and int(storm[0][3]) >= 3
    assert hbm and hbm[0][1:3] == ("device cpu", "critical")


def test_status_routes_without_a_sql_server(li, monkeypatch):
    """A status server that serves no SQL server reads the module-level
    observability (`obs.DEFAULT`, which the port lacked: every such
    request failed) and answers /debug/mesh and /metrics as the
    reference's does."""
    import urllib.request

    from tidb_tpu.server.status import StatusServer as RS
    from tidb_tpu_torch.server.status import StatusServer as PS

    def get(port, route):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=30) as r:
            return r.status, r.read()

    got = []
    for side, S, M, P in ((li[0], RS, RM, ref_plane),
                          (li[1], PS, PM, port_plane)):
        plane = P()
        monkeypatch.setattr(M, "_PLANE", plane)
        side.session(plane).query(TPCH_Q6)
        srv = S("127.0.0.1", 0)
        srv.start()
        try:
            code, body = get(srv.port, "/debug/mesh")
            mcode, _ = get(srv.port, "/metrics")
        finally:
            srv.close()
        payload = json.loads(body)
        got.append((code, mcode, sorted(payload),
                    len(payload["dispatches"])))
    assert got[0] == got[1] == (200, 200, ["compiles", "dispatches",
                                           "status", "storage"], 1)
