"""Overlay rows: the port's second batch vs the JAX reference, on the CPU.

A reference `Session` holds a fact table `f` and two dimension tables `d`
and `d2` (the shapes of the MVCC case in `tests/test_group_semi_device.py`,
at a smaller size, made from a seed with numpy). Inside a transaction a
few rows of a table are inserted (some with NULLs), updated and deleted;
the statement's coprocessor calls then carry those rows as the snapshot's
overlay. `unittest.mock` wraps the reference's `CopClient.execute` and
`copr.fragment.execute_fragment` to capture each request, its snapshots
and the reference's answer; the transaction rolls back, and the captured
request runs through the port (`tidb_tpu_torch.convert`, `device="cpu"`).

Tolerance: exact, engine tag included. Partial aggregation rows compare
sorted (the base epoch's and the overlay's partials are separate chunks,
merged above the coprocessor); row results column by column in the order
returned, chunk for chunk (the overlay batch is a chunk of its own).
"""

from unittest import mock

import numpy as np
import pytest

from tidb_tpu.copr import client as JC
from tidb_tpu.copr import fragment as JF
from tidb_tpu.session import Session
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.copr.fragment import execute_fragment

N_FACT, N_DIM = 6_000, 1_500

# statements run inside the transaction before the query: inserts with
# NULLs (b, w), updates of base rows, deletes of base rows
F_WRITES = [
    "insert into f values (900001, 7, null, 12.50, null, 2, 3), "
    "(900002, 49999, 4, -3.25, 17, 4, 1499), (900003, 7, 8, 0.01, -5, 0, 9)",
    "update f set v = v + 1, w = 3 where k < 40",
    "update f set c = 4, g = 11 where k between 300 and 320",
    "delete from f where k between 1000 and 1100",
]
D_WRITES = ["update d set x = x + 7 where g < 30",
            "insert into d values (5000, 42)"]

# (SQL, tables written, reference engine tag)
SINGLE = {
    # dense loop strategy: sums, counts over NULLs, min/max
    "agg_loop": ("select c, sum(v), count(w), min(w), max(v) from f "
                 "group by c", "f", "device"),
    # 100 segments: the einsum strategy
    "agg_einsum": ("select g % 100, sum(v), count(*) from f "
                   "group by g % 100", "f", "device"),
    "agg_no_group": ("select sum(v), count(*), max(w) from f where w > 0",
                     "f", "device"),
    "agg_hll": ("select c, approx_count_distinct(a), count(*) from f "
                "group by c", "f", "device"),
    "rows_selection": ("select k, a, w from f where c = 2", "f", "device"),
    "rows_bare": ("select k, b from f", "f", "device"),
    "rows_limit": ("select k, v from f where w > 100 limit 25", "f",
                   "device"),
    "topn_one_key": ("select k, v from f order by v desc limit 30", "f",
                     "device"),
    "topn_two_keys": ("select k, w, c from f order by c, w desc limit 40",
                      "f", "device"),
    # the MVCC case: a wide group space with overlay rows cannot take the
    # sorted-run path (a group split across batches), so both go host
    "group_space_host": ("select a, sum(v) from f group by a", "f", "host"),
}

FRAGMENTS = {
    "join_agg": ("select c, sum(x), count(*) from f, d where f.g = d.g "
                 "group by c", "f", "device[agg]"),
    "join_rows": ("select k, x, w from f, d where f.g = d.g and f.c = 1",
                  "f", "device[rows]"),
    "join_topn": ("select k, x, c from f, d where f.g = d.g "
                  "order by c desc, x limit 20", "f", "device[topn]"),
    "semi_agg": ("select c, count(*) from f where exists (select * from d2 "
                 "where d2.kk = f.a and d2.x > 5) group by c", "f",
                 "device[agg+semi]"),
    "semi_rows": ("select k, a from f where a in (select kk from d2 "
                  "where x > 5)", "f", "device[rows+semi]"),
    # an overlay on a group-space request: the reference's hc gate
    "group_space": ("select a, x, sum(v) from f, d where f.g = d.g "
                    "group by a, x", "f", "host(fragment:group-space)"),
    # an overlay on the build table
    "build_overlay": ("select c, sum(x) from f, d where f.g = d.g "
                      "group by c", "d", "host(fragment:build-overlay)"),
}


def _bulk(session, name, ddl, cols, valids=None):
    session.execute(ddl)
    info = session.catalog.table("test", name)
    session.storage.table_store(info.id).bulk_load(cols, valids)


@pytest.fixture(scope="module")
def session():
    rng = np.random.default_rng(43)
    s = Session()
    n = N_FACT
    _bulk(s, "f", "create table f (k bigint primary key, a int, b int, "
          "v decimal(9,2), w int, c int, g int)",
          [np.arange(n, dtype=np.int64), rng.integers(0, 50_000, n),
           rng.integers(0, 30_000, n), rng.integers(-40_000, 40_000, n),
           rng.integers(-500, 500, n), rng.integers(0, 5, n),
           rng.integers(0, N_DIM, n)],
          [None, None, rng.random(n) > 0.15, None, rng.random(n) > 0.2,
           None, None])
    _bulk(s, "d", "create table d (g bigint primary key, x int)",
          [np.arange(N_DIM, dtype=np.int64), rng.integers(0, 60_000, N_DIM)])
    _bulk(s, "d2", "create table d2 (id bigint primary key, kk int, x int)",
          [np.arange(N_DIM, dtype=np.int64), rng.integers(0, 50_000, N_DIM),
           rng.integers(0, 100, N_DIM)],
          [None, rng.random(N_DIM) > 0.1, None])
    return s


def _calls_in_txn(session, sql, writes, ref_cop=None):
    """[(kind, request, snapshot(s), reference result)] of `sql` run
    inside a transaction that first makes `writes`; rolled back after."""
    calls = []
    run_dag, run_frag = JC.CopClient.execute, JF.execute_fragment

    def dag_call(self, dag, snap):
        r = run_dag(ref_cop or self, dag, snap)
        calls.append(("dag", dag, snap, r))
        return r

    def frag_call(cop, frag, snaps):
        r = run_frag(ref_cop or cop, frag, snaps)
        calls.append(("frag", frag, snaps, r))
        return r

    session.execute("begin")
    try:
        for w in writes:
            session.execute(w)
        with mock.patch.object(JC.CopClient, "execute", dag_call), \
                mock.patch.object(JF, "execute_fragment", frag_call):
            session.query(sql)
    finally:
        session.execute("rollback")
    return calls


def _assert_same(got, ref):
    assert got.engine == ref.engine
    assert got.is_partial_agg == ref.is_partial_agg
    if ref.is_partial_agg:
        rows = TR.partial_rows(got.chunks)
        assert rows and rows == TR.partial_rows(ref.chunks)
        return
    assert len(got.chunks) == len(ref.chunks)
    cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
    assert len(cols) == len(want) and len(want[0])
    for a, b in zip(cols, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("tiled", [False, True], ids=["epoch", "tiled"])
@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_table_overlay_matches_reference(session, name, tiled):
    sql, table, tag = SINGLE[name]
    cop = CopClient("cpu")
    ref_cop = None
    if tiled:
        # 6,000 base rows in 2,048-row tiles, then the overlay batch
        ref_cop = JC.CopClient()
        ref_cop.TILE_ROWS = cop.TILE_ROWS = 2048
    calls = [c for c in _calls_in_txn(session, sql, F_WRITES, ref_cop)
             if c[0] == "dag"]
    assert len(calls) == 1
    _, dag, snap, ref = calls[0]
    assert len(snap.overlay_handles) == 3 + 40 + 21
    assert ref.engine.startswith(tag)
    _assert_same(cop.execute(request_from_reference(dag),
                             snapshot_from_reference(snap)), ref)


@pytest.mark.parametrize("name", sorted(FRAGMENTS))
def test_fragment_overlay_matches_reference(session, name):
    sql, table, tag = FRAGMENTS[name]
    writes = F_WRITES if table == "f" else D_WRITES
    calls = [c for c in _calls_in_txn(session, sql, writes)
             if c[0] == "frag"]
    assert len(calls) == 1
    _, frag, snaps, ref = calls[0]
    assert ref.engine == tag
    got = execute_fragment(CopClient("cpu"), request_from_reference(frag),
                           {tid: snapshot_from_reference(s)
                            for tid, s in snaps.items()})
    _assert_same(got, ref)


def test_overlay_snapshot_helper_matches_the_oracles():
    # the bench helper's overlay (8,192 deltas) on a small lineitem: Q6
    # through the port equals the oracle over the visible base rows plus
    # the oracle over the overlay rows, one partial row each
    from tidb_tpu_torch.bench import tpch_data as TD
    data = TD.generate_tpch(0.01, 7)
    tables, snaps = TR.load_tables(data, ("lineitem",))
    t = tables["lineitem"]
    snap, visible, ov = TR.overlay_snapshot(snaps[t.id], data["lineitem"], 7)
    assert len(snap.overlay_handles) == 6144
    assert snap.num_visible_rows == snaps[t.id].epoch.num_rows
    r = CopClient("cpu").execute(TR.q6_dag(t), snap)
    assert r.engine == "device" and len(r.chunks) == 2
    want = sorted(TR.q6_oracle(TR.rows_of(data["lineitem"], visible))
                  + TR.q6_oracle(ov))
    assert TR.partial_rows(r.chunks) == want
