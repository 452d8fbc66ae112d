"""Gather-join fragments: the port's fragment executor vs the JAX reference.

TPC-H (SF0.02, seed 42, all eight tables) is loaded into a reference
`Session`. Each query runs there; `unittest.mock` wraps the reference's
`copr.fragment.execute_fragment` to capture every fragment, its snapshots
and the answer the reference's coprocessor gave. Fragment and snapshots
then cross over with `tidb_tpu_torch.convert` and run through the port on
the CPU.

Tolerance: exact, engine tag included. Aggregations are compared as
sorted partial-layout rows (the order of groups is not part of the
contract); row fragments column by column in the order returned (probe-row
order, tile by tile). Where the reference serves a fragment on its host
interpreter, so does the port: the same rows, tagged
`host(fragment:<reason>)` with the reference's reason.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from tidb_tpu.bench.tpch_data import load_tpch
from tidb_tpu.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu.copr import client as JC
from tidb_tpu.copr import fragment as JF
from tidb_tpu.plan import expr as JE
from tidb_tpu.session import Session
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr import fragment as PF
from tidb_tpu_torch.copr import streamseg as PSS
from tidb_tpu_torch.copr.client import CopClient

SF, SEED = 0.02, 42
JOIN_HAVING = ("select o_orderkey, o_orderdate, sum(l_quantity) from "
               "lineitem, orders where l_orderkey = o_orderkey group by "
               "o_orderkey, o_orderdate having sum(l_quantity) > 250")
JOIN_GROUP = ("select o_orderkey, o_orderdate, count(*) from lineitem, orders "
              "where l_orderkey = o_orderkey and l_discount > 0.05 "
              "group by o_orderkey, o_orderdate")
Q18_JOIN_HAVING = ("select o_orderkey, sum(l_quantity) from lineitem, orders "
                   "where l_orderkey = o_orderkey group by o_orderkey "
                   "having sum(l_quantity) > 300")
CUST_HAVING = ("select c_custkey, sum(l_quantity) from lineitem, orders, "
               "customer where l_orderkey = o_orderkey and o_custkey = "
               "c_custkey group by c_custkey having sum(l_quantity) > 1000")
SEMI_HAVING = ("select l_orderkey, sum(l_quantity) from lineitem where exists "
               "(select * from orders where o_orderkey = l_orderkey and "
               "o_orderpriority = '1-URGENT') group by l_orderkey "
               "having sum(l_quantity) > 300")

# name: (SQL, position among the statement's fragment calls, device tag
# the port must give as the reference does)
FRAGMENTS = {
    "q5": (TPCH_QUERIES["q5"], 0, "device[agg]"),
    "q8": (TPCH_QUERIES["q8"], 0, "device[agg]"),
    "q12": (TPCH_QUERIES["q12"], 0, "device[agg]"),
    "q14": (TPCH_QUERIES["q14"], 0, "device[agg]"),
    "q11_second": (TPCH_QUERIES["q11"], 1, "device[agg]"),
    # the first Q11 fragment groups partsupp by ps_partkey, which is
    # run-ordered in storage: the reference takes the rank path
    # (all-groups mode), and so does the port
    "q11_first": (TPCH_QUERIES["q11"], 0, "device[group]"),
    "q9": (TPCH_QUERIES["q9"], 0, "device[rows]"),
    "q17": (TPCH_QUERIES["q17"], 0, "device[rows]"),
    "q18_outer": (TPCH_QUERIES["q18"], 0, "device[rows]"),
    # o_orderkey is the join's unique build key: l_orderkey stands for it
    "join_having": (JOIN_HAVING, 0, "device[hc]"),
    "join_group": (JOIN_GROUP, 0, "device[group]"),
    # the fused join+agg+TopN cut: Q3 over the run-ordered l_orderkey
    # (streamseg rank path), Q10 over c_custkey through the sorted body
    "q3": (TPCH_QUERIES["q3"], 0, "device[fat]"),
    "q10": (TPCH_QUERIES["q10"], 0, "device[fat]"),
    # c_custkey is not run-ordered in lineitem: the sorted-run body
    "cust_having": (CUST_HAVING, 0, "device[hc]"),
    # all-groups mode through the sorted body: Q2's min(ps_supplycost)
    # rides the sort as its extra operand; Q7's three keys (two nation
    # names and a year) pack into the sort operands
    "q2_group": (TPCH_QUERIES["q2"], 1, "device[group]"),
    "q7": (TPCH_QUERIES["q7"], 0, "device[group]"),
    # semi/anti membership edges: Q4's EXISTS (SEMI, dense agg), Q16's NOT
    # IN (NULL-aware ANTI_NULL, rows), Q20's ps_partkey IN (...) block
    "q4": (TPCH_QUERIES["q4"], 0, "device[agg+semi]"),
    "q16": (TPCH_QUERIES["q16"], 0, "device[rows+semi]"),
    "q20_semi": (TPCH_QUERIES["q20"], 1, "device[rows+semi]"),
    # a SEMI edge in front of the run-ordered HAVING: the rank path
    "semi_having": (SEMI_HAVING, 0, "device[hc+semi]"),
}


@pytest.fixture(scope="module")
def session():
    s = Session()
    load_tpch(s, sf=SF, seed=SEED)
    return s


def _frag_calls(session, sql):
    """[(fragment, snapshots, reference result)] per fragment the
    statement dispatched."""
    calls = []
    run = JF.execute_fragment

    def frag_call(cop, frag, snaps):
        r = run(cop, frag, snaps)
        calls.append((frag, snaps, r))
        return r

    with mock.patch.object(JF, "execute_fragment", frag_call):
        session.query(sql)
    return calls


def _fragment(session, name):
    sql, pos, _ = FRAGMENTS[name]
    return _frag_calls(session, sql)[pos]


def _port(frag, snaps, cop=None):
    return PF.execute_fragment(
        cop or CopClient("cpu"), request_from_reference(frag),
        {tid: snapshot_from_reference(s) for tid, s in snaps.items()})


def _assert_same(got, ref, rows_mode):
    assert got.engine == ref.engine
    assert got.is_partial_agg == ref.is_partial_agg == (not rows_mode)
    if rows_mode:
        cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
        assert len(cols) == len(want) and len(want[0])
        for a, b in zip(cols, want):
            assert np.array_equal(a, b)
    else:
        rows = TR.partial_rows(got.chunks)
        assert rows and rows == TR.partial_rows(ref.chunks)


@pytest.mark.parametrize("name", sorted(FRAGMENTS))
def test_join_fragment_matches_reference(session, name):
    frag, snaps, ref = _fragment(session, name)
    assert ref.engine == FRAGMENTS[name][2]
    _assert_same(_port(frag, snaps), ref, frag.agg is None)


def test_semi_having_takes_the_rank_path(session):
    # the SEMI gate masks rows in front of streamseg's rank sums: the
    # run-ordered l_orderkey keeps the rank path, as in the reference
    frag, snaps, ref = _fragment(session, "semi_having")
    with mock.patch.object(PSS, "rank_sums", wraps=PSS.rank_sums) as rs:
        got = _port(frag, snaps)
    assert rs.call_count == 1
    _assert_same(got, ref, False)


def test_join_fragment_not_in_slice():
    # uncommitted probe rows: a second (overlay) batch on the device path,
    # in the reference and in the port; the row passes Q12's filters
    s = Session()
    load_tpch(s, sf=SF, seed=SEED, tables=["lineitem", "orders"])
    s.execute("begin")
    s.execute("insert into lineitem values (1, 1, 1, 9, 5.00, 100.00, 0.05, "
              "0.01, 'N', 'O', '1994-03-01', '1994-03-05', '1994-03-09', "
              "'NONE', 'MAIL', 'x')")
    frag, snaps, ref = _frag_calls(s, TPCH_QUERIES["q12"])[0]
    s.execute("rollback")
    assert ref.engine == "device[agg]"
    assert len(ref.chunks) == 2  # the base epoch's and the overlay's
    _assert_same(_port(frag, snaps), ref, False)


# single-table requests of the TPC-H queries that the dense gate rejects
# and the coprocessor lifts into the all-groups fragment mode: (SQL,
# position among the statement's CopClient.execute calls, engine tag).
# Q20's sum(l_quantity) GROUP BY l_partkey, l_suppkey sorts by both keys.
LIFTED = {"q20": (TPCH_QUERIES["q20"], 0, "device[group]")}


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_group_request_matches_reference(session, name):
    sql, pos, tag = LIFTED[name]
    calls = []
    run = JC.CopClient.execute

    def dag_call(self, dag, snap):
        r = run(self, dag, snap)
        calls.append((dag, snap, r))
        return r

    with mock.patch.object(JC.CopClient, "execute", dag_call):
        session.query(sql)
    dag, snap, ref = calls[pos]
    assert ref.engine == tag
    got = CopClient("cpu").execute(request_from_reference(dag),
                                   snapshot_from_reference(snap))
    _assert_same(got, ref, False)


# ---- gates: each gives the reference's host answer through the port ---------

def _assert_same_host(frag, snaps, reason) -> None:
    """The reference's host interpreter answers for `reason`, and the port's
    gives the same rows and tag."""
    ref = JF.execute_fragment(JC.CopClient(), frag, snaps)
    assert ref.engine == f"host(fragment:{reason})"
    _assert_same(_port(frag, snaps), ref, frag.agg is None)


def test_key_span_gate(session):
    frag, snaps, _ = _fragment(session, "q12")
    # o_orderkey spans ~80k keys at SF0.02
    with mock.patch.object(JF, "FRAG_SPAN_CAP", 1000), \
            mock.patch.object(PF, "FRAG_SPAN_CAP", 1000):
        _assert_same_host(frag, snaps, "key-span")


def _replace_epoch(snap, **changes):
    return dataclasses.replace(
        snap, epoch=dataclasses.replace(snap.epoch, **changes))


def test_int64_build_column_gate(session):
    frag, snaps, _ = _fragment(session, "q18_outer")
    orders = frag.tables[1].table.id
    cols = list(snaps[orders].epoch.columns)
    price = cols[3].copy()  # o_totalprice, staged as int32 on the device
    price[7] = 2**40
    cols[3] = price
    snaps = dict(snaps)
    snaps[orders] = _replace_epoch(snaps[orders], columns=cols)
    _assert_same_host(frag, snaps, "int64-column")


def test_build_overlay_gate():
    s = Session()
    load_tpch(s, sf=SF, seed=SEED, tables=["lineitem", "orders"])
    s.execute("begin")
    s.execute("insert into orders values (99999999, 1, 'O', 1.00, "
              "'1995-01-01', '1-URGENT', 'Clerk#1', 0, 'x')")
    frag, snaps, ref = _frag_calls(s, Q18_JOIN_HAVING)[0]
    s.execute("rollback")
    assert ref.engine == "host(fragment:build-overlay)"
    _assert_same(_port(frag, snaps), ref, False)


# ---- tiles, per-query gathers, cache rebuild ---------------------------------

@pytest.mark.parametrize("name", ["q5", "q12", "q9", "q18_outer"])
def test_tiled_join_matches_reference(session, name):
    # 121k lineitem rows in 40k-row tiles: 4 tiles of one shape bucket
    frag, snaps, _ = _fragment(session, name)
    ref_cop = JC.CopClient()
    ref_cop.TILE_ROWS = 40_000
    ref = JF.execute_fragment(ref_cop, frag, snaps)
    cop = CopClient("cpu")
    cop.TILE_ROWS = 40_000
    _assert_same(_port(frag, snaps, cop), ref, frag.agg is None)
    # every tile's aligned build columns are cached under its own tag
    tags = {k[-1] for k in cop._col_cache if k[1:2] == ("aligned",)}
    assert tags == {("tile", ti) for ti in range(4)}


@pytest.mark.parametrize("name", ["q12", "q17"])
def test_computed_probe_key_gathers_per_query(session, name):
    # l_orderkey + 1 (l_partkey + 1): a Call probe key is not aligned; the
    # program gathers it per query (and the row replay evaluates it again)
    frag, snaps, _ = _fragment(session, name)
    frag = dataclasses.replace(frag, joins=list(frag.joins))
    key = frag.joins[0].probe_key
    frag.joins[0] = dataclasses.replace(frag.joins[0], probe_key=JE.Call(
        "add", [key, JE.Const(1, key.ftype)], key.ftype))
    ref = JF.execute_fragment(JC.CopClient(), frag, snaps)
    assert ref.engine == FRAGMENTS[name][2]
    cop = CopClient("cpu")
    _assert_same(_port(frag, snaps, cop), ref, frag.agg is None)
    assert not [k for k in cop._col_cache if k[1:2] == ("aligned",)]


def test_aligned_cache_rebuilt_after_new_build_epoch(session):
    frag, snaps, _ = _fragment(session, "q12")
    orders = frag.tables[1].table.id
    pfrag = request_from_reference(frag)
    psnaps = {tid: snapshot_from_reference(s) for tid, s in snaps.items()}
    cop = CopClient("cpu")
    before = PF.execute_fragment(cop, pfrag, psnaps)
    old_epoch = snaps[orders].epoch.epoch_id
    assert [k for k in cop._col_cache
            if k[1:2] == ("aligned",) and k[2] == old_epoch]

    # a new orders epoch: every order becomes 1-URGENT
    cols = list(snaps[orders].epoch.columns)
    d = snaps[orders].dictionaries[5]
    cols[5] = np.full_like(cols[5], d.lookup("1-URGENT"))
    new = dict(snaps)
    new[orders] = _replace_epoch(snaps[orders], columns=cols,
                                 epoch_id=old_epoch + 10_000)
    psnaps[orders] = snapshot_from_reference(new[orders])
    after = PF.execute_fragment(cop, pfrag, psnaps)
    ref = JF.execute_fragment(JC.CopClient(), frag, new)
    _assert_same(after, ref, False)
    assert TR.partial_rows(after.chunks) != TR.partial_rows(before.chunks)
    aligned = [k[2] for k in cop._col_cache if k[1:2] == ("aligned",)]
    assert aligned == [old_epoch + 10_000]


# ---- the row-mode bitmask ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 1001, 4096])
def test_packbits_matches_numpy(n):
    mask = np.random.default_rng(n).random(n) < 0.3
    packed = PF.packbits(torch.from_numpy(mask)).numpy()
    assert packed.dtype == np.uint8
    assert np.array_equal(packed, np.packbits(mask))
    assert np.array_equal(np.unpackbits(packed)[:n].astype(bool), mask)


def test_empty_row_result_matches_reference(session):
    # no part is Brand#99: the row fragment returns one empty chunk of the
    # output schema
    frag, snaps, _ = _fragment(session, "q17")
    part = dataclasses.replace(frag.tables[1], filters=list(
        frag.tables[1].filters))
    brand = part.filters[0]
    part.filters[0] = dataclasses.replace(brand, args=[
        brand.args[0], dataclasses.replace(brand.args[1], value="Brand#99")])
    frag = dataclasses.replace(frag, tables=[frag.tables[0], part])
    ref = JF.execute_fragment(JC.CopClient(), frag, snaps)
    got = _port(frag, snaps)
    assert got.engine == ref.engine == "device[rows]"
    assert not got.is_partial_agg
    for chunks in (got.chunks, ref.chunks):
        assert len(chunks) == 1 and chunks[0].num_rows == 0
    assert [c.ftype for c in got.chunks[0].columns] == \
        [request_from_reference(c.ftype) for c in ref.chunks[0].columns]


# ---- semi/anti membership edges (the corpus of tests/test_group_semi_device.py)

N_SEMI_FACT = 9_000
N_SEMI_DIM = 2_000

SEMI_QUERIES = [
    # IN over a filtered subquery key (nullable build key: NULLs in the
    # set never match a SEMI probe)
    "select k, a from f where a in (select kk from d2 where x > 5) "
    "order by k limit 80",
    # correlated EXISTS (decorrelates to the same SEMI shape)
    "select k from f where exists (select * from d2 "
    "where d2.kk = f.a and d2.x > 5) order by k limit 80",
    # NULL probe keys (b) are filtered by IN
    "select k from f where b in (select kk from d2 where x > 5) "
    "order by k limit 80",
    # NOT EXISTS -> plain ANTI (NULL probe keys kept)
    "select k from f where not exists (select * from d2 "
    "where d2.kk = f.a) order by k limit 80",
    # NULL-aware NOT IN: the build set contains NULL -> empty result
    "select k from f where a not in (select kk from d2 where x > 5) "
    "order by k limit 80",
    # NOT IN over a NULL-free filtered set
    "select k from f where a not in (select kk from d2 "
    "where x > 5 and kk is not null) order by k limit 80",
    # NOT IN (empty set) is TRUE for every row, NULL probe keys included
    "select k from f where b not in (select kk from d2 where x > 9000) "
    "order by k limit 80",
    # fused agg over a semi gate (dense groups -> mode agg+semi)
    "select c, count(*) from f where exists (select * from d2 "
    "where d2.kk = f.a and d2.x > 5) group by c order by c",
    # wide groups over a semi gate -> group+semi
    "select a, count(*) from f where exists (select * from d2 "
    "where d2.kk = f.a and d2.x > 5) group by a order by a",
]
SEMI_ENGINES = ["device[rows+semi]"] * 7 + ["device[agg+semi]",
                                            "device[group+semi]"]


def _bulk(session, name, ddl, cols, valids=None):
    session.execute(ddl)
    info = session.catalog.table("test", name)
    session.storage.table_store(info.id).bulk_load(cols, valids)


@pytest.fixture(scope="module")
def semi_corpus():
    """The reference's semi corpus, drawn in its order from its seed."""
    rng = np.random.default_rng(41)
    s = Session(cop=JC.CopClient())
    n = N_SEMI_FACT
    k = np.arange(n, dtype=np.int64)
    a = rng.integers(0, 50_000, n)
    b = rng.integers(0, 30_000, n)
    b_valid = rng.random(n) > 0.15
    v = rng.integers(-40_000, 40_000, n)
    w = rng.integers(-500, 500, n)
    w_valid = rng.random(n) > 0.2
    c = rng.integers(0, 5, n)
    g = rng.integers(0, N_SEMI_DIM, n)
    _bulk(s, "f", "create table f (k bigint primary key, a int, b int, "
          "v decimal(9,2), w int, c int, g int)", [k, a, b, v, w, c, g],
          [None, None, b_valid, None, w_valid, None, None])
    _bulk(s, "d", "create table d (g bigint primary key, x int)",
          [np.arange(N_SEMI_DIM, dtype=np.int64),
           rng.integers(0, 60_000, N_SEMI_DIM)])
    kk = rng.integers(0, 50_000, N_SEMI_DIM)
    kk_valid = rng.random(N_SEMI_DIM) > 0.1
    _bulk(s, "d2", "create table d2 (id bigint primary key, kk int, x int)",
          [np.arange(N_SEMI_DIM, dtype=np.int64), kk,
           rng.integers(0, 100, N_SEMI_DIM)], [None, kk_valid, None])
    return s


@pytest.mark.parametrize("tiled", [False, True], ids=["epoch", "tiled"])
@pytest.mark.parametrize("qi", range(len(SEMI_QUERIES)))
def test_semi_corpus_matches_reference(semi_corpus, qi, tiled):
    calls = _frag_calls(semi_corpus, SEMI_QUERIES[qi])
    assert len(calls) == 1
    frag, snaps, ref = calls[0]
    cop = CopClient("cpu")
    if tiled:
        # the fact table's 9,000 rows stream as 5 tiles on both clients
        # (the group mode stages the whole epoch)
        ref_cop = JC.CopClient()
        ref_cop.TILE_ROWS = cop.TILE_ROWS = 2048
        ref = JF.execute_fragment(ref_cop, frag, snaps)
    assert ref.engine == SEMI_ENGINES[qi]
    got = _port(frag, snaps, cop)
    assert got.engine == ref.engine
    if frag.agg is not None:
        rows = TR.partial_rows(got.chunks)
        assert rows and rows == TR.partial_rows(ref.chunks)
        return
    # row results may be empty (NOT IN over a set holding NULL)
    assert len(got.chunks) == len(ref.chunks)
    cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
    assert len(cols) == len(want)
    for x, y in zip(cols, want):
        assert np.array_equal(x, y)
    assert (len(want[0]) == 0) == (qi == 4)
