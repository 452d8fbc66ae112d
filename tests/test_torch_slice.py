"""The port's coprocessor slice vs the JAX reference, request by request.

TPC-H lineitem (SF0.02, seed 42) is loaded into a reference `Session`.
Each query runs there; `unittest.mock` wraps the reference's
`CopClient.execute` and `copr.fragment.execute_fragment` to capture the
request, the snapshot(s) and the answer the coprocessor gave. The request
and snapshots then cross over with `tidb_tpu_torch.convert` and run
through the port on the CPU.

Tolerance: exact. The coprocessor answers in its partial layout
[group cols..., (val, cnt) per aggregate] of exact int64 sums, and the
engine tags must be the same strings. Rows are compared sorted: the order
of groups is not part of the contract (the HAVING candidate buffer is
filled by approx_max_k in the reference and by torch.topk in the port).
Where the reference leaves the device for its host interpreter, so does
the port: the same rows, tagged `host(<reason>)` with the reference's own
reason.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

from tidb_tpu.bench.tpch_data import generate_tpch as ref_generate_tpch
from tidb_tpu.bench.tpch_data import load_tpch
from tidb_tpu.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu.copr import client as JC
from tidb_tpu.copr import fragment as JF
from tidb_tpu.plan.fragment import FragmentDAG as RefFragmentDAG
from tidb_tpu.session import Session
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.copr.fragment import execute_fragment
from tidb_tpu_torch.plan.expr import AggDesc
from tidb_tpu_torch.plan.fragment import FragmentDAG

SF, SEED = 0.02, 42
Q18_INNER = ("select l_orderkey, sum(l_quantity) from lineitem "
             "group by l_orderkey having sum(l_quantity) > 300")
SLICE = {"q6": (TPCH_QUERIES["q6"], "dag", "device"),
         "q1": (TPCH_QUERIES["q1"], "dag", "device"),
         "q18_inner": (Q18_INNER, "frag", "device[hc]")}


@pytest.fixture(scope="module")
def session():
    s = Session()
    load_tpch(s, sf=SF, seed=SEED, tables=["lineitem"])
    return s


def _capture(session, sql):
    """[(kind, request, snapshot(s), reference result)] per coprocessor
    call the statement made."""
    calls = []
    run_dag, run_frag = JC.CopClient.execute, JF.execute_fragment

    def dag_call(self, dag, snap):
        r = run_dag(self, dag, snap)
        calls.append(("dag", dag, snap, r))
        return r

    def frag_call(cop, frag, snaps):
        r = run_frag(cop, frag, snaps)
        calls.append(("frag", frag, snaps, r))
        return r

    with mock.patch.object(JC.CopClient, "execute", dag_call), \
            mock.patch.object(JF, "execute_fragment", frag_call):
        session.query(sql)
    return calls


def _port(kind, req, snaps, cop=None):
    cop = cop or CopClient("cpu")
    if kind == "dag":
        return cop.execute(request_from_reference(req),
                           snapshot_from_reference(snaps))
    return execute_fragment(cop, request_from_reference(req),
                            {tid: snapshot_from_reference(s)
                             for tid, s in snaps.items()})


def _one_call(session, sql):
    calls = _capture(session, sql)
    assert len(calls) == 1, [c[0] for c in calls]
    return calls[0]


@pytest.mark.parametrize("name", sorted(SLICE))
def test_slice_query_matches_reference(session, name):
    sql, kind, tag = SLICE[name]
    k, req, snaps, ref = _one_call(session, sql)
    assert k == kind and ref.engine == tag
    got = _port(kind, req, snaps)
    assert got.engine == ref.engine
    assert got.is_partial_agg and ref.is_partial_agg
    rows = TR.partial_rows(got.chunks)
    assert rows and rows == TR.partial_rows(ref.chunks)


@pytest.mark.parametrize("name", ["q6", "q1"])
def test_tiled_epoch_matches_reference(session, name):
    # 121k rows in 40k-row tiles: 4 tiles padded to one shape bucket
    _, req, snap, _ = _one_call(session, SLICE[name][0])
    ref_cop = JC.CopClient()
    ref_cop.TILE_ROWS = 40_000
    ref = ref_cop.execute(req, snap)
    cop = CopClient("cpu")
    cop.TILE_ROWS = 40_000
    got = _port("dag", req, snap, cop)
    assert got.engine == ref.engine == "device"
    assert TR.partial_rows(got.chunks) == TR.partial_rows(ref.chunks)


def _without_agg_names(obj):
    """Request tree with AggDesc.name (the SQL text of the call, for
    display only) blanked."""
    if isinstance(obj, AggDesc):
        return dataclasses.replace(obj, name="",
                                   arg=_without_agg_names(obj.arg))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _without_agg_names(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, list):
        return [_without_agg_names(x) for x in obj]
    return obj


# join fragments built by hand in tpch_requests: (SQL, position among the
# statement's fragment calls, engine tag)
JOINS = {
    "q12": (TPCH_QUERIES["q12"], 0, "device[agg]"),
    "q14": (TPCH_QUERIES["q14"], 0, "device[agg]"),
    "q5": (TPCH_QUERIES["q5"], 0, "device[agg]"),
    "q17_outer": (TPCH_QUERIES["q17"], 0, "device[rows]"),
    "q18_outer": (TPCH_QUERIES["q18"], 0, "device[rows]"),
    "q18_join_having": (
        "select o_orderkey, sum(l_quantity) from lineitem, orders where "
        "l_orderkey = o_orderkey group by o_orderkey "
        "having sum(l_quantity) > 300", 0, "device[hc]"),
    "q3": (TPCH_QUERIES["q3"], 0, "device[fat]"),
    "q10": (TPCH_QUERIES["q10"], 0, "device[fat]"),
    "join_topn": (
        "select l_orderkey, l_linenumber, o_orderdate, o_orderpriority, "
        "l_quantity from lineitem, orders where l_orderkey = o_orderkey and "
        "l_shipdate > '1995-03-15' order by o_orderdate desc, "
        "o_orderpriority, l_quantity desc limit 100", 0, "device[topn]"),
    "cust_having": (
        "select c_custkey, sum(l_quantity) from lineitem, orders, customer "
        "where l_orderkey = o_orderkey and o_custkey = c_custkey group by "
        "c_custkey having sum(l_quantity) > 2700", 0, "device[hc]"),
    # semi/anti membership edges
    "q4": (TPCH_QUERIES["q4"], 0, "device[agg+semi]"),
    "q16": (TPCH_QUERIES["q16"], 0, "device[rows+semi]"),
    "q20_semi": (TPCH_QUERIES["q20"], 1, "device[rows+semi]"),
    "semi_having": (
        "select l_orderkey, sum(l_quantity) from lineitem where exists "
        "(select * from orders where o_orderkey = l_orderkey and "
        "o_orderpriority = '1-URGENT') group by l_orderkey "
        "having sum(l_quantity) > 300", 0, "device[hc+semi]"),
}

# single-table row and TopN requests built by hand in tpch_requests: (SQL,
# position among the statement's CopClient.execute calls, engine tag)
DAGS = {
    "q21_rows": (TPCH_QUERIES["q21"], 1, "device"),
    "q13_orders_scan": (TPCH_QUERIES["q13"], 1, "device"),
    "row_proj": ("select l_orderkey, l_extendedprice * (1 - l_discount) "
                 "from lineitem where l_quantity < 5", 0, "device"),
    "scan_topn": ("select l_orderkey, l_linenumber, l_extendedprice from "
                  "lineitem where l_shipdate >= date '1995-01-01' order by "
                  "l_extendedprice desc limit 100", 0, "device"),
    "scan_topn3": ("select l_orderkey, l_shipdate, l_quantity from lineitem "
                   "where l_discount > 0.05 order by l_shipdate desc, "
                   "l_quantity, l_linenumber desc limit 100", 0, "device"),
}


@pytest.fixture(scope="module")
def tpch_session():
    s = Session()
    load_tpch(s, sf=SF, seed=SEED)
    return s


def _join_request_equals_planner(session, name):
    sql, pos, _ = JOINS[name]
    _, frag, snaps, _ = [c for c in _capture(session, sql)
                         if c[0] == "frag"][pos]
    tables = {}
    for t in list(frag.tables) + [sm.table for sm in frag.semis]:
        ref = t.table
        tables[ref.name] = TR.tpch_table(ref.name, ref.id, ref.columns[0].id)
        assert request_from_reference(ref) == tables[ref.name]
    built = TR.JOIN_REQUESTS[name](tables)
    assert _without_agg_names(built) == \
        _without_agg_names(request_from_reference(frag))


def _dag_request_equals_planner(session, name):
    sql, pos, tag = DAGS[name]
    _, dag, snap, ref = [c for c in _capture(session, sql)
                         if c[0] == "dag"][pos]
    assert ref.engine == tag
    t = snap.table
    table = TR.tpch_table(t.name, t.id, t.columns[0].id)
    assert request_from_reference(t) == table
    built = TR.DAG_REQUESTS[name]({t.name: table})
    assert built == request_from_reference(dag)


@pytest.mark.parametrize("name", sorted(SLICE) + sorted(JOINS) + sorted(DAGS))
def test_hand_built_request_equals_planner(request, name):
    if name in DAGS:
        _dag_request_equals_planner(request.getfixturevalue("tpch_session"),
                                    name)
        return
    if name in JOINS:
        _join_request_equals_planner(request.getfixturevalue("tpch_session"),
                                     name)
        return
    session = request.getfixturevalue("session")
    _, req, snaps, _ = _one_call(session, SLICE[name][0])
    planner = _without_agg_names(request_from_reference(req))
    tid = req.scan.table_id if name != "q18_inner" else \
        req.tables[0].table.id
    table = TR.lineitem_table(tid)
    assert request_from_reference(
        (snaps if name != "q18_inner" else snaps[tid]).table) == table
    built = {"q6": TR.q6_dag, "q1": TR.q1_dag,
             "q18_inner": TR.q18_inner_frag}[name](table)
    assert _without_agg_names(built) == planner


@pytest.mark.parametrize("table", ["lineitem", "orders", "part", "customer",
                                   "supplier", "partsupp", "nation",
                                   "region"])
def test_generator_matches_reference(table):
    ours = TD.generate_tpch(SF, SEED)[table]
    ref = ref_generate_tpch(SF, SEED)[table]
    assert ours.keys() == ref.keys()
    for col, v in ref.items():
        if isinstance(v, tuple):
            assert list(ours[col][0]) == list(v[0]), col
            assert np.array_equal(ours[col][1], v[1]), col
        else:
            assert np.array_equal(ours[col], v), col


def _join_matches_numpy_oracle(name):
    data = TD.generate_tpch(SF, SEED)
    tables, snaps = TR.load_tables(data, TR.JOIN_TABLES[name])
    frag = TR.JOIN_REQUESTS[name](tables)
    r = execute_fragment(CopClient("cpu"), frag, snaps)
    assert r.engine == JOINS[name][2]
    want = getattr(TR, f"{name}_oracle")(data)
    if frag.agg is not None:
        assert want and TR.partial_rows(r.chunks) == want
        return
    got = TR.row_columns(r.chunks)
    assert len(got) == len(want) and len(want[0])
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def _dag_matches_numpy_oracle(name):
    data = TD.generate_tpch(SF, SEED)
    tables, snaps = TR.load_tables(data, TR.DAG_TABLES[name])
    dag = TR.DAG_REQUESTS[name](tables)
    r = CopClient("cpu").execute(dag, snaps[dag.scan.table_id])
    assert r.engine == DAGS[name][2] and not r.is_partial_agg
    got, want = TR.row_columns(r.chunks), getattr(TR, f"{name}_oracle")(data)
    assert len(got) == len(want) and len(want[0])
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SLICE) + sorted(JOINS) + sorted(DAGS))
def test_port_matches_numpy_oracle(name):
    if name in DAGS:
        _dag_matches_numpy_oracle(name)
        return
    if name in JOINS:
        _join_matches_numpy_oracle(name)
        return
    li = TD.generate_tpch(SF, SEED)["lineitem"]
    table = TR.lineitem_table(5)
    snap = TR.load_table(table, li).snapshot(0)
    cop = CopClient("cpu")
    if name == "q18_inner":
        r = execute_fragment(cop, TR.q18_inner_frag(table), {5: snap})
        want = TR.q18_inner_oracle(li)
    else:
        r = cop.execute(getattr(TR, f"{name}_dag")(table), snap)
        want = getattr(TR, f"{name}_oracle")(li)
    assert r.engine == SLICE[name][2]
    assert want and TR.partial_rows(r.chunks) == want


# ---- wider single-table shapes on the same two entry points ------------------
# (SQL, outcome): "same" = identical rows and engine tag on a device path;
# "host" = identical rows and the reference's host(<reason>) tag
SHAPES = {
    # a string ordering compare keeps the filter on the host above a bare
    # row scan (no selection, no projection: no device program runs)
    "row_scan": (
        "select sum(l_quantity) from lineitem where l_shipmode > 'AIR'",
        "same"),
    # rows: plain projections of every visible row
    "row_bare_projected": (
        "select l_orderkey, l_comment from lineitem", "same"),
    # rows: a selection on the device (one packed bitmask per tile)
    "row_selection": (
        "select l_orderkey, l_quantity from lineitem "
        "where l_discount > 0.05 and l_shipmode = 'MAIL'", "same"),
    # rows: computed projections, evaluated on the host (NumpyEval)
    "row_projection": (
        "select l_orderkey + 1, l_quantity * 2, l_shipdate from lineitem "
        "where l_tax < 0.02", "same"),
    # rows: LIMIT cuts the selected rows, and a bare scan's
    "row_limit": (
        "select l_orderkey, l_partkey from lineitem where l_quantity > 45 "
        "limit 17", "same"),
    "row_limit_scan": ("select l_orderkey from lineitem limit 5", "same"),
    # TopN: a packed two-key composite over the selected rows
    "topn_two_keys": (
        "select l_orderkey, l_tax from lineitem where l_quantity < 3 "
        "order by l_tax, l_orderkey desc limit 20", "same"),
    # TopN gates: the key, or a projection, outgrows int32
    "topn_key_expression_too_wide": (
        "select l_orderkey from lineitem "
        "order by l_extendedprice * l_quantity desc limit 5", "host"),
    "topn_projection_too_wide": (
        "select l_orderkey, l_extendedprice * l_extendedprice from lineitem "
        "order by l_orderkey limit 5", "host"),
    "max_per_dict_group": (
        "select l_shipmode, max(l_extendedprice) from lineitem "
        "group by l_shipmode", "same"),
    "like_and_min_avg": (
        "select l_linenumber, l_shipmode, sum(l_quantity), avg(l_discount), "
        "min(l_shipdate) from lineitem where l_comment like '%ly%' "
        "group by l_linenumber, l_shipmode", "same"),
    "in_list_not": (
        "select count(*) from lineitem where l_shipinstruct in "
        "('NONE', 'COLLECT COD') and not (l_tax = 0)", "same"),
    "computed_key": (
        "select l_suppkey % 7, sum(l_quantity) from lineitem "
        "group by l_suppkey % 7", "same"),
    "year_key": (
        "select year(l_shipdate), sum(l_tax) from lineitem "
        "group by year(l_shipdate)", "same"),
    # dense gate rejects l_orderkey; lifted to a run-ordered fragment
    "all_groups_lift": (
        "select l_orderkey, count(*) from lineitem group by l_orderkey",
        "same"),
    "all_groups_lift_filtered": (
        "select l_orderkey, sum(l_extendedprice), count(l_tax) from lineitem "
        "where l_discount > 0.03 group by l_orderkey", "same"),
    # 201 dense segments over 121k rows: the one-hot (einsum) strategy
    "einsum_strategy": (
        "select l_suppkey, sum(l_quantity), count(*) from lineitem "
        "group by l_suppkey", "same"),
    # nine value arrays exceed streamseg's K <= 8: the sorted-run body
    # over the run-ordered epoch (raw key-change bounds, no sort)
    "streamseg_k_gate": (
        "select l_orderkey, sum(l_extendedprice), sum(l_tax), "
        "sum(l_discount), count(*) from lineitem group by l_orderkey",
        "same"),
    # the reference's host gate: the port's host tier answers
    "not_decomposable": (
        "select sum(l_extendedprice * l_extendedprice * l_extendedprice * "
        "l_quantity) from lineitem", "host"),
    # the int64-accumulator gate (|bound| x rows >= 2^62) that also sends
    # Q1's sum_charge to the host at SF10
    "int64_accumulator_gate": (
        "select sum(l_extendedprice * l_extendedprice) from lineitem",
        "host"),
    # not run-ordered: the sorted-run hc body sorts by l_partkey
    "sorted_run_body": (
        "select l_partkey, sum(l_quantity) from lineitem group by l_partkey",
        "same"),
    # three segment keys folded into two int32 sort operands, not
    # run-ordered (the filter keeps the ~22k groups inside the 65,536-group
    # buffer; unfiltered, every one of the 121k rows is a group and the
    # reference concedes group-overflow)
    "three_keys_one_pack": (
        "select l_orderkey, l_quantity, l_linenumber, count(*) from lineitem "
        "where l_quantity < 10 "
        "group by l_orderkey, l_quantity, l_linenumber",
        "same"),
    # three segment keys needing three int32 operands: the packing gate
    # rejects the sorted-run path and the reference goes to the host
    "three_keys_no_pack": (
        "select l_partkey * 100000, l_suppkey * 100000, l_orderkey, count(*) "
        "from lineitem group by l_partkey * 100000, l_suppkey * 100000, "
        "l_orderkey", "host"),
}


def _assert_same(got, ref):
    """Same engine tag and answer: partial rows compared sorted, row results
    column by column in the order returned, chunk for chunk (TopN: one
    chunk per tile)."""
    assert got.engine == ref.engine
    assert got.is_partial_agg == ref.is_partial_agg
    if ref.is_partial_agg:
        assert TR.partial_rows(got.chunks) == TR.partial_rows(ref.chunks)
        return
    assert len(got.chunks) == len(ref.chunks)
    cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
    assert len(cols) == len(want) and len(want[0])
    for a, b in zip(cols, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_single_table_shapes(session, name):
    sql, outcome = SHAPES[name]
    kind, req, snaps, ref = _one_call(session, sql)
    assert ref.engine.startswith("host(") == (outcome == "host")
    _assert_same(_port(kind, req, snaps), ref)


def test_group_overflow_gate_matches_reference(session):
    # a 256-group HAVING buffer: the ~290 passing orders exhaust it, and
    # the reference concedes to its host interpreter
    _, frag, snaps, _ = _one_call(session, Q18_INNER)
    with mock.patch.object(RefFragmentDAG, "HAVING_CAP", 256):
        ref = JF.execute_fragment(JC.CopClient(), frag, snaps)
    assert ref.engine == "host(fragment:group-overflow)"
    with mock.patch.object(FragmentDAG, "HAVING_CAP", 256):
        got = _port("frag", frag, snaps)
    _assert_same(got, ref)


# ---- NULLs and floats: a small table of every staged width ------------------

NULLABLE_DDL = ("create table t (k bigint not null, d double, "
                "x decimal(10,2), s varchar(10), b tinyint)")
NULLABLE_QUERIES = {
    "fsum_avg_max_by_key": "select k, sum(d), avg(x), count(x), max(d), "
                           "min(x) from t group by k",
    "by_string_with_nulls": "select s, count(*), sum(x) from t "
                            "where x is not null or d > 0 group by s",
    "by_nullable_int": "select b, sum(k), count(d) from t group by b",
    "no_group": "select sum(d), sum(x), count(*) from t where b < 3",
}


@pytest.fixture(scope="module")
def nullable_session():
    rng = np.random.default_rng(9)
    n = 5000
    s = Session()
    s.execute(NULLABLE_DDL)
    info = s.catalog.table(s.current_db, "t")
    store = s.storage.table_store(info.id)
    d = store.dictionaries[3]
    words = np.array([d.encode(w) for w in ("ab", "cd", "ef", "gh")])
    store.bulk_load(
        [np.sort(rng.integers(0, 40, n)), rng.random(n) * 100,
         rng.integers(-99999, 99999, n), words[rng.integers(0, 4, n)],
         rng.integers(-5, 6, n)],
        [None, rng.random(n) > 0.1, rng.random(n) > 0.2,
         rng.random(n) > 0.05, rng.random(n) > 0.3])
    return s


@pytest.mark.parametrize("name", sorted(NULLABLE_QUERIES))
def test_nulls_and_floats_match_reference(nullable_session, name):
    kind, req, snaps, ref = _one_call(nullable_session,
                                      NULLABLE_QUERIES[name])
    assert ref.engine == "device"
    got = _port(kind, req, snaps)
    assert got.engine == ref.engine
    rows, want = TR.partial_rows(got.chunks), TR.partial_rows(ref.chunks)
    assert len(rows) == len(want)
    for r, w in zip(rows, want):
        # float sums: f32 block partials summed on the host in f64, in
        # another order than the reference's (rtol 1e-6; the doubles are
        # positive so sums do not cancel); all else exact
        for a, b in zip(r, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-6)
            else:
                assert a == b


# ---- single-table TopN: NULLs, floats, signed zeros, the key gates ------------
# Each tile returns its top n rows in score order, ties to the lower row:
# compared chunk by chunk and row by row with the reference's candidates.
# NULLs sort first in ASC and last in DESC; ASC float keys score -v, so a
# column of zeros turns into -0.0 scores, and both packages rank -0.0 below
# +0.0 (IEEE total order).

NULLABLE_TOPN = {
    # 500 NULL d's lead the ASC order; the cut falls among the values
    "float_asc": "select k, d from t order by d limit 600",
    "float_desc": "select k, d from t order by d desc limit 60",
    # 1,500 NULL b's; b ties heavily (11 values): the cut is a tie
    "int_asc": "select k, b from t order by b limit 1600",
    "int_desc": "select k, b, s from t where d > 10 order by b desc limit 70",
    "decimal_desc": "select k, x from t order by x desc limit 30",
    "two_keys": "select k, b, x from t order by b desc, x limit 25",
}

ZERO_TOPN = {
    # NULLs first, then the zeros: the cut falls among -0.0 / +0.0 ties
    "zeros_asc": "select id, f from z order by f limit 700",
    # the positives, then the zeros
    "zeros_desc": "select id, f from z order by f desc limit 2000",
    # non-positive g: the zeros lead DESC, NULLs trail it
    "zeros_desc_first": "select id, g from z order by g desc limit 700",
    "negatives_asc": "select id, g from z order by g limit 700",
}


@pytest.fixture(scope="module")
def zeros_session():
    rng = np.random.default_rng(12)
    n = 3000
    s = Session()
    s.execute("create table z (id bigint primary key, f double, g double, "
              "w bigint)")
    info = s.catalog.table(s.current_db, "z")
    w = rng.integers(-1000, 1000, n)
    w[7] = -(2**31)  # -w overflows int32: the TopN key gate
    s.storage.table_store(info.id).bulk_load(
        [np.arange(n, dtype=np.int64),
         rng.choice(np.array([0.0, -0.0, 1.5, 2.25]), n),
         rng.choice(np.array([0.0, -0.0, -1.5, -3.0]), n), w],
        [None, rng.random(n) > 0.1, rng.random(n) > 0.1, None])
    return s


def _topn_case(request, name):
    if name in NULLABLE_TOPN:
        return request.getfixturevalue("nullable_session"), \
            NULLABLE_TOPN[name]
    return request.getfixturevalue("zeros_session"), ZERO_TOPN[name]


@pytest.mark.parametrize("tiled", [False, True], ids=["epoch", "tiled"])
@pytest.mark.parametrize("name", sorted(NULLABLE_TOPN) + sorted(ZERO_TOPN))
def test_scan_topn_matches_reference(request, name, tiled):
    session, sql = _topn_case(request, name)
    kind, req, snap, ref = _one_call(session, sql)
    assert kind == "dag" and req.topn is not None
    cop = CopClient("cpu")
    if tiled:
        # 5,000 (3,000) rows in 1,024-row tiles: one candidate chunk each
        ref_cop = JC.CopClient()
        ref_cop.TILE_ROWS = cop.TILE_ROWS = 1024
        ref = ref_cop.execute(req, snap)
        assert len(ref.chunks) == -(-snap.epoch.num_rows // 1024)
    assert ref.engine == "device"
    _assert_same(_port(kind, req, snap, cop), ref)


def test_topn_key_too_wide_gate(zeros_session):
    kind, req, snap, ref = _one_call(
        zeros_session, "select id, w from z order by w limit 5")
    assert ref.engine == "host(TopN key too wide for int32 device)"
    _assert_same(_port(kind, req, snap), ref)


@pytest.mark.parametrize("sql", [
    "select id, w * 3 from z order by id limit 5",
    "select id from z order by w * w limit 5"], ids=["output", "key"])
def test_topn_expression_too_wide_gate(zeros_session, sql):
    # w reaches -2^31: a product of it leaves int32, in an output column or
    # in the sort key (the planner projects the key, so it is an output too)
    kind, req, snap, ref = _one_call(zeros_session, sql)
    assert ref.engine == "host(TopN expression too wide for int32 device)"
    _assert_same(_port(kind, req, snap), ref)


def test_string_topn_key_gate(nullable_session):
    # the planner keeps a string ORDER BY on the host; a request whose one
    # key is a string projection gates out on both sides
    _, req, snap, _ = _one_call(nullable_session,
                                "select k, s from t order by k limit 5")
    key = req.projections[1]
    req = dataclasses.replace(req, topn=dataclasses.replace(
        req.topn, items=[(dataclasses.replace(key, idx=1), False)]))
    ref = JC.CopClient().execute(req, snap)
    assert ref.engine == "host(string TopN key is host-side)"
    _assert_same(_port("dag", req, snap), ref)
