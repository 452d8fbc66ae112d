"""The host interpreter: the port's `host_exec` and `_host_fragment` vs the
JAX reference's, on the CPU.

Requests are captured from a reference `Session` over a table of every
staged width (NULLs in ints, doubles and strings; made from a seed with
numpy), then edited where a case needs a shape the planner would not push
(a string or float TopN key, float and NULL group keys in a fragment).
Both packages' interpreters run the same request on the same snapshot:
`host_exec.execute_host` for a `CopDAG`, `fragment._host_fragment` for a
`FragmentDAG`. Each gate of the device paths that leads here is covered
by the comparisons in `test_torch_slice.py`, `test_torch_joins.py`,
`test_torch_topn.py` and `test_torch_overlay.py`; this file holds the
interpreter's own cases, and the port's grouping of key tuples against
`np.unique(axis=0)`, which the reference groups with.

Tolerance: exact, float sums included: both sides sum the same float64
values in the same order (`np.add.reduceat` over the same group order,
`np.bincount`).
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

from tidb_tpu.copr import client as JC
from tidb_tpu.copr import fragment as JF
from tidb_tpu.copr import host_exec as JH
from tidb_tpu.plan.dag import DAGAggregation
from tidb_tpu.plan.expr import AggDesc, Col
from tidb_tpu.plan.fragment import FragmentDAG, FragTable
from tidb_tpu.session import Session
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr import fragment as PF
from tidb_tpu_torch.copr import host_exec as PH

N = 4_000


@pytest.fixture(scope="module")
def session():
    rng = np.random.default_rng(23)
    s = Session()
    s.execute("create table t (k bigint primary key, a int, b int, d double, "
              "s varchar(10), x decimal(10,2))")
    info = s.catalog.table("test", "t")
    store = s.storage.table_store(info.id)
    words = np.array([store.dictionaries[4].encode(w)
                      for w in ("pear", "apple", "fig", "kiwi")])
    d = np.round(rng.normal(size=N) * 4) / 2  # repeats, zeros of both signs
    d[:7] = -0.0
    store.bulk_load(
        [np.arange(N, dtype=np.int64), rng.integers(-50, 50, N),
         rng.integers(0, 9, N), d, words[rng.integers(0, 4, N)],
         rng.integers(-99_999, 99_999, N)],
        [None, None, rng.random(N) > 0.2, rng.random(N) > 0.15,
         rng.random(N) > 0.1, None])
    return s


def _dag_call(session, sql):
    calls = []
    run = JC.CopClient.execute

    def dag_call(self, dag, snap):
        r = run(self, dag, snap)
        calls.append((dag, snap))
        return r

    with mock.patch.object(JC.CopClient, "execute", dag_call):
        session.query(sql)
    assert len(calls) == 1
    return calls[0]


def _same_chunks(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g.columns) == len(w.columns)
        for a, b in zip(g.columns, w.columns):
            assert a.ftype == request_from_reference(b.ftype)
            assert a.data.dtype == b.data.dtype
            assert np.array_equal(a.data, b.data)
            assert np.array_equal(a.validity, b.validity)
            if b.dictionary is not None:
                assert list(a.dictionary.values) == list(b.dictionary.values)


def _host_same(dag, snap):
    want = JH.execute_host(dag, snap, "test")
    got = PH.execute_host(request_from_reference(dag),
                          snapshot_from_reference(snap), "test")
    assert got.is_partial_agg == want.is_partial_agg
    _same_chunks(got.chunks, want.chunks)
    return got


def _with_items(dag, items):
    return dataclasses.replace(dag, topn=dataclasses.replace(
        dag.topn, items=items))


def test_topn_keys(session):
    # projections (k, s, d, b): string keys by collation rank, float keys
    # with NULLs and signed zeros, mixed directions, ties to storage order
    dag, snap = _dag_call(session, "select k, s, d, b from t order by k "
                                   "limit 60")
    out = dag.projections
    cases = [[(Col(1, out[1].ftype), False)],
             [(Col(1, out[1].ftype), True), (Col(2, out[2].ftype), False)],
             [(Col(2, out[2].ftype), True)],
             [(Col(3, out[3].ftype), False), (Col(1, out[1].ftype), True),
              (Col(2, out[2].ftype), True)]]
    for items in cases:
        got = _host_same(_with_items(dag, items), snap)
        assert got.chunks[0].num_rows == 60


def test_agg_with_hll_columns(session):
    dag, snap = _dag_call(session, "select b, approx_count_distinct(a), "
                                   "approx_count_distinct(x), sum(d), count(d) "
                                   "from t group by b")
    got = _host_same(dag, snap)
    assert got.chunks[0].num_rows == 10  # 9 values and NULL


@pytest.mark.parametrize("sql", [
    "select b, sum(x), count(d), max(d), min(a), avg(x) from t "
    "where d > 0 group by b",
    "select s, b, count(*), sum(d) from t group by s, b",
    "select count(*), sum(x) from t where a > 10",
    "select k, s from t where a = 3 limit 7"], ids=["agg", "two_keys",
                                                     "no_group", "rows"])
def test_requests(session, sql):
    _host_same(*_dag_call(session, sql))


def test_empty_results(session):
    # nothing passes: an aggregation answers no chunk, rows one empty
    # chunk, a fragment no chunk
    for sql, n_chunks in (("select b, sum(x) from t where a > 1000 "
                           "group by b", 0),
                          ("select k, s from t where a > 1000", 1),
                          ("select k, d from t where a > 1000 order by d "
                           "limit 5", 1)):
        dag, snap = _dag_call(session, sql)
        got = _host_same(dag, snap)
        assert len(got.chunks) == n_chunks
        assert all(c.num_rows == 0 for c in got.chunks)
    frag, snaps = _fragment(session, [], "a > 1000")
    assert PF._host_fragment(request_from_reference(frag), {
        tid: snapshot_from_reference(s) for tid, s in snaps.items()
    }).chunks == JF._host_fragment(frag, snaps).chunks == []


def _fragment(session, group_offsets, where=None):
    """A single-table fragment over t grouping by the columns at
    `group_offsets` (float and NULL keys allowed), with sum / count / min /
    max / avg aggregates."""
    dag, snap = _dag_call(session, "select a, b, d, x, s from t where " +
                          (where or "k >= 0"))
    cols = dag.scan.col_offsets
    types = [snap.table.columns[o].ftype for o in cols]
    frag = FragmentDAG([FragTable(snap.table, list(cols),
                                  list(dag.selection.conditions),
                                  types)], [])
    c = [Col(i, ft) for i, ft in enumerate(types)]
    by = {o: c[cols.index(o)] for o in cols}
    aggs = [AggDesc("sum", by[5], types[cols.index(5)]),
            AggDesc("count", by[3], types[0]),
            AggDesc("min", by[3], types[cols.index(3)]),
            AggDesc("max", by[1], types[cols.index(1)]),
            AggDesc("avg", by[3], types[cols.index(3)])]
    frag.agg = DAGAggregation([by[o] for o in group_offsets], aggs)
    frag.output_types = [by[o].ftype for o in group_offsets] + [
        t for d in aggs for t in (d.ftype, types[0])]
    return frag, {snap.table.id: snap}


@pytest.mark.parametrize("keys", [[3], [2, 3], [4, 2], []],
                         ids=["float", "null_int_and_float",
                              "string_and_null_int", "no_key"])
def test_host_fragment_agg_group_keys(session, keys):
    frag, snaps = _fragment(session, keys)
    want = JF._host_fragment(frag, snaps)
    got = PF._host_fragment(request_from_reference(frag), {
        tid: snapshot_from_reference(s) for tid, s in snaps.items()})
    assert got.is_partial_agg and want.is_partial_agg
    _same_chunks(got.chunks, want.chunks)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_group_ids_equal_row_unique(seed):
    # NULL sentinels, float bit keys, wide spans that overflow the folded
    # code (the renumbering branch), and a single column
    rng = np.random.default_rng(seed)
    n = 3000
    cols = [np.where(rng.random(n) > 0.1, rng.integers(-5, 5, n),
                     np.iinfo(np.int64).min),
            rng.normal(size=n).round(1).view(np.int64),
            rng.integers(-(2**62), 2**62, n) // (10**17) * (10**17),
            rng.integers(0, 3, n)]
    for k in (cols[:1], cols[:2], cols, cols[2:3] * 3):
        want_inv = np.unique(np.stack(k, axis=1), axis=0,
                             return_inverse=True)[1].reshape(-1)
        inv, n_seg = PH._group_ids(k)
        assert np.array_equal(inv, want_inv) and n_seg == want_inv.max() + 1

