"""Index-ranged scans: the port's `ranged` path vs the JAX reference, on the CPU.

A reference `Session` holds a table with secondary indexes (on a nullable
int, on a pair of ints, on a string and on a date), its data made from a
seed with numpy, and ANALYZEd so that the planner takes intervals too.
`unittest.mock` wraps the reference's `CopClient.execute` to capture each
index-ranged request (`DAGScan.ranges` set), its snapshot and the
reference's answer; the request runs through the port
(`tidb_tpu_torch.convert`, `device="cpu"`), whose converted snapshot
carries a port store holding the table's indexes. Overlay rows come from
a transaction's writes (inserts, updates, deletes), rolled back after.

Tolerance: exact: the same rows in the same (handle) order, or the same
partial aggregation rows, and the engine tag `ranged`.
"""

from unittest import mock

import numpy as np
import pytest

from tidb_tpu.copr import client as JC
from tidb_tpu.session import Session
from tidb_tpu.store import index as JI
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.store import index as PI

N = 5_000

QUERIES = {
    "point": "select k, a, x from r where a = 77",
    "in_list": "select k, x from r where a in (3, 77, 1500, 99999)",
    "absent_point": "select k from r where a = -5",
    "two_columns": "select k, x from r where a = 12 and b = 4",
    "string_point": "select k, s, dt from r where s = 'qq'",
    "string_absent": "select k from r where s = 'zz'",
    "points_agg": "select count(*), sum(x) from r where a in (5, 6, 7, 8)",
    "interval": "select k, dt, x from r where dt >= '1995-03-01' and "
                "dt < '1995-04-01'",
    "interval_open": "select k, dt from r where dt > '1997-11-20'",
    "interval_agg": "select s, count(*), sum(x) from r where dt between "
                    "'1995-01-01' and '1995-01-20' group by s",
}

WRITES = [
    # inserts matching the points and the interval, one with NULLs
    "insert into r values (900001, 77, 1, 'qq', '1995-03-10', 1.50), "
    "(900002, 12, 4, 'ab', '1997-12-01', -2.25), "
    "(900003, null, null, null, '1995-03-02', 0.00)",
    # updates moving rows into and out of the ranges
    "update r set a = 77, x = x + 1 where k < 25",
    "update r set s = 'qq' where k between 100 and 140",
    "delete from r where k between 2000 and 2600",
]


@pytest.fixture(scope="module")
def session():
    rng = np.random.default_rng(29)
    s = Session()
    s.execute("create table r (k bigint primary key, a int, b int, "
              "s varchar(10), dt date, x decimal(10,2))")
    info = s.catalog.table("test", "r")
    store = s.storage.table_store(info.id)
    # 'qq' is rare: a point on it is selective enough for the planner
    words = np.array([store.dictionaries[3].encode(w)
                      for w in ("ab", "cd", "ef", "gh", "qq")])
    store.bulk_load(
        [np.arange(N, dtype=np.int64), rng.integers(0, 2000, N),
         rng.integers(0, 10, N),
         words[rng.choice(5, N, p=[0.3, 0.3, 0.2, 0.195, 0.005])],
         rng.integers(8800, 10200, N), rng.integers(-99_999, 99_999, N)],
        [None, rng.random(N) > 0.1, rng.random(N) > 0.2, rng.random(N) > 0.1,
         None, None])
    for ddl in ("create index i_a on r (a)", "create index i_ab on r (a, b)",
                "create index i_s on r (s)", "create index i_dt on r (dt)"):
        s.execute(ddl)
    s.execute("analyze table r")
    return s


def _ranged_call(session, sql, writes=()):
    calls = []
    run = JC.CopClient.execute

    def dag_call(self, dag, snap):
        r = run(self, dag, snap)
        calls.append((dag, snap, r))
        return r

    session.execute("begin")
    try:
        for w in writes:
            session.execute(w)
        with mock.patch.object(JC.CopClient, "execute", dag_call):
            session.query(sql)
    finally:
        session.execute("rollback")
    assert len(calls) == 1
    dag, snap, ref = calls[0]
    assert dag.scan.ranges is not None and ref.engine == "ranged"
    return dag, snap, ref


def _assert_same(got, ref):
    assert got.engine == ref.engine == "ranged"
    assert got.is_partial_agg == ref.is_partial_agg
    if ref.is_partial_agg:
        assert TR.partial_rows(got.chunks) == TR.partial_rows(ref.chunks)
        return
    assert len(got.chunks) == len(ref.chunks)
    cols, want = TR.row_columns(got.chunks), TR.row_columns(ref.chunks)
    assert len(cols) == len(want)
    for a, b in zip(cols, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("overlay", [False, True], ids=["epoch", "overlay"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_ranged_request_matches_reference(session, name, overlay):
    dag, snap, ref = _ranged_call(session, QUERIES[name],
                                  WRITES if overlay else ())
    assert (len(snap.overlay_handles) > 0) == overlay
    req = request_from_reference(dag)
    assert req.scan.ranges.describe() == dag.scan.ranges.describe()
    _assert_same(CopClient("cpu").execute(req, snapshot_from_reference(snap)),
                 ref)


@pytest.mark.parametrize("overlay", [False, True], ids=["epoch", "overlay"])
def test_index_searcher_matches_reference(session, overlay):
    # every index, points (NULL and absent ones too) and intervals, and
    # the single-column sort order
    _, snap, _ = _ranged_call(session, QUERIES["point"],
                              WRITES if overlay else ())
    port = snapshot_from_reference(snap)
    for ref_idx in snap.table.indices:
        idx = request_from_reference(ref_idx)
        js = JI.IndexSearcher(snap.store, snap, ref_idx)
        ps = PI.IndexSearcher(port.store, port, idx)
        first = snap.table.columns[ref_idx.col_offsets[0]].ftype
        if first.is_string:
            points = [("ab",), ("qq",), ("zz",), (None,)]
        else:
            points = [(77,), (12, 4), (12, None), (-1,), (None,), (1999, 9)]
            points = [p[:len(ref_idx.col_offsets)] for p in points]
        for p in points:
            assert np.array_equal(ps.eq(p), js.eq(p)), (ref_idx.name, p)
        if first.is_string:
            continue
        for lo, hi, li, hi_i in [(10, 500, True, False), (None, 40, True, True),
                                 (9000, None, False, True),
                                 (9500, 9400, True, True)]:
            assert np.array_equal(ps.range(lo, hi, li, hi_i),
                                  js.range(lo, hi, li, hi_i))
    for off in (1, 3, 4):
        jo, js_ = JI.epoch_column_order(snap.store, snap.epoch, off)
        po, ps_ = PI.epoch_column_order(port.store, port.epoch, off)
        assert js_ == ps_ and np.array_equal(po, jo)


def test_ranged_helpers_match_the_oracles():
    # the bench requests over TPC-H orders with two indexes, before and
    # after the overlay helper's deltas
    from tidb_tpu_torch.bench import tpch_data as TD
    data = TD.generate_tpch(0.01, 3)
    t = TR.orders_indexed_table(1)
    base = TR.load_table(t, data["orders"]).snapshot(0)
    ov_snap, _, ov = TR.overlay_snapshot(base, data["orders"], 3)
    rng = np.random.default_rng(3)
    custs = rng.choice(np.unique(data["orders"]["o_custkey"]), 50,
                       replace=False)
    cop = CopClient("cpu")
    for snap, overlay in ((base, None), (ov_snap, ov)):
        rows, handles = TR.visible_rows(snap, data["orders"], overlay)
        for dag, want in (
                (TR.ranged_points_dag({"orders": t}, custs),
                 TR.ranged_points_oracle(rows, handles, custs)),
                (TR.ranged_interval_dag({"orders": t}),
                 TR.ranged_interval_oracle(rows, handles))):
            r = cop.execute(dag, snap)
            assert r.engine == "ranged"
            got = TR.row_columns(r.chunks)
            assert len(got) == len(want) and len(want[0])
            for a, b in zip(got, want):
                assert np.array_equal(a, b)
