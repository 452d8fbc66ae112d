"""TPC-H's refresh functions through SQL, port against reference.

TPC-H at SF0.01 (seed 42, all eight tables) is loaded into a reference
`Session` and a port `Session(device="cpu")`, and both ANALYZE every table.
Then, statement for statement on both sides:

1. RF1 (`bench/tpch_refresh.py`: 15 new orders with their lineitems, as
   10-row autocommit INSERTs, orders first): each statement's affected
   count and engine tag (`point`: the fast path) are the reference's;
2. the 22 queries but Q19 (its run is ~50 s a side at SF0.01, see
   `test_torch_sql_tpch.py`) give the reference's rows (exact; in order
   where the query has ORDER BY) and engine tags, over overlay deltas and
   over epochs that compaction rebuilt; Q3, Q4, Q5, Q6, Q10, Q12 and Q14
   also equal the numpy answers over the arrays as RF1 left them;
3. RF2 (the 15 seeded orders and their lineitems, by DELETE ... IN);
4. the same queries again, then once more after `Storage.flush()` folds
   every delta.

At SF0.01 RF1 writes 79 rows, far below the stores' 8,192-delta
threshold, so both sides' `TableStore.COMPACT_THRESHOLD` is set to 16 for
the module: commits then fold as they do at 8,192 on the card (at
min(safe_ts, commit_ts - 1)), and the stores stay equal after every
phase (epochs, dictionaries, deltas).
"""

import pytest

import tidb_tpu.store.table_store as ref_table_store
import tidb_tpu_torch.store.table_store as port_table_store
from tidb_tpu.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.bench import tpch_refresh as RF
from tidb_tpu_torch.bench import tpch_requests as TR

from test_torch_sql_tpch import ORDERED, RUN_QUERIES, load_both, norm_rows
from test_torch_store_writes import store_state

SF, SEED, THRESHOLD = 0.01, 42, 16


@pytest.fixture(scope="module")
def tpch():
    mp = pytest.MonkeyPatch()
    for mod in (ref_table_store, port_table_store):
        mp.setattr(mod.TableStore, "COMPACT_THRESHOLD", THRESHOLD)
    data, ref, port = load_both(SF, SEED)
    for s in (ref, port):
        for name in ("lineitem", "orders", "customer", "part", "partsupp",
                     "supplier", "nation", "region"):
            s.execute(f"analyze table {name}")
    new = RF.rf1_rows(data, SF, SEED + 1)
    keys = RF.rf2_keys(data, SF, SEED + 2)
    state = {"data": data, "new": new, "keys": keys,
             "after_rf1": RF.apply_rf1(data, new)}
    state["after_rf2"] = RF.apply_rf2(state["after_rf1"], keys)
    yield ref, port, state
    mp.undo()


def _run_both(ref, port, sql):
    want = ref.execute(sql)
    want_tags = list(ref.last_engines)
    got = port.execute(sql)
    return got, want, list(port.last_engines), want_tags


def _stores_equal(ref, port):
    for name in ("orders", "lineitem"):
        a = store_state(port.storage.table_store(
            port.catalog.table("test", name).id))
        b = store_state(ref.storage.table_store(
            ref.catalog.table("test", name).id))
        assert a == b, name


def test_rf1_statements(tpch):
    ref, port, state = tpch
    stmts = RF.rf1_statements(state["new"], batch=10)
    n_lines = len(state["new"]["lineitem"]["l_orderkey"])
    assert len(stmts) == 2 + -(-n_lines // 10) and n_lines > 3 * THRESHOLD
    for sql in stmts:
        got, want, tags, want_tags = _run_both(ref, port, sql)
        assert got.affected == want.affected == sql.count("),(") + 1
        assert tags == want_tags == ["point"]
    _stores_equal(ref, port)
    li = port.storage.table_store(port.catalog.table("test", "lineitem").id)
    assert li.epoch.fold_ts > 0 and 0 < len(li.deltas) < THRESHOLD


def _check(tpch, q, oracle_data):
    ref, port, state = tpch
    got, want, tags, want_tags = _run_both(ref, port, TPCH_QUERIES[q])
    assert norm_rows(got.rows, q in ORDERED) == \
        norm_rows(want.rows, q in ORDERED)
    assert tags == want_tags
    if oracle_data is not None and q in TR.SQL_ORACLES + ("q18",):
        assert TR.sql_cells(got.rows) == TR.sql_oracle(q, oracle_data)


@pytest.mark.parametrize("q", RUN_QUERIES)
def test_queries_after_rf1(tpch, q):
    _check(tpch, q, tpch[2]["after_rf1"])


def test_rf2_statements(tpch):
    ref, port, state = tpch
    stmts = RF.rf2_statements(state["keys"])
    assert len(stmts) == 2
    lines = int(sum(
        (state["after_rf1"]["lineitem"]["l_orderkey"] == k).sum()
        for k in state["keys"]))
    for sql, n in zip(stmts, (lines, len(state["keys"]))):
        got, want, tags, want_tags = _run_both(ref, port, sql)
        assert got.affected == want.affected == n
        assert tags == want_tags
    _stores_equal(ref, port)


@pytest.mark.parametrize("q", RUN_QUERIES)
def test_queries_after_rf2(tpch, q):
    _check(tpch, q, tpch[2]["after_rf2"])


@pytest.mark.parametrize("q", ["q1", "q3", "q6", "q12", "q18"])
def test_queries_after_full_compaction(tpch, q):
    ref, port, state = tpch
    if q == "q1":
        for s in (ref, port):
            s.storage.flush()
        _stores_equal(ref, port)
        li = port.storage.table_store(
            port.catalog.table("test", "lineitem").id)
        assert li.deltas == []
    _check(tpch, q, state["after_rf2"])
