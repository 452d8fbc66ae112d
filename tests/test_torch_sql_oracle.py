"""The port's SQL answers against the sqlite oracle, and Q19 against the
reference, at SF0.003 (seed 7, the scale of `tests/test_tpch_full.py`).

* All 22 TPC-H queries run through a port `Session(device="cpu")` and
  through sqlite over the same generated rows (`tests/tpch_oracle.py`):
  an oracle independent of both packages, with its own float tolerance,
  since sqlite keeps decimals as floats. SF0.003 rather than SF0.01,
  because sqlite takes 84 s for Q21 alone at SF0.01.
* The numpy answers `chip_smoke.py` holds the card's SQL rows to
  (`bench/tpch_requests.sql_oracle`: Q3, Q4, Q5, Q6, Q10, Q12, Q14) equal
  the port's rows exactly, values, scales and order.
* Q19 runs on a reference `Session` and the port's, loaded alike at
  SF0.003 with seed 1: equal EXPLAIN, equal rows (exact), equal engine
  tags. The reference plans Q19 as a cross join of lineitem and part whose
  OR filter the root evaluates over every pair; at SF0.003 that is 10.8M
  pairs, about 50 s less than at SF0.01 on either side. Seed 1, because
  with seeds 7 and 42 no lineitem passes Q19's filter at this scale and
  the sum is NULL.
"""

import pytest

from tidb_tpu.bench.tpch_data import TPCH_DDL, generate_tpch
from tidb_tpu.bench.tpch_data import load_table as ref_load_table
from tidb_tpu.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu.session import Session as RefSession
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_data import load_table
from tidb_tpu_torch.session import Session

from test_torch_sql_tpch import explain_both, norm_rows
from tpch_oracle import load_sqlite, rows_equal, to_sqlite_sql

SF, SEED = 0.003, 7
QUERIES = sorted(TPCH_QUERIES, key=lambda q: int(q[1:]))
# queries whose final ORDER BY totally orders the result (as
# tests/test_tpch_full.py); the rest compare as multisets
TOTALLY_ORDERED = {"q2", "q21"}


@pytest.fixture(scope="module")
def loaded():
    data = generate_tpch(SF, SEED)
    port = Session(device="cpu")
    for name in TPCH_DDL:
        load_table(port, name, data[name])
    conn = load_sqlite(data, TPCH_DDL)
    yield data, port, conn
    conn.close()


@pytest.mark.parametrize("q", QUERIES)
def test_rows_match_sqlite(loaded, q):
    _, port, conn = loaded
    sql = TPCH_QUERIES[q]
    got = port.query(sql)
    want = [tuple(r) for r in conn.execute(to_sqlite_sql(sql)).fetchall()]
    ok, msg = rows_equal(got, want, ordered=q in TOTALLY_ORDERED)
    assert ok, f"{q}: {msg}"


@pytest.mark.parametrize("q", TR.SQL_ORACLES)
def test_final_oracles_match_the_port(loaded, q):
    data, port, _ = loaded
    assert TR.sql_cells(port.query(TPCH_QUERIES[q])) == \
        TR.sql_oracle(q, data)


def test_q19_matches_reference():
    data = generate_tpch(SF, 1)
    ref, port = RefSession(), Session(device="cpu")
    for name in TPCH_DDL:
        ref_load_table(ref, name, data[name])
        load_table(port, name, data[name])
    sql = TPCH_QUERIES["q19"]
    got, want = explain_both(ref, port, sql)
    assert got == want
    assert any("HashJoin(INNER): eq=[]" in line for line in got)
    want_rows = ref.query(sql)
    rows = port.query(sql)
    assert port.last_engines == ref.last_engines == ["device", "device"]
    assert norm_rows(rows, False) == norm_rows(want_rows, False)
    assert rows[0][0] is not None  # some lineitem passes the filter
