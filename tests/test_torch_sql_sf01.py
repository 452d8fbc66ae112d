"""Q20 as SQL text at SF0.1 (seed 42), where it returns rows.

At SF0.01 Q20 returns none (`test_torch_sql_tpch.py` runs it there all the
same); at SF0.1 the reference returns 19. The reference `Session` and the
port's `Session(device="cpu")` are loaded alike, statement for statement;
the port must give the reference's rows, in order (Q20 orders by
s_name), and its engine tags. Tolerance: none.
"""

from tidb_tpu.bench.tpch_queries import TPCH_QUERIES

from test_torch_sql_tpch import explain_both, load_both, norm_rows


def test_q20_at_sf01_returns_the_reference_rows():
    _, ref, port = load_both(0.1, 42)
    sql = TPCH_QUERIES["q20"]
    got, want = explain_both(ref, port, sql)
    assert got == want
    want_rows = ref.query(sql)
    rows = port.query(sql)
    assert len(want_rows) == 19
    assert port.last_engines == ref.last_engines
    assert norm_rows(rows, True) == norm_rows(want_rows, True)
