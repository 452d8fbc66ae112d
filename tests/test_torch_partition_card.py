"""Partitioned tables read back on the card: TPC-H lineitem RANGE-
partitioned on l_orderkey (four ranges and MAXVALUE) beside orders and
customer at SF0.05 (seed 42), in a card `Session()` and a
`Session(device="cpu")`, each over its own in-memory store, through the
same script: routed INSERTs, an UPDATE that moves rows across partitions,
a DELETE, a new l_shipmode value in one partition read through LIKE and IN
from the others, TRUNCATE PARTITION, DROP PARTITION, the schema surface
(information_schema.partitions, SHOW TABLE STATUS, CHECKSUM TABLE, ADMIN
CHECK TABLE). After each statement the two give equal outcomes, and Q6, Q1
and Q18 equal rows and engine tags. A dropped partition's device tensors
are freed. Tolerance: none.

These tests need a CUDA device and skip elsewhere; the reference is not
imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_partition_card.py --noconftest -m gpu`.
"""

import pytest
import torch

from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_data import (generate_tpch, load_table,
                                            load_table_partitioned)
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

SF, SEED = 0.05, 42
# l_orderkey runs to ~SF x 60,000 x 4 (sparse keys): four ranges and the
# rest
BY = ("partition by range (l_orderkey) ("
      "partition p0 values less than (15000), "
      "partition p1 values less than (30000), "
      "partition p2 values less than (45000), "
      "partition p3 values less than (60000), "
      "partition pmax values less than maxvalue)")
NEW_ROW = ("14999, 1, 1, 9, 1.00, 2.00, 0.05, 0.01, 'N', 'O', "
           "'1995-01-01', '1995-01-02', '1995-01-03', 'NONE', "
           "'HOVERCRAFT', 'new'")

SCRIPT = [
    "INSERT INTO lineitem SELECT l_orderkey + 700000, l_partkey, "
    "l_suppkey, l_linenumber, l_quantity, l_extendedprice, l_discount, "
    "l_tax, l_returnflag, l_linestatus, l_shipdate, l_commitdate, "
    "l_receiptdate, l_shipinstruct, l_shipmode, l_comment FROM lineitem "
    "WHERE l_orderkey < 400",
    "UPDATE lineitem SET l_orderkey = l_orderkey + 20000 "
    "WHERE l_orderkey >= 14000 AND l_orderkey < 14100",
    "DELETE FROM lineitem WHERE l_orderkey >= 44000 AND l_orderkey < 44500",
    f"INSERT INTO lineitem VALUES ({NEW_ROW})",
    "SELECT count(*) FROM lineitem WHERE l_shipmode LIKE 'HOV%'",
    "SELECT count(*) FROM lineitem WHERE l_shipmode LIKE '%AIL' "
    "AND l_orderkey >= 15000",
    "SELECT l_shipmode, count(*) FROM lineitem WHERE l_shipmode IN "
    "('HOVERCRAFT', 'MAIL', 'SHIP') AND l_orderkey >= 30000 "
    "GROUP BY l_shipmode ORDER BY l_shipmode",
    "ALTER TABLE lineitem TRUNCATE PARTITION p2",
    "ALTER TABLE lineitem DROP PARTITION p1",
    "SELECT partition_name, partition_description, table_rows FROM "
    "information_schema.partitions WHERE table_name = 'lineitem' "
    "ORDER BY partition_ordinal_position",
    "SHOW TABLE STATUS LIKE 'lineitem'",
    "CHECKSUM TABLE lineitem",
    "ADMIN CHECK TABLE lineitem",
]


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    data = generate_tpch(SF, SEED)
    card, cpu = Session(Storage()), Session(Storage(), device="cpu")
    for s in (card, cpu):
        for name in ("orders", "customer"):
            load_table(s, name, data[name])
        load_table_partitioned(s, "lineitem", data["lineitem"], BY)
        s.execute("ANALYZE TABLE lineitem, orders, customer")
    return card, cpu


def _outcome(s, sql):
    try:
        rs = s.execute(sql)
    except Exception as e:  # the session error: errno and message
        return ("error", getattr(e, "errno", None), str(e))
    return (rs.affected, TR.sql_cells(rs.rows), list(s.last_engines))


def _reads(card, cpu) -> None:
    for q in ("q6", "q1", "q18"):
        rows = card.query(TPCH_QUERIES[q])
        want = cpu.query(TPCH_QUERIES[q])
        assert TR.sql_cells(rows) == TR.sql_cells(want), q
        assert card.last_engines == cpu.last_engines, q


@pytest.mark.gpu
def test_partition_script_card_equals_cpu(sessions):
    card, cpu = sessions
    _reads(card, cpu)
    assert card.last_engines and card.cop.device.type == "cuda"
    li = card.catalog.table("test", "lineitem")
    dropped = li.partition.by_name("p1").id
    out = {}
    for sql in SCRIPT:
        out[sql] = _outcome(card, sql)
        assert out[sql] == _outcome(cpu, sql), sql
        if not sql.startswith("SELECT"):
            _reads(card, cpu)
    assert out[SCRIPT[4]][1] == [(1,)]
    assert out[SCRIPT[1]][0] > 0
    assert dropped not in card.cop._live_epochs
    assert [r[0] for r in out[SCRIPT[9]][1]] == ["p0", "p2", "p3", "pmax"]
    assert out[SCRIPT[10]][1][0][16] == "partitioned"


@pytest.mark.gpu
def test_q6_q1_per_partition_device_tags(sessions):
    card, cpu = sessions
    n = len(card.catalog.table("test", "lineitem").partition.defs)
    for q in ("q6", "q1"):
        card.query(TPCH_QUERIES[q])
        assert card.last_engines == ["device"] * n, q
