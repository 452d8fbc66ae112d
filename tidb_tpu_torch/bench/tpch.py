"""TPC-H lineitem generation and the Q1/Q6 texts (correctness fixtures).

Port of `tidb_tpu/bench/tpch.py`, whole: the same seeded numpy arrays,
DDL and query texts. The reference uses the TPC-H plan corpus as its correctness baseline
(reference: cmd/explaintest/t/tpch.test, r/tpch.result) and ships an
importer for fake data (reference: cmd/importer). This module generates a
statistically-TPC-H-shaped `lineitem` directly into the columnar store
(vectorized numpy; deterministic per seed), sized by scale factor.

Column value distributions follow the TPC-H spec ranges (qty 1..50,
discount 0.00..0.10, tax 0.00..0.08, dates 1992-01-01..1998-12-01,
returnflag A/N/R correlated with receiptdate, linestatus from shipdate).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..types.value import parse_date

if TYPE_CHECKING:  # lazy: a data-only import must not pull torch
    from ..session import Session

LINEITEM_DDL = """
create table lineitem (
  l_orderkey bigint not null,
  l_partkey bigint not null,
  l_suppkey bigint not null,
  l_linenumber bigint not null,
  l_quantity decimal(15,2) not null,
  l_extendedprice decimal(15,2) not null,
  l_discount decimal(15,2) not null,
  l_tax decimal(15,2) not null,
  l_returnflag char(1) not null,
  l_linestatus char(1) not null,
  l_shipdate date not null,
  l_commitdate date not null,
  l_receiptdate date not null
)
"""

ROWS_PER_SF = 6_001_215

TPCH_Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""

TPCH_Q1 = """
select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""


def lineitem_ddl() -> str:
    return LINEITEM_DDL


def generate_lineitem_arrays(n_rows: int, seed: int = 42) -> dict[str, np.ndarray]:
    """Physical-encoding arrays for lineitem (decimals pre-scaled x100,
    dates as day numbers, flags as small ints to dictionary-encode)."""
    rng = np.random.default_rng(seed)
    orderkey = np.repeat(
        np.arange(1, n_rows // 4 + 2, dtype=np.int64), 4)[:n_rows]
    quantity = rng.integers(1, 51, n_rows, dtype=np.int64) * 100
    partkey = rng.integers(1, max(2, n_rows // 30), n_rows, dtype=np.int64)
    suppkey = rng.integers(1, max(2, n_rows // 300), n_rows, dtype=np.int64)
    linenumber = np.tile(np.arange(1, 5, dtype=np.int64),
                         n_rows // 4 + 1)[:n_rows]
    # extendedprice = qty * partprice, partprice in [900, 2100) cents*? spec
    # uses (90000 + partkey%...); keep it value-shaped: price per unit in
    # [901.00, 1100.99]
    unit_price = 90100 + (partkey % 20000) + rng.integers(0, 100, n_rows)
    extendedprice = (quantity // 100) * unit_price
    discount = rng.integers(0, 11, n_rows, dtype=np.int64)  # 0.00..0.10
    tax = rng.integers(0, 9, n_rows, dtype=np.int64)  # 0.00..0.08
    start = parse_date("1992-01-02")
    end = parse_date("1998-12-01")
    # dates/flags in the store's host dtypes (DATE=int32, dict
    # code=int32-able int8): bulk_load adopts without an int64->int32
    # cast copy, and the caller's oracle copy stays small (the r05 SF100
    # flight died of exactly these duplications)
    shipdate = rng.integers(start, end + 1, n_rows, dtype=np.int32)
    commitdate = shipdate + rng.integers(-30, 31, n_rows, dtype=np.int32)
    receiptdate = shipdate + rng.integers(1, 31, n_rows, dtype=np.int32)
    cutoff = parse_date("1995-06-17")
    # returnflag: R/A split for old receipts, N for recent (spec-shaped)
    ra = rng.integers(0, 2, n_rows, dtype=np.int8)
    returnflag = np.where(receiptdate <= cutoff, ra,
                          np.int8(2)).astype(np.int8)  # 0=A 1=R 2=N
    linestatus = (shipdate > cutoff).astype(np.int8)  # 0=F 1=O
    return {
        "l_orderkey": orderkey,
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_linenumber": linenumber,
        "l_quantity": quantity,
        "l_extendedprice": extendedprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
    }


def load_lineitem(session: "Session", n_rows: int, seed: int = 42,
                  arrays: dict[str, np.ndarray] | None = None) -> None:
    """Create + bulk-load lineitem into the session's storage. Pass
    pre-generated `arrays` to avoid generating twice (SF10 = ~30s/gen)."""
    session.execute("drop table if exists lineitem")
    session.execute(LINEITEM_DDL)
    info = session.catalog.table(session.current_db, "lineitem")
    store = session.storage.table_store(info.id)
    if arrays is None:
        arrays = generate_lineitem_arrays(n_rows, seed)

    # dictionary-encode the flag columns (A/R/N, F/O)
    rf_dict = store.dictionaries[info.column_by_name("l_returnflag").offset]
    ls_dict = store.dictionaries[info.column_by_name("l_linestatus").offset]
    rf_codes = np.array([rf_dict.encode(c) for c in ("A", "R", "N")],
                        dtype=np.int32)
    ls_codes = np.array([ls_dict.encode(c) for c in ("F", "O")],
                        dtype=np.int32)
    arrays = dict(arrays)
    arrays["l_returnflag"] = rf_codes[arrays["l_returnflag"]]
    arrays["l_linestatus"] = ls_codes[arrays["l_linestatus"]]

    columns = [arrays[c.name] for c in info.columns]
    store.bulk_load(columns)
