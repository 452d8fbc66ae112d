"""TPC-H's refresh functions (specification clause 2.5) as SQL text.

* RF1, New Sales: SF x 1,500 new orders, each with 1-7 lineitems, drawn
  from `tpch_data.generate_tpch`'s own distributions (one seeded stream,
  the loaded vocabularies) with order keys that follow on from the
  loaded maximum (the generator's keys are dense). They go in as
  autocommit `INSERT ... VALUES` statements of `batch` rows each, orders
  first.
* RF2, Old Sales: SF x 1,500 existing orders, a seeded sample, deleted
  with their lineitems by `DELETE ... WHERE ... IN (...)` statements,
  lineitem first, each of at most `max_rows` keys and rows.

`apply_rf1` / `apply_rf2` give the generated arrays as the refresh leaves
them, in the generator's layout, so that the numpy oracles of
`tpch_requests` answer over the modified database.
"""

from __future__ import annotations

import numpy as np

from ..types.value import decode_date, parse_date
from .tpch_data import CURRENT_DATE, TPCH_DDL


def refresh_count(data: dict, sf: float) -> int:
    """Orders a refresh function inserts or deletes: SF x 1,500, at least
    one and at most the loaded orders."""
    return max(1, min(int(round(sf * 1500)),
                      len(data["orders"]["o_orderkey"])))


def rf1_rows(data: dict, sf: float, seed: int) -> dict:
    """New orders and lineitems in `generate_tpch`'s layout (string
    columns as (the loaded vocabulary, codes))."""
    rng = np.random.default_rng(seed)
    o, li = data["orders"], data["lineitem"]
    n = refresh_count(data, sf)
    ok = int(o["o_orderkey"].max()) + 1 + np.arange(n, dtype=np.int64)
    n_cust = len(data["customer"]["c_custkey"])
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    cust_pool = ck[ck % 3 != 0]
    o_cust = cust_pool[rng.integers(0, len(cust_pool), n)]
    d0, d1 = parse_date("1992-01-01"), parse_date("1998-08-02")
    o_date = rng.integers(d0, d1 + 1, n, dtype=np.int64)

    def pick(col, size):
        vocab, codes = col
        return vocab, rng.integers(0, int(codes.max()) + 1, size)

    lines_per = rng.integers(1, 8, n)
    jumbo = rng.random(n) < 0.01
    lines_per[jumbo] = 7
    l_ok = np.repeat(ok, lines_per)
    l_odate = np.repeat(o_date, lines_per)
    m = len(l_ok)
    starts = np.cumsum(lines_per) - lines_per
    l_ln = np.arange(m, dtype=np.int64) - np.repeat(starts, lines_per) + 1
    n_part = len(data["part"]["p_partkey"])
    S = len(data["supplier"]["s_suppkey"])
    l_pk = rng.integers(1, n_part + 1, m, dtype=np.int64)
    i4 = rng.integers(0, 4, m, dtype=np.int64)
    l_sk = (l_pk + i4 * (S // 4 + (l_pk - 1) // S)) % S + 1
    qty = rng.integers(1, 51, m, dtype=np.int64)
    l_jumbo = np.repeat(jumbo, lines_per)
    qty[l_jumbo] = rng.integers(45, 51, int(l_jumbo.sum()))
    retail = 90000 + (l_pk // 10) % 20001 + 100 * (l_pk % 1000)
    l_price = qty * retail
    disc = rng.integers(0, 11, m, dtype=np.int64)
    tax = rng.integers(0, 9, m, dtype=np.int64)
    ship = l_odate + rng.integers(1, 122, m)
    commit = l_odate + rng.integers(30, 91, m)
    receipt = ship + rng.integers(1, 31, m)
    cur = parse_date(CURRENT_DATE)
    rf = np.where(receipt <= cur, rng.integers(0, 2, m), 2)
    ls = (ship > cur).astype(np.int64)
    lines = {
        "l_orderkey": l_ok, "l_partkey": l_pk, "l_suppkey": l_sk,
        "l_linenumber": l_ln, "l_quantity": qty * 100,
        "l_extendedprice": l_price, "l_discount": disc, "l_tax": tax,
        "l_returnflag": (li["l_returnflag"][0], rf),
        "l_linestatus": (li["l_linestatus"][0], ls),
        "l_shipdate": ship, "l_commitdate": commit,
        "l_receiptdate": receipt,
        "l_shipinstruct": pick(li["l_shipinstruct"], m),
        "l_shipmode": pick(li["l_shipmode"], m),
        "l_comment": pick(li["l_comment"], m),
    }
    # o_orderstatus and o_totalprice from the lines, as the generator
    idx = np.repeat(np.arange(n), lines_per)
    sums = np.bincount(idx, weights=ls, minlength=n).astype(np.int64)
    status = np.full(n, 2, dtype=np.int64)
    status[sums == 0] = 0
    status[sums == lines_per] = 1
    line_total = l_price * (100 + tax) * (100 - disc) // 10000
    totals = np.zeros(n, dtype=np.int64)
    np.add.at(totals, idx, line_total)
    orders = {
        "o_orderkey": ok, "o_custkey": o_cust,
        "o_orderstatus": (o["o_orderstatus"][0], status),
        "o_totalprice": totals, "o_orderdate": o_date,
        "o_orderpriority": pick(o["o_orderpriority"], n),
        "o_clerk": pick(o["o_clerk"], n),
        "o_shippriority": np.zeros(n, dtype=np.int64),
        "o_comment": pick(o["o_comment"], n),
    }
    return {"orders": orders, "lineitem": lines}


def rf2_keys(data: dict, sf: float, seed: int) -> np.ndarray:
    """A seeded sample of SF x 1,500 loaded order keys, ascending."""
    rng = np.random.default_rng(seed)
    keys = data["orders"]["o_orderkey"]
    pick = rng.choice(len(keys), refresh_count(data, sf), replace=False)
    return np.sort(keys[pick])


def _column_types(table: str) -> dict[str, str]:
    out = {}
    for line in TPCH_DDL[table].splitlines():
        parts = line.strip().split()
        if len(parts) >= 2 and parts[0] not in ("create", ")"):
            out[parts[0]] = parts[1]
    return out


def _sql_column(col, ty: str) -> list[str]:
    """One column's values as SQL literals."""
    if isinstance(col, tuple):
        vocab, codes = col
        texts = [vocab[int(c)] for c in codes]
        assert not any("'" in s or "\\" in s for s in texts)
        return [f"'{s}'" for s in texts]
    if ty.startswith("decimal"):
        return [f"{'-' if v < 0 else ''}{abs(v) // 100}.{abs(v) % 100:02d}"
                for v in col.tolist()]
    if ty == "date":
        return [f"'{decode_date(v).isoformat()}'" for v in col.tolist()]
    return [str(v) for v in col.tolist()]


def insert_statements(table: str, rows: dict, batch: int = 1000
                      ) -> list[str]:
    """`INSERT INTO table VALUES ...` of `batch` rows each."""
    types = _column_types(table)
    names = list(types)
    cols = [_sql_column(rows[c], types[c]) for c in names]
    n = len(cols[0])
    out = []
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        out.append(f"insert into {table} values " + ",".join(
            "(" + ",".join(c[i] for c in cols) + ")" for i in range(lo, hi)))
    return out


def rf1_statements(new: dict, batch: int = 1000) -> list[str]:
    return insert_statements("orders", new["orders"], batch) + \
        insert_statements("lineitem", new["lineitem"], batch)


def rf2_statements(keys: np.ndarray, lines: np.ndarray = None,
                   max_rows: int = 15000) -> list[str]:
    """A lineitem and an orders DELETE per batch of `keys`; a batch holds
    at most `max_rows` keys and, where `lines` (each key's lineitem
    count) is given, at most `max_rows` lineitems."""
    lines = np.ones(len(keys), np.int64) if lines is None else lines
    batches, batch, rows = [], [], 0
    for k, n in zip(keys.tolist(), lines.tolist()):
        if batch and (len(batch) == max_rows or rows + n > max_rows):
            batches.append(batch)
            batch, rows = [], 0
        batch.append(k)
        rows += n
    out = []
    for batch in batches + [batch]:
        ks = ",".join(str(k) for k in batch)
        out.append(f"delete from lineitem where l_orderkey in ({ks})")
        out.append(f"delete from orders where o_orderkey in ({ks})")
    return out


def lines_per_order(data: dict, keys: np.ndarray) -> np.ndarray:
    """Each order key's lineitem count in `data`."""
    counts = np.bincount(data["lineitem"]["l_orderkey"],
                         minlength=int(keys.max()) + 1)
    return counts[keys]


def _concat(a, b):
    if isinstance(a, tuple):
        assert a[0] is b[0] or a[0] == b[0]
        return a[0], np.concatenate([a[1], b[1]])
    return np.concatenate([a, b])


def _take(col, mask: np.ndarray):
    if isinstance(col, tuple):
        return col[0], col[1][mask]
    return col[mask]


def rf1_prefix(new: dict, n_lines: int) -> dict:
    """RF1's rows once its order statements and its first `n_lines`
    lineitems have run (statements go in orders first)."""
    head = np.arange(len(new["lineitem"]["l_orderkey"])) < n_lines
    return {"orders": new["orders"],
            "lineitem": {c: _take(v, head)
                         for c, v in new["lineitem"].items()}}


def apply_rf1(data: dict, new: dict) -> dict:
    """`data` with `new`'s rows appended, table by table."""
    out = dict(data)
    for t in new:
        out[t] = {c: _concat(v, new[t][c]) for c, v in data[t].items()}
    return out


def apply_rf2(data: dict, keys: np.ndarray) -> dict:
    out = dict(data)
    for t, kc in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        keep = ~np.isin(data[t][kc], keys)
        out[t] = {c: _take(v, keep) for c, v in data[t].items()}
    return out
