"""TPC-H Q6, Q1 and Q18's inner block as coprocessor requests, with oracles.

The SQL tier (parser, planner) is a later slice of the port, so these
requests are built by hand with the port's dataclasses, exactly as the
reference planner builds them for the SQL below (the tests check that the
two are equal):

* Q6: `select sum(l_extendedprice * l_discount) from lineitem where
  l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' and
  l_discount between 0.05 and 0.07 and l_quantity < 24` -> a `CopDAG`;
* Q1: the pricing summary report (TPC-H spec 2.4.1) -> a `CopDAG`;
* Q18's inner block: `select l_orderkey, sum(l_quantity) from lineitem
  group by l_orderkey having sum(l_quantity) > 300` -> a single-table
  `FragmentDAG` with `having` set.

Each oracle computes, in numpy from the generated arrays, the rows the
coprocessor must return in its partial layout [group cols..., (val, cnt)
per aggregate], in the form `partial_rows` gives a result chunk.
"""

from __future__ import annotations

import numpy as np

from ..catalog.schema import ColumnInfo, TableInfo
from ..chunk.chunk import Chunk
from ..plan.dag import CopDAG, DAGAggregation, DAGScan, DAGSelection
from ..plan.expr import (AggDesc, Call, Col, Const, agg_result_type,
                         arith_result_type, bool_call)
from ..plan.fragment import FragmentDAG, FragTable
from ..store.table_store import TableStore
from ..types.field_type import FieldType, TypeKind
from ..types.value import parse_date

# lineitem DDL (TPC-H spec 1.4), every column NOT NULL
_BIGINT = FieldType(TypeKind.BIGINT, nullable=False)
_MONEY = FieldType(TypeKind.DECIMAL, flen=15, scale=2, nullable=False)
_DATE = FieldType(TypeKind.DATE, nullable=False)


def _char(n: int) -> FieldType:
    return FieldType(TypeKind.CHAR, flen=n, nullable=False)


LINEITEM_COLUMNS = [
    ("l_orderkey", _BIGINT), ("l_partkey", _BIGINT),
    ("l_suppkey", _BIGINT), ("l_linenumber", _BIGINT),
    ("l_quantity", _MONEY), ("l_extendedprice", _MONEY),
    ("l_discount", _MONEY), ("l_tax", _MONEY),
    ("l_returnflag", _char(1)), ("l_linestatus", _char(1)),
    ("l_shipdate", _DATE), ("l_commitdate", _DATE),
    ("l_receiptdate", _DATE), ("l_shipinstruct", _char(25)),
    ("l_shipmode", _char(10)),
    ("l_comment", FieldType(TypeKind.VARCHAR, flen=44, nullable=False)),
]


def lineitem_table(table_id: int = 1) -> TableInfo:
    return TableInfo(table_id, "lineitem", [
        ColumnInfo(i + 1, name, ft, offset=i)
        for i, (name, ft) in enumerate(LINEITEM_COLUMNS)])


def load_table(table: TableInfo, data: dict[str, object]) -> TableStore:
    """Bulk-load generated arrays (`tpch_data.generate_tpch(...)[name]`)
    into a fresh store; string columns encode through the store's
    dictionaries in vocabulary order, as the reference loader does."""
    store = TableStore(table)
    cols = []
    for c in table.columns:
        v = data[c.name]
        if isinstance(v, tuple):
            vocab, codes = v
            d = store.dictionaries[c.offset]
            remap = np.array([d.encode(s) for s in vocab], dtype=np.int64)
            cols.append(remap[codes])
        else:
            cols.append(np.asarray(v))
    store.bulk_load(cols)
    return store


def _col(table: TableInfo, off: int, idx: int) -> Col:
    c = table.columns[off]
    return Col(idx, c.ftype, c.name)


def _agg(func: str, arg) -> AggDesc:
    return AggDesc(func, arg, agg_result_type(func, arg))


def _partial_types(aggs: list[AggDesc]) -> list[FieldType]:
    """(val, cnt) per aggregate: SUM/AVG ship the sum at the argument's
    SUM type, COUNT its count; cnt is a non-null BIGINT."""
    out = []
    for d in aggs:
        val = agg_result_type("sum", d.arg) if d.func == "avg" else d.ftype
        out += [val, _BIGINT]
    return out


def q6_dag(table: TableInfo) -> CopDAG:
    qty, price, disc, ship = (_col(table, off, i)
                              for i, off in enumerate((4, 5, 6, 10)))
    conds = [
        bool_call("ge", [ship, Const(parse_date("1994-01-01"), _DATE)]),
        bool_call("lt", [ship, Const(parse_date("1995-01-01"), _DATE)]),
        bool_call("ge", [disc, Const(5, _MONEY)]),
        bool_call("le", [disc, Const(7, _MONEY)]),
        bool_call("lt", [qty, Const(2400, _MONEY)]),
    ]
    rev = Call("mul", [price, disc],
               arith_result_type("mul", price.ftype, disc.ftype))
    aggs = [_agg("sum", rev)]
    return CopDAG(scan=DAGScan(table.id, [4, 5, 6, 10]),
                  selection=DAGSelection(conds),
                  agg=DAGAggregation([], aggs),
                  output_types=_partial_types(aggs))


def q1_dag(table: TableInfo) -> CopDAG:
    offs = [4, 5, 6, 7, 8, 9, 10]
    qty, price, disc, tax, rf, ls, ship = (_col(table, off, i)
                                           for i, off in enumerate(offs))
    one = Const(1, _BIGINT)
    one_minus_disc = Call("sub", [one, disc],
                          arith_result_type("sub", _BIGINT, disc.ftype))
    disc_price = Call("mul", [price, one_minus_disc], arith_result_type(
        "mul", price.ftype, one_minus_disc.ftype))
    one_plus_tax = Call("add", [one, tax],
                        arith_result_type("add", _BIGINT, tax.ftype))
    charge = Call("mul", [disc_price, one_plus_tax], arith_result_type(
        "mul", disc_price.ftype, one_plus_tax.ftype))
    aggs = [_agg("sum", qty), _agg("sum", price), _agg("sum", disc_price),
            _agg("sum", charge), _agg("avg", qty), _agg("avg", price),
            _agg("avg", disc), _agg("count", None)]
    cutoff = parse_date("1998-12-01") - 90
    return CopDAG(scan=DAGScan(table.id, offs),
                  selection=DAGSelection(
                      [bool_call("le", [ship, Const(cutoff, _DATE)])]),
                  agg=DAGAggregation([rf, ls], aggs),
                  output_types=[rf.ftype, ls.ftype] + _partial_types(aggs))


Q18_THRESHOLD = 300 * 100  # sum(l_quantity) > 300, at the DECIMAL's scale 2


def q18_inner_frag(table: TableInfo) -> FragmentDAG:
    okey, qty = _col(table, 0, 0), _col(table, 4, 1)
    aggs = [_agg("sum", qty)]
    frag = FragmentDAG(
        [FragTable(table, [0, 4], [], [okey.ftype, qty.ftype])], [])
    frag.agg = DAGAggregation([okey], aggs)
    frag.output_types = [okey.ftype] + _partial_types(aggs)
    frag.having = [(0, "gt", Q18_THRESHOLD)]
    return frag


# ---- results as comparable rows ---------------------------------------------

def partial_rows(chunks: list[Chunk]) -> list[tuple]:
    """Result chunks -> sorted rows of plain values: dictionary codes
    decoded to strings, NULL as None, everything else its physical int
    (scaled decimals stay scaled)."""
    rows = []
    for ch in chunks:
        cols = []
        for c in ch.columns:
            valid = [True] * len(c.data) if c.valid is None else c.valid
            cols.append([
                None if not ok else c.dictionary.decode(int(x))
                if c.dictionary is not None else x.item()
                for x, ok in zip(c.data, valid)])
        rows.extend(zip(*cols))
    return sorted(rows, key=lambda r: tuple((v is None, v) for v in r))


# ---- numpy oracles -----------------------------------------------------------

def q6_oracle(li: dict) -> list[tuple]:
    ship, disc, qty = li["l_shipdate"], li["l_discount"], li["l_quantity"]
    m = ((ship >= parse_date("1994-01-01")) & (ship < parse_date("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    n = int(m.sum())
    if n == 0:
        return []
    val = int(np.sum(li["l_extendedprice"][m] * disc[m], dtype=np.int64))
    return [(val, n)]


def q1_oracle(li: dict) -> list[tuple]:
    m = li["l_shipdate"] <= parse_date("1998-12-01") - 90
    rf_vocab, rf = li["l_returnflag"]
    ls_vocab, ls = li["l_linestatus"]
    qty, price = li["l_quantity"][m], li["l_extendedprice"][m]
    disc, tax = li["l_discount"][m], li["l_tax"][m]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    key = rf[m] * len(ls_vocab) + ls[m]
    rows = []
    for k in np.unique(key):
        g = key == k
        n = int(g.sum())

        def s(x):
            return int(np.sum(x[g], dtype=np.int64))
        rows.append((rf_vocab[k // len(ls_vocab)], ls_vocab[k % len(ls_vocab)],
                     s(qty), n, s(price), n, s(disc_price), n, s(charge), n,
                     s(qty), n, s(price), n, s(disc), n, n, n))
    return sorted(rows)


def q18_inner_oracle(li: dict) -> list[tuple]:
    """Orders passing the coprocessor's widened HAVING test: the f32
    predicate sum > 300 - (|sum| * 2^-18 + 2), which the host Selection
    above re-applies exactly (l_quantity sums are multiples of 100, so
    the widened and the exact test agree)."""
    okey = li["l_orderkey"]
    keys, start, counts = np.unique(okey, return_index=True,
                                    return_counts=True)
    sums = np.add.reduceat(li["l_quantity"], start)
    sv = sums.astype(np.float32)
    eps = np.abs(sv) * np.float32(2.0 ** -18) + np.float32(2.0)
    ok = sv > np.float32(Q18_THRESHOLD) - eps
    return sorted(zip(keys[ok].tolist(), sums[ok].tolist(),
                      counts[ok].tolist()))
