"""TPC-H requests to the coprocessor, built by hand, with numpy oracles.

These requests drive the coprocessor's entry points directly, without a
Session, so that each path is timed and checked on its own. They are
built by hand with the port's dataclasses, exactly as the reference
planner builds them for the SQL below (the tests check that the two are
equal):

* Q6: `select sum(l_extendedprice * l_discount) from lineitem where
  l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01' and
  l_discount between 0.05 and 0.07 and l_quantity < 24` -> a `CopDAG`;
* Q1: the pricing summary report (TPC-H spec 2.4.1) -> a `CopDAG`;
* Q18's inner block: `select l_orderkey, sum(l_quantity) from lineitem
  group by l_orderkey having sum(l_quantity) > 300` -> a single-table
  `FragmentDAG` with `having` set;
* join fragments (`FragmentDAG`s with gather joins), as the planner cuts
  them out of the TPC-H queries: Q12 (lineitem -> orders, GROUP BY
  l_shipmode), Q14 (lineitem -> part), Q5 (lineitem -> orders -> customer,
  supplier -> nation -> region, GROUP BY n_name), Q17's outer block
  (lineitem -> part, rows), Q18's outer block (lineitem -> orders ->
  customer, rows) and `q18_join_having`: `select o_orderkey,
  sum(l_quantity) from lineitem, orders where l_orderkey = o_orderkey group
  by o_orderkey having sum(l_quantity) > 300`;
* TopN and high-cardinality consumers: Q3 and Q10 (GROUP BY ... ORDER BY
  revenue LIMIT k, the fused cut), `join_topn` (lineitem -> orders rows
  ORDER BY o_orderdate DESC, o_orderpriority, l_quantity DESC LIMIT 100)
  and `cust_having` (GROUP BY c_custkey HAVING sum(l_quantity) > 2700);
* semi/anti membership edges: Q4 (orders EXISTS late lineitem, count per
  priority), Q16's fragment (partsupp -> part, NOT IN the complaining
  suppliers), Q20's partsupp block (IN the 'forest%' parts) and
  `semi_having` (Q18-inner over the lineitems of 1-URGENT orders);
* single-table row and TopN `CopDAG`s (`DAG_REQUESTS`): Q21's `lineitem
  l3` selection, Q13's bare orders scan, `row_proj` (a computed
  projection), `scan_topn` (one key) and `scan_topn3` (three keys packed
  into one int32).

Each oracle computes, in numpy from the generated arrays, what the
coprocessor must return: aggregations in its partial layout [group
cols..., (val, cnt) per aggregate], in the form `partial_rows` gives a
result chunk (TopN consumers: the k groups the fused cut keeps); row
results as the output columns in probe-row order (TopN rows: each tile's
top rows in order, ties to the lower row), in the form `row_columns` gives
the result chunks. `sql_oracle` finishes seven of them as the root does,
into the final rows a Session returns for the query text.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from ..catalog.schema import ColumnInfo, IndexInfo, TableInfo
from ..chunk.chunk import Chunk
from ..copr.analyze import (hll_group_registers_host, hll_hash_src_int,
                            hll_pack_words)
from ..copr.client import CopClient
from ..plan.dag import (HLL_WORDS, CopDAG, DAGAggregation, DAGScan,
                        DAGSelection, DAGTopN)
from ..plan.expr import (AggDesc, Call, Col, Const, agg_result_type,
                         arith_result_type, bool_call)
from ..plan.fragment import (FragJoin, FragmentDAG, FragSemi, FragTable,
                             HCTopN)
from ..plan.ranger import ScanRanges
from ..store.table_store import TableSnapshot, TableStore
from ..types.field_type import FieldType, TypeKind
from ..types.value import parse_date
from .tpch_data import TPCH_DDL

_BIGINT = FieldType(TypeKind.BIGINT, nullable=False)
_DATE = FieldType(TypeKind.DATE, nullable=False)
_MONEY = FieldType(TypeKind.DECIMAL, flen=15, scale=2, nullable=False)
_STR = FieldType(TypeKind.VARCHAR, nullable=False)  # a string literal
_KINDS = {"bigint": TypeKind.BIGINT, "decimal": TypeKind.DECIMAL,
          "date": TypeKind.DATE, "char": TypeKind.CHAR,
          "varchar": TypeKind.VARCHAR}


def tpch_table(name: str, table_id: int, first_column_id: int = 1
               ) -> TableInfo:
    """TableInfo of a TPC-H table from `tpch_data.TPCH_DDL`, as the
    reference catalog makes it: every column NOT NULL, the BIGINT primary
    key (where the table has one) as the row handle. Column ids count up
    from `first_column_id` (the catalog numbers them across tables)."""
    cols = []
    pk = None
    body = TPCH_DDL[name].strip().split("(", 1)[1].rsplit(")", 1)[0]
    for off, line in enumerate(body.strip().splitlines()):
        m = re.match(r"\s*(\w+) (\w+)(?:\((\d+)(?:,(\d+))?\))?(.*)", line)
        cname, kind, flen, scale, rest = m.groups()
        ft = FieldType(_KINDS[kind], flen=int(flen) if flen else -1,
                       scale=int(scale or 0), nullable="not null" not in rest)
        primary = "primary key" in rest
        if primary and ft.kind == TypeKind.BIGINT:
            pk = off
        cols.append(ColumnInfo(first_column_id + off, cname, ft, offset=off,
                               is_primary=primary))
    return TableInfo(table_id, name, cols, pk_handle_offset=pk)


def lineitem_table(table_id: int = 1) -> TableInfo:
    return tpch_table("lineitem", table_id)


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


def load_tables(data: dict, names, first_table_id: int = 1
                ) -> tuple[dict, dict]:
    """Load the named tables of `generate_tpch(...)` output: -> (name ->
    TableInfo, table id -> TableSnapshot with every row visible)."""
    tables, snaps = {}, {}
    for i, name in enumerate(names):
        t = tpch_table(name, first_table_id + i)
        tables[name] = t
        # a bulk-loaded store holds no delta: every ts sees the epoch
        snaps[t.id] = load_table(t, data[name]).snapshot(0)
    return tables, snaps


def _col(table: TableInfo, off: int, idx: int, alias: str = "") -> Col:
    """Column `off` of `table` at position `idx`, named as the planner
    names it (`alias.column` where the query aliases the table)."""
    c = table.columns[off]
    return Col(idx, c.ftype, f"{alias}.{c.name}" if alias else c.name)


def _agg(func: str, arg) -> AggDesc:
    return AggDesc(func, arg, agg_result_type(func, arg))


def _partial_types(aggs: list[AggDesc]) -> list[FieldType]:
    """(val, cnt) per aggregate: SUM/AVG ship the sum at the argument's
    SUM type, COUNT its count; APPROX_COUNT_DISTINCT ships HLL_WORDS
    register words in place of val; cnt is a non-null BIGINT."""
    out = []
    for d in aggs:
        if d.func == "approx_count_distinct":
            out += [_BIGINT] * HLL_WORDS
        else:
            out.append(agg_result_type("sum", d.arg) if d.func == "avg"
                       else d.ftype)
        out.append(_BIGINT)
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


# ---- join fragments -----------------------------------------------------------
# tables: name -> TableInfo for every table a request reads. Filters are in
# each table's local column space and name their column; the combined
# space (joins, selection, aggregation) is unnamed, as the planner
# leaves it.

def _frag(tables: dict, spec: list, joins: list) -> FragmentDAG:
    """spec: [(table name, offsets, filters(local cols))]; joins:
    [(build table position, probe key combined index)] on the build's
    first column (its key)."""
    ftabs = []
    for name, offs, filt in spec:
        t = tables[name]
        local = [_col(t, off, i) for i, off in enumerate(offs)]
        ftabs.append(FragTable(t, list(offs), filt(*local) if filt else [],
                               [c.ftype for c in local]))
    types = [ft for t in ftabs for ft in t.col_types]
    return FragmentDAG(ftabs, [FragJoin(b, Col(k, types[k], ""), 0)
                               for b, k in joins])


def _combined(frag: FragmentDAG, idx: int) -> Col:
    return Col(idx, frag.combined_types()[idx], "")


def _set_agg(frag: FragmentDAG, group_by: list, aggs: list) -> None:
    frag.agg = DAGAggregation(group_by, aggs)
    frag.output_types = [g.ftype for g in group_by] + _partial_types(aggs)


def _set_rows(frag: FragmentDAG, out_map: list[int]) -> None:
    types = frag.combined_types()
    frag.out_map = list(out_map)
    frag.output_types = [types[i] for i in out_map]


def _date_range(c: Col, lo: str, hi: str) -> list:
    return [bool_call("ge", [c, Const(parse_date(lo), _DATE)]),
            bool_call("lt", [c, Const(parse_date(hi), _DATE)])]


def _disc_price(price: Col, disc: Col) -> Call:
    """l_extendedprice * (1 - l_discount)"""
    one_minus = Call("sub", [Const(1, _BIGINT), disc],
                     arith_result_type("sub", _BIGINT, disc.ftype))
    return Call("mul", [price, one_minus],
                arith_result_type("mul", price.ftype, one_minus.ftype))


def q12_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q12: shipping modes and order priority (1994, MAIL/SHIP)."""
    def li_filters(okey, ship, commit, receipt, mode):
        return [bool_call("in_values", [mode], ["MAIL", "SHIP"]),
                bool_call("lt", [commit, receipt]),
                bool_call("lt", [ship, commit])] + \
            _date_range(receipt, "1994-01-01", "1995-01-01")
    frag = _frag(tables, [("lineitem", [0, 10, 11, 12, 14], li_filters),
                          ("orders", [0, 5], None)], [(1, 0)])
    prio = _combined(frag, 6)

    def count_if(op, join):
        cond = bool_call(join, [
            bool_call(op, [prio, Const("1-URGENT", _STR)]),
            bool_call(op, [prio, Const("2-HIGH", _STR)])])
        return _agg("sum", Call("case", [cond, Const(1, _BIGINT),
                                         Const(0, _BIGINT)], _BIGINT))
    _set_agg(frag, [_combined(frag, 4)],
             [count_if("eq", "or"), count_if("ne", "and")])
    return frag


def q14_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q14: promotion effect (September 1995)."""
    frag = _frag(tables, [
        ("lineitem", [1, 5, 6, 10],
         lambda pk, price, disc, ship: _date_range(ship, "1995-09-01",
                                                   "1995-10-01")),
        ("part", [0, 4], None)], [(1, 0)])
    rev = _disc_price(_combined(frag, 1), _combined(frag, 2))
    promo = bool_call("like", [_combined(frag, 5)], "PROMO%")
    _set_agg(frag, [], [
        _agg("sum", Call("case", [promo, rev, Const(0, _BIGINT)],
                         rev.ftype)),
        _agg("sum", rev)])
    return frag


def q5_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q5: local supplier volume (ASIA, 1994)."""
    frag = _frag(tables, [
        ("lineitem", [0, 2, 5, 6], None),
        ("orders", [0, 1, 4],
         lambda okey, cust, date: _date_range(date, "1994-01-01",
                                              "1995-01-01")),
        ("customer", [0, 3], None),
        ("supplier", [0, 3], None),
        ("nation", [0, 1, 2], None),
        ("region", [0, 1],
         lambda rkey, name: [bool_call("eq", [name, Const("ASIA", _STR)])]),
    ], [(1, 0), (2, 5), (3, 1), (4, 10), (5, 13)])
    # c_nationkey = s_nationkey
    frag.selection = [bool_call("eq", [_combined(frag, 8),
                                       _combined(frag, 10)])]
    _set_agg(frag, [_combined(frag, 12)],
             [_agg("sum", _disc_price(_combined(frag, 2),
                                      _combined(frag, 3)))])
    return frag


def q7_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q7: volume shipping (FRANCE / GERMANY, 1995-1996): lineitem ->
    supplier -> nation n1 and lineitem -> orders -> customer -> nation n2,
    GROUP BY n1.n_name, n2.n_name, year(l_shipdate). Its dense space is
    26 x 26 x (year span + 1) = 5,408 slots, so at SF1 and above (>= 128
    rows a slot) the dense gate keeps the einsum strategy."""
    frag = _frag(tables, [
        ("lineitem", [0, 2, 5, 6, 10],
         lambda okey, supp, price, disc, ship: [
             bool_call("ge", [ship, Const(parse_date("1995-01-01"), _DATE)]),
             bool_call("le", [ship, Const(parse_date("1996-12-31"), _DATE)])]),
        ("supplier", [0, 3], None),
        ("orders", [0, 1], None),
        ("customer", [0, 3], None),
        ("nation", [0, 1], None),
        ("nation", [0, 1], None),
    ], [(1, 1), (2, 0), (3, 8), (4, 6), (5, 10)])
    n1, n2 = _combined(frag, 12), _combined(frag, 14)

    def pair(a, b):
        return bool_call("and", [bool_call("eq", [n1, Const(a, _STR)]),
                                 bool_call("eq", [n2, Const(b, _STR)])])
    frag.selection = [bool_call("or", [pair("FRANCE", "GERMANY"),
                                       pair("GERMANY", "FRANCE")])]
    year = Call("year", [_combined(frag, 4)], FieldType(TypeKind.BIGINT))
    _set_agg(frag, [n1, n2, year],
             [_agg("sum", _disc_price(_combined(frag, 2),
                                      _combined(frag, 3)))])
    return frag


def q17_outer_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q17's outer block: the lineitem rows of Brand#23 MED BOX
    parts (the correlated avg(l_quantity) runs above it)."""
    frag = _frag(tables, [
        ("lineitem", [1, 4, 5], None),
        ("part", [0, 3, 6],
         lambda pk, brand, cont: [
             bool_call("eq", [brand, Const("Brand#23", _STR)]),
             bool_call("eq", [cont, Const("MED BOX", _STR)])])],
        [(1, 0)])
    _set_rows(frag, [0, 1, 2, 3, 4, 5])
    return frag


def q18_outer_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q18's outer block: every lineitem row with its order and
    customer (the IN (inner block) semi-join runs above it)."""
    frag = _frag(tables, [("lineitem", [0, 4], None),
                          ("orders", [0, 1, 3, 4], None),
                          ("customer", [0, 1], None)], [(1, 0), (2, 3)])
    _set_rows(frag, [6, 7, 2, 3, 4, 5, 0, 1])
    return frag


def q18_join_having_frag(tables: dict) -> FragmentDAG:
    """GROUP BY o_orderkey ... HAVING sum(l_quantity) > 300 over lineitem
    joined to orders: o_orderkey is the join's unique build key, so the
    run-ordered l_orderkey stands for it and the rank path serves it."""
    frag = _frag(tables, [("lineitem", [0, 4], None),
                          ("orders", [0], None)], [(1, 0)])
    _set_agg(frag, [_combined(frag, 2)], [_agg("sum", _combined(frag, 1))])
    frag.having = [(0, "gt", Q18_THRESHOLD)]
    return frag


Q3_CUTOFF = "1995-03-15"


def q3_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q3: shipping priority (BUILDING, 1995-03-15): GROUP BY
    l_orderkey, o_orderdate, o_shippriority ORDER BY revenue DESC,
    o_orderdate LIMIT 10. l_orderkey determines the orders columns, so it
    is the one segment key, and lineitem is run-ordered by it."""
    cutoff = Const(parse_date(Q3_CUTOFF), _DATE)
    frag = _frag(tables, [
        ("lineitem", [0, 5, 6, 10],
         lambda okey, price, disc, ship: [bool_call("gt", [ship, cutoff])]),
        ("orders", [0, 1, 4, 7],
         lambda okey, cust, date, prio: [bool_call("lt", [date, cutoff])]),
        ("customer", [0, 6],
         lambda ckey, seg: [bool_call("eq", [seg,
                                             Const("BUILDING", _STR)])]),
    ], [(1, 0), (2, 5)])
    _set_agg(frag, [_combined(frag, 0), _combined(frag, 6),
                    _combined(frag, 7)],
             [_agg("sum", _disc_price(_combined(frag, 1),
                                      _combined(frag, 2)))])
    frag.hc = HCTopN(("agg", 0), True, 10,
                     [("agg", 0, True), ("group", 1, False)])
    return frag


def q10_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q10: returned item reporting (1993-10-01 .. 1994-01-01):
    GROUP BY the customer's columns and n_name ORDER BY revenue DESC LIMIT
    20. c_custkey (the customer's primary key) determines the rest; it is
    reached through orders, so lineitem is not run-ordered by it and the
    sorted-run body serves the fragment."""
    frag = _frag(tables, [
        ("lineitem", [0, 5, 6, 8],
         lambda okey, price, disc, flag: [
             bool_call("eq", [flag, Const("R", _STR)])]),
        ("orders", [0, 1, 4],
         lambda okey, cust, date: _date_range(date, "1993-10-01",
                                              "1994-01-01")),
        ("customer", [0, 1, 2, 3, 4, 5, 7], None),
        ("nation", [0, 1], None),
    ], [(1, 0), (2, 5), (3, 10)])
    _set_agg(frag, [_combined(frag, i) for i in (7, 8, 12, 11, 15, 9, 13)],
             [_agg("sum", _disc_price(_combined(frag, 1),
                                      _combined(frag, 2)))])
    frag.hc = HCTopN(("agg", 0), True, 20, [("agg", 0, True)])
    return frag


JOIN_TOPN_N = 100


def join_topn_frag(tables: dict) -> FragmentDAG:
    """`select l_orderkey, l_linenumber, o_orderdate, o_orderpriority,
    l_quantity from lineitem, orders where l_orderkey = o_orderkey and
    l_shipdate > '1995-03-15' order by o_orderdate desc, o_orderpriority,
    l_quantity desc limit 100`: a row fragment with a TopN consumer whose
    three keys pack into one int32 (o_orderpriority through its
    dictionary's rank table)."""
    cutoff = Const(parse_date(Q3_CUTOFF), _DATE)
    frag = _frag(tables, [
        ("lineitem", [0, 3, 4, 10],
         lambda okey, line, qty, ship: [bool_call("gt", [ship, cutoff])]),
        ("orders", [0, 4, 5], None)], [(1, 0)])
    _set_rows(frag, list(range(7)))
    frag.topn = DAGTopN([(_combined(frag, 5), True),
                         (_combined(frag, 6), False),
                         (_combined(frag, 2), True)], JOIN_TOPN_N)
    return frag


# sum(l_quantity) > 2700 at the DECIMAL's scale 2: ~1.4k customers pass at
# SF1 and ~14k at SF10 (the HAVING buffer holds 65,536)
CUST_HAVING_THRESHOLD = 2700 * 100


def cust_having_frag(tables: dict) -> FragmentDAG:
    """`select c_custkey, sum(l_quantity) from lineitem, orders, customer
    where l_orderkey = o_orderkey and o_custkey = c_custkey group by
    c_custkey having sum(l_quantity) > 2700`: c_custkey is not run-ordered
    in lineitem, so the sorted-run body sorts every row by it."""
    frag = _frag(tables, [("lineitem", [0, 4], None),
                          ("orders", [0, 1], None),
                          ("customer", [0], None)], [(1, 0), (2, 3)])
    _set_agg(frag, [_combined(frag, 4)], [_agg("sum", _combined(frag, 1))])
    frag.having = [(0, "gt", CUST_HAVING_THRESHOLD)]
    return frag


def _semi(tables: dict, name: str, offs: list, filt, probe: Col,
          kind: str) -> FragSemi:
    """Membership edge over a bare scan of `name` (key: its first
    column); filters in the build table's local column space."""
    t = tables[name]
    local = [_col(t, off, i) for i, off in enumerate(offs)]
    return FragSemi(FragTable(t, list(offs), filt(*local) if filt else [],
                              [c.ftype for c in local]), probe, 0, kind)


def q4_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q4: order priority checking (1993-07-01 .. 1993-10-01): the
    orders with a late lineitem (EXISTS, a SEMI edge whose build filter
    l_commitdate < l_receiptdate runs on the host), counted per
    o_orderpriority."""
    frag = _frag(tables, [
        ("orders", [0, 4, 5],
         lambda okey, date, prio: _date_range(date, "1993-07-01",
                                              "1993-10-01"))], [])
    frag.semis = [_semi(
        tables, "lineitem", [0, 11, 12],
        lambda okey, commit, receipt: [bool_call("lt", [commit, receipt])],
        _combined(frag, 0), "SEMI")]
    _set_agg(frag, [_combined(frag, 2)], [_agg("count", None)])
    return frag


Q16_SIZES = [49, 14, 23, 45, 19, 3, 36, 9]


def q16_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q16's fragment: partsupp joined to the parts that are not
    Brand#45, not MEDIUM POLISHED and of eight sizes, whose supplier is NOT
    IN the suppliers with customer complaints (a NULL-aware ANTI_NULL
    edge; the LIKE build filter runs on the host). Rows; the COUNT(DISTINCT)
    above runs on the host."""
    frag = _frag(tables, [
        ("partsupp", [0, 1], None),
        ("part", [0, 3, 4, 5],
         lambda pk, brand, ptype, size: [
             bool_call("ne", [brand, Const("Brand#45", _STR)]),
             bool_call("not", [bool_call("like", [ptype],
                                         "MEDIUM POLISHED%")]),
             bool_call("in_values", [size], list(Q16_SIZES))])],
        [(1, 0)])
    frag.semis = [_semi(
        tables, "supplier", [0, 6],
        lambda sk, comment: [bool_call("like", [comment],
                                       "%Customer%Complaints%")],
        _combined(frag, 1), "ANTI_NULL")]
    _set_rows(frag, list(range(6)))
    return frag


def q20_semi_frag(tables: dict) -> FragmentDAG:
    """TPC-H Q20's partsupp block: the partsupp rows of 'forest%' parts
    (ps_partkey IN (...), a SEMI edge with a host LIKE build filter)."""
    frag = _frag(tables, [("partsupp", [0, 1, 2], None)], [])
    frag.semis = [_semi(
        tables, "part", [0, 1],
        lambda pk, pname: [bool_call("like", [pname], "forest%")],
        _combined(frag, 0), "SEMI")]
    _set_rows(frag, [0, 1, 2])
    return frag


def semi_having_frag(tables: dict) -> FragmentDAG:
    """`select l_orderkey, sum(l_quantity) from lineitem where exists
    (select * from orders where o_orderkey = l_orderkey and o_orderpriority
    = '1-URGENT') group by l_orderkey having sum(l_quantity) > 300`: a SEMI
    edge in front of the run-ordered HAVING (streamseg's rank path); about
    a fifth of Q18-inner's passing orders are 1-URGENT."""
    frag = _frag(tables, [("lineitem", [0, 4], None)], [])
    frag.semis = [_semi(
        tables, "orders", [0, 5],
        lambda okey, prio: [bool_call("eq", [prio,
                                             Const("1-URGENT", _STR)])],
        _combined(frag, 0), "SEMI")]
    _set_agg(frag, [_combined(frag, 0)], [_agg("sum", _combined(frag, 1))])
    frag.having = [(0, "gt", Q18_THRESHOLD)]
    return frag


JOIN_REQUESTS = {"q12": q12_frag, "q14": q14_frag, "q5": q5_frag,
                 "q7": q7_frag,
                 "q17_outer": q17_outer_frag, "q18_outer": q18_outer_frag,
                 "q18_join_having": q18_join_having_frag, "q3": q3_frag,
                 "q10": q10_frag, "join_topn": join_topn_frag,
                 "cust_having": cust_having_frag, "q4": q4_frag,
                 "q16": q16_frag, "q20_semi": q20_semi_frag,
                 "semi_having": semi_having_frag}
JOIN_TABLES = {"q12": ("lineitem", "orders"), "q14": ("lineitem", "part"),
               "q5": ("lineitem", "orders", "customer", "supplier", "nation",
                      "region"),
               "q7": ("lineitem", "supplier", "orders", "customer",
                      "nation"),
               "q17_outer": ("lineitem", "part"),
               "q18_outer": ("lineitem", "orders", "customer"),
               "q18_join_having": ("lineitem", "orders"),
               "q3": ("lineitem", "orders", "customer"),
               "q10": ("lineitem", "orders", "customer", "nation"),
               "join_topn": ("lineitem", "orders"),
               "cust_having": ("lineitem", "orders", "customer"),
               "q4": ("orders", "lineitem"),
               "q16": ("partsupp", "part", "supplier"),
               "q20_semi": ("partsupp", "part"),
               "semi_having": ("lineitem", "orders")}


# ---- single-table row and TopN requests (CopDAG, no aggregation) -------------

def q21_rows_dag(tables: dict) -> CopDAG:
    """TPC-H Q21's `lineitem l3` scan: the late lineitems (l_receiptdate >
    l_commitdate) of the NOT EXISTS subquery, shipped as rows."""
    t = tables["lineitem"]
    cols = [_col(t, off, i, "l3") for i, off in enumerate((0, 2, 11, 12))]
    return CopDAG(scan=DAGScan(t.id, [0, 2, 11, 12]),
                  selection=DAGSelection([bool_call("gt", [cols[3],
                                                           cols[2]])]),
                  output_types=[c.ftype for c in cols])


def q13_orders_scan_dag(tables: dict) -> CopDAG:
    """TPC-H Q13's orders scan: a bare scan of (o_orderkey, o_custkey,
    o_comment); the outer join and the NOT LIKE run on the host."""
    t = tables["orders"]
    return CopDAG(scan=DAGScan(t.id, [0, 1, 8]),
                  output_types=[t.columns[off].ftype for off in (0, 1, 8)])


def row_proj_dag(tables: dict) -> CopDAG:
    """`select l_orderkey, l_extendedprice * (1 - l_discount) from lineitem
    where l_quantity < 5`: rows with a computed projection, which the host
    evaluates over the selected rows."""
    t = tables["lineitem"]
    okey, qty, price, disc = (_col(t, off, i)
                              for i, off in enumerate((0, 4, 5, 6)))
    rev = _disc_price(price, disc)
    return CopDAG(scan=DAGScan(t.id, [0, 4, 5, 6]),
                  selection=DAGSelection([bool_call("lt", [
                      qty, Const(500, _MONEY)])]),
                  projections=[okey, rev],
                  output_types=[okey.ftype, rev.ftype])


SCAN_TOPN_N = 100


def scan_topn_dag(tables: dict) -> CopDAG:
    """`select l_orderkey, l_linenumber, l_extendedprice from lineitem
    where l_shipdate >= date '1995-01-01' order by l_extendedprice desc
    limit 100`: a single-key TopN, scored as the int32 price."""
    t = tables["lineitem"]
    okey, line, price, ship = (_col(t, off, i)
                               for i, off in enumerate((0, 3, 5, 10)))
    return CopDAG(scan=DAGScan(t.id, [0, 3, 5, 10]),
                  selection=DAGSelection([bool_call("ge", [
                      ship, Const(parse_date("1995-01-01"), _DATE)])]),
                  topn=DAGTopN([(price, True)], SCAN_TOPN_N),
                  projections=[okey, line, price],
                  output_types=[okey.ftype, line.ftype, price.ftype])


def scan_topn3_dag(tables: dict) -> CopDAG:
    """`select l_orderkey, l_shipdate, l_quantity from lineitem where
    l_discount > 0.05 order by l_shipdate desc, l_quantity, l_linenumber
    desc limit 100`: three keys packed into one int32 composite (the sort
    items read the projection's outputs; l_linenumber is a hidden fourth
    output)."""
    t = tables["lineitem"]
    okey, line, qty, disc, ship = (_col(t, off, i)
                                   for i, off in enumerate((0, 3, 4, 6, 10)))
    proj = [okey, ship, qty, line]
    items = [(Col(1, ship.ftype, ship.name), True),
             (Col(2, qty.ftype, qty.name), False),
             (Col(3, line.ftype), True)]
    return CopDAG(scan=DAGScan(t.id, [0, 3, 4, 6, 10]),
                  selection=DAGSelection([bool_call("gt", [
                      disc, Const(5, _MONEY)])]),
                  topn=DAGTopN(items, SCAN_TOPN_N),
                  projections=proj,
                  output_types=[c.ftype for c in proj])


DAG_REQUESTS = {"q21_rows": q21_rows_dag,
                "q13_orders_scan": q13_orders_scan_dag,
                "row_proj": row_proj_dag, "scan_topn": scan_topn_dag,
                "scan_topn3": scan_topn3_dag}
DAG_TABLES = {"q21_rows": ("lineitem",), "q13_orders_scan": ("orders",),
              "row_proj": ("lineitem",), "scan_topn": ("lineitem",),
              "scan_topn3": ("lineitem",)}


# ---- APPROX_COUNT_DISTINCT, index-ranged scans, overlay rows -----------------

def hll_dag(table: TableInfo) -> CopDAG:
    """`select l_returnflag, l_linestatus, approx_count_distinct(
    l_orderkey), approx_count_distinct(l_suppkey), count(*) from lineitem
    group by l_returnflag, l_linestatus`: per-group HLL registers."""
    okey, supp, rf, ls = (_col(table, off, i)
                          for i, off in enumerate((0, 2, 8, 9)))
    aggs = [_agg("approx_count_distinct", okey),
            _agg("approx_count_distinct", supp), _agg("count", None)]
    return CopDAG(scan=DAGScan(table.id, [0, 2, 8, 9]),
                  agg=DAGAggregation([rf, ls], aggs),
                  output_types=[rf.ftype, ls.ftype] + _partial_types(aggs))


def orders_indexed_table(table_id: int) -> TableInfo:
    """orders with two secondary indexes: on o_custkey (points) and on
    o_orderdate (intervals)."""
    t = tpch_table("orders", table_id)
    t.indices = [IndexInfo(1, "i_custkey", [1]),
                 IndexInfo(2, "i_orderdate", [4])]
    return t


def ranged_points_dag(tables: dict, custkeys) -> CopDAG:
    """`select o_orderkey, o_totalprice from orders where o_custkey in
    (...)` through the o_custkey index, one point per key (the planner
    keeps the condition as the selection too)."""
    t = tables["orders"]
    okey, cust, price = (_col(t, off, i) for i, off in enumerate((0, 1, 3)))
    keys = [int(k) for k in custkeys]
    return CopDAG(scan=DAGScan(t.id, [0, 1, 3], ScanRanges(
                      t.indices[0], [(k,) for k in keys])),
                  selection=DAGSelection([bool_call("in_values", [cust],
                                                    keys)]),
                  projections=[okey, price],
                  output_types=[okey.ftype, price.ftype])


RANGED_MONTH = ("1995-03-01", "1995-04-01")


def ranged_interval_dag(tables: dict) -> CopDAG:
    """`select o_orderkey, o_custkey, o_totalprice from orders where
    o_orderdate >= '1995-03-01' and o_orderdate < '1995-04-01'` through the
    o_orderdate index: one interval."""
    t = tables["orders"]
    okey, cust, price, date = (_col(t, off, i)
                               for i, off in enumerate((0, 1, 3, 4)))
    lo, hi = (parse_date(d) for d in RANGED_MONTH)
    return CopDAG(scan=DAGScan(t.id, [0, 1, 3, 4], ScanRanges(
                      t.indices[1], [], (lo, hi, True, False))),
                  selection=DAGSelection(_date_range(date, *RANGED_MONTH)),
                  projections=[okey, cust, price],
                  output_types=[okey.ftype, cust.ftype, price.ftype])


# 8,192 deltas: the reference store's compaction threshold
# (`TableStore.COMPACT_THRESHOLD`), the most unfolded rows a snapshot
# carries before compaction folds them into a new epoch
OVERLAY_UPDATES, OVERLAY_DELETES, OVERLAY_INSERTS = 4096, 2048, 2048


def overlay_snapshot(snap: TableSnapshot, data: dict, seed: int):
    """`snap`'s table with 8,192 unfolded deltas made from `seed`: 4,096
    updates (a base row keeps its primary-key columns and takes every other
    column from a random donor row), 2,048 deletes and 2,048 inserts (donor
    rows under new handles; a primary-key handle column gets new keys above
    the largest). `data`: the table's generated arrays
    (`generate_tpch(...)[name]`), which `snap` holds. String values keep the
    snapshot's dictionaries (the same codes).

    -> (snapshot, visible base-row mask, overlay rows as generated arrays,
    updates first, then inserts)."""
    table = snap.table
    rng = np.random.default_rng(seed)
    n = snap.epoch.num_rows
    picked = rng.choice(n, OVERLAY_UPDATES + OVERLAY_DELETES, replace=False)
    upd = picked[:OVERLAY_UPDATES]
    donor_u = rng.integers(0, n, OVERLAY_UPDATES)
    donor_i = rng.integers(0, n, OVERLAY_INSERTS)
    visible = np.ones(n, bool)
    visible[picked] = False
    ov, ov_cols = {}, []
    for c in table.columns:
        v = data[c.name]
        vals = np.asarray(v[1] if isinstance(v, tuple) else v)
        ins = vals[donor_i]
        if c.offset == table.pk_handle_offset:
            ins = vals.max() + 1 + np.arange(OVERLAY_INSERTS, dtype=vals.dtype)
        rows = np.concatenate([vals[upd] if c.is_primary else vals[donor_u],
                               ins])
        if isinstance(v, tuple):
            ov[c.name] = (v[0], rows)
            d = snap.dictionaries[c.offset]
            remap = np.array([d.lookup(w) for w in v[0]], dtype=np.int64)
            ov_cols.append(remap[rows].astype(c.ftype.np_dtype))
        else:
            ov[c.name] = rows
            ov_cols.append(rows.astype(c.ftype.np_dtype))
    top = int(snap.epoch.handles.max()) if n else 0
    handles = np.concatenate([snap.epoch.handles[upd],
                              top + 1 + np.arange(OVERLAY_INSERTS)])
    out = dataclasses.replace(
        snap, base_visible=visible, overlay_handles=handles.astype(np.int64),
        overlay_columns=ov_cols, overlay_valids=[None] * len(ov_cols))
    return out, visible, ov


def rows_of(data: dict, rows) -> dict:
    """The generated arrays of one table at `rows` (a mask or indices)."""
    return {k: (v[0], np.asarray(v[1])[rows]) if isinstance(v, tuple)
            else np.asarray(v)[rows] for k, v in data.items()}


def visible_rows(snap: TableSnapshot, data: dict, overlay=None):
    """The rows a snapshot shows, as generated arrays: its visible base
    rows, then its overlay rows (`overlay_snapshot`'s third result) ->
    (rows, their handles)."""
    rows = rows_of(data, snap.base_visible)
    handles = snap.epoch.handles[snap.base_visible]
    if overlay is not None:
        rows = {k: (v[0], np.concatenate([v[1], overlay[k][1]]))
                if isinstance(v, tuple) else np.concatenate([v, overlay[k]])
                for k, v in rows.items()}
        handles = np.concatenate([handles, snap.overlay_handles])
    return rows, handles


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


# ---- join oracles --------------------------------------------------------------
# data: generate_tpch(...) output, table name -> column name -> array (or
# (vocabulary, codes) for strings). Keys are dense small integers, so
# key -> row maps are plain arrays indexed by key.

def _strings(v) -> np.ndarray:
    vocab, codes = v
    return np.asarray(vocab, dtype=object)[codes]


def _row_of(keys: np.ndarray) -> np.ndarray:
    """key -> row index (-1 where absent)."""
    out = np.full(int(keys.max()) + 1, -1, dtype=np.int64)
    out[keys] = np.arange(len(keys))
    return out


def _find(keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Row of each probe value among the unique `keys`, -1 where absent
    (an inner join drops those probe rows)."""
    size = int(max(keys.max(initial=0), probe.max(initial=0))) + 1
    out = np.full(size, -1, dtype=np.int64)
    out[keys] = np.arange(len(keys))
    return out[probe]


def q12_oracle(data: dict) -> list[tuple]:
    li, o = data["lineitem"], data["orders"]
    mode = _strings(li["l_shipmode"])
    orow = _find(o["o_orderkey"], li["l_orderkey"])
    m = (np.isin(mode, ["MAIL", "SHIP"])
         & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"])
         & (li["l_receiptdate"] >= parse_date("1994-01-01"))
         & (li["l_receiptdate"] < parse_date("1995-01-01"))
         & (orow >= 0))
    prio = _strings(o["o_orderpriority"])[orow[m]]
    high = np.isin(prio, ["1-URGENT", "2-HIGH"])
    rows = []
    for md in np.unique(mode[m]):
        g = mode[m] == md
        n = int(g.sum())
        h = int((high & g).sum())
        rows.append((md, h, n, n - h, n))
    return sorted(rows)


def q14_oracle(data: dict) -> list[tuple]:
    li, p = data["lineitem"], data["part"]
    m = ((li["l_shipdate"] >= parse_date("1995-09-01"))
         & (li["l_shipdate"] < parse_date("1995-10-01")))
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    ptype = _strings(p["p_type"])[_row_of(p["p_partkey"])[li["l_partkey"][m]]]
    promo = np.array([t.startswith("PROMO") for t in ptype], dtype=bool)
    n = int(m.sum())
    if n == 0:
        return []
    return [(int(rev[promo].sum()), n, int(rev.sum()), n)]


def q5_oracle(data: dict) -> list[tuple]:
    """Exact (nation, revenue at scale 4, rows) for TPC-H Q5 (ASIA, 1994)."""
    li, o = data["lineitem"], data["orders"]
    c, sp = data["customer"], data["supplier"]
    nat, reg = data["nation"], data["region"]
    asia = reg["r_regionkey"][_strings(reg["r_name"]) == "ASIA"]
    nat_ok = np.zeros(int(nat["n_nationkey"].max()) + 1, bool)
    nat_ok[nat["n_nationkey"][np.isin(nat["n_regionkey"], asia)]] = True
    c_nat = np.full(int(c["c_custkey"].max()) + 1, -1, np.int64)
    c_nat[c["c_custkey"]] = c["c_nationkey"]
    s_nat = np.full(int(sp["s_suppkey"].max()) + 1, -1, np.int64)
    s_nat[sp["s_suppkey"]] = sp["s_nationkey"]
    o_ok = ((o["o_orderdate"] >= parse_date("1994-01-01"))
            & (o["o_orderdate"] < parse_date("1995-01-01")))
    o_cnat = np.full(int(o["o_orderkey"].max()) + 1, -1, np.int64)
    o_cnat[o["o_orderkey"][o_ok]] = c_nat[o["o_custkey"][o_ok]]
    lnat = s_nat[li["l_suppkey"]]
    m = (lnat >= 0) & (lnat == o_cnat[li["l_orderkey"]]) & \
        nat_ok[np.clip(lnat, 0, None)]
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    span = len(nat_ok)
    counts = np.bincount(lnat[m], minlength=span)
    sums = np.zeros(span, np.int64)
    np.add.at(sums, lnat[m], rev)
    names = _strings(nat["n_name"])[_row_of(nat["n_nationkey"])]
    return sorted((names[k], int(sums[k]), int(counts[k]))
                  for k in np.nonzero(counts)[0])


def _years(days: np.ndarray) -> np.ndarray:
    """Calendar year of day numbers (days since 1970-01-01)."""
    d = np.datetime64("1970-01-01", "D") + days.astype("timedelta64[D]")
    return d.astype("datetime64[Y]").astype(np.int64) + 1970


def q7_oracle(data: dict) -> list[tuple]:
    """Exact (supp_nation, cust_nation, l_year, revenue at scale 4, rows)
    for TPC-H Q7 (FRANCE / GERMANY, 1995-1996)."""
    li, o, c = data["lineitem"], data["orders"], data["customer"]
    sp, nat = data["supplier"], data["nation"]
    names = _strings(nat["n_name"])[_row_of(nat["n_nationkey"])]
    ship = li["l_shipdate"]
    m = (ship >= parse_date("1995-01-01")) & (ship <= parse_date("1996-12-31"))
    s_nat = sp["s_nationkey"][_row_of(sp["s_suppkey"])[li["l_suppkey"][m]]]
    cust = o["o_custkey"][_row_of(o["o_orderkey"])[li["l_orderkey"][m]]]
    c_nat = c["c_nationkey"][_row_of(c["c_custkey"])[cust]]
    n1, n2 = names[s_nat], names[c_nat]
    ok = (((n1 == "FRANCE") & (n2 == "GERMANY"))
          | ((n1 == "GERMANY") & (n2 == "FRANCE")))
    rev = (li["l_extendedprice"][m] * (100 - li["l_discount"][m]))[ok]
    year = _years(ship[m][ok])
    rows = []
    for a, b in (("FRANCE", "GERMANY"), ("GERMANY", "FRANCE")):
        pair = (n1[ok] == a) & (n2[ok] == b)
        for y in np.unique(year[pair]):
            g = pair & (year == y)
            rows.append((a, b, int(y), int(rev[g].sum()), int(g.sum())))
    return sorted(rows)


def q17_outer_oracle(data: dict) -> list[np.ndarray]:
    li, p = data["lineitem"], data["part"]
    prow = _row_of(p["p_partkey"])[li["l_partkey"]]
    brand, cont = _strings(p["p_brand"]), _strings(p["p_container"])
    ok = (brand == "Brand#23") & (cont == "MED BOX")
    m = ok[prow]
    r = prow[m]
    return [li["l_partkey"][m], li["l_quantity"][m], li["l_extendedprice"][m],
            p["p_partkey"][r], brand[r], cont[r]]


def q18_outer_oracle(data: dict) -> list[np.ndarray]:
    """Every lineitem row (each has its order, each order its customer)."""
    li, o, c = data["lineitem"], data["orders"], data["customer"]
    orow = _row_of(o["o_orderkey"])[li["l_orderkey"]]
    crow = _row_of(c["c_custkey"])[o["o_custkey"][orow]]
    return [c["c_custkey"][crow], _strings(c["c_name"])[crow],
            o["o_orderkey"][orow], o["o_custkey"][orow],
            o["o_totalprice"][orow], o["o_orderdate"][orow],
            li["l_orderkey"], li["l_quantity"]]


def q18_join_having_oracle(data: dict) -> list[tuple]:
    """Every lineitem row joins its order, so the groups are Q18-inner's."""
    return q18_inner_oracle(data["lineitem"])


def _group_sums(keys: np.ndarray, vals: np.ndarray):
    """Exact int64 per-key sums: -> (distinct keys, sums, row counts)."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, vals.astype(np.int64))
    return uniq, sums, np.bincount(inv, minlength=len(uniq))


def q3_oracle(data: dict) -> list[tuple]:
    """The 10 groups of TPC-H Q3 (revenue DESC, o_orderdate) in the
    partial layout: (l_orderkey, o_orderdate, o_shippriority, revenue at
    scale 4, rows)."""
    li, o, c = data["lineitem"], data["orders"], data["customer"]
    cutoff = parse_date(Q3_CUTOFF)
    cust_ok = np.zeros(int(c["c_custkey"].max()) + 1, bool)
    cust_ok[c["c_custkey"][_strings(c["c_mktsegment"]) == "BUILDING"]] = True
    orow = _row_of(o["o_orderkey"])[li["l_orderkey"]]
    m = ((li["l_shipdate"] > cutoff) & (o["o_orderdate"][orow] < cutoff)
         & cust_ok[o["o_custkey"][orow]])
    keys, sums, counts = _group_sums(
        li["l_orderkey"][m],
        li["l_extendedprice"][m] * (100 - li["l_discount"][m]))
    r = _row_of(o["o_orderkey"])[keys]
    odate, sprio = o["o_orderdate"][r], o["o_shippriority"][r]
    top = np.lexsort((odate, -sums))[:10]
    return sorted((int(keys[i]), int(odate[i]), int(sprio[i]), int(sums[i]),
                   int(counts[i])) for i in top)


def q10_oracle(data: dict) -> list[tuple]:
    """The 20 groups of TPC-H Q10 (revenue DESC) in the partial layout:
    (c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment,
    revenue at scale 4, rows)."""
    li, o, c, n = (data["lineitem"], data["orders"], data["customer"],
                   data["nation"])
    orow = _row_of(o["o_orderkey"])[li["l_orderkey"]]
    odate = o["o_orderdate"][orow]
    m = ((_strings(li["l_returnflag"]) == "R")
         & (odate >= parse_date("1993-10-01"))
         & (odate < parse_date("1994-01-01")))
    keys, sums, counts = _group_sums(
        o["o_custkey"][orow[m]],
        li["l_extendedprice"][m] * (100 - li["l_discount"][m]))
    top = np.argsort(-sums, kind="stable")[:20]
    crow = _row_of(c["c_custkey"])[keys[top]]
    nrow = _row_of(n["n_nationkey"])[c["c_nationkey"][crow]]
    cols = [c["c_custkey"][crow], _strings(c["c_name"])[crow],
            c["c_acctbal"][crow], _strings(c["c_phone"])[crow],
            _strings(n["n_name"])[nrow], _strings(c["c_address"])[crow],
            _strings(c["c_comment"])[crow], sums[top], counts[top]]
    return sorted(tuple(x if isinstance(x, str) else int(x) for x in row)
                  for row in zip(*cols))


def join_topn_oracle(data: dict, tile_rows: int = CopClient.TILE_ROWS
                     ) -> list[np.ndarray]:
    """Each probe tile's top 100 rows of `join_topn_frag` in order (larger
    o_orderdate, then smaller o_orderpriority by string order, then larger
    l_quantity, then the lower row), the tiles one after another, as the
    output columns (l_orderkey, l_linenumber, l_quantity, l_shipdate,
    o_orderkey, o_orderdate, o_orderpriority)."""
    li, o = data["lineitem"], data["orders"]
    orow = _row_of(o["o_orderkey"])[li["l_orderkey"]]
    vocab, codes = o["o_orderpriority"]
    rank_of = np.argsort(np.argsort(np.asarray(vocab, dtype=object),
                                    kind="stable"))
    prank = rank_of[np.asarray(codes)][orow]
    date, qty = o["o_orderdate"][orow], li["l_quantity"]
    ok = li["l_shipdate"] > parse_date(Q3_CUTOFF)
    parts = []
    for lo in range(0, len(ok), tile_rows):
        sel = lo + np.nonzero(ok[lo:lo + tile_rows])[0]
        order = np.lexsort((sel, -qty[sel], prank[sel], -date[sel]))
        parts.append(sel[order[:JOIN_TOPN_N]])
    rows = np.concatenate(parts)
    return [li["l_orderkey"][rows], li["l_linenumber"][rows], qty[rows],
            li["l_shipdate"][rows], o["o_orderkey"][orow[rows]],
            date[rows], _strings(o["o_orderpriority"])[orow[rows]]]


def cust_having_oracle(data: dict) -> list[tuple]:
    """Customers passing the coprocessor's widened HAVING test (as
    q18_inner_oracle: quantity sums are multiples of 100, so the widened
    and the exact test agree): (c_custkey, sum(l_quantity), rows)."""
    li, o = data["lineitem"], data["orders"]
    cust = o["o_custkey"][_row_of(o["o_orderkey"])[li["l_orderkey"]]]
    keys, sums, counts = _group_sums(cust, li["l_quantity"])
    sv = sums.astype(np.float32)
    eps = np.abs(sv) * np.float32(2.0 ** -18) + np.float32(2.0)
    ok = sv > np.float32(CUST_HAVING_THRESHOLD) - eps
    return sorted(zip(keys[ok].tolist(), sums[ok].tolist(),
                      counts[ok].tolist()))


def _like_mask(v, pattern: str) -> np.ndarray:
    """Per-row SQL LIKE over a generated string column (vocabulary,
    codes): '%' any run, '_' one character, matched once per word."""
    vocab, codes = v
    rx = re.compile("".join(".*" if ch == "%" else "." if ch == "_"
                            else re.escape(ch) for ch in pattern), re.DOTALL)
    hit = np.array([rx.fullmatch(s) is not None for s in vocab], dtype=bool)
    return hit[np.asarray(codes)]


def q4_oracle(data: dict) -> list[tuple]:
    """(o_orderpriority, count, count) over the 1993-Q3 orders that have a
    lineitem with l_commitdate < l_receiptdate."""
    li, o = data["lineitem"], data["orders"]
    late = np.zeros(int(o["o_orderkey"].max()) + 1, bool)
    late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] = True
    date = o["o_orderdate"]
    m = ((date >= parse_date("1993-07-01")) & (date < parse_date("1993-10-01"))
         & late[o["o_orderkey"]])
    prio = _strings(o["o_orderpriority"])[m]
    return sorted((p, int(n), int(n))
                  for p, n in zip(*np.unique(prio, return_counts=True)))


def q16_oracle(data: dict) -> list[np.ndarray]:
    """partsupp rows (in storage order) of the admitted parts whose
    supplier has no complaint, as (ps_partkey, ps_suppkey, p_partkey,
    p_brand, p_type, p_size). NOT IN over a NULL-free set: NULL cannot
    occur, the set is non-empty at every scale (the generator plants
    complaints)."""
    ps, p, s = data["partsupp"], data["part"], data["supplier"]
    prow = _row_of(p["p_partkey"])[ps["ps_partkey"]]
    brand, ptype = _strings(p["p_brand"]), _strings(p["p_type"])
    ok = ((brand != "Brand#45") & ~_like_mask(p["p_type"], "MEDIUM POLISHED%")
          & np.isin(p["p_size"], Q16_SIZES))
    bad = s["s_suppkey"][_like_mask(s["s_comment"], "%Customer%Complaints%")]
    m = ok[prow] & ~np.isin(ps["ps_suppkey"], bad)
    r = prow[m]
    return [ps["ps_partkey"][m], ps["ps_suppkey"][m], p["p_partkey"][r],
            brand[r], ptype[r], p["p_size"][r]]


def q20_semi_oracle(data: dict) -> list[np.ndarray]:
    """partsupp rows of 'forest%' parts: (ps_partkey, ps_suppkey,
    ps_availqty) in storage order."""
    ps, p = data["partsupp"], data["part"]
    forest = p["p_partkey"][_like_mask(p["p_name"], "forest%")]
    m = np.isin(ps["ps_partkey"], forest)
    return [ps["ps_partkey"][m], ps["ps_suppkey"][m], ps["ps_availqty"][m]]


def semi_having_oracle(data: dict) -> list[tuple]:
    """Q18-inner's widened HAVING over the lineitems of 1-URGENT orders:
    (l_orderkey, sum(l_quantity), rows)."""
    li, o = data["lineitem"], data["orders"]
    urgent = np.zeros(int(o["o_orderkey"].max()) + 1, bool)
    urgent[o["o_orderkey"][_strings(o["o_orderpriority"]) == "1-URGENT"]] = \
        True
    m = urgent[li["l_orderkey"]]
    return q18_inner_oracle({"l_orderkey": li["l_orderkey"][m],
                             "l_quantity": li["l_quantity"][m]})


def q21_rows_oracle(data: dict) -> list[np.ndarray]:
    li = data["lineitem"]
    m = li["l_receiptdate"] > li["l_commitdate"]
    return [li[c][m] for c in ("l_orderkey", "l_suppkey", "l_commitdate",
                               "l_receiptdate")]


def q13_orders_scan_oracle(data: dict) -> list[np.ndarray]:
    o = data["orders"]
    return [o["o_orderkey"], o["o_custkey"], _strings(o["o_comment"])]


def row_proj_oracle(data: dict) -> list[np.ndarray]:
    """(l_orderkey, l_extendedprice * (1 - l_discount) at scale 4) of the
    rows with l_quantity < 5."""
    li = data["lineitem"]
    m = li["l_quantity"] < 500
    return [li["l_orderkey"][m],
            li["l_extendedprice"][m] * (100 - li["l_discount"][m])]


def _tile_tops(ok: np.ndarray, keys: list, tile_rows: int) -> np.ndarray:
    """Each tile's first SCAN_TOPN_N passing rows by `keys` (most
    significant first, ascending; negate for DESC), ties to the lower row,
    the tiles one after another."""
    parts = []
    for lo in range(0, len(ok), tile_rows):
        sel = lo + np.nonzero(ok[lo:lo + tile_rows])[0]
        order = np.lexsort([sel] + [k[sel] for k in reversed(keys)])
        parts.append(sel[order[:SCAN_TOPN_N]])
    return np.concatenate(parts)


def scan_topn_oracle(data: dict, tile_rows: int = CopClient.TILE_ROWS,
                     visible=None) -> list[np.ndarray]:
    """Each tile's top 100 rows by l_extendedprice DESC among l_shipdate >=
    1995-01-01 (and, where given, the `visible` rows): (l_orderkey,
    l_linenumber, l_extendedprice)."""
    li = data["lineitem"]
    ok = li["l_shipdate"] >= parse_date("1995-01-01")
    if visible is not None:
        ok &= visible
    rows = _tile_tops(ok, [-li["l_extendedprice"]], tile_rows)
    return [li[c][rows] for c in ("l_orderkey", "l_linenumber",
                                  "l_extendedprice")]


def scan_topn3_oracle(data: dict, tile_rows: int = CopClient.TILE_ROWS
                      ) -> list[np.ndarray]:
    """Each tile's top 100 rows by (l_shipdate DESC, l_quantity, l_linenumber
    DESC) among l_discount > 0.05: (l_orderkey, l_shipdate, l_quantity,
    l_linenumber)."""
    li = data["lineitem"]
    rows = _tile_tops(li["l_discount"] > 5,
                      [-li["l_shipdate"], li["l_quantity"],
                       -li["l_linenumber"]], tile_rows)
    return [li[c][rows] for c in ("l_orderkey", "l_shipdate", "l_quantity",
                                  "l_linenumber")]


def hll_oracle(li: dict) -> list[tuple]:
    """`hll_dag`'s partial rows from the host twin of the device sketch:
    (l_returnflag, l_linestatus, 32 register words of l_orderkey, rows, 32
    of l_suppkey, rows, count, count)."""
    rf_vocab, rf = li["l_returnflag"]
    ls_vocab, ls = li["l_linestatus"]
    key = np.asarray(rf) * len(ls_vocab) + np.asarray(ls)
    groups, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    live = np.ones(len(key), bool)
    words = [hll_pack_words(hll_group_registers_host(
        hll_hash_src_int(li[c]), live, inv, len(groups)))
        for c in ("l_orderkey", "l_suppkey")]
    counts = np.bincount(inv, minlength=len(groups))
    rows = []
    for g, k in enumerate(groups):
        n = int(counts[g])
        rows.append((rf_vocab[k // len(ls_vocab)], ls_vocab[k % len(ls_vocab)],
                     *words[0][g].tolist(), n, *words[1][g].tolist(), n,
                     n, n))
    return sorted(rows)


def _by_handle(rows: dict, handles: np.ndarray, m: np.ndarray,
               names) -> list[np.ndarray]:
    """The selected rows' columns in handle order (a ranged scan's)."""
    order = np.argsort(handles[m], kind="stable")
    return [np.asarray(rows[c])[m][order] for c in names]


def ranged_points_oracle(rows: dict, handles: np.ndarray, custkeys
                         ) -> list[np.ndarray]:
    """`ranged_points_dag` over the rows a snapshot shows
    (`visible_rows`): (o_orderkey, o_totalprice) in handle order."""
    m = np.isin(rows["o_custkey"], np.asarray(custkeys))
    return _by_handle(rows, handles, m, ("o_orderkey", "o_totalprice"))


def ranged_interval_oracle(rows: dict, handles: np.ndarray
                           ) -> list[np.ndarray]:
    """`ranged_interval_dag` over the rows a snapshot shows: (o_orderkey,
    o_custkey, o_totalprice) in handle order."""
    lo, hi = (parse_date(d) for d in RANGED_MONTH)
    date = rows["o_orderdate"]
    return _by_handle(rows, handles, (date >= lo) & (date < hi),
                      ("o_orderkey", "o_custkey", "o_totalprice"))


def row_columns(chunks: list[Chunk]) -> list[np.ndarray]:
    """Row-mode result chunks -> one array per output column, rows in the
    order returned: dictionary codes decoded to strings (object arrays),
    NULL as None, everything else its physical value."""
    parts: list[list[np.ndarray]] = []
    for ch in chunks:
        for ci, c in enumerate(ch.columns):
            a = np.asarray(c.data)
            if c.dictionary is not None:
                a = np.asarray(c.dictionary.values, dtype=object)[a]
            if c.valid is not None and not c.valid.all():
                a = a.astype(object)
                a[~c.valid] = None
            if ci == len(parts):
                parts.append([])
            parts[ci].append(a)
    return [np.concatenate(p) for p in parts]


# ---- final rows of the SQL text ----------------------------------------------
# What a Session returns for the TPC-H query text (bench/tpch_queries.py):
# the partial oracles above, finished as the root does it (the final merge,
# the arithmetic over aggregates, ORDER BY, LIMIT), in numpy and Python ints.
# Rows are in the query's ORDER BY order, each value as `sql_cells` gives
# it, so that they compare exactly with a session's rows.

def sql_cells(rows: list[tuple]) -> list[tuple]:
    """Session rows -> comparable tuples: a Decimal as ("dec", unscaled,
    scale), a float by its exact hex form, a date as its day number."""
    import datetime

    def cell(v):
        if type(v).__name__ == "Decimal":
            return ("dec", v.unscaled, v.scale)
        if isinstance(v, float):
            return ("float", v.hex())
        if isinstance(v, datetime.date):
            return (v - datetime.date(1970, 1, 1)).days
        return v
    return [tuple(cell(v) for v in r) for r in rows]


def _dec(unscaled: int, scale: int) -> tuple:
    return ("dec", int(unscaled), scale)


def _div_round(num: int, den: int) -> int:
    """num / den rounded half away from zero (MySQL decimal division)."""
    q, r = divmod(abs(num), abs(den))
    q += 2 * r >= abs(den)
    return q if (num < 0) == (den < 0) else -q


def sql_oracle(name: str, data: dict) -> list[tuple]:
    """Final rows of TPC-H query `name` ("q1", "q3", "q4", "q5", "q6",
    "q10", "q12", "q14", "q18") over the generated arrays."""
    if name == "q6":
        (val, _), = q6_oracle(data["lineitem"])
        return [(_dec(val, 4),)]  # price (scale 2) * discount (scale 2)
    if name == "q14":
        (promo, _, total, _), = q14_oracle(data)
        # 100.00 * promo: scale 2 + 4; the quotient gains 4 digits (MySQL's
        # div_precision_increment): scale 10
        return [(_dec(_div_round(10000 * promo * 10 ** 8, total), 10),)]
    if name == "q12":
        return [(mode, high, n - high)
                for mode, high, n, _, _ in q12_oracle(data)]
    if name == "q5":
        rows = [(nat, _dec(rev, 4)) for nat, rev, _ in q5_oracle(data)]
        return sorted(rows, key=lambda r: -r[1][1])
    if name == "q3":
        rows = sorted(q3_oracle(data), key=lambda r: (-r[3], r[1]))
        return [(key, _dec(rev, 4), day, prio)
                for key, day, prio, rev, _ in rows]
    if name == "q10":
        rows = sorted(q10_oracle(data), key=lambda r: -r[7])
        return [(ck, cn, _dec(rev, 4), _dec(bal, 2), nn, addr, phone, cmt)
                for ck, cn, bal, phone, nn, addr, cmt, rev, _ in rows]
    if name == "q4":
        return [(prio, n) for prio, n, _ in q4_oracle(data)]
    if name == "q1":
        # avg of a scale-s decimal: scale s + 4, rounded half away from
        # zero (MySQL's div_precision_increment)
        return [(rf, ls, _dec(qty, 2), _dec(price, 2), _dec(dp, 4),
                 _dec(ch, 6), _dec(_div_round(qty * 10 ** 4, n), 6),
                 _dec(_div_round(price * 10 ** 4, n), 6),
                 _dec(_div_round(disc * 10 ** 4, n), 6), n)
                for rf, ls, qty, n, price, _, dp, _, ch, _, _, _, _, _,
                disc, _, _, _ in q1_oracle(data["lineitem"])]
    if name == "q18":
        li, o, c = data["lineitem"], data["orders"], data["customer"]
        # per-order sums of quantities below 2^53: exact in float64
        sums = np.bincount(li["l_orderkey"], weights=li["l_quantity"])
        big = np.flatnonzero(sums > Q18_THRESHOLD)
        qty = sums[big].astype(np.int64)
        orow = _row_of(o["o_orderkey"])[big]
        crow = _row_of(c["c_custkey"])[o["o_custkey"][orow]]
        names = _strings(c["c_name"])[crow]
        rows = sorted(zip((-o["o_totalprice"][orow]).tolist(),
                          o["o_orderdate"][orow].tolist(), big.tolist(),
                          names.tolist(), c["c_custkey"][crow].tolist(),
                          qty.tolist()))[:100]
        return [(cn, ck, ok, day, _dec(-negp, 2), _dec(q, 2))
                for negp, day, ok, cn, ck, q in rows]
    raise KeyError(name)


SQL_ORACLES = ("q3", "q4", "q5", "q6", "q10", "q12", "q14")
