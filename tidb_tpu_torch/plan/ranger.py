"""Ranger: derive index access ranges from conjunctive predicates.

Counterpart of the reference's util/ranger (detacher.go/points.go/ranger.go)
which detaches index-usable conditions and builds key ranges. This version
extracts *equality point* prefixes only — `col = const` and
`col IN (consts)` over a prefix of the index columns — which is the
high-confidence case that needs no statistics to justify: point lookups
beat a full columnar scan at any table size. Interval ranges join once the
statistics subsystem can estimate their selectivity (SURVEY.md §2
statistics/ inventory).

Inputs are resolved conjuncts over the *scan output schema*; `col_map`
translates Col.idx (position in the scan's output) to stored-table column
offsets, since column pruning may have re-mapped them.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

from ..catalog.schema import IndexInfo, TableInfo
from .expr import Call, Col, Const, PlanExpr

# cap on the cartesian product of IN-lists across index columns — beyond
# this a scan is likely cheaper than many point probes (the reference
# similarly bounds ranges via MaxAccessPathCount/range mem quotas)
MAX_POINTS = 1024


@dataclass
class ScanRanges:
    """Access ranges on one index. Two forms:

    * points mode: every tuple is a full value list for the first
      len(tuple) index columns (physical domain, strings raw — encoded by
      the searcher)
    * interval mode: one (lo, hi, lo_incl, hi_incl) interval on the FIRST
      index column (numeric/temporal only; None bound = unbounded on that
      side) — chosen only when statistics justify it
    """

    index: IndexInfo
    points: list[tuple]
    interval: Optional[tuple] = None  # (lo, hi, lo_incl, hi_incl)

    def describe(self) -> str:
        if self.interval is not None:
            lo, hi, li, hi_i = self.interval
            lb = ("[" if li else "(") + (str(lo) if lo is not None else "-inf")
            ub = (str(hi) if hi is not None else "+inf") + ("]" if hi_i else ")")
            return f"index:{self.index.name} range {lb},{ub}"
        return (f"index:{self.index.name}"
                f"({len(self.points)} point{'s' if len(self.points) != 1 else ''})")


def _eq_values(cond: PlanExpr, col_map: dict[int, int]) -> Optional[
        tuple[int, list]]:
    """(table_offset, candidate values) if cond is `col = const` or
    `col IN (consts)` with non-NULL constants."""
    if not isinstance(cond, Call):
        return None
    if cond.op == "eq":
        a, b = cond.args
        if isinstance(a, Const) and isinstance(b, Col):
            a, b = b, a
        if isinstance(a, Col) and isinstance(b, Const) and b.value is not None:
            off = col_map.get(a.idx)
            if off is not None:
                return off, [b.value]
        return None
    if cond.op == "in_values" and isinstance(cond.args[0], Col):
        off = col_map.get(cond.args[0].idx)
        if off is None:
            return None
        # extra holds already-coerced physical values (builder strips Consts)
        vals = [c.value if isinstance(c, Const) else c
                for c in (cond.extra or [])]
        if not vals or any(v is None for v in vals):
            return None
        return off, vals
    return None


def extract_points(
    table: TableInfo,
    index: IndexInfo,
    conditions: list[PlanExpr],
    col_map: dict[int, int],
) -> Optional[ScanRanges]:
    """Longest equality-point prefix of `index` satisfiable from the
    conjuncts; None when the first index column has no equality."""
    by_off: dict[int, list] = {}
    for c in conditions:
        hit = _eq_values(c, col_map)
        if hit is None:
            continue
        off, vals = hit
        if off in by_off:
            # two equalities on one column: intersect candidate sets
            keep = [v for v in by_off[off] if v in vals]
            by_off[off] = keep
        else:
            by_off[off] = vals
    prefix: list[list] = []
    for off in index.col_offsets:
        vals = by_off.get(off)
        if vals is None:
            break
        prefix.append(vals)
    if not prefix:
        return None
    n_points = 1
    for vals in prefix:
        n_points *= len(vals)
        if n_points > MAX_POINTS:
            return None
    if n_points == 0:
        return ScanRanges(index, [])  # contradictory equalities: empty scan
    return ScanRanges(index, list(itertools.product(*prefix)))


_CMP_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}


def extract_interval(offset: int, conditions: list[PlanExpr],
                     col_map: dict[int, int]) -> Optional[tuple]:
    """Merged (lo, hi, lo_incl, hi_incl) interval on the column at table
    offset `offset` from comparison conjuncts; None when no comparison
    bounds it. BETWEEN arrives here already lowered to ge+le."""
    lo = hi = None
    lo_incl = hi_incl = True
    found = False
    for c in conditions:
        if not isinstance(c, Call) or c.op not in ("lt", "le", "gt", "ge"):
            continue
        a, b = c.args
        op = c.op
        if isinstance(a, Const) and isinstance(b, Col):
            a, b, op = b, a, _CMP_FLIP[op]
        if not (isinstance(a, Col) and isinstance(b, Const)):
            continue
        if col_map.get(a.idx) != offset or b.value is None:
            continue
        v = b.value
        found = True
        if op in ("gt", "ge"):
            incl = op == "ge"
            if lo is None or v > lo or (v == lo and not incl):
                lo, lo_incl = v, incl
        else:
            incl = op == "le"
            if hi is None or v < hi or (v == hi and not incl):
                hi, hi_incl = v, incl
    return (lo, hi, lo_incl, hi_incl) if found else None


def full_unique_match(table: TableInfo, ranges: ScanRanges) -> bool:
    """True when the ranges pin every column of a unique index — the
    point-get / batch-point-get case (reference:
    planner/core/point_get_plan.go:413)."""
    idx = ranges.index
    if not (idx.unique or idx.primary):
        return False
    return all(len(p) == len(idx.col_offsets) for p in ranges.points)
