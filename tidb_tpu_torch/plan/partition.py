"""Partition expansion + pruning: partitioned scans become unions of
physical per-partition scans.

Counterpart of the reference's partition handling (reference: the
planner's partition pruning, planner/core/rule_partition_processor.go —
a partitioned LogicalDataSource expands into a union of per-partition
data sources with non-matching partitions pruned; the executor side is
table/tables/partition.go). Here each partition is a real TableStore
with its own device epoch cache, so the expansion gives every surviving
partition its own coprocessor scan.

Runs after predicate pushdown (scan-level conjuncts sit directly above
the scans) and before join reorder/pruning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .expr import PlanExpr
from .logical import (
    LogicalPlan,
    LogicalScan,
    LogicalSelection,
    LogicalUnion,
)
from .schema import PlanSchema


def expand_partitions(plan: LogicalPlan) -> LogicalPlan:
    # the Selection-over-Scan shape must be inspected BEFORE recursion
    # replaces the scan child with a union
    if isinstance(plan, LogicalSelection) and \
            isinstance(plan.children[0], LogicalScan):
        scan = plan.children[0]
        part = getattr(scan.table, "partition", None)
        if part is not None:
            keep = prune_partitions(part, plan.conditions, scan)
            return _scan_union(scan, keep, plan.conditions)
    plan.children = [expand_partitions(c) for c in plan.children]
    if isinstance(plan, LogicalScan):
        part = getattr(plan.table, "partition", None)
        if part is not None:
            return _scan_union(plan, part.defs, [])
    return plan


def _const_num(c) -> Optional[float]:
    """A Const's value in the SQL numeric domain the partition bounds
    live in (decimal literals carry scaled integers physically)."""
    from .expr import Const

    if not isinstance(c, Const) or c.value is None:
        return None
    if getattr(c.ftype, "is_decimal", False):
        return c.value / (10 ** c.ftype.scale)
    if isinstance(c.value, (int, float)):
        return c.value
    return None


def prune_partitions(part, conditions: list[PlanExpr], scan: LogicalScan):
    """Partitions that can hold rows satisfying the conjuncts
    (reference: rule_partition_processor.go pruning on hash equality and
    range intervals). Falls back to all partitions when the conjuncts
    don't bound the partition column. Constant values normalize out of
    their physical encodings (scaled decimals) before comparing with the
    partition bounds."""
    from .expr import Call, Col, Const

    # scan schema is the full column list at this point: position ->
    # table offset through source_offset
    pos = next((i for i, f in enumerate(scan.schema.fields)
                if f.source_offset == part.col_offset), None)
    if pos is None:
        return list(part.defs)

    def col_const(c):
        """(op, numeric const) for `pcol OP const` conjuncts."""
        if not isinstance(c, Call) or c.op not in (
                "eq", "lt", "le", "gt", "ge", "in_values"):
            return None
        if c.op == "in_values":
            a = c.args[0]
            if isinstance(a, Col) and a.idx == pos:
                return ("in", list(c.extra))
            return None
        a, b = c.args
        op = c.op
        if isinstance(b, Col) and isinstance(a, Const):
            a, b = b, a
            op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                  "eq": "eq"}[op]
        if not (isinstance(a, Col) and a.idx == pos
                and isinstance(b, Const)):
            return None
        v = _const_num(b)
        if v is None:
            return None
        return (op, v)

    lo = hi = None
    lo_incl = hi_incl = True
    eq_vals: Optional[list] = None
    for c in conditions:
        hit = col_const(c)
        if hit is None:
            continue
        op, v = hit
        if op == "in":
            eq_vals = [x for x in v if isinstance(x, (int, float))]
        elif op == "eq":
            eq_vals = [v]
        elif op in ("gt", "ge"):
            if lo is None or v > lo:
                lo, lo_incl = v, op == "ge"
        elif op in ("lt", "le"):
            if hi is None or v < hi:
                hi, hi_incl = v, op == "le"

    if eq_vals is not None:
        keep = []
        for v in eq_vals:
            if float(v) != int(v):
                continue  # fractional value never equals an int column
            try:
                d = part.route(int(v))
            except (ValueError, TypeError):
                continue
            if d not in keep:
                keep.append(d)
        return keep
    if part.kind == "range" and (lo is not None or hi is not None):
        keep = []
        prev_bound = None
        for d in part.defs:
            # partition covers [prev_bound, d.less_than). Comparisons
            # stay exact for any numeric bound type (no integer ±1
            # tricks — a float bound like d < 10.5 must not prune the
            # partition holding d = 10); at worst they keep an extra
            # partition, never drop a matching one.
            p_lo = prev_bound
            p_hi = d.less_than
            prev_bound = d.less_than
            if lo is not None and p_hi is not None and p_hi <= lo:
                continue  # entirely below the requested range
            if hi is not None and p_lo is not None:
                if p_lo > hi or (not hi_incl and p_lo >= hi):
                    continue  # entirely above
            keep.append(d)
        return keep
    return list(part.defs)


def _scan_union(scan: LogicalScan, defs, conditions: list[PlanExpr]
                ) -> LogicalPlan:
    if not defs:
        defs = [scan.table.partition.defs[0]]  # provably-empty: 1 scan
    children: list[LogicalPlan] = []
    for d in defs:
        child_info = dataclasses.replace(
            scan.table, id=d.id, name=f"{scan.table.name}#{d.name}",
            partition=None)
        cscan = LogicalScan(child_info, scan.alias,
                            PlanSchema(list(scan.schema.fields)))
        node: LogicalPlan = cscan
        if conditions:
            # expression objects are read-only to the engine: sharing
            # them across partition branches is safe
            node = LogicalSelection(list(conditions), cscan.schema,
                                    [cscan])
        children.append(node)
    if len(children) == 1:
        return children[0]
    return LogicalUnion(PlanSchema(list(scan.schema.fields)), children)


__all__ = ["expand_partitions", "prune_partitions"]
