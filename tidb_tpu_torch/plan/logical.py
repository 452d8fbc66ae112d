"""Logical plan operators.

Counterpart of reference planner/core logical ops (LogicalDataSource,
LogicalSelection, LogicalProjection, LogicalAggregation, LogicalJoin,
LogicalSort, LogicalLimit — planner/core/logical_plans.go). The rule
pipeline here keeps the reference's order for the rules we implement
(reference planner/core/optimizer.go:59-74): column pruning and predicate
pushdown happen during build; agg/topn pushdown happens at physical time
when choosing the cop/root split.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..catalog.schema import TableInfo
from .expr import AggDesc, PlanExpr
from .schema import PlanSchema


class LogicalPlan:
    schema: PlanSchema
    children: list["LogicalPlan"]


@dataclass
class LogicalScan(LogicalPlan):
    table: TableInfo
    alias: str
    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)
    # filled by column pruning: offsets of table columns actually needed
    used_offsets: Optional[list[int]] = None


@dataclass
class LogicalSelection(LogicalPlan):
    conditions: list[PlanExpr]
    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)


@dataclass
class LogicalProjection(LogicalPlan):
    exprs: list[PlanExpr]
    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)


@dataclass
class LogicalAggregation(LogicalPlan):
    group_by: list[PlanExpr]
    aggs: list[AggDesc]
    schema: PlanSchema  # group cols then agg results
    children: list[LogicalPlan] = field(default_factory=list)


@dataclass
class LogicalJoin(LogicalPlan):
    kind: str  # 'INNER' | 'LEFT' | 'RIGHT' | 'CROSS'
    # equi-join conditions as (left_idx, right_idx) over child schemas
    eq_conditions: list[tuple[int, int]]
    # residual conditions over the concatenated (left ++ right) schema
    other_conditions: list[PlanExpr]
    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)


@dataclass
class LogicalSort(LogicalPlan):
    items: list[tuple[PlanExpr, bool]]  # (expr, desc)
    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)


@dataclass
class LogicalLimit(LogicalPlan):
    limit: int
    offset: int
    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)


@dataclass
class LogicalUnion(LogicalPlan):
    """UNION ALL: bag concatenation of same-width children (reference:
    planner/core LogicalUnionAll; DISTINCT lowers to an aggregation above,
    exactly like buildDistinct)."""

    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)


@dataclass
class WindowItem:
    """One window computation (reference: planner/core LogicalWindow
    WindowFuncDesc). frame=None means the default frame: with order,
    running (peers share values — RANGE UNBOUNDED PRECEDING..CURRENT
    ROW); without, the whole partition. An explicit frame is the AST
    WindowFrame (ROWS/RANGE bounds)."""

    func: str  # upper-case window/agg function name
    args: list[PlanExpr]
    partition: list[PlanExpr]
    order: list[tuple[PlanExpr, bool]]
    ftype: object
    frame: object = None  # ast.WindowFrame | None


@dataclass
class LogicalWindow(LogicalPlan):
    """Appends one output column per window item to the child schema
    (reference: planner/core/logical_plans.go LogicalWindow;
    executor/window.go)."""

    items: list[WindowItem]
    schema: PlanSchema
    children: list[LogicalPlan] = field(default_factory=list)
