"""Physical planning: column pruning, pushdown split, host operators.

Counterpart of the reference's physical optimization + task model (reference:
planner/core/find_best_task.go, task.go:56 copTask/rootTask; pushdown gate
expression.CanExprsPushDown -> canFuncBePushed, expression/expression.go:921).
Round-1 strategy is heuristic rather than cost-based: push the largest
scan->selection->agg/projection prefix whose expressions the device kernel
library supports; everything above runs in the host volcano engine.

Pruning mirrors columnPruner (reference: planner/core/rule_column_pruning.go):
scans read only referenced columns — essential when the device column cache
holds wide TPC-H tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.field_type import FieldType, TypeKind
from .dag import (CopDAG, DAGAggregation, DAGScan, DAGSelection, DAGTopN,
                  DAGLimit, HLL_WORDS)
from .expr import AggDesc, Call, Col, Const, PlanExpr, ScalarSubq
from .logical import (
    LogicalAggregation,
    LogicalJoin,
    LogicalLimit,
    LogicalPlan,
    LogicalProjection,
    LogicalScan,
    LogicalSelection,
    LogicalSort,
    LogicalUnion,
    LogicalWindow,
)
from .schema import PlanSchema, ResultField


# ==================== physical nodes ====================

class PhysicalPlan:
    schema: PlanSchema
    children: list["PhysicalPlan"]


@dataclass
class PhysTableRead(PhysicalPlan):
    """Leaf: ships a CopDAG to the TiTPU coprocessor (distsql.Select analog).

    With a pushed aggregation the output is partial-state columns:
    [group cols..., (val, cnt) per agg...] — the host PhysHashAgg(final)
    merges them (reference P2: partial agg in copr, final in TiDB)."""

    dag: CopDAG
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)
    est_rows: Optional[float] = None  # CBO estimate for EXPLAIN
    table: object = None  # TableInfo (fragment eligibility, plan/fragment.py)


@dataclass
class PhysPointGet(PhysicalPlan):
    """Point / batch-point get: resolve rows directly by handle or by a
    fully-pinned unique index key, bypassing the coprocessor scan entirely
    (reference: executor/point_get.go, executor/batch_point_get.go; planned
    by the TryFastPlan bypass, planner/core/point_get_plan.go:413)."""

    table: object  # TableInfo
    col_offsets: list[int]
    # pk-is-handle path: literal handles to fetch; else None
    handles: Optional[list[int]]
    # unique-index path: ScanRanges with full key points; else None
    ranges: Optional[object]
    # residual filter over the output schema
    conditions: list[PlanExpr]
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)
    est_rows: Optional[float] = None


@dataclass
class PhysIndexMerge(PhysicalPlan):
    """Union several index paths' handle sets, fetch once, re-check the
    full filter (reference: executor/index_merge_reader.go; planned by
    generateIndexMergePath, planner/core/stats.go). Chosen when the
    filter has one OR conjunct whose EVERY disjunct is servable by some
    index — each branch over-approximates its disjunct, so the union
    over-approximates the OR and the residual filter restores exactness."""

    table: object  # TableInfo
    col_offsets: list[int]
    branches: list[object]  # one ScanRanges per OR disjunct
    conditions: list[PlanExpr]  # FULL conjunct list, re-checked on fetch
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)
    est_rows: Optional[float] = None


@dataclass
class PhysSelection(PhysicalPlan):
    conditions: list[PlanExpr]
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysProjection(PhysicalPlan):
    exprs: list[PlanExpr]
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysHashAgg(PhysicalPlan):
    """mode 'final': merge device partials; mode 'complete': host-only agg."""

    mode: str
    group_by: list[PlanExpr]
    aggs: list[AggDesc]
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysHashJoin(PhysicalPlan):
    kind: str
    eq_conditions: list[tuple[int, int]]
    other_conditions: list[PlanExpr]
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysIndexJoin(PhysicalPlan):
    """Outer-driven index lookup join: per outer batch, probe the inner
    table's lazy sorted-permutation index with the outer keys and gather
    only the matching rows — no build of the full inner side (reference:
    executor/index_lookup_join.go; chosen by cost like
    planner/core/exhaust_physical_plans.go getIndexJoin when the outer is
    far smaller than the indexed inner). children = [outer, inner scan];
    the inner PhysTableRead is for EXPLAIN/stats — execution probes its
    table's index directly."""

    kind: str
    eq_conditions: list[tuple[int, int]]   # [(outer idx, inner LOCAL idx)]
    other_conditions: list[PlanExpr]
    schema: PlanSchema
    inner_offset: int = 0                  # store offset of the join col
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysMergeJoin(PhysicalPlan):
    """Sort-merge equi-join over key-ordered inputs (both sides join on
    their PK handles, which the columnar epochs keep ordered) — no hash
    table, a single searchsorted alignment (reference:
    executor/merge_join.go; picked by exhaust_physical_plans.go when both
    children provide the key order)."""

    kind: str
    eq_conditions: list[tuple[int, int]]
    other_conditions: list[PlanExpr]
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysUnion(PhysicalPlan):
    """UNION ALL: run children, normalize each child's columns to the
    unified schema (scale/width/dictionary), concatenate (reference:
    executor/union iterating children; DISTINCT is an agg above)."""

    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysWindow(PhysicalPlan):
    """Host window computation appending one column per item (reference:
    executor/window.go; shuffle-partition parallelism replaced by
    vectorized segmented numpy passes)."""

    items: list
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysSort(PhysicalPlan):
    items: list[tuple[PlanExpr, bool]]
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


@dataclass
class PhysLimit(PhysicalPlan):
    limit: int
    offset: int
    schema: PlanSchema
    children: list[PhysicalPlan] = field(default_factory=list)


# ==================== pushdown gate ====================

# ops the JAX kernel compiler supports (copr/compiler.py) — keep in sync.
_DEVICE_OPS = frozenset(
    """
    add sub mul div intdiv mod neg abs
    eq ne lt le gt ge
    and or not isnull in_values like if ifnull coalesce case
    year month day date_add_days cast
    """.split()
)

_STRING_OK_OPS = frozenset({"eq", "ne", "in_values", "like", "isnull",
                            "ifnull", "coalesce", "if", "case"})


def _type_on_device(ft: FieldType) -> bool:
    return ft.kind != TypeKind.NULL


def expr_pushable(e: PlanExpr) -> bool:
    """The canFuncBePushed analog for the TiTPU store."""
    if isinstance(e, (Col, Const)):
        if e.ftype.is_string and e.ftype.is_ci:
            # ci collations compare casefolded strings; the device code
            # tables are built per-predicate host-side, but keeping ci
            # columns host-only keeps code-space semantics simple
            # (reference gates new collations similarly,
            # expression.go:921 canFuncBePushed collation check)
            return False
        return _type_on_device(e.ftype)
    if isinstance(e, Call):
        if e.op not in _DEVICE_OPS:
            return False
        if e.op == "cast":
            # only numeric<->numeric casts on device
            if e.ftype.is_string or any(a.ftype.is_string for a in e.args):
                return False
        for a in e.args:
            if a.ftype.is_string and e.op not in _STRING_OK_OPS:
                return False
            if not expr_pushable(a):
                return False
        return _type_on_device(e.ftype)
    return False


def agg_pushable(group_by: list[PlanExpr], aggs: list[AggDesc]) -> bool:
    for g in group_by:
        if not expr_pushable(g):
            return False
        if g.ftype.is_float:
            # float group keys are ill-defined on device hashing; host handles
            return False
        if g.ftype.is_string and g.ftype.is_ci:
            return False  # ci grouping merges case variants host-side
    for d in aggs:
        if d.distinct:
            return False
        if d.func not in ("sum", "count", "avg", "min", "max",
                          "approx_count_distinct"):
            return False
        if d.func == "approx_count_distinct":
            # device HLL hashes the widened int32 value; floats would hash
            # their f32 staging (host values are f64 — sketch mismatch) and
            # string dict codes differ across partition dictionaries, so
            # both stay host-side
            if d.arg is None or not expr_pushable(d.arg) \
                    or d.arg.ftype.is_string or d.arg.ftype.is_float:
                return False
            continue
        if d.arg is not None:
            if not expr_pushable(d.arg):
                return False
            if d.arg.ftype.is_string:
                return False  # min/max over dict codes is order-wrong
    return True


# ==================== predicate pushdown ====================

def push_predicates(plan: LogicalPlan) -> LogicalPlan:
    """Push selection conditions below joins; discover equi-join conditions
    from WHERE (turns comma/CROSS joins into INNER hash joins). Counterpart
    of reference planner/core/rule_predicate_push_down.go. Outer joins only
    accept pushes to their outer side (null-extension safety)."""
    plan.children = [push_predicates(c) for c in plan.children]

    if isinstance(plan, (LogicalUnion, LogicalWindow)):
        return plan

    if isinstance(plan, LogicalSelection):
        child = plan.children[0]
        if isinstance(child, LogicalSelection):
            child.conditions = plan.conditions + child.conditions
            return child
        if isinstance(child, LogicalJoin):
            join = child
            nleft = len(join.children[0].schema)
            left_c: list[PlanExpr] = []
            right_c: list[PlanExpr] = []
            remain: list[PlanExpr] = []
            for cond in plan.conditions:
                cols: set[int] = set()
                _expr_cols(cond, cols)
                pair = _as_equi_pair_phys(cond, nleft)
                if pair is not None and join.kind in ("INNER", "CROSS"):
                    join.eq_conditions.append(pair)
                elif cols and max(cols) < nleft and join.kind in (
                    "INNER", "CROSS", "LEFT", "SEMI", "ANTI", "ANTI_NULL"
                ):
                    left_c.append(cond)
                elif cols and min(cols) >= nleft and join.kind in (
                    "INNER", "CROSS", "RIGHT"
                ):
                    right_c.append(_remap_expr(
                        cond, {i: i - nleft for i in cols}))
                elif join.kind in ("INNER", "CROSS"):
                    join.other_conditions.append(cond)
                else:
                    remain.append(cond)
            if join.kind == "CROSS" and (join.eq_conditions or
                                         join.other_conditions):
                join.kind = "INNER"
            if left_c:
                join.children[0] = push_predicates(LogicalSelection(
                    left_c, join.children[0].schema, [join.children[0]]))
            if right_c:
                join.children[1] = push_predicates(LogicalSelection(
                    right_c, join.children[1].schema, [join.children[1]]))
            if remain:
                plan.conditions = remain
                plan.children = [join]
                return plan
            return join
    return plan


def _as_equi_pair_phys(cond: PlanExpr, nleft: int):
    if isinstance(cond, Call) and cond.op == "eq":
        a, b = cond.args
        if isinstance(a, Col) and isinstance(b, Col):
            if a.idx < nleft <= b.idx:
                return (a.idx, b.idx - nleft)
            if b.idx < nleft <= a.idx:
                return (b.idx, a.idx - nleft)
    return None


# ==================== column pruning ====================

def _expr_cols(e: PlanExpr, out: set[int]) -> None:
    if isinstance(e, Col):
        out.add(e.idx)
    elif isinstance(e, Call):
        for a in e.args:
            _expr_cols(a, out)


def _remap_expr(e: PlanExpr, mapping: dict[int, int]) -> PlanExpr:
    if isinstance(e, Col):
        return Col(mapping[e.idx], e.ftype, e.name)
    if isinstance(e, Call):
        return Call(e.op, [_remap_expr(a, mapping) for a in e.args], e.ftype,
                    e.extra)
    return e


def prune(plan: LogicalPlan, required: Optional[set[int]] = None) -> LogicalPlan:
    """Drop unused columns below each node; rewrites Col indices in place of
    the old schema positions. `required` is the set of this node's output
    indices the parent needs (None = all)."""
    if required is None:
        required = set(range(len(plan.schema)))

    if isinstance(plan, LogicalUnion):
        # union columns align by position, so the parent's requirement
        # prunes every child at the same positions; a child that must
        # keep extra columns (its selection's condition columns) gets an
        # aligning projection. Essential for partitioned scans, whose
        # unions would otherwise read every column of wide tables.
        keep = sorted(required)
        if not keep and plan.schema.fields:
            keep = [0]
        new_children = []
        for c in plan.children:
            c2 = prune(c, set(keep))
            m = c2._prune_map  # type: ignore[attr-defined]
            positions = [m[old] for old in keep]
            if positions != list(range(len(c2.schema))):
                exprs = [Col(m[old], c2.schema.fields[m[old]].ftype)
                         for old in keep]
                c2 = LogicalProjection(
                    exprs,
                    PlanSchema([c2.schema.fields[m[old]] for old in keep]),
                    [c2])
            new_children.append(c2)
        plan.children = new_children
        plan.schema = PlanSchema([plan.schema.fields[i] for i in keep])
        plan._prune_map = {old: new for new, old in enumerate(keep)}  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalWindow):
        # window items reference arbitrary child columns; keep them all
        plan.children = [prune(c) for c in plan.children]
        plan._prune_map = {i: i for i in range(len(plan.schema))}  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalScan):
        keep = sorted(required) or [0] if plan.table.columns else []
        if plan.table.columns and not keep:
            keep = [0]
        fields = [plan.schema.fields[i] for i in keep]
        plan.used_offsets = [plan.schema.fields[i].source_offset for i in keep]
        plan.schema = PlanSchema(fields)
        plan._prune_map = {old: new for new, old in enumerate(keep)}  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalSelection):
        need = set(required)
        for c in plan.conditions:
            _expr_cols(c, need)
        child = prune(plan.children[0], need)
        m = child._prune_map  # type: ignore[attr-defined]
        plan.conditions = [_remap_expr(c, m) for c in plan.conditions]
        plan.schema = child.schema
        plan._prune_map = m  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalProjection):
        keep = sorted(required)
        if not keep and plan.exprs:
            # a zero-column chunk cannot carry a row count: keep one
            # expr so '(select 1) d' cross joins still contribute rows
            keep = [0]
        exprs = [plan.exprs[i] for i in keep]
        need: set[int] = set()
        for e in exprs:
            _expr_cols(e, need)
        child = prune(plan.children[0], need)
        m = child._prune_map  # type: ignore[attr-defined]
        plan.exprs = [_remap_expr(e, m) for e in exprs]
        plan.schema = PlanSchema([plan.schema.fields[i] for i in keep])
        plan._prune_map = {old: new for new, old in enumerate(keep)}  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalAggregation):
        ngroups = len(plan.group_by)
        keep_aggs = sorted(
            {i - ngroups for i in required if i >= ngroups}
        )
        plan.aggs = [plan.aggs[i] for i in keep_aggs]
        need: set[int] = set()
        for g in plan.group_by:
            _expr_cols(g, need)
        for d in plan.aggs:
            if d.arg is not None:
                _expr_cols(d.arg, need)
        child = prune(plan.children[0], need)
        m = child._prune_map  # type: ignore[attr-defined]
        plan.group_by = [_remap_expr(g, m) for g in plan.group_by]
        plan.aggs = [
            AggDesc(d.func, None if d.arg is None else _remap_expr(d.arg, m),
                    d.ftype, d.distinct, d.name, d.params)
            for d in plan.aggs
        ]
        fields = plan.schema.fields[:ngroups] + [
            plan.schema.fields[ngroups + i] for i in keep_aggs
        ]
        plan.schema = PlanSchema(fields)
        out_map = {g: g for g in range(ngroups)}
        for new, old in enumerate(keep_aggs):
            out_map[ngroups + old] = ngroups + new
        plan._prune_map = out_map  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalSort):
        need = set(required)
        for e, _ in plan.items:
            _expr_cols(e, need)
        child = prune(plan.children[0], need)
        m = child._prune_map  # type: ignore[attr-defined]
        plan.items = [(_remap_expr(e, m), d) for e, d in plan.items]
        plan.schema = child.schema
        plan._prune_map = m  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalLimit):
        child = prune(plan.children[0], set(required))
        plan.schema = child.schema
        plan._prune_map = child._prune_map  # type: ignore[attr-defined]
        return plan

    if isinstance(plan, LogicalJoin):
        semi = plan.kind in ("SEMI", "ANTI", "ANTI_NULL")
        nleft = len(plan.children[0].schema)
        need_l: set[int] = set()
        need_r: set[int] = set()
        for i in required:
            # semi/anti joins output the left schema only
            (need_l if i < nleft else need_r).add(i if i < nleft else i - nleft)
        for li, ri in plan.eq_conditions:
            need_l.add(li)
            need_r.add(ri)
        both: set[int] = set()
        for c in plan.other_conditions:
            _expr_cols(c, both)
        for i in both:
            (need_l if i < nleft else need_r).add(i if i < nleft else i - nleft)
        left = prune(plan.children[0], need_l)
        right = prune(plan.children[1], need_r)
        ml = left._prune_map  # type: ignore[attr-defined]
        mr = right._prune_map  # type: ignore[attr-defined]
        new_nleft = len(left.schema)
        m = {}
        for old, new in ml.items():
            m[old] = new
        for old, new in mr.items():
            m[nleft + old] = new_nleft + new
        plan.eq_conditions = [(ml[a], mr[b]) for a, b in plan.eq_conditions]
        plan.other_conditions = [
            _remap_expr(c, m) for c in plan.other_conditions
        ]
        if semi:
            plan.schema = PlanSchema(left.schema.fields)
            plan._prune_map = ml  # type: ignore[attr-defined]
        else:
            plan.schema = PlanSchema(left.schema.fields + right.schema.fields)
            plan._prune_map = m  # type: ignore[attr-defined]
        return plan

    raise TypeError(f"prune: unknown node {type(plan).__name__}")


# ==================== physical build ====================

def optimize(plan: LogicalPlan, stats=None) -> PhysicalPlan:
    plan = push_predicates(plan)
    from .partition import expand_partitions
    plan = expand_partitions(plan)
    from .reorder import reorder_joins
    plan = reorder_joins(plan, stats)
    plan = prune(plan)
    phys = _to_physical(plan, stats)
    from .fragment import apply_fragments
    phys = apply_fragments(phys)
    # joins the device fragment rewriter left on the host pick their
    # algorithm by cost (hash / index-lookup / merge)
    phys = apply_join_algorithms(phys)
    _optimize_subqueries(phys, stats)
    return phys


def apply_join_algorithms(plan: PhysicalPlan) -> PhysicalPlan:
    plan.children = [apply_join_algorithms(c) for c in plan.children]
    if isinstance(plan, PhysHashJoin):
        return _choose_join(plan, plan.children[0], plan.children[1])
    return plan


def _optimize_subqueries(plan: PhysicalPlan, stats=None) -> None:
    """Optimize the logical plan inside every ScalarSubq expression
    (uncorrelated — runs once per statement, engine materializes it)."""
    for e in _node_exprs(plan):
        _optimize_subq_expr(e, stats)
    for c in plan.children:
        _optimize_subqueries(c, stats)


def _optimize_subq_expr(e: PlanExpr, stats=None) -> None:
    if isinstance(e, ScalarSubq):
        if e.phys is None:
            e.phys = optimize(e.logical, stats)
    elif isinstance(e, Call):
        for a in e.args:
            _optimize_subq_expr(a, stats)


def _node_exprs(plan: PhysicalPlan) -> list[PlanExpr]:
    out: list[PlanExpr] = []
    if isinstance(plan, PhysSelection):
        out += plan.conditions
    elif isinstance(plan, PhysPointGet):
        out += plan.conditions
    elif isinstance(plan, PhysProjection):
        out += plan.exprs
    elif isinstance(plan, PhysHashAgg):
        out += plan.group_by
        out += [d.arg for d in plan.aggs if d.arg is not None]
    elif isinstance(plan, PhysSort):
        out += [e for e, _ in plan.items]
    elif isinstance(plan, PhysHashJoin):
        out += plan.other_conditions
    return out


def _fresh_table_read(scan: LogicalScan) -> PhysTableRead:
    offsets = scan.used_offsets
    if offsets is None:
        offsets = [f.source_offset for f in scan.schema.fields]
    dag = CopDAG(
        scan=DAGScan(scan.table.id, offsets),
        output_types=[f.ftype for f in scan.schema.fields],
    )
    return PhysTableRead(dag, scan.schema, table=scan.table)


def _bare_scan(tr: PhysTableRead) -> bool:
    dag = tr.dag
    if dag.scan.table_id < 0:
        return False  # dual pseudo-table: everything stays host-side
    return dag.agg is None and dag.topn is None and dag.limit is None and \
        dag.projections is None


def _has_subq(e: PlanExpr) -> bool:
    if isinstance(e, ScalarSubq):
        return True
    if isinstance(e, Call):
        return any(_has_subq(a) for a in e.args)
    return False


# index path cost gates (fractions of table rows): the device scan is so
# fast that host-side gather only wins at low selectivity
POINT_SEL_LIMIT = 0.1     # non-unique equality points (stats available)
INTERVAL_SEL_LIMIT = 0.05  # interval ranges (require stats to justify)


def _access_path(scan_offsets: list[int], table, conditions, stats=None,
                 scan=None):
    """Choose an index access path from the conjuncts. Equality points are
    chosen heuristically (point lookups justify themselves); interval
    ranges are chosen only when statistics estimate low selectivity.
    USE_INDEX/IGNORE_INDEX hints on the scan constrain the candidate set
    and bypass the selectivity gates (reference: hints.go).
    Returns ('handles', [int], est) | ('unique', ScanRanges, est) |
    ('ranges', ScanRanges, est) | None (full scan). Reference: access-path
    selection planner/core/planbuilder.go:933 + point-get bypass
    point_get_plan.go:413 + selectivity feed statistics/selectivity.go.
    """
    from .ranger import (
        _eq_values,
        extract_interval,
        extract_points,
        full_unique_match,
        ScanRanges,
    )

    use_hint = [n.lower() for n in
                getattr(scan, "hint_use_index", [])] if scan else []
    ignore_hint = {n.lower() for n in
                   getattr(scan, "hint_ignore_index", [])} if scan else set()

    def allowed(index) -> bool:
        if index.name.lower() in ignore_hint:
            return False
        return not use_hint or index.name.lower() in use_hint

    col_map = {i: off for i, off in enumerate(scan_offsets)}
    if table.pk_handle_offset is not None and not use_hint:
        for c in conditions:
            hit = _eq_values(c, col_map)
            if hit is not None and hit[0] == table.pk_handle_offset:
                return "handles", [int(v) for v in hit[1]], float(len(hit[1]))
    ts = stats.table_stats(table.id) if stats is not None else None
    best = None
    best_est = None
    # the ranged path evals all conjuncts storage-side, which can't host a
    # scalar subquery; unique/handle point gets filter engine-side, so
    # they stay eligible
    has_subq = any(_has_subq(c) for c in conditions)
    for index in table.indices:
        if not index.visible:
            continue  # still being built online (ddl/ddl.py)
        if not allowed(index):
            continue
        r = extract_points(table, index, conditions, col_map)
        if r is None:
            continue
        if full_unique_match(table, r):
            return "unique", r, float(len(r.points))
        if has_subq:
            continue
        if not r.points:  # contradictory equalities: provably empty
            return "ranges", r, 0.0
        est = None
        if ts is not None:
            off0 = index.col_offsets[0]
            est = sum(
                stats.est_eq_rows(table.id, off0, p[0], ts.row_count)
                for p in r.points)
            if est > ts.row_count * POINT_SEL_LIMIT and \
                    index.name.lower() not in use_hint:
                continue  # too many rows: the full scan is cheaper
        depth = len(r.points[0])
        if best is None or depth > len(best.points[0]) or (
                depth == len(best.points[0])
                and len(r.points) < len(best.points)):
            best, best_est = r, est
    if best is not None:
        return "ranges", best, best_est
    # interval ranges: only with statistics backing the choice (a USE_INDEX
    # hint overrides the gate — the user asserted the path is good)
    if (ts is not None or use_hint) and not has_subq:
        for index in table.indices:
            if not index.visible or not allowed(index):
                continue
            off0 = index.col_offsets[0]
            if table.columns[off0].ftype.is_string:
                continue
            interval = extract_interval(off0, conditions, col_map)
            if interval is None:
                continue
            lo, hi, li, hi_i = interval
            if index.name.lower() in use_hint:
                return "ranges", ScanRanges(index, [], interval), None
            if ts is None:
                continue
            est = stats.est_range_rows(table.id, off0, lo, hi, li, hi_i,
                                       ts.row_count)
            if est <= ts.row_count * INTERVAL_SEL_LIMIT:
                return "ranges", ScanRanges(index, [], interval), est
    return None


MERGE_SEL_LIMIT = 0.3  # union of branch estimates vs full scan


def _flatten_bool(e: PlanExpr, op: str) -> list[PlanExpr]:
    if isinstance(e, Call) and e.op == op:
        out: list[PlanExpr] = []
        for a in e.args:
            out.extend(_flatten_bool(a, op))
        return out
    return [e]


def _index_merge_path(scan_offsets: list[int], table, conditions,
                      stats=None, scan=None):
    """(branches, est) for an index-merge UNION read, or None.

    Looks for ONE conjunct that is an OR whose every disjunct (itself a
    conjunction) is servable by an index equality-point set — or by the
    pk-handle column. Estimates sum per-branch; with statistics the sum
    must clear MERGE_SEL_LIMIT (without them, points-only branches are
    allowed on the same heuristic as the single-index path). Reference:
    planner/core/stats.go generateIndexMergePath + its accessPaths-per-
    disjunct check."""
    from .ranger import _eq_values, extract_points

    use_hint = [n.lower() for n in
                getattr(scan, "hint_use_index", [])] if scan else []
    ignore_hint = {n.lower() for n in
                   getattr(scan, "hint_ignore_index", [])} if scan else set()
    col_map = {i: off for i, off in enumerate(scan_offsets)}
    or_cond = None
    for c in conditions:
        if isinstance(c, Call) and c.op == "or":
            if _has_subq(c):
                return None
            if or_cond is not None:
                return None  # one mergeable OR at a time (ref parity)
            or_cond = c
    if or_cond is None:
        return None
    disjuncts = _flatten_bool(or_cond, "or")
    if len(disjuncts) < 2:
        return None
    ts = stats.table_stats(table.id) if stats is not None else None
    branches = []
    total_est = 0.0 if ts is not None else None
    for d in disjuncts:
        conjs = _flatten_bool(d, "and")
        # pk-handle branch: col = const / IN on the handle column
        handle_rng = None
        if table.pk_handle_offset is not None:
            for c in conjs:
                hit = _eq_values(c, col_map)
                if hit is not None and hit[0] == table.pk_handle_offset:
                    from .ranger import ScanRanges
                    handle_rng = ScanRanges(
                        None, [(int(v),) for v in hit[1]])
                    break
        best = None
        for index in table.indices:
            if not index.visible or index.name.lower() in ignore_hint:
                continue
            if use_hint and index.name.lower() not in use_hint:
                continue
            r = extract_points(table, index, conjs, col_map)
            if r is None or not r.points:
                continue
            depth = len(r.points[0])
            if best is None or depth > len(best.points[0]) or (
                    depth == len(best.points[0])
                    and len(r.points) < len(best.points)):
                best = r
        if best is None:
            best = handle_rng
        if best is None:
            return None  # a disjunct with no index: merge can't win
        branches.append(best)
        if ts is not None:
            if best.index is None:
                total_est += len(best.points)
            else:
                off0 = best.index.col_offsets[0]
                total_est += sum(
                    stats.est_eq_rows(table.id, off0, p[0], ts.row_count)
                    for p in best.points)
    if ts is not None and total_est > ts.row_count * MERGE_SEL_LIMIT \
            and not use_hint:
        return None
    return branches, total_est


def conds_digest(conditions: list[PlanExpr]) -> str:
    """Stable identity of a conjunct set (feedback keying)."""
    return "&".join(sorted(repr(c) for c in conditions))


def _est_selection_rows(table, scan_offsets: list[int],
                        conditions: list[PlanExpr], stats) -> Optional[float]:
    """Cardinality estimate for a conjunct set (reference:
    statistics/selectivity.go): per-conjunct selectivities combined
    with exponential backoff (most selective factor fully, later ones
    with diminishing exponents) so correlated predicates don't compound
    into wild underestimates. An actual-execution feedback record for
    the same conjunct set overrides everything
    (statistics/feedback.go)."""
    if stats is not None:
        fb = stats.feedback_rows(table.id, conds_digest(conditions))
        if fb is not None:
            return float(fb)
    ts = stats.table_stats(table.id) if stats is not None else None
    if ts is None:
        return None
    from .ranger import _eq_values, extract_interval

    col_map = {i: off for i, off in enumerate(scan_offsets)}
    rows = max(ts.row_count, 1.0)
    interval_offs: set[int] = set()
    sels: list[float] = []
    for c in conditions:
        hit = _eq_values(c, col_map)
        if hit is not None:
            off, vals = hit
            est = sum(stats.est_eq_rows(table.id, off, v, rows)
                      for v in vals)
            sels.append(min(est / rows, 1.0))
            continue
        if isinstance(c, Call) and c.op in ("lt", "le", "gt", "ge"):
            cols: set[int] = set()
            _expr_cols(c, cols)
            offs = {col_map[i] for i in cols if i in col_map}
            if len(offs) == 1:
                off = next(iter(offs))
                if off in interval_offs:
                    continue  # both bounds of one interval: count once
                interval_offs.add(off)
                iv = extract_interval(off, conditions, col_map)
                if iv is not None:
                    est = stats.est_range_rows(table.id, off, *iv,
                                               fallback_rows=rows)
                    sels.append(min(est / rows, 1.0))
                    continue
        sels.append(0.8)  # uninterpretable conjunct: mild filter factor
    # exponential backoff instead of naive independence: correlated
    # predicates make the product wildly underestimate, so later (less
    # selective... sorted ascending) factors contribute with diminishing
    # exponents s0 * s1^(1/2) * s2^(1/4) * ... (reference: the
    # selectivity ordering in statistics/selectivity.go; the backoff
    # form is TiDB's tidb_opt_correlation-era estimator)
    sel = 1.0
    for k, s in enumerate(sorted(sels)):
        if k >= 4:
            break  # factors beyond the 4th add nothing measurable
        sel *= s ** (1.0 / (1 << k))
    return rows * sel


def _to_physical(plan: LogicalPlan, stats=None) -> PhysicalPlan:
    if isinstance(plan, LogicalScan):
        tr = _fresh_table_read(plan)
        ts = stats.table_stats(plan.table.id) if stats is not None \
            else None
        if ts is not None:
            tr.est_rows = float(ts.row_count)
        return tr

    if isinstance(plan, LogicalSelection):
        child = _to_physical(plan.children[0], stats)
        if isinstance(child, PhysTableRead) and _bare_scan(child) and \
                isinstance(plan.children[0], LogicalScan):
            scan = plan.children[0]
            ap = _access_path(child.dag.scan.col_offsets, scan.table,
                              plan.conditions, stats, scan=scan)
            if ap is not None:
                kind, payload, est = ap
                if kind in ("handles", "unique"):
                    return PhysPointGet(
                        scan.table, child.dag.scan.col_offsets,
                        payload if kind == "handles" else None,
                        payload if kind == "unique" else None,
                        list(plan.conditions), plan.schema, est_rows=est)
                child.dag.scan.ranges = payload
                child.dag.selection = DAGSelection(list(plan.conditions))
                child.est_rows = est
                return child
            im = _index_merge_path(child.dag.scan.col_offsets, scan.table,
                                   plan.conditions, stats, scan=scan)
            if im is not None:
                branches, est = im
                return PhysIndexMerge(
                    scan.table, child.dag.scan.col_offsets, branches,
                    list(plan.conditions), plan.schema, est_rows=est)
        if (
            isinstance(child, PhysTableRead)
            and _bare_scan(child)
            and all(expr_pushable(c) for c in plan.conditions)
        ):
            dag = child.dag
            if dag.selection is None:
                dag.selection = DAGSelection(list(plan.conditions))
            else:
                dag.selection.conditions.extend(plan.conditions)
            if isinstance(plan.children[0], LogicalScan):
                child.est_rows = _est_selection_rows(
                    plan.children[0].table, dag.scan.col_offsets,
                    plan.conditions, stats)
            return child
        return PhysSelection(plan.conditions, plan.schema, [child])

    if isinstance(plan, LogicalAggregation):
        child = _to_physical(plan.children[0], stats)
        if (
            isinstance(child, PhysTableRead)
            and _bare_scan(child)
            and agg_pushable(plan.group_by, plan.aggs)
        ):
            dag = child.dag
            dag.agg = DAGAggregation(list(plan.group_by), list(plan.aggs))
            # partial layout: group cols, then (val, cnt) per agg —
            # except approx_count_distinct, which ships HLL_WORDS packed
            # register words + cnt (plan/dag.agg_partial_width)
            fields = []
            for i, g in enumerate(plan.group_by):
                fields.append(ResultField(f"gk#{i}", g.ftype))
            for i, d in enumerate(plan.aggs):
                if d.func == "approx_count_distinct":
                    for w in range(HLL_WORDS):
                        fields.append(ResultField(
                            f"ph#{i}_{w}",
                            FieldType(TypeKind.BIGINT, nullable=False)))
                else:
                    val_t = _partial_val_type(d)
                    fields.append(ResultField(f"pv#{i}", val_t))
                fields.append(
                    ResultField(f"pc#{i}",
                                FieldType(TypeKind.BIGINT, nullable=False))
                )
            child.schema = PlanSchema(fields)
            dag.output_types = [f.ftype for f in fields]
            return PhysHashAgg("final", plan.group_by, plan.aggs, plan.schema,
                               [child])
        return PhysHashAgg("complete", plan.group_by, plan.aggs, plan.schema,
                           [child])

    if isinstance(plan, LogicalProjection):
        child = _to_physical(plan.children[0], stats)
        if (
            isinstance(child, PhysTableRead)
            and _bare_scan(child)
            and all(expr_pushable(e) for e in plan.exprs)
            and not any(e.ftype.is_string and not isinstance(e, Col)
                        for e in plan.exprs)
        ):
            child.dag.projections = list(plan.exprs)
            child.dag.output_types = [e.ftype for e in plan.exprs]
            child.schema = plan.schema
            return child
        return PhysProjection(plan.exprs, plan.schema, [child])

    if isinstance(plan, LogicalUnion):
        return PhysUnion(plan.schema,
                         [_to_physical(c, stats) for c in plan.children])

    if isinstance(plan, LogicalWindow):
        return PhysWindow(plan.items, plan.schema,
                          [_to_physical(plan.children[0], stats)])

    if isinstance(plan, LogicalSort):
        child = _to_physical(plan.children[0], stats)
        return PhysSort(plan.items, plan.schema, [child])

    if isinstance(plan, LogicalLimit):
        # TopN pushdown (reference: rule_topn_push_down.go). Patterns:
        #   Limit <- Sort <- pushable chain
        #   Limit <- Projection(trim) <- Sort <- pushable chain
        # dag.topn runs after dag.projections, so sort items referencing the
        # projected output are valid as-is.
        if plan.offset == 0:
            sort_node = None
            trim: Optional[LogicalProjection] = None
            c0 = plan.children[0]
            if isinstance(c0, LogicalSort):
                sort_node = c0
            elif isinstance(c0, LogicalProjection) and \
                    isinstance(c0.children[0], LogicalSort) and \
                    all(isinstance(e, Col) for e in c0.exprs):
                trim = c0
                sort_node = c0.children[0]
            if sort_node is not None and all(
                expr_pushable(e) and not e.ftype.is_string
                for e, _ in sort_node.items
            ):
                inner = _to_physical(sort_node.children[0], stats)
                if isinstance(inner, PhysTableRead) and \
                        inner.dag.scan.table_id >= 0 and \
                        inner.dag.agg is None and \
                        inner.dag.topn is None and inner.dag.limit is None:
                    inner.dag.topn = DAGTopN(sort_node.items, plan.limit)
                    # per-batch top-k results (base epoch + MVCC overlay)
                    # still need a host merge sort + exact limit
                    merged: PhysicalPlan = PhysSort(
                        sort_node.items, inner.schema, [inner])
                    merged = PhysLimit(plan.limit, 0, inner.schema, [merged])
                    if trim is not None:
                        return PhysProjection(trim.exprs, trim.schema,
                                              [merged])
                    return merged
        child = _to_physical(plan.children[0], stats)
        # Limit over a pushable chain lowers to dag.limit (per-region limit is
        # a superset; host PhysLimit still enforces the exact count)
        if isinstance(child, PhysTableRead) and child.dag.agg is None and \
                child.dag.topn is None and child.dag.limit is None:
            child.dag.limit = DAGLimit(plan.limit + plan.offset)
        return PhysLimit(plan.limit, plan.offset, plan.schema, [child])

    if isinstance(plan, LogicalJoin):
        left = _to_physical(plan.children[0], stats)
        right = _to_physical(plan.children[1], stats)
        return PhysHashJoin(plan.kind, plan.eq_conditions,
                            plan.other_conditions, plan.schema,
                            [left, right])

    raise TypeError(f"optimize: unknown node {type(plan).__name__}")


# outer side must be this much smaller (and absolutely small) before
# an index probe beats building one hash of the inner
_INDEX_JOIN_RATIO = 32
_INDEX_JOIN_MAX_OUTER = 200_000


def _join_col_index(table, off: int) -> bool:
    """Does the inner table have a usable single-column index (or the PK
    handle) on store offset `off`?"""
    if table.pk_handle_offset == off:
        return True
    for ix in table.indices:
        if ix.visible and ix.col_offsets == [off]:
            return True
    return False


def _bare_inner_scan(node) -> bool:
    return (isinstance(node, PhysTableRead)
            and getattr(node, "table", None) is not None
            and node.dag.agg is None and node.dag.topn is None
            and node.dag.limit is None and node.dag.scan.ranges is None
            and node.dag.projections is None)


def _choose_join(plan: PhysHashJoin, left, right):
    """Cost-based physical join selection (reference:
    planner/core/exhaust_physical_plans.go): index-lookup join when one
    side is a bare indexed scan and the other side is much smaller;
    merge join when both sides arrive ordered on their join keys (PK
    handles); hash join otherwise. Runs AFTER the device-fragment
    rewriter — only host-remaining joins choose an algorithm."""
    hash_join = plan
    if len(plan.eq_conditions) != 1:
        return hash_join

    def est(node):
        return getattr(node, "est_rows", None)

    # ---- merge join: both sides PK-ordered on the join key ----
    if plan.kind == "INNER" and _bare_inner_scan(left) and \
            _bare_inner_scan(right):
        # LogicalJoin eq pairs are (left idx, right-LOCAL idx)
        li, ri = plan.eq_conditions[0]
        l_off = left.dag.scan.col_offsets[li] if li < len(
            left.dag.scan.col_offsets) else None
        r_off = right.dag.scan.col_offsets[ri] \
            if ri < len(right.dag.scan.col_offsets) else None
        if l_off == left.table.pk_handle_offset and \
                r_off == right.table.pk_handle_offset and \
                l_off is not None and r_off is not None:
            return PhysMergeJoin(plan.kind, plan.eq_conditions,
                                 plan.other_conditions, plan.schema,
                                 [left, right])

    # ---- index join: inner is a bare indexed scan, outer is small ----
    if plan.kind in ("INNER", "SEMI"):
        oi, ii = plan.eq_conditions[0]
        inner, outer = right, left
        if _bare_inner_scan(inner) and ii < len(
                inner.dag.scan.col_offsets):
            off = inner.dag.scan.col_offsets[ii]
            ft = inner.dag.output_types[ii]
            # BOTH key types must be integral: the probe casts outer
            # keys to int64, which would silently truncate float or
            # misread scaled-decimal keys
            oft = outer.schema.fields[oi].ftype \
                if oi < len(outer.schema.fields) else None
            o_est, i_est = est(outer), est(inner)
            if oft is not None and oft.kind in _INT_JOIN_KINDS and \
                    ft.kind in _INT_JOIN_KINDS and \
                    _join_col_index(inner.table, off) and \
                    o_est is not None and i_est is not None and \
                    o_est < _INDEX_JOIN_MAX_OUTER and \
                    o_est * _INDEX_JOIN_RATIO < i_est:
                return PhysIndexJoin(plan.kind, plan.eq_conditions,
                                     plan.other_conditions, plan.schema,
                                     off, [outer, inner])
    return hash_join


_INT_JOIN_KINDS = (TypeKind.TINYINT, TypeKind.SMALLINT, TypeKind.INT,
                   TypeKind.BIGINT, TypeKind.YEAR)


def _partial_val_type(d: AggDesc) -> FieldType:
    if d.func == "count":
        return FieldType(TypeKind.BIGINT, nullable=False)
    if d.func == "avg":
        assert d.arg is not None
        at = d.arg.ftype
        if at.is_decimal:
            return FieldType(TypeKind.DECIMAL, flen=18, scale=at.scale)
        if at.is_float:
            return FieldType(TypeKind.DOUBLE)
        return FieldType(TypeKind.BIGINT)
    return d.ftype


# ==================== explain ====================

def explain_nodes(plan: PhysicalPlan, depth: int = 0):
    """[(node, rendered line)] in display order."""
    out = [(plan, explain_plan(plan, depth)[0])]
    for c in plan.children:
        out.extend(explain_nodes(c, depth + 1))
    return out


def explain_plan(plan: PhysicalPlan, depth: int = 0) -> list[str]:
    pad = "  " * depth
    name = type(plan).__name__
    if isinstance(plan, PhysTableRead):
        est = f" est={plan.est_rows:.0f}" if plan.est_rows is not None else ""
        line = f"{pad}TableRead[TiTPU]: {plan.dag.describe()}{est}"
    elif isinstance(plan, PhysPointGet):
        if plan.handles is not None:
            what = f"handles={plan.handles}"
        else:
            what = plan.ranges.describe()
        line = f"{pad}PointGet: {plan.table.name} {what}"
    elif isinstance(plan, PhysIndexMerge):
        parts = []
        for r in plan.branches:
            if r.index is None:
                parts.append(f"handle[{len(r.points)} pts]")
            else:
                parts.append(r.describe())
        est = f" est={plan.est_rows:.0f}" if plan.est_rows is not None else ""
        line = (f"{pad}IndexMerge(union): {plan.table.name} "
                f"{' | '.join(parts)}{est}")
    elif isinstance(plan, PhysHashAgg):
        line = (f"{pad}HashAgg({plan.mode}): groups={len(plan.group_by)} "
                f"aggs={plan.aggs}")
    elif isinstance(plan, PhysSelection):
        line = f"{pad}Selection: {plan.conditions}"
    elif isinstance(plan, PhysProjection):
        line = f"{pad}Projection: {plan.exprs}"
    elif isinstance(plan, PhysSort):
        line = f"{pad}Sort: {[(repr(e), d) for e, d in plan.items]}"
    elif isinstance(plan, PhysLimit):
        line = f"{pad}Limit: {plan.limit} offset {plan.offset}"
    elif isinstance(plan, PhysHashJoin):
        line = f"{pad}HashJoin({plan.kind}): eq={plan.eq_conditions}"
    elif isinstance(plan, PhysIndexJoin):
        line = (f"{pad}IndexJoin({plan.kind}): eq={plan.eq_conditions} "
                f"inner_offset={plan.inner_offset}")
    elif isinstance(plan, PhysMergeJoin):
        line = f"{pad}MergeJoin({plan.kind}): eq={plan.eq_conditions}"
    elif isinstance(plan, PhysUnion):
        line = f"{pad}Union: {len(plan.children)} children"
    elif isinstance(plan, PhysWindow):
        line = f"{pad}Window: {[it.func for it in plan.items]}"
    elif name == "PhysFragmentRead":
        line = f"{pad}FragmentRead[TiTPU]: {plan.frag.describe()}"
    else:
        line = f"{pad}{name}"
    out = [line]
    for c in plan.children:
        out.extend(explain_plan(c, depth + 1))
    return out
