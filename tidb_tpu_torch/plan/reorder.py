"""Greedy join reordering over INNER/CROSS join groups.

Counterpart of the reference's join-reorder rule (reference:
planner/core/rule_join_reorder.go — the greedy solver joinReorderGreedy;
the DP solver is gated behind tidb_opt_join_reorder_threshold and not
replicated here). Runs after predicate pushdown, so comma-join WHERE
equalities have already become join eq_conditions.

Shape: flatten a maximal INNER/CROSS group into leaves + a global
condition pool, pick a left-deep order (LEADING hint wins, else greedy
smallest-first preferring connected leaves), rebuild the tree placing
each condition at the first join where its columns are available, and
restore the original column order with a projection so parents are
untouched. Reordering is stats-driven: with no row-count estimates and
no hint the syntactic order stands.
"""

from __future__ import annotations

from typing import Optional

from .expr import Call, Col, PlanExpr
from .logical import (
    LogicalJoin,
    LogicalPlan,
    LogicalScan,
    LogicalSelection,
    LogicalProjection,
)
from .schema import PlanSchema


def reorder_joins(plan: LogicalPlan, stats=None) -> LogicalPlan:
    if isinstance(plan, LogicalJoin) and plan.kind in ("INNER", "CROSS"):
        leaves, conds = _flatten(plan)
        leaves = [reorder_joins(l, stats) for l in leaves]
        hint = getattr(plan, "_leading_hint", None)
        if len(leaves) >= 2 and (hint or len(leaves) >= 3):
            order = _choose_order(leaves, conds, stats, hint)
            if order is not None and order != list(range(len(leaves))):
                return _rebuild(leaves, conds, order)
        return plan
    plan.children = [reorder_joins(c, stats) for c in plan.children]
    return plan


def _flatten(node: LogicalPlan):
    """(leaves, conds): leaves in syntactic order; conds as
    ('eq', gl, gr) | ('other', expr) with column positions global over
    the leaf concatenation."""
    if isinstance(node, LogicalJoin) and node.kind in ("INNER", "CROSS"):
        lleaves, lconds = _flatten(node.children[0])
        rleaves, rconds = _flatten(node.children[1])
        nleft = sum(len(l.schema) for l in lleaves)
        conds = list(lconds)
        for c in rconds:
            if c[0] == "eq":
                conds.append(("eq", c[1] + nleft, c[2] + nleft))
            else:
                conds.append(("other", _shift(c[1], nleft)))
        for li, ri in node.eq_conditions:
            conds.append(("eq", li, ri + nleft))
        for e in node.other_conditions:
            conds.append(("other", e))
        return lleaves + rleaves, conds
    return [node], []


def _shift(e: PlanExpr, by: int) -> PlanExpr:
    if isinstance(e, Col):
        return Col(e.idx + by, e.ftype, e.name)
    if isinstance(e, Call):
        return Call(e.op, [_shift(a, by) for a in e.args], e.ftype, e.extra)
    return e


def _leaf_alias(leaf: LogicalPlan) -> Optional[str]:
    if isinstance(leaf, LogicalScan):
        return leaf.alias
    if isinstance(leaf, LogicalSelection) and \
            isinstance(leaf.children[0], LogicalScan):
        return leaf.children[0].alias
    return None


def _leaf_rows(leaf: LogicalPlan, stats) -> Optional[float]:
    scan = leaf
    n_conds = 0
    if isinstance(leaf, LogicalSelection) and \
            isinstance(leaf.children[0], LogicalScan):
        n_conds = len(leaf.conditions)
        scan = leaf.children[0]
    if isinstance(scan, LogicalScan) and stats is not None:
        ts = stats.table_stats(scan.table.id)
        if ts is not None:
            # conjunct-count damping stands in for real selectivity
            # (the reference multiplies per-conjunct selectivities,
            # statistics/selectivity.go)
            return max(ts.row_count * (0.25 ** n_conds), 1.0)
    return None


def _choose_order(leaves, conds, stats, hint) -> Optional[list[int]]:
    n = len(leaves)
    bases = _bases(leaves)

    def leaf_of(g: int) -> int:
        lo = 0
        while lo + 1 < n and bases[lo + 1] <= g:
            lo += 1
        return lo

    # leaf adjacency through eq conditions
    adj: dict[int, set[int]] = {i: set() for i in range(n)}
    for c in conds:
        if c[0] == "eq":
            a, b = leaf_of(c[1]), leaf_of(c[2])
            if a != b:
                adj[a].add(b)
                adj[b].add(a)

    ests = [_leaf_rows(l, stats) for l in leaves]
    order: list[int] = []
    if hint:
        by_alias = {_leaf_alias(l): i for i, l in enumerate(leaves)}
        for name in hint:
            i = by_alias.get(name)
            if i is None or i in order:
                return None  # unknown alias: hint can't be honored
            order.append(i)
    if not order:
        if any(e is None for e in ests):
            return None  # no stats: syntactic order stands
        order.append(min(range(n), key=lambda i: (ests[i], i)))
    remaining = [i for i in range(n) if i not in order]
    cur_rows = max((e for i in order for e in [ests[i]] if e is not None),
                   default=1.0)
    while remaining:
        placed = set(order)

        def cost(i: int) -> tuple[float, int]:
            e = ests[i] if ests[i] is not None else 1e5
            connected = bool(adj[i] & placed)
            return (e if connected else cur_rows * e, i)

        nxt = min(remaining, key=cost)
        remaining.remove(nxt)
        order.append(nxt)
        e = ests[nxt] if ests[nxt] is not None else 1e5
        cur_rows = max(cur_rows, e)
    return order


def _bases(leaves) -> list[int]:
    bases = []
    acc = 0
    for l in leaves:
        bases.append(acc)
        acc += len(l.schema)
    return bases


def _rebuild(leaves, conds, order) -> LogicalPlan:
    """Left-deep tree in `order`; conditions placed at the first join
    where their columns are available; a projection restores the
    original output column order."""
    n = len(leaves)
    bases = _bases(leaves)
    widths = [len(l.schema) for l in leaves]

    def leaf_of(g: int) -> int:
        lo = 0
        while lo + 1 < n and bases[lo + 1] <= g:
            lo += 1
        return lo

    new_base: dict[int, int] = {}
    acc = 0
    for i in order:
        new_base[i] = acc
        acc += widths[i]

    def new_pos(g: int) -> int:
        i = leaf_of(g)
        return new_base[i] + (g - bases[i])

    def cols_of(c) -> set[int]:
        if c[0] == "eq":
            return {c[1], c[2]}
        out: set[int] = set()
        _collect(c[1], out)
        return out

    pending = list(conds)
    first = order[0]
    cur = leaves[first]
    # conditions entirely within the first leaf become a selection on it
    mine_idx = [k for k, c in enumerate(pending)
                if c[0] == "other"
                and cols_of(c)
                and all(leaf_of(g) == first for g in cols_of(c))]
    if mine_idx:
        remapped = [_remap_global(pending[k][1], new_pos)
                    for k in mine_idx]
        cur = LogicalSelection(remapped, cur.schema, [cur])
        drop = set(mine_idx)
        pending = [c for k, c in enumerate(pending) if k not in drop]

    placed = {first}
    for i in order[1:]:
        nleft = len(cur.schema)
        placed.add(i)
        eq_here: list[tuple[int, int]] = []
        others_here: list[PlanExpr] = []
        rest = []
        for c in pending:
            gs = cols_of(c)
            if any(leaf_of(g) not in placed for g in gs):
                rest.append(c)
                continue
            if c[0] == "eq":
                a, b = c[1], c[2]
                if leaf_of(a) == i:
                    a, b = b, a
                if leaf_of(b) == i and leaf_of(a) != i:
                    eq_here.append((new_pos(a), new_pos(b) - nleft))
                else:  # both sides already inside cur (or inside i)
                    lt = leaves[leaf_of(a)].schema.fields[
                        a - bases[leaf_of(a)]].ftype
                    others_here.append(Call(
                        "eq", [Col(new_pos(a), lt), Col(new_pos(b), lt)],
                        _bool_type()))
            else:
                others_here.append(_remap_global(c[1], new_pos))
        pending = rest
        kind = "INNER" if (eq_here or others_here) else "CROSS"
        schema = PlanSchema(cur.schema.fields + leaves[i].schema.fields)
        cur = LogicalJoin(kind, eq_here, others_here, schema,
                          [cur, leaves[i]])
    assert not pending, "join reorder lost conditions"

    total = sum(widths)
    orig_fields = []
    for i in range(n):
        orig_fields.extend(leaves[i].schema.fields)
    exprs = [Col(new_pos(g), orig_fields[g].ftype, orig_fields[g].name)
             for g in range(total)]
    if all(e.idx == g for g, e in enumerate(exprs)):
        return cur
    return LogicalProjection(exprs, PlanSchema(orig_fields), [cur])


def _collect(e: PlanExpr, out: set[int]) -> None:
    if isinstance(e, Col):
        out.add(e.idx)
    elif isinstance(e, Call):
        for a in e.args:
            _collect(a, out)


def _remap_global(e: PlanExpr, new_pos) -> PlanExpr:
    if isinstance(e, Col):
        return Col(new_pos(e.idx), e.ftype, e.name)
    if isinstance(e, Call):
        return Call(e.op, [_remap_global(a, new_pos) for a in e.args],
                    e.ftype, e.extra)
    return e


def _bool_type():
    from ..types.field_type import FieldType, TypeKind
    return FieldType(TypeKind.BIGINT)


__all__ = ["reorder_joins"]
