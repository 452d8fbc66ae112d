"""AST -> logical plan: name resolution, type inference, agg extraction.

Counterpart of the reference's logical plan builder (reference:
planner/core/logical_plan_builder.go + planbuilder.go — buildSelect,
buildAggregation, buildProjection, havingWindowAndOrderbyExprResolver).
Strict ONLY_FULL_GROUP_BY semantics: a non-aggregated column must appear in
GROUP BY.

Constant folding runs inline during resolution (reference:
expression/constant_fold.go) — required for plan-time temporal arithmetic
like `date '1998-12-01' - interval '90' day`.
"""

from __future__ import annotations

import datetime as _dt
from typing import Callable, Optional

from ..catalog.schema import Catalog, TableInfo
from ..sql import ast
from ..types.field_type import FieldType, TypeKind, boolean_type
from ..types.value import Decimal, decode_date, encode_date, parse_date, parse_datetime
from .expr import (
    AggDesc,
    Call,
    Col,
    Const,
    ExprError,
    PlanExpr,
    ScalarSubq,
    agg_result_type,
    arith_result_type,
    bool_call,
    comparable,
    is_numeric,
)
from .logical import (
    LogicalAggregation,
    LogicalJoin,
    LogicalLimit,
    LogicalPlan,
    LogicalProjection,
    LogicalScan,
    LogicalSelection,
    LogicalSort,
)
from .schema import PlanSchema, ResultField

_AGG_NAMES = {"COUNT", "SUM", "AVG", "MIN", "MAX",
              "GROUP_CONCAT", "STD", "STDDEV", "STDDEV_POP",
              "STDDEV_SAMP", "VARIANCE", "VAR_POP", "VAR_SAMP",
              "BIT_AND", "BIT_OR", "BIT_XOR", "ANY_VALUE",
              "APPROX_COUNT_DISTINCT", "APPROX_PERCENTILE",
              "JSON_ARRAYAGG", "JSON_OBJECTAGG"}

_ARITH_OPS = {"+": "add", "-": "sub", "*": "mul", "/": "div",
              "DIV": "intdiv", "%": "mod"}
_CMP_OPS = {"=": "eq", "<=>": "eq", "<>": "ne", "<": "lt", "<=": "le",
            ">": "gt", ">=": "ge"}
_CMP_SWAP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt",
             "ge": "le"}


from ..errno import ER_BAD_FIELD, CodedError
from ..errno import wrap as err_wrap


class PlanError(CodedError):
    """Planner error; name-resolution sites attach 1054/1146 etc."""


def ast_key(node: object) -> str:
    """Structural identity for AST expressions (group-by matching)."""
    return repr(node).lower()


def _coerce_date_arg(a: PlanExpr, fname: str) -> PlanExpr:
    """Date-bearing argument: DATE/DATETIME/TIMESTAMP columns pass
    through; string literals parse (reference: implicit temporal casts,
    types/convert.go). TIME is a duration, not a calendar point."""
    from ..types.field_type import TypeKind as _TK

    if a.ftype.is_string and isinstance(a, Const) and a.value is not None:
        from ..types.value import parse_date, parse_datetime
        s = str(a.value)
        try:
            if " " in s or "T" in s:
                return Const(parse_datetime(s),
                             FieldType(_TK.DATETIME))
            return Const(parse_date(s), FieldType(_TK.DATE))
        except ValueError:
            raise PlanError(
                f"invalid date literal {s!r} for {fname}") from None
    if a.ftype.kind in (_TK.DATE, _TK.DATETIME, _TK.TIMESTAMP):
        return a
    raise PlanError(f"{fname} requires a date argument")


def _parse_time_us(s: str) -> int:
    """'[-]HH:MM:SS[.ffffff]' -> signed microseconds (TIME domain)."""
    neg = s.startswith("-")
    body = s[1:] if neg else s
    parts = body.split(":")
    if len(parts) != 3:
        raise PlanError(f"invalid TIME literal {s!r}")
    try:
        h = int(parts[0])
        m = int(parts[1])
        sec = float(parts[2])
    except ValueError:
        raise PlanError(f"invalid TIME literal {s!r}") from None
    us = int(round((h * 3600 + m * 60 + sec) * 1_000_000))
    return -us if neg else us


class PlanBuilder:
    def __init__(self, catalog: Catalog, current_db: str = "test") -> None:
        self.catalog = catalog
        self.current_db = current_db
        self._hints: list[tuple[str, list[str]]] = []

    # ==================== SELECT ====================
    def build_select(self, stmt) -> LogicalPlan:
        if isinstance(stmt, ast.SetOpStmt):
            return self._build_set_op(stmt)
        # hint scope is per-SELECT: nested build_select calls (derived
        # tables, subqueries) must neither clobber the outer statement's
        # hints nor leak theirs outward
        prev_hints = self._hints
        self._hints = list(getattr(stmt, "hints", []) or [])
        try:
            return self._build_select_inner(stmt)
        finally:
            self._hints = prev_hints

    def _build_select_inner(self, stmt) -> LogicalPlan:
        if stmt.from_ is None:
            plan = self._build_dual(stmt)
        else:
            plan = self.build_table_refs(stmt.from_)
        # LEADING join-order hint travels on the plan for the reorder rule
        # (reference: hints.go HintLeading -> rule_join_reorder.go)
        for name, args in self._hints:
            if name == "LEADING" and args:
                plan._leading_hint = args  # type: ignore[attr-defined]

        if stmt.where is not None:
            plain, with_subq = [], []
            for c in _ast_conjuncts(stmt.where):
                (with_subq if _contains_subquery(c) else plain).append(c)
            conds: list[PlanExpr] = []
            for c in plain:
                conds.extend(self._split_conjuncts(
                    self.resolve(c, plan.schema)))
            if conds:
                plan = LogicalSelection(conds, plan.schema, [plan])
            for c in with_subq:
                plan = self._apply_subquery_conjunct(c, plan)

        has_agg = bool(stmt.group_by) or any(
            f.expr is not None and _contains_agg(f.expr) for f in stmt.fields
        ) or (stmt.having is not None and _contains_agg(stmt.having))

        if has_agg:
            plan = self._build_aggregate(stmt, plan)
        else:
            if stmt.having is not None:
                raise PlanError("HAVING without aggregation/group-by")
            if any(f.expr is not None and _contains_window(f.expr)
                   for f in stmt.fields):
                if stmt.from_ is None:
                    raise PlanError(
                        "window functions require a FROM clause")
                plan = self._build_windows(stmt, plan)
            plan = self._build_projection(stmt, plan)

        if stmt.distinct:
            plan = self._build_distinct(plan)

        if stmt.order_by:
            plan = self._build_sort(stmt, plan)

        if stmt.limit is not None or stmt.offset:
            limit = stmt.limit if stmt.limit is not None else 2**62
            plan = LogicalLimit(limit, stmt.offset, plan.schema, [plan])
        return plan

    def _build_set_op(self, stmt: ast.SetOpStmt) -> LogicalPlan:
        """Fold UNION [ALL] left to right; DISTINCT steps dedupe everything
        accumulated so far (MySQL cumulative-distinct semantics)."""
        from .logical import LogicalUnion

        plan = self.build_select(stmt.selects[0])
        for sel, is_all in zip(stmt.selects[1:], stmt.alls):
            right = self.build_select(sel)
            if len(right.schema) != len(plan.schema):
                raise PlanError(
                    "The used SELECT statements have a different number "
                    "of columns")
            fields = []
            for lf, rf in zip(plan.schema.fields, right.schema.fields):
                fields.append(ResultField(
                    lf.name, _union_ftype(lf.ftype, rf.ftype)))
            plan = LogicalUnion(PlanSchema(fields), [plan, right])
            if not is_all:
                plan = self._build_distinct(plan)
        if stmt.order_by:
            items = []
            for item in stmt.order_by:
                e = item.expr
                pe = None
                if isinstance(e, ast.Literal) and e.tag == "int":
                    k = int(e.value)
                    if not (1 <= k <= len(plan.schema)):
                        raise PlanError(
                            f"ORDER BY position {k} out of range")
                    pe = Col(k - 1, plan.schema.fields[k - 1].ftype)
                elif isinstance(e, ast.ColumnRef) and e.table is None:
                    idx = plan.schema.resolve(e.name)
                    if idx is not None:
                        pe = Col(idx, plan.schema.fields[idx].ftype, e.name)
                if pe is None:
                    raise PlanError(
                        "UNION ORDER BY must reference output columns")
                items.append((pe, item.desc))
            plan = LogicalSort(items, plan.schema, [plan])
        if stmt.limit is not None or stmt.offset:
            limit = stmt.limit if stmt.limit is not None else 2**62
            plan = LogicalLimit(limit, stmt.offset, plan.schema, [plan])
        return plan

    # ---- FROM -------------------------------------------------------------
    def build_table_refs(self, ref: ast.TableRef) -> LogicalPlan:
        if isinstance(ref, ast.TableName):
            return self._build_scan(ref)
        if isinstance(ref, ast.Join):
            return self._build_join(ref)
        if isinstance(ref, ast.SubqueryTable):
            sub = self.build_select(ref.query)
            alias = (ref.alias or "").lower()
            fields = [
                ResultField(f.name, f.ftype, alias) for f in sub.schema.fields
            ]
            sub.schema = PlanSchema(fields)
            return sub
        raise PlanError(f"unsupported table reference {type(ref).__name__}")

    def _build_scan(self, tn: ast.TableName):
        db = tn.db or self.current_db
        try:
            info = self.catalog.table(db, tn.name)
        except KeyError as e:
            view = self._lookup_view(db, tn.name)
            if view is not None:
                return self._expand_view(db, tn, view)
            raise err_wrap(PlanError, e) from None
        alias = (tn.alias or tn.name).lower()
        fields = [
            ResultField(c.name.lower(), c.ftype, alias, source_offset=c.offset)
            for c in info.columns
        ]
        scan = LogicalScan(info, alias, PlanSchema(fields))
        # USE_INDEX / IGNORE_INDEX hints pin this scan's access path
        # (reference: hints.go HintUseIndex -> access-path filtering,
        # planbuilder.go:933)
        for name, args in self._hints:
            if len(args) >= 1 and args[0] in (alias, tn.name.lower()):
                if name in ("USE_INDEX", "FORCE_INDEX"):
                    scan.hint_use_index = args[1:]  # type: ignore[attr-defined]
                elif name == "IGNORE_INDEX":
                    scan.hint_ignore_index = args[1:]  # type: ignore[attr-defined]
        return scan

    _VIEW_DEPTH_CAP = 16

    def _lookup_view(self, db: str, name: str):
        try:
            schema = self.catalog.schema(db)
        except KeyError:
            return None
        return getattr(schema, "views", {}).get(name.lower())

    def _expand_view(self, db: str, tn: ast.TableName, view) -> LogicalPlan:
        """Inline the view's stored SELECT as a derived table (reference:
        planner/core/logical_plan_builder.go BuildDataSourceFromView —
        the stored text re-parses against the CURRENT schema, so views
        track later DDL on their base tables)."""
        from ..sql.parser import parse_sql as _parse

        depth = getattr(self, "_view_depth", 0)
        if depth >= self._VIEW_DEPTH_CAP:
            raise PlanError(f"view nesting too deep at {view.name}")
        self._view_depth = depth + 1
        try:
            stmts = _parse(view.sql)
            sub = self.build_select(stmts[0])
        except Exception as e:
            if isinstance(e, PlanError):
                raise
            raise PlanError(
                f"view {view.name} is invalid: {e}") from None
        finally:
            self._view_depth = depth
        alias = (tn.alias or tn.name).lower()
        names = list(view.columns) if view.columns else [
            f.name for f in sub.schema.fields]
        if len(names) != len(sub.schema.fields):
            raise PlanError(f"view {view.name} column list mismatch")
        sub.schema = PlanSchema([
            ResultField(n.lower(), f.ftype, alias)
            for n, f in zip(names, sub.schema.fields)])
        return sub

    def _build_join(self, j: ast.Join) -> LogicalPlan:
        left = self.build_table_refs(j.left)
        right = self.build_table_refs(j.right)
        merged = PlanSchema(left.schema.fields + right.schema.fields)
        eq: list[tuple[int, int]] = []
        others: list[PlanExpr] = []
        nleft = len(left.schema)
        if j.using:
            for name in j.using:
                li = left.schema.resolve(name)
                ri = right.schema.resolve(name)
                if li is None or ri is None:
                    raise PlanError(f"USING column {name} not found on both sides")
                eq.append((li, ri))
        elif j.on is not None:
            for cond in self._split_conjuncts(self.resolve(j.on, merged)):
                pair = _as_equi_pair(cond, nleft)
                if pair is not None:
                    eq.append(pair)
                else:
                    others.append(cond)
        kind = j.kind if j.kind != "CROSS" else "INNER"
        if j.kind == "CROSS" and not eq and not others:
            kind = "CROSS"
        return LogicalJoin(kind, eq, others, merged, [left, right])

    # ---- subqueries --------------------------------------------------------
    #
    # The reference rewrites subqueries during logical planning
    # (planner/core/expression_rewriter.go + rule_decorrelate.go). We keep
    # the same playbook, specialized to the decision-support shapes:
    #   EXISTS / NOT EXISTS  -> SEMI / ANTI hash join (correlation becomes
    #                           join keys; non-equality correlation becomes
    #                           residual join conditions)
    #   x IN (sub)           -> SEMI join;  x NOT IN (sub) -> null-aware ANTI
    #   col CMP (corr. agg)  -> group the subquery by its correlation keys,
    #                           INNER join on them, filter CMP (Q2/Q17/Q20)
    #   uncorrelated scalar  -> ScalarSubq, materialized once at execution

    def _apply_subquery_conjunct(
        self, c: ast.Expr, plan: LogicalPlan
    ) -> LogicalPlan:
        neg = False
        node = c
        while isinstance(node, ast.UnaryOp) and node.op == "NOT":
            neg = not neg
            node = node.operand
        if isinstance(node, ast.SubqueryExpr) and node.exists:
            return self._build_exists(node.query, plan,
                                      anti=neg != node.negated)
        if isinstance(node, ast.InSubquery):
            return self._build_in_subquery(node, plan, negate=neg)
        if isinstance(node, ast.BinaryOp) and node.op in (
                "=", "<>", "!=", "<", "<=", ">", ">="):
            for lhs, sub, flip in ((node.left, node.right, False),
                                   (node.right, node.left, True)):
                if isinstance(sub, ast.SubqueryExpr) and not sub.exists \
                        and not _contains_subquery(lhs):
                    op = _flip_cmp(node.op) if flip else node.op
                    out = self._build_scalar_cmp(lhs, op, sub.query, plan)
                    if neg:
                        # NOT (a CMP b): wrap the appended selection
                        sel = out
                        assert isinstance(sel, LogicalSelection)
                        sel.conditions = [
                            bool_call("not", [_coerce_bool(x)])
                            for x in sel.conditions]
                    return out
        # fallback: resolve in place (uncorrelated subqueries become
        # ScalarSubq consts; correlated ones raise)
        conds = self._split_conjuncts(self.resolve(c, plan.schema))
        return LogicalSelection(conds, plan.schema, [plan])

    def _build_sub_source(
        self, sub: ast.SelectStmt, outer: PlanSchema
    ) -> tuple[LogicalPlan, list[tuple[int, int]], list[PlanExpr]]:
        """Build sub's FROM + WHERE with correlation split out.

        Returns (sub plan, eq pairs (outer_idx, sub_idx), residual
        conditions over the concatenated outer++sub schema)."""
        if sub.from_ is None:
            raise PlanError("correlated subquery needs a FROM clause")
        splan = self.build_table_refs(sub.from_)
        local: list[PlanExpr] = []
        eq_pairs: list[tuple[int, int]] = []
        residual: list[PlanExpr] = []
        nouter = len(outer)

        def r_scoped(node: ast.Expr) -> PlanExpr:
            # SQL scoping: the subquery's own tables shadow outer tables;
            # indices land in the concatenated outer++sub space
            if isinstance(node, ast.ColumnRef):
                idx = splan.schema.resolve(node.name, node.table)
                if idx is not None:
                    return Col(nouter + idx, splan.schema.fields[idx].ftype,
                               str(node))
                idx = outer.resolve(node.name, node.table)
                if idx is None:
                    raise PlanError(f"unknown column {node}",
                                    errno=ER_BAD_FIELD)
                return Col(idx, outer.fields[idx].ftype, str(node))
            return self._resolve_composite(node, r_scoped)

        if sub.where is not None:
            for conj in _ast_conjuncts(sub.where):
                if _contains_subquery(conj):
                    # nested subquery inside a correlated one: only the
                    # uncorrelated form is supported (resolved in place)
                    splan = self._apply_subquery_conjunct(conj, splan)
                    continue
                try:
                    local.extend(self._split_conjuncts(
                        self.resolve(conj, splan.schema)))
                    continue
                except PlanError:
                    pass
                e = r_scoped(conj)  # raises if truly unknown
                pair = _as_equi_pair(e, nouter)
                if pair is not None:
                    eq_pairs.append(pair)
                else:
                    residual.append(e)
        if local:
            splan = LogicalSelection(local, splan.schema, [splan])
        return splan, eq_pairs, residual

    def _build_exists(
        self, sub: ast.SelectStmt, plan: LogicalPlan, anti: bool
    ) -> LogicalPlan:
        # EXISTS truth depends only on row existence in FROM+WHERE.
        # LIMIT k>=1 does not change existence — drop it (the common
        # EXISTS(... LIMIT 1) idiom); LIMIT 0 yields no rows, so EXISTS
        # is constant FALSE. An UNgrouped aggregate always yields exactly
        # one row, so EXISTS is constant TRUE (reference:
        # rule_decorrelate.go handles these as trivial cases).
        if sub.limit == 0:
            const = Const(1 if anti else 0, FieldType(TypeKind.BOOLEAN))
            return LogicalSelection([const], plan.schema, [plan])
        if sub.limit is not None and sub.limit >= 1 and not sub.offset:
            import dataclasses
            sub = dataclasses.replace(sub, limit=None)
        has_agg = any(f.expr is not None and _contains_agg(f.expr)
                      for f in sub.fields)
        if has_agg and not sub.group_by and sub.having is None and \
                sub.limit is None and not sub.offset:
            # still VALIDATE the subquery (names, correlation) before
            # constant-folding it away
            splan, _eq, _res = self._build_sub_source(sub, plan.schema)
            comb = PlanSchema(plan.schema.fields + splan.schema.fields)
            try:
                for f in sub.fields:
                    if f.expr is None:
                        continue
                    for call in _find_aggs(f.expr):
                        if call.args and not call.is_star:
                            # inner scope shadows outer (SQL resolution)
                            try:
                                self.resolve(call.args[0], splan.schema)
                            except (PlanError, KeyError):
                                self.resolve(call.args[0], comb)
            except KeyError as e:
                raise err_wrap(PlanError, e) from None
            const = Const(0 if anti else 1, FieldType(TypeKind.BOOLEAN))
            return LogicalSelection([const], plan.schema, [plan])
        if sub.group_by or sub.having or sub.limit is not None or \
                sub.offset or has_agg:
            raise PlanError("EXISTS subquery with aggregation/HAVING/"
                            "LIMIT/OFFSET is not supported")
        splan, eq_pairs, residual = self._build_sub_source(sub, plan.schema)
        # remap residuals: outer indices stay, sub indices shift to
        # len(plan.schema) .. (they were resolved over outer++sub already)
        kind = "ANTI" if anti else "SEMI"
        return LogicalJoin(kind, eq_pairs, residual, plan.schema,
                           [plan, splan])

    def _build_in_subquery(
        self, node: ast.InSubquery, plan: LogicalPlan, negate: bool
    ) -> LogicalPlan:
        lhs = self.resolve(node.operand, plan.schema)
        if not isinstance(lhs, Col):
            raise PlanError("IN (subquery) requires a column operand")
        anti = negate != node.negated
        try:
            sub = self.build_select(node.query)
        except PlanError as e:
            # correlated IN: the subquery references outer columns —
            # recognizable as an unresolved-column error. Anything else
            # is a genuine error; re-raise it undisguised.
            # x IN (SELECT y FROM ... WHERE corr) decorrelates to a SEMI
            # join carrying both the correlation and the x = y equality
            # (reference: rule_decorrelate.go pulls the correlated
            # conditions into the semi join). NOT IN needs null-aware
            # anti semantics; with a correlated body we support it only
            # when both compared columns are non-nullable.
            if "unknown column" not in str(e).lower():
                raise
            return self._build_corr_in(node, plan, lhs, anti)
        if len(sub.schema) != 1:
            raise PlanError("IN subquery must return exactly one column")
        kind = "ANTI_NULL" if anti else "SEMI"
        return LogicalJoin(kind, [(lhs.idx, 0)], [], plan.schema,
                           [plan, sub])

    def _build_corr_in(self, node: ast.InSubquery, plan: LogicalPlan,
                       lhs: Col, anti: bool) -> LogicalPlan:
        sub = node.query
        if sub.group_by or sub.having or sub.limit is not None or \
                len(sub.fields) != 1 or sub.fields[0].expr is None or \
                _contains_agg(sub.fields[0].expr):
            raise PlanError("correlated IN subquery must be a bare "
                            "single-column SELECT")
        splan, eq_pairs, residual = self._build_sub_source(
            sub, plan.schema)
        # inner scope shadows outer for the selected column (SQL name
        # resolution); fall back to the combined space for qualified refs
        try:
            rhs_local = self.resolve(sub.fields[0].expr, splan.schema)
            rhs = Col(rhs_local.idx + len(plan.schema),
                      rhs_local.ftype) \
                if isinstance(rhs_local, Col) else None
        except (PlanError, KeyError):
            rhs = None
        if rhs is None:
            try:
                rhs = self.resolve(
                    sub.fields[0].expr,
                    PlanSchema(plan.schema.fields + splan.schema.fields))
            except KeyError as e:
                raise err_wrap(PlanError, e) from None
        if not isinstance(rhs, Col) or rhs.idx < len(plan.schema):
            raise PlanError("correlated IN subquery selects a non-column")
        if anti and (lhs.ftype.nullable or rhs.ftype.nullable):
            raise PlanError(
                "correlated NOT IN over nullable columns is not "
                "supported (null-aware anti join)")
        kind = "ANTI" if anti else "SEMI"
        eq_pairs = list(eq_pairs) + [(lhs.idx,
                                      rhs.idx - len(plan.schema))]
        return LogicalJoin(kind, eq_pairs, residual, plan.schema,
                           [plan, splan])

    def _build_scalar_cmp(
        self, lhs_ast: ast.Expr, op: str, sub: ast.SelectStmt,
        plan: LogicalPlan
    ) -> LogicalPlan:
        """col CMP (SELECT agg ... WHERE inner.k = outer.k ...) — the
        correlated-aggregate pattern (Q2/Q17/Q20)."""
        try:
            # uncorrelated scalar subquery: plain selection w/ ScalarSubq
            cond = self.resolve(
                ast.BinaryOp(op, lhs_ast, ast.SubqueryExpr(sub)), plan.schema)
            return LogicalSelection(self._split_conjuncts(cond), plan.schema,
                                    [plan])
        except PlanError:
            pass
        splan, eq_pairs, residual = self._build_sub_source(sub, plan.schema)
        if residual:
            raise PlanError(
                "correlated scalar subquery supports only equality "
                "correlation")
        if not eq_pairs:
            raise PlanError("correlated scalar subquery: no correlation "
                            "keys found")
        if len(sub.fields) != 1 or sub.fields[0].expr is None:
            raise PlanError("scalar subquery must select exactly one "
                            "expression")
        if sub.group_by or sub.having or sub.order_by or sub.limit:
            raise PlanError("correlated scalar subquery must be a bare "
                            "aggregate")
        nouter = len(plan.schema)
        # group the subquery by its correlation columns (sub-relative idx)
        group_cols = [Col(s, splan.schema.fields[s].ftype)
                      for _, s in eq_pairs]
        field_expr = sub.fields[0].expr
        aggs: list[AggDesc] = []
        agg_keys: dict[str, int] = {}
        for call in _find_aggs(field_expr):
            key = ast_key(call)
            if key in agg_keys:
                continue
            func = call.name.lower()
            if func not in ("sum", "min", "max", "avg", "count"):
                raise PlanError(f"unsupported aggregate {func} in "
                                "correlated subquery")
            arg = None if call.is_star else self.resolve(
                call.args[0], splan.schema)
            agg_keys[key] = len(aggs)
            aggs.append(AggDesc(func, arg, agg_result_type(func, arg),
                                call.distinct, name=key))
        if not aggs:
            raise PlanError("correlated scalar subquery must aggregate")
        ngroup = len(group_cols)
        agg_fields = [ResultField(f"#corr_k{i}", g.ftype, "#subq")
                      for i, g in enumerate(group_cols)]
        agg_fields += [ResultField(f"#corr_a{i}", d.ftype, "#subq")
                       for i, d in enumerate(aggs)]
        agg_plan = LogicalAggregation(
            list(group_cols), aggs, PlanSchema(agg_fields), [splan])

        # scalar-of-aggregate expression over the agg schema (e.g. 0.2*avg)
        def r_over(e: ast.Expr) -> PlanExpr:
            key = ast_key(e)
            if key in agg_keys:
                i = ngroup + agg_keys[key]
                return Col(i, agg_plan.schema.fields[i].ftype)
            if isinstance(e, ast.ColumnRef):
                raise PlanError(
                    f"column {e} not allowed in correlated scalar subquery")
            return self._resolve_composite(e, r_over)

        value = r_over(field_expr)
        proj_fields = [ResultField(f"#corr_k{i}", g.ftype, "#subq")
                       for i, g in enumerate(group_cols)]
        proj_fields.append(ResultField("#corr_v", value.ftype, "#subq"))
        proj = LogicalProjection(
            [Col(i, g.ftype) for i, g in enumerate(group_cols)] + [value],
            PlanSchema(proj_fields), [agg_plan])

        # LEFT join outer plan to the grouped subquery on correlation keys:
        # an outer row with no group sees NULL (scalar subquery over an
        # empty set), except COUNT which must see 0 (hence the ifnull)
        join_schema = PlanSchema(plan.schema.fields + proj_fields)
        join = LogicalJoin(
            "LEFT", [(o, i) for i, (o, _) in enumerate(eq_pairs)], [],
            join_schema, [plan, proj])
        lhs = self.resolve(lhs_ast, plan.schema)  # outer indices unchanged
        vcol: PlanExpr = Col(nouter + ngroup, value.ftype, "#corr_v")
        if isinstance(field_expr, ast.FuncCall) and \
                field_expr.name.upper() == "COUNT":
            vcol = Call("ifnull", [vcol, Const(0, vcol.ftype)], vcol.ftype)
        tag = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
               ">": "gt", ">=": "ge"}[op]
        cond = self._resolve_cmp(tag, lhs, vcol)
        return LogicalSelection([cond], join_schema, [join])

    def _build_dual(self, stmt: ast.SelectStmt) -> LogicalPlan:
        """SELECT without FROM: a one-row, zero-column pseudo scan."""
        return LogicalScan(
            TableInfo(id=-1, name="dual", columns=[]), "dual", PlanSchema([])
        )

    # ---- projection / aggregation -----------------------------------------
    def _expand_fields(
        self, stmt: ast.SelectStmt, child_schema: PlanSchema
    ) -> list[tuple[ast.Expr, Optional[str]]]:
        """Expand wildcards into (expr, alias) pairs."""
        out: list[tuple[ast.Expr, Optional[str]]] = []
        for f in stmt.fields:
            if f.expr is not None:
                out.append((f.expr, f.alias))
                continue
            for rf in child_schema.fields:
                if f.wildcard_table and rf.table_alias != f.wildcard_table.lower():
                    continue
                if rf.name.startswith("#"):
                    continue  # hidden columns from subquery decorrelation
                out.append((ast.ColumnRef(rf.name, table=rf.table_alias or None),
                            None))
            if not out:
                raise PlanError("wildcard expanded to no columns")
        return out

    _WINDOW_ONLY = {"ROW_NUMBER", "RANK", "DENSE_RANK", "LEAD", "LAG",
                    "FIRST_VALUE", "LAST_VALUE", "NTH_VALUE", "NTILE",
                    "PERCENT_RANK", "CUME_DIST"}

    def _build_windows(self, stmt: ast.SelectStmt,
                       child: LogicalPlan) -> LogicalPlan:
        """Plan window computations between the row source and the final
        projection (reference: planner/core buildWindowFunctions;
        executor/window.go). Each distinct windowed call appends one
        "__win#i" column; the select fields are rewritten to reference it.
        Default frames only."""
        from .logical import LogicalWindow, WindowItem

        schema = child.schema
        items: list[WindowItem] = []
        keys: dict[str, int] = {}
        for f in stmt.fields:
            if f.expr is None:
                continue
            for call in _find_windows(f.expr):
                k = ast_key(call)
                if k in keys:
                    continue
                name = call.name
                args = [self.resolve(a, schema) for a in call.args]
                if name in ("ROW_NUMBER", "RANK", "DENSE_RANK"):
                    if args:
                        raise PlanError(f"{name}() takes no arguments")
                    ftype = FieldType(TypeKind.BIGINT, nullable=False)
                elif name in ("LEAD", "LAG"):
                    if not 1 <= len(args) <= 3:
                        raise PlanError(f"{name} takes 1-3 arguments")
                    if args[0].ftype.is_string and \
                            not isinstance(args[0], Col):
                        raise PlanError(
                            f"{name} over computed strings unsupported")
                    ftype = FieldType(args[0].ftype.kind,
                                      flen=args[0].ftype.flen,
                                      scale=args[0].ftype.scale)
                elif name in ("FIRST_VALUE", "LAST_VALUE", "NTH_VALUE"):
                    want = 2 if name == "NTH_VALUE" else 1
                    if len(args) != want:
                        raise PlanError(f"{name} takes {want} argument(s)")
                    if args[0].ftype.is_string and \
                            not isinstance(args[0], Col):
                        raise PlanError(
                            f"{name} over computed strings unsupported")
                    ftype = FieldType(args[0].ftype.kind,
                                      flen=args[0].ftype.flen,
                                      scale=args[0].ftype.scale)
                elif name == "NTILE":
                    if len(args) != 1:
                        raise PlanError("NTILE takes one argument")
                    ftype = FieldType(TypeKind.BIGINT)
                elif name in ("PERCENT_RANK", "CUME_DIST"):
                    if args:
                        raise PlanError(f"{name}() takes no arguments")
                    ftype = FieldType(TypeKind.DOUBLE, nullable=False)
                elif name.upper() in _AGG_NAMES:
                    if call.distinct:
                        # MySQL: DISTINCT is not allowed in window aggs
                        raise PlanError(
                            f"DISTINCT in window aggregate {name}")
                    if call.is_star:
                        args = []
                    elif len(args) != 1:
                        raise PlanError(f"{name} takes one argument")
                    if args and args[0].ftype.is_string and \
                            name.upper() != "COUNT":
                        raise PlanError(
                            f"window {name} over strings unsupported")
                    ftype = agg_result_type(
                        name.lower(), args[0] if args else None)
                else:
                    raise PlanError(f"unsupported window function {name}")
                spec = call.window
                part = [self.resolve(e, schema)
                        for e in spec.partition_by]
                order = [(self.resolve(it.expr, schema), it.desc)
                         for it in spec.order_by]
                frame = spec.frame
                if frame is not None:
                    # MySQL semantics: ranking funcs ignore the frame
                    if name in ("ROW_NUMBER", "RANK", "DENSE_RANK",
                                "NTILE", "PERCENT_RANK", "CUME_DIST",
                                "LEAD", "LAG"):
                        frame = None
                    elif frame.unit == "RANGE" and (
                            frame.start_value is not None
                            or frame.end_value is not None):
                        # value-offset RANGE needs exactly one numeric
                        # ORDER BY key (reference: MySQL 3593 checks)
                        if len(order) != 1 or order[0][0].ftype.is_string:
                            raise PlanError(
                                "RANGE frame with offset requires a "
                                "single numeric ORDER BY expression")
                keys[k] = len(items)
                items.append(WindowItem(name, args, part, order, ftype,
                                        frame))
        if not items:
            return child
        fields = list(schema.fields) + [
            ResultField(f"__win#{i}", it.ftype)
            for i, it in enumerate(items)
        ]
        wplan = LogicalWindow(items, PlanSchema(fields), [child])
        # rewrite the select fields: windowed calls -> __win#i refs
        wmap = {k: ast.ColumnRef(f"__win#{i}") for k, i in keys.items()}
        stmt.fields = [
            ast.SelectField(
                None if f.expr is None else _replace_windows(f.expr, wmap),
                f.alias, f.wildcard_table)
            for f in stmt.fields
        ]
        return wplan

    def _build_projection(
        self, stmt: ast.SelectStmt, child: LogicalPlan
    ) -> LogicalProjection:
        pairs = self._expand_fields(stmt, child.schema)
        exprs: list[PlanExpr] = []
        fields: list[ResultField] = []
        for e, alias in pairs:
            pe = self.resolve(e, child.schema)
            exprs.append(pe)
            fields.append(ResultField(_output_name(e, alias), pe.ftype))
        return LogicalProjection(exprs, PlanSchema(fields), [child])

    def _build_aggregate(
        self, stmt: ast.SelectStmt, child: LogicalPlan
    ) -> LogicalPlan:
        child_schema = child.schema
        # 1. resolve group-by expressions (positional ints and aliases allowed)
        pairs = self._expand_fields(stmt, child_schema)
        group_ast: list[ast.Expr] = []
        for g in stmt.group_by:
            if isinstance(g, ast.Literal) and g.tag == "int":
                k = int(g.value)
                if not (1 <= k <= len(pairs)):
                    raise PlanError(f"GROUP BY position {k} out of range")
                group_ast.append(pairs[k - 1][0])
            elif isinstance(g, ast.ColumnRef) and g.table is None and any(
                alias and alias.lower() == g.name.lower() for _, alias in pairs
            ):
                idx = next(i for i, (_, a) in enumerate(pairs)
                           if a and a.lower() == g.name.lower())
                group_ast.append(pairs[idx][0])
            else:
                group_ast.append(g)
        group_exprs = [self.resolve(g, child_schema) for g in group_ast]
        group_keys = [ast_key(g) for g in group_ast]

        # 2. collect aggregate descriptors across select/having/order exprs
        aggs: list[AggDesc] = []
        agg_keys: dict[str, int] = {}

        def collect(e: ast.Expr) -> None:
            for call in _find_aggs(e):
                key = ast_key(call)
                if key in agg_keys:
                    continue
                func = call.name.lower()
                params: tuple = ()
                if func == "json_objectagg" and len(call.args) != 2:
                    raise PlanError(
                        "Incorrect parameter count in the call to "
                        "native function 'json_objectagg'")
                if call.is_star:
                    arg = None
                elif func != "json_objectagg" and len(call.args) == 1:
                    arg = self.resolve(call.args[0], child_schema)
                elif func == "json_objectagg" and len(call.args) == 2:
                    # two-arg aggregate: pack (key, value) as a synthetic
                    # Call so pruning/remap walk both expressions; the
                    # engine evaluates the parts, never the call itself
                    k = self.resolve(call.args[0], child_schema)
                    v = self.resolve(call.args[1], child_schema)
                    arg = Call("json_kv", [k, v],
                               FieldType(TypeKind.JSON))
                elif func == "approx_percentile" and len(call.args) == 2:
                    # APPROX_PERCENTILE(expr, percent): percent must be a
                    # constant 1..100 (reference: builder.go:110)
                    arg = self.resolve(call.args[0], child_schema)
                    if arg.ftype.is_string:
                        raise PlanError(
                            "APPROX_PERCENTILE requires a numeric or "
                            "temporal argument")
                    p = self.resolve(call.args[1], child_schema)
                    if not isinstance(p, Const):
                        raise PlanError(
                            "APPROX_PERCENTILE percent must be constant")
                    try:
                        pv = float(p.value)
                    except (TypeError, ValueError):
                        raise PlanError(
                            "Percentage value 0-100 required") from None
                    if not 0 < pv <= 100:
                        raise PlanError(
                            "Percentage value 0-100 required")
                    params = (pv,)
                else:
                    raise PlanError(f"{call.name} takes one argument")
                if func != "count" and arg is None:
                    raise PlanError(f"{call.name}(*) is not valid")
                desc = AggDesc(func, arg, agg_result_type(func, arg),
                               call.distinct, name=key, params=params)
                agg_keys[key] = len(aggs)
                aggs.append(desc)

        for e, _ in pairs:
            collect(e)
        if stmt.having is not None:
            collect(stmt.having)
        for item in stmt.order_by:
            collect(item.expr)
        if not aggs and not group_exprs:
            raise PlanError("aggregation without aggregates or group by")

        # 3. agg node schema: [group cols..., agg results...]
        agg_fields = []
        for i, (g, ga) in enumerate(zip(group_exprs, group_ast)):
            name = ga.name.lower() if isinstance(ga, ast.ColumnRef) else f"group#{i}"
            tbl = (ga.table or "").lower() if isinstance(ga, ast.ColumnRef) else ""
            agg_fields.append(ResultField(name, g.ftype, tbl))
        for i, d in enumerate(aggs):
            agg_fields.append(ResultField(f"agg#{i}", d.ftype))
        agg_plan = LogicalAggregation(
            group_exprs, aggs, PlanSchema(agg_fields), [child]
        )

        # 4. projection over agg output: replace agg calls / group exprs
        ngroups = len(group_exprs)

        def resolve_over_agg(e: ast.Expr) -> PlanExpr:
            key = ast_key(e)
            if key in agg_keys:
                i = ngroups + agg_keys[key]
                return Col(i, agg_plan.schema.fields[i].ftype,
                           repr(aggs[agg_keys[key]]))
            for gi, gkey in enumerate(group_keys):
                if key == gkey:
                    return Col(gi, group_exprs[gi].ftype,
                               agg_plan.schema.fields[gi].name)
            if isinstance(e, ast.ColumnRef):
                idx = agg_plan.schema.resolve(e.name, e.table)
                if idx is not None and idx < ngroups:
                    return Col(idx, agg_plan.schema.fields[idx].ftype, e.name)
                if e.table is None:
                    # select-field alias (MySQL allows these in HAVING/ORDER)
                    for fe, alias in pairs:
                        if alias and alias.lower() == e.name.lower():
                            return resolve_over_agg(fe)
                raise PlanError(
                    f"column {e} must appear in GROUP BY or an aggregate"
                )
            return self._resolve_composite(e, resolve_over_agg)

        exprs = []
        fields = []
        for e, alias in pairs:
            pe = resolve_over_agg(e)
            exprs.append(pe)
            fields.append(ResultField(_output_name(e, alias), pe.ftype))
        plan: LogicalPlan = LogicalProjection(exprs, PlanSchema(fields), [agg_plan])

        # 5. HAVING: filter between agg and projection (resolved in agg scope)
        if stmt.having is not None:
            cond = resolve_over_agg(stmt.having)
            # insert selection under the projection
            sel = LogicalSelection(
                self._split_conjuncts(cond), agg_plan.schema, [agg_plan]
            )
            plan.children[0] = sel
        # stash for order-by resolution
        plan._agg_resolver = resolve_over_agg  # type: ignore[attr-defined]
        return plan

    def _build_distinct(self, child: LogicalPlan) -> LogicalPlan:
        """DISTINCT = group by every output column (reference lowers it the
        same way, planner/core/logical_plan_builder.go buildDistinct)."""
        group = [
            Col(i, f.ftype, f.name) for i, f in enumerate(child.schema.fields)
        ]
        return LogicalAggregation(group, [], child.schema, [child])

    def _build_sort(self, stmt: ast.SelectStmt, plan: LogicalPlan) -> LogicalPlan:
        out_schema = plan.schema
        resolver: Optional[Callable] = getattr(plan, "_agg_resolver", None)
        proj = plan if isinstance(plan, LogicalProjection) else None
        items: list[tuple[PlanExpr, bool]] = []
        hidden: list[PlanExpr] = []  # appended projection cols for sort-only refs
        for item in stmt.order_by:
            e = item.expr
            pe: Optional[PlanExpr] = None
            if isinstance(e, ast.Literal) and e.tag == "int":
                k = int(e.value)
                if not (1 <= k <= len(out_schema)):
                    raise PlanError(f"ORDER BY position {k} out of range")
                pe = Col(k - 1, out_schema.fields[k - 1].ftype)
            elif isinstance(e, ast.ColumnRef) and e.table is None:
                idx = out_schema.resolve(e.name)
                if idx is not None:
                    pe = Col(idx, out_schema.fields[idx].ftype, e.name)
            if pe is None and proj is not None:
                # match select expressions structurally
                key = ast_key(e)
                pairs = self._expand_fields(stmt, proj.children[0].schema) \
                    if resolver is None else None
                if pairs is not None:
                    for i, (fe, _) in enumerate(pairs):
                        if ast_key(fe) == key:
                            pe = Col(i, out_schema.fields[i].ftype)
                            break
            if pe is None:
                if resolver is not None:
                    under = resolver(e)
                    # add as hidden projection column
                    assert proj is not None
                    proj.exprs.append(under)
                    hid_idx = len(proj.schema.fields)
                    proj.schema.fields.append(
                        ResultField(f"__sort#{len(hidden)}", under.ftype)
                    )
                    pe = Col(hid_idx, under.ftype)
                    hidden.append(under)
                elif proj is not None:
                    under = self.resolve(e, proj.children[0].schema)
                    proj.exprs.append(under)
                    hid_idx = len(proj.schema.fields)
                    proj.schema.fields.append(
                        ResultField(f"__sort#{len(hidden)}", under.ftype)
                    )
                    pe = Col(hid_idx, under.ftype)
                    hidden.append(under)
                else:
                    pe = self.resolve(e, out_schema)
            items.append((pe, item.desc))
        sort = LogicalSort(items, plan.schema, [plan])
        if hidden:
            # visible width shrinks back after sort via a trimming projection
            vis = len(plan.schema.fields) - len(hidden)
            exprs = [Col(i, plan.schema.fields[i].ftype) for i in range(vis)]
            trim_schema = PlanSchema(plan.schema.fields[:vis])
            return LogicalProjection(exprs, trim_schema, [sort])
        return sort

    # ==================== expression resolution ====================
    def resolve(self, e: ast.Expr, schema: PlanSchema) -> PlanExpr:
        def r(node: ast.Expr) -> PlanExpr:
            if isinstance(node, ast.ColumnRef):
                idx = schema.resolve(node.name, node.table)
                if idx is None:
                    raise PlanError(f"unknown column {node}",
                                    errno=ER_BAD_FIELD)
                return Col(idx, schema.fields[idx].ftype, str(node))
            return self._resolve_composite(node, r)

        return r(e)

    def _resolve_composite(
        self, node: ast.Expr, r: Callable[[ast.Expr], PlanExpr]
    ) -> PlanExpr:
        """Resolve every non-ColumnRef node, delegating children to r."""
        if isinstance(node, ast.Literal):
            return _literal_const(node)
        if isinstance(node, ast.BinaryOp):
            return self._resolve_binary(node, r)
        if isinstance(node, ast.UnaryOp):
            if node.op == "NOT":
                arg = _coerce_bool(r(node.operand))
                return bool_call("not", [arg])
            arg = r(node.operand)
            if not is_numeric(arg.ftype):
                raise PlanError(f"unary - over {arg.ftype!r}")
            return _fold(Call("neg", [arg], arg.ftype))
        if isinstance(node, ast.IsNull):
            arg = r(node.operand)
            out = bool_call("isnull", [arg])
            return bool_call("not", [out]) if node.negated else out
        if isinstance(node, ast.Between):
            lo = self._resolve_cmp("ge", r(node.operand), r(node.low))
            hi = self._resolve_cmp("le", r(node.operand), r(node.high))
            out = bool_call("and", [lo, hi])
            return bool_call("not", [out]) if node.negated else out
        if isinstance(node, ast.InList):
            arg = r(node.operand)
            items = [r(i) for i in node.items]
            if not all(isinstance(i, Const) for i in items):
                # general IN lowers to OR of equalities
                out: PlanExpr = self._resolve_cmp("eq", arg, items[0])
                for it in items[1:]:
                    out = bool_call("or", [out, self._resolve_cmp("eq", arg, it)])
            else:
                consts = [self._coerce_const(c, arg.ftype) for c in items]
                if arg.ftype.is_decimal:
                    # values whose scale exceeds the column's can never
                    # equal a stored value — drop them (exact semantics)
                    consts = [
                        c for c in consts
                        if not (c.ftype.is_decimal
                                and c.ftype.scale > arg.ftype.scale)
                    ]  # empty list => never matches (both evaluators)
                out = bool_call("in_values", [arg],
                                extra=[c.value for c in consts])
            return bool_call("not", [out]) if node.negated else out
        if isinstance(node, ast.Like):
            arg = r(node.operand)
            if not arg.ftype.is_string:
                raise PlanError("LIKE requires a string operand")
            pat = r(node.pattern)
            if not isinstance(pat, Const):
                raise PlanError("LIKE pattern must be a constant")
            out = bool_call("like", [arg], extra=str(pat.value))
            return bool_call("not", [out]) if node.negated else out
        if isinstance(node, ast.FuncCall):
            if node.name in _AGG_NAMES:
                raise PlanError(f"aggregate {node.name} not allowed here")
            return self._resolve_scalar_func(node, r)
        if isinstance(node, ast.Case):
            return self._resolve_case(node, r)
        if isinstance(node, ast.Cast):
            arg = r(node.operand)
            return _fold(Call("cast", [arg], node.target))
        if isinstance(node, ast.IntervalExpr):
            raise PlanError("INTERVAL only valid in +/- date arithmetic")
        if isinstance(node, ast.SubqueryExpr):
            if node.exists:
                raise PlanError("EXISTS is only valid as a WHERE condition")
            sub = self.build_select(node.query)  # raises if correlated
            if len(sub.schema) != 1:
                raise PlanError("scalar subquery must return one column")
            return ScalarSubq(sub, sub.schema.fields[0].ftype)
        if isinstance(node, ast.InSubquery):
            raise PlanError("IN (subquery) is only valid as a WHERE "
                            "condition")
        raise PlanError(f"unsupported expression {type(node).__name__}")

    def _resolve_binary(
        self, node: ast.BinaryOp, r: Callable[[ast.Expr], PlanExpr]
    ) -> PlanExpr:
        op = node.op
        if op in ("AND", "OR"):
            left = _coerce_bool(r(node.left))
            right = _coerce_bool(r(node.right))
            return _fold(bool_call(op.lower(), [left, right]))
        if op in ("XOR",):
            left = _coerce_bool(r(node.left))
            right = _coerce_bool(r(node.right))
            return _fold(bool_call("ne", [left, right]))
        if op in _CMP_OPS:
            return self._resolve_cmp(_CMP_OPS[op], r(node.left), r(node.right))
        if op in _ARITH_OPS:
            # interval arithmetic on dates
            if isinstance(node.right, ast.IntervalExpr) and op in ("+", "-"):
                return self._resolve_date_arith(r(node.left), node.right, op, r)
            if isinstance(node.left, ast.IntervalExpr) and op == "+":
                return self._resolve_date_arith(r(node.right), node.left, op, r)
            a, b = r(node.left), r(node.right)
            tag = _ARITH_OPS[op]
            try:
                ftype = arith_result_type(tag, a.ftype, b.ftype)
            except ExprError as e:
                raise err_wrap(PlanError, e) from None
            return _fold(Call(tag, [a, b], ftype))
        raise PlanError(f"unsupported operator {op}")

    def _resolve_cmp(self, tag: str, a: PlanExpr, b: PlanExpr) -> PlanExpr:
        # constant-side coercion: string consts vs temporal/decimal columns
        if isinstance(b, Const) and not isinstance(a, Const):
            b = self._coerce_const(b, a.ftype)
        elif isinstance(a, Const) and not isinstance(b, Const):
            a = self._coerce_const(a, b.ftype)
            a, b = b, a
            tag = _CMP_SWAP[tag]
        if not comparable(a.ftype, b.ftype):
            raise PlanError(f"incomparable types {a.ftype!r} vs {b.ftype!r}")
        return _fold(bool_call(tag, [a, b]))

    def _coerce_const(self, c: Const, target: FieldType) -> Const:
        """Fold a literal into the physical domain of the other operand."""
        if c.value is None:
            return Const(None, target)
        if target.kind == TypeKind.JSON and c.ftype.is_string:
            # stored JSON is normalized; normalize the literal the same
            # way or equality on the just-inserted spelling never matches
            import json as _json
            try:
                return Const(_json.dumps(_json.loads(str(c.value)),
                                         sort_keys=True,
                                         separators=(", ", ": ")), target)
            except ValueError:
                return c  # non-JSON literal: compare as plain text
        if target.kind == TypeKind.SET and c.ftype.is_string:
            # 'a,b' literal -> element bitmask for SET-column compares
            from ..chunk.column import _encode_scalar
            try:
                return Const(_encode_scalar(target, str(c.value), None),
                             target)
            except ValueError:
                return Const(-1, target)  # unknown elems: never equal
        if target.kind == TypeKind.DATE and c.ftype.is_string:
            return Const(parse_date(str(c.value)), target)
        if target.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP) and \
                c.ftype.is_string:
            return Const(parse_datetime(str(c.value)), target)
        if target.is_decimal and c.ftype.is_integer:
            return Const(int(c.value) * target.decimal_multiplier, target)
        if target.is_decimal and c.ftype.is_decimal:
            if c.ftype.scale <= target.scale:
                # exact widening into the column's scale (required for
                # IN-lists, which compare raw unscaled values)
                mult = 10 ** (target.scale - c.ftype.scale)
                return Const(int(c.value) * mult, target)
            div = 10 ** (c.ftype.scale - target.scale)
            if int(c.value) % div == 0:
                return Const(int(c.value) // div, target)  # e.g. 3.250 @ s2
            return c  # not representable at the column scale
        if target.is_float and (c.ftype.is_integer or c.ftype.is_decimal):
            v = c.value
            if c.ftype.is_decimal:
                v = Decimal(v, c.ftype.scale).to_float()
            return Const(float(v), target)
        if target.is_integer and c.ftype.is_decimal:
            return c  # numeric compare handles mixed scale
        return c

    def _resolve_date_arith(
        self,
        date_expr: PlanExpr,
        interval: ast.IntervalExpr,
        op: str,
        r: Callable[[ast.Expr], PlanExpr],
    ) -> PlanExpr:
        if date_expr.ftype.is_string and isinstance(date_expr, Const):
            date_expr = Const(parse_date(str(date_expr.value)),
                              FieldType(TypeKind.DATE))
        if date_expr.ftype.kind != TypeKind.DATE:
            raise PlanError("interval arithmetic supports DATE operands")
        amount = r(interval.value)
        if not isinstance(amount, Const):
            raise PlanError("INTERVAL amount must be constant")
        n = int(amount.value) if not amount.ftype.is_string else int(
            str(amount.value))
        if op == "-":
            n = -n
        unit = interval.unit
        if unit in ("DAY", "WEEK"):
            days = n * (7 if unit == "WEEK" else 1)
            if isinstance(date_expr, Const):
                return Const(int(date_expr.value) + days, date_expr.ftype)
            return Call("date_add_days", [date_expr], date_expr.ftype,
                        extra=days)
        if unit in ("MONTH", "QUARTER", "YEAR"):
            months = n * {"MONTH": 1, "QUARTER": 3, "YEAR": 12}[unit]
            if isinstance(date_expr, Const):
                d = decode_date(int(date_expr.value))
                return Const(encode_date(_add_months(d, months)),
                             date_expr.ftype)
            raise PlanError("month/year interval over columns not supported yet")
        raise PlanError(f"unsupported interval unit {unit}")

    def _resolve_scalar_func(
        self, node: ast.FuncCall, r: Callable[[ast.Expr], PlanExpr]
    ) -> PlanExpr:
        name = node.name
        args = [r(a) for a in node.args]

        def need(n: int) -> None:
            if len(args) != n:
                raise PlanError(f"{name} expects {n} argument(s)")

        if name in ("YEAR", "MONTH", "DAY", "DAYOFMONTH"):
            need(1)
            if not args[0].ftype.is_temporal:
                raise PlanError(f"{name} requires a temporal argument")
            tag = {"YEAR": "year", "MONTH": "month", "DAY": "day",
                   "DAYOFMONTH": "day"}[name]
            return _fold(Call(tag, args, FieldType(TypeKind.BIGINT)))
        if name == "ABS":
            need(1)
            return _fold(Call("abs", args, args[0].ftype))
        if name == "IF":
            need(3)
            cond = _coerce_bool(args[0])
            ft = _unify_types(args[1].ftype, args[2].ftype)
            return _fold(Call("if", [cond, args[1], args[2]], ft))
        if name == "IFNULL":
            need(2)
            ft = _unify_types(args[0].ftype, args[1].ftype)
            return _fold(Call("ifnull", args, ft))
        if name == "COALESCE":
            if not args:
                raise PlanError("COALESCE needs arguments")
            ft = args[0].ftype
            for a in args[1:]:
                ft = _unify_types(ft, a.ftype)
            return _fold(Call("coalesce", args, ft))
        if name == "SUBSTRING":
            if len(args) not in (2, 3):
                raise PlanError("SUBSTRING expects 2 or 3 arguments")
            if not args[0].ftype.is_string:
                raise PlanError("SUBSTRING requires a string argument")
            for a in args[1:]:
                if not isinstance(a, Const):
                    raise PlanError("SUBSTRING position/length must be "
                                    "constant")
            start = int(args[1].value)
            length = int(args[2].value) if len(args) == 3 else None
            from ..types.field_type import varchar_type
            return Call("substring", [args[0]], varchar_type(),
                        extra=(start, length))
        # ---- JSON function family (host-evaluated; reference:
        # types/json/binary.go + expression/builtin_json.go) ----------
        from ..types.field_type import varchar_type as _vt
        if name == "JSON_EXTRACT":
            if len(args) != 2 or not isinstance(args[1], Const):
                raise PlanError(
                    "JSON_EXTRACT expects (doc, constant path)")
            return Call("json_extract", [args[0]], _vt(),
                        extra=str(args[1].value))
        if name == "JSON_UNQUOTE":
            need(1)
            return Call("json_unquote", args, _vt())
        if name == "JSON_VALID":
            need(1)
            return Call("json_valid", args, FieldType(TypeKind.BIGINT))
        if name == "JSON_TYPE":
            need(1)
            return Call("json_type", args, _vt())
        if name == "JSON_LENGTH":
            need(1)
            return Call("json_length", args, FieldType(TypeKind.BIGINT))
        if name in ("JSON_OBJECT", "JSON_ARRAY"):
            for a in args:
                if not isinstance(a, Const):
                    raise PlanError(f"{name} supports constant arguments")
            import json as _json
            if name == "JSON_ARRAY":
                doc = _json.dumps([a.value for a in args])
            else:
                if len(args) % 2:
                    raise PlanError("JSON_OBJECT needs key/value pairs")
                doc = _json.dumps(
                    {str(args[i].value): args[i + 1].value
                     for i in range(0, len(args), 2)}, sort_keys=True)
            return Const(doc, _vt())
        if name == "FIND_IN_SET":
            need(2)
            return Call("find_in_set", args, FieldType(TypeKind.BIGINT))
        out = self._resolve_builtin(name, args, need)
        if out is not None:
            return out
        # breadth layer: the declarative host-function registry
        # (copr/funcs.py). LOCATE's 3-arg form shares a name with the
        # vectorized 2-arg core — registered under an alias.
        from ..copr.funcs import lookup
        reg_name = "LOCATE3" if name == "LOCATE" and len(args) == 3 \
            else name
        fd = lookup(reg_name)
        if fd is not None:
            if not fd.min_args <= len(args) <= fd.max_args:
                raise PlanError(
                    f"{name} expects {fd.min_args}..{fd.max_args} "
                    f"argument(s)")
            from ..types.field_type import varchar_type
            ret = {"str": varchar_type(),
                   "int": FieldType(TypeKind.BIGINT),
                   "float": FieldType(TypeKind.DOUBLE),
                   "date": FieldType(TypeKind.DATE)}.get(fd.ret)
            if ret is None:  # argN: result typed like that argument
                i = 1 if fd.ret == "arg1" and len(args) > 1 else 0
                ret = args[i].ftype
            return _fold(Call(f"fx:{fd.name}", args, ret))
        raise PlanError(f"unsupported function {name}")

    def _resolve_builtin(self, name: str, args: list[PlanExpr],
                         need) -> Optional[PlanExpr]:
        """The everyday MySQL scalar library (reference:
        expression/builtin_string.go / builtin_math.go /
        builtin_time.go / builtin_compare.go — host-evaluated here, the
        device gate keeps them off the pushdown path)."""
        from ..types.field_type import varchar_type as _vt

        bigint = FieldType(TypeKind.BIGINT)
        double = FieldType(TypeKind.DOUBLE)

        # ---- string functions ----
        if name in ("UPPER", "UCASE", "LOWER", "LCASE", "TRIM", "LTRIM",
                    "RTRIM", "REVERSE"):
            need(1)
            op = {"UPPER": "upper", "UCASE": "upper", "LOWER": "lower",
                  "LCASE": "lower", "TRIM": "trim", "LTRIM": "ltrim",
                  "RTRIM": "rtrim", "REVERSE": "reverse"}[name]
            return (Call(op, args, _vt()))
        if name in ("CONCAT", "CONCAT_WS"):
            if len(args) < (2 if name == "CONCAT_WS" else 1):
                raise PlanError(f"{name} needs more arguments")
            return (Call(name.lower(), args, _vt()))
        if name in ("LEFT", "RIGHT", "REPEAT"):
            need(2)
            return (Call(name.lower(), args, _vt()))
        if name == "REPLACE":
            need(3)
            return (Call("replace", args, _vt()))
        if name in ("LPAD", "RPAD"):
            need(3)
            return (Call(name.lower(), args, _vt()))
        if name in ("LENGTH", "CHAR_LENGTH", "CHARACTER_LENGTH",
                    "OCTET_LENGTH", "ASCII"):
            need(1)
            op = {"LENGTH": "length", "OCTET_LENGTH": "length",
                  "CHAR_LENGTH": "char_length",
                  "CHARACTER_LENGTH": "char_length",
                  "ASCII": "ascii"}[name]
            return Call(op, args, bigint)
        if (name == "LOCATE" and len(args) == 2) or name == "INSTR":
            need(2)
            if name == "INSTR":  # INSTR(str, substr) = LOCATE(substr, str)
                args = [args[1], args[0]]
            return Call("locate", args, bigint)

        # ---- math functions ----
        if name in ("ROUND", "TRUNCATE"):
            if len(args) not in (1, 2):
                raise PlanError(f"{name} expects 1 or 2 arguments")
            d = 0
            if len(args) == 2:
                if not isinstance(args[1], Const):
                    raise PlanError(f"{name} digits must be constant")
                if args[1].value is None:  # MySQL: NULL digits -> NULL
                    return Const(None, args[0].ftype)
                d = int(args[1].value)
            at = args[0].ftype
            if at.is_float:
                ft = double
            elif at.is_decimal:
                ft = FieldType(TypeKind.DECIMAL, flen=at.flen,
                               scale=max(0, min(d, at.scale)))
            else:
                ft = bigint
            return Call(name.lower(), [args[0]], ft, extra=d)
        if name in ("FLOOR", "CEIL", "CEILING"):
            need(1)
            ft = double if args[0].ftype.is_float else bigint
            op = "floor" if name == "FLOOR" else "ceil"
            return Call(op, args, ft)
        if name in ("SQRT", "EXP", "LN", "LOG2", "LOG10"):
            need(1)
            return Call(name.lower(), args, double)
        if name == "RAND" and args:
            # RAND(seed): per-STATEMENT seeded sequence, one draw per row
            # (reference: builtin_math.go randWithSeed). The registry's
            # per-row call model would repeat the first draw.
            need(1)
            if not isinstance(args[0], Const):
                raise PlanError("RAND seed must be constant")
            return Call("rand_seeded", args, double)
        if name == "LOG":
            if len(args) == 1:
                return Call("ln", args, double)
            need(2)  # LOG(base, x)
            return Call("log_base", args, double)
        if name in ("POW", "POWER"):
            need(2)
            return Call("pow", args, double)
        if name == "SIGN":
            need(1)
            return Call("sign", args, bigint)
        if name == "PI":
            need(0)
            import math
            return Const(math.pi, double)
        if name in ("GREATEST", "LEAST"):
            if len(args) < 2:
                raise PlanError(f"{name} needs at least 2 arguments")
            ft = args[0].ftype
            for a in args[1:]:
                ft = _unify_types(ft, a.ftype)
            return Call(name.lower(), args, ft)
        if name == "NULLIF":
            need(2)
            # NULLIF(a, b) = IF(a = b, NULL, a)
            cond = self._resolve_cmp("eq", args[0], args[1])
            return Call("if", [cond, Const(None, args[0].ftype),
                               args[0]], args[0].ftype)

        # ---- date/time functions ----
        if name in ("DAYOFWEEK", "WEEKDAY", "DAYOFYEAR", "QUARTER"):
            need(1)
            a = _coerce_date_arg(args[0], name)
            return Call(name.lower(), [a], bigint)
        if name in ("HOUR", "MINUTE", "SECOND"):
            need(1)
            a = args[0]
            if a.ftype.is_string and isinstance(a, Const):
                a = Const(_parse_time_us(str(a.value)),
                          FieldType(TypeKind.TIME))
            if a.ftype.kind not in (TypeKind.DATETIME,
                                    TypeKind.TIMESTAMP, TypeKind.TIME):
                raise PlanError(f"{name} requires a time argument")
            return Call(name.lower(), [a], bigint)
        if name == "DATE":
            need(1)
            a = _coerce_date_arg(args[0], name)
            return Call("to_date", [a], FieldType(TypeKind.DATE))
        if name == "LAST_DAY":
            need(1)
            a = _coerce_date_arg(args[0], name)
            return Call("last_day", [a], FieldType(TypeKind.DATE))
        if name == "DATEDIFF":
            need(2)
            coerced = [_coerce_date_arg(a, name) for a in args]
            return Call("datediff", coerced, bigint)
        return None

    def _resolve_case(
        self, node: ast.Case, r: Callable[[ast.Expr], PlanExpr]
    ) -> PlanExpr:
        # CASE x WHEN v ... lowers to CASE WHEN x = v ...
        branches: list[PlanExpr] = []
        result_t: Optional[FieldType] = None
        for when, then in node.branches:
            if node.operand is not None:
                cond = self._resolve_cmp("eq", r(node.operand), r(when))
            else:
                cond = _coerce_bool(r(when))
            tv = r(then)
            result_t = tv.ftype if result_t is None else _unify_types(
                result_t, tv.ftype)
            branches.extend([cond, tv])
        if node.else_expr is not None:
            ev = r(node.else_expr)
            result_t = ev.ftype if result_t is None else _unify_types(
                result_t, ev.ftype)
            branches.append(ev)
        assert result_t is not None
        return _fold(Call("case", branches, result_t))

    # ---- helpers -----------------------------------------------------------
    def _split_conjuncts(self, e: PlanExpr) -> list[PlanExpr]:
        if isinstance(e, Call) and e.op == "and":
            return self._split_conjuncts(e.args[0]) + \
                self._split_conjuncts(e.args[1])
        return [e]


# ==================== module helpers ====================

def _output_name(e: ast.Expr, alias: Optional[str]) -> str:
    if alias:
        return alias.lower()
    if isinstance(e, ast.ColumnRef):
        return e.name.lower()
    return _short_sql(e)


def _short_sql(e: ast.Expr) -> str:
    if isinstance(e, ast.FuncCall):
        inner = "*" if e.is_star else ", ".join(_short_sql(a) for a in e.args)
        return f"{e.name.lower()}({inner})"
    if isinstance(e, ast.ColumnRef):
        return e.name.lower()
    if isinstance(e, ast.Literal):
        return str(e.value)
    if isinstance(e, ast.BinaryOp):
        return f"{_short_sql(e.left)} {e.op.lower()} {_short_sql(e.right)}"
    return type(e).__name__.lower()


def _contains_window(e: ast.Expr) -> bool:
    return any(True for _ in _find_windows(e))


def _find_windows(e: ast.Expr):
    if isinstance(e, ast.FuncCall) and e.window is not None:
        yield e
        return
    for attr in ("left", "right", "operand", "low", "high", "pattern",
                 "value", "else_expr"):
        sub = getattr(e, attr, None)
        if isinstance(sub, ast.Expr):
            yield from _find_windows(sub)
    for attr in ("args", "values", "when_thens"):
        seq = getattr(e, attr, None)
        if isinstance(seq, list):
            for x in seq:
                if isinstance(x, ast.Expr):
                    yield from _find_windows(x)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Expr):
                            yield from _find_windows(y)


def _replace_windows(e: ast.Expr, wmap: dict):
    """Structurally replace windowed calls with their __win#i refs."""
    import dataclasses as _dc

    if isinstance(e, ast.FuncCall) and e.window is not None:
        return wmap[ast_key(e)]
    if not _dc.is_dataclass(e):
        return e
    changed = False
    kwargs = {}
    for fld in _dc.fields(e):
        v = getattr(e, fld.name)
        if isinstance(v, ast.Expr):
            nv = _replace_windows(v, wmap)
            changed |= nv is not v
            kwargs[fld.name] = nv
        elif isinstance(v, list):
            nv = []
            for x in v:
                if isinstance(x, ast.Expr):
                    y = _replace_windows(x, wmap)
                    changed |= y is not x
                    nv.append(y)
                elif isinstance(x, tuple):
                    ny = tuple(_replace_windows(z, wmap)
                               if isinstance(z, ast.Expr) else z for z in x)
                    changed |= ny != x
                    nv.append(ny)
                else:
                    nv.append(x)
            kwargs[fld.name] = nv
        else:
            kwargs[fld.name] = v
    return type(e)(**kwargs) if changed else e


def _contains_agg(e: ast.Expr) -> bool:
    return any(True for _ in _find_aggs(e))


def _find_aggs(e: ast.Expr):
    if isinstance(e, ast.FuncCall) and e.name in _AGG_NAMES:
        if e.window is None:
            yield e
        return
    for attr in ("left", "right", "operand", "low", "high", "pattern",
                 "value", "else_expr"):
        sub = getattr(e, attr, None)
        if isinstance(sub, ast.Expr):
            yield from _find_aggs(sub)
    for attr in ("args", "items"):
        subs = getattr(e, attr, None)
        if isinstance(subs, list):
            for s in subs:
                if isinstance(s, ast.Expr):
                    yield from _find_aggs(s)
    if isinstance(e, ast.Case):
        for w, t in e.branches:
            yield from _find_aggs(w)
            yield from _find_aggs(t)


def _literal_const(node: ast.Literal) -> Const:
    tag, v = node.tag, node.value
    if tag == "null" or v is None:
        return Const(None, FieldType(TypeKind.NULL))
    if tag == "int":
        return Const(int(v), FieldType(TypeKind.BIGINT, nullable=False))
    if tag == "decimal":
        d: Decimal = v if isinstance(v, Decimal) else Decimal.parse(str(v))
        return Const(d.unscaled,
                     FieldType(TypeKind.DECIMAL, flen=18, scale=d.scale,
                               nullable=False))
    if tag == "float":
        return Const(float(v), FieldType(TypeKind.DOUBLE, nullable=False))
    if tag == "string":
        return Const(str(v), FieldType(TypeKind.VARCHAR, nullable=False))
    if tag == "bool":
        return Const(int(bool(v)), FieldType(TypeKind.BOOLEAN, nullable=False))
    if tag == "date":
        return Const(parse_date(str(v)), FieldType(TypeKind.DATE,
                                                   nullable=False))
    if tag == "datetime":
        return Const(parse_datetime(str(v)),
                     FieldType(TypeKind.DATETIME, nullable=False))
    raise PlanError(f"unknown literal tag {tag}")


def _coerce_bool(e: PlanExpr) -> PlanExpr:
    if e.ftype.kind == TypeKind.BOOLEAN:
        return e
    if is_numeric(e.ftype):
        zero = Const(0, FieldType(TypeKind.BIGINT, nullable=False))
        return bool_call("ne", [e, zero])
    raise PlanError(f"cannot use {e.ftype!r} as a condition")


def _unify_types(a: FieldType, b: FieldType) -> FieldType:
    if a.kind == TypeKind.NULL:
        return b
    if b.kind == TypeKind.NULL:
        return a
    if a.kind == b.kind:
        if a.is_decimal:
            return a if a.scale >= b.scale else b
        return a
    if is_numeric(a) and is_numeric(b):
        from .expr import _NUMERIC_RANK
        if _NUMERIC_RANK[a.kind] >= _NUMERIC_RANK[b.kind]:
            hi, lo = a, b
        else:
            hi, lo = b, a
        if hi.is_decimal and lo.is_decimal:
            return hi if hi.scale >= lo.scale else lo
        return hi
    if a.is_string and b.is_string:
        return a
    raise PlanError(f"cannot unify types {a!r} and {b!r}")


def _ast_conjuncts(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.BinaryOp) and e.op == "AND":
        return _ast_conjuncts(e.left) + _ast_conjuncts(e.right)
    return [e]


def _contains_subquery(e: ast.Expr) -> bool:
    if isinstance(e, (ast.SubqueryExpr, ast.InSubquery)):
        return True
    for child in vars(e).values():
        if isinstance(child, ast.Expr) and _contains_subquery(child):
            return True
        if isinstance(child, (list, tuple)):
            for item in child:
                if isinstance(item, ast.Expr) and _contains_subquery(item):
                    return True
                if isinstance(item, tuple) and any(
                        isinstance(x, ast.Expr) and _contains_subquery(x)
                        for x in item):
                    return True
    return False


def _flip_cmp(op: str) -> str:
    return {"=": "=", "<>": "<>", "!=": "!=", "<": ">", "<=": ">=",
            ">": "<", ">=": "<="}[op]


def _as_equi_pair(cond: PlanExpr, nleft: int) -> Optional[tuple[int, int]]:
    if isinstance(cond, Call) and cond.op == "eq":
        a, b = cond.args
        if isinstance(a, Col) and isinstance(b, Col):
            if a.idx < nleft <= b.idx:
                return (a.idx, b.idx - nleft)
            if b.idx < nleft <= a.idx:
                return (b.idx, a.idx - nleft)
    return None


def _add_months(d: _dt.date, months: int) -> _dt.date:
    m = d.month - 1 + months
    y = d.year + m // 12
    m = m % 12 + 1
    # clamp day to month end (MySQL DATE_ADD semantics)
    for day in (d.day, 30, 29, 28):
        try:
            return _dt.date(y, m, day)
        except ValueError:
            continue
    raise ValueError("unreachable")


# ---- constant folding -------------------------------------------------------

_FOLD_NUMERIC = {"add", "sub", "mul", "neg"}


def _fold(e: Call) -> PlanExpr:
    """Fold constant subtrees. Conservative: only pure numeric/bool ops with
    all-constant args; decimal ops fold via host Decimal for exactness."""
    if not all(isinstance(a, Const) for a in e.args):
        return e
    args: list[Const] = e.args  # type: ignore[assignment]
    if any(a.value is None for a in args):
        if e.op == "isnull":
            return Const(1, e.ftype)
        if e.op in _FOLD_NUMERIC or e.op in ("div", "eq", "ne", "lt", "le",
                                             "gt", "ge"):
            return Const(None, e.ftype)
        return e
    try:
        if e.op in ("add", "sub", "mul", "div") and all(
            a.ftype.is_decimal or a.ftype.is_integer for a in args
        ):
            def as_dec(c: Const) -> Decimal:
                if c.ftype.is_decimal:
                    return Decimal(int(c.value), c.ftype.scale)
                return Decimal.from_int(int(c.value))
            a, b = as_dec(args[0]), as_dec(args[1])
            out = {"add": a + b, "sub": a - b, "mul": a * b}.get(e.op)
            if e.op == "div":
                out = a.div(b)
            assert out is not None
            if e.ftype.is_decimal:
                return Const(out.rescale(e.ftype.scale).unscaled, e.ftype)
            return Const(out.rescale(0).unscaled, e.ftype)
        if e.op in ("add", "sub", "mul", "div") and any(
            a.ftype.is_float for a in args
        ):
            x, y = float(args[0].value), float(args[1].value)
            val = {"add": x + y, "sub": x - y, "mul": x * y,
                   "div": x / y if y != 0 else None}[e.op]
            return Const(val, e.ftype)
        if e.op == "neg":
            return Const(-args[0].value, e.ftype)
        if e.op == "isnull":
            return Const(0, e.ftype)
        if e.op in ("eq", "ne", "lt", "le", "gt", "ge") and all(
            a.ftype.is_integer or a.ftype.is_decimal or a.ftype.is_float or
            a.ftype.is_temporal for a in args
        ):
            def as_num(c: Const):
                if c.ftype.is_decimal:
                    return Decimal(int(c.value), c.ftype.scale)
                return c.value
            x, y = as_num(args[0]), as_num(args[1])
            if isinstance(x, Decimal) and not isinstance(y, Decimal):
                y = Decimal.from_int(int(y))
            if isinstance(y, Decimal) and not isinstance(x, Decimal):
                x = Decimal.from_int(int(x))
            res = {"eq": x == y, "ne": x != y, "lt": x < y, "le": x <= y,
                   "gt": x > y, "ge": x >= y}[e.op]
            return Const(int(res), e.ftype)
    except (ZeroDivisionError, OverflowError, ExprError):
        return e
    return e


_INT_ORDER = [TypeKind.BOOLEAN, TypeKind.TINYINT, TypeKind.SMALLINT,
              TypeKind.INT, TypeKind.BIGINT]


def _union_ftype(a: FieldType, b: FieldType) -> FieldType:
    """Result type of a UNION column pair (conservative subset of MySQL's
    aggregation rules: same family merges; mixed families are rejected at
    plan time rather than silently coerced)."""
    if a.kind == TypeKind.NULL:
        return FieldType(b.kind, flen=b.flen, scale=b.scale)
    if b.kind == TypeKind.NULL:
        return FieldType(a.kind, flen=a.flen, scale=a.scale)
    if a.is_string and b.is_string:
        return FieldType(TypeKind.VARCHAR, flen=max(a.flen, b.flen))
    if a.is_float or b.is_float:
        if (a.is_float or a.is_integer or a.is_decimal) and \
                (b.is_float or b.is_integer or b.is_decimal):
            return FieldType(TypeKind.DOUBLE)
        raise PlanError("UNION over incompatible column types")
    if a.is_decimal or b.is_decimal:
        if not ((a.is_decimal or a.is_integer)
                and (b.is_decimal or b.is_integer)):
            raise PlanError("UNION over incompatible column types")
        sa = a.scale if a.is_decimal else 0
        sb = b.scale if b.is_decimal else 0
        ia = (a.flen - a.scale) if a.is_decimal else 19
        ib = (b.flen - b.scale) if b.is_decimal else 19
        scale = max(sa, sb)
        return FieldType(TypeKind.DECIMAL,
                         flen=min(max(ia, ib) + scale, 18 + scale),
                         scale=scale)
    if a.is_integer and b.is_integer:
        k = max(a.kind, b.kind, key=lambda x: _INT_ORDER.index(x)
                if x in _INT_ORDER else 99)
        if k not in _INT_ORDER:
            k = TypeKind.BIGINT
        return FieldType(k)
    if a.kind == b.kind:
        return FieldType(a.kind, flen=max(a.flen, b.flen),
                         scale=max(a.scale, b.scale))
    raise PlanError("UNION over incompatible column types")
