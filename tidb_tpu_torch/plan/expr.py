"""Resolved expression IR with MySQL type inference.

Counterpart of the reference's `expression.Expression` tree
(reference: expression/expression.go — Column/Constant/ScalarFunction) but
columnar-only: every node evaluates to a whole column vector. Constants hold
*physical* encodings (decimal -> scaled int, date -> day number, string ->
resolved per-use), so the device compiler never sees host objects.

Operator names are lowercase snake tags; the pushdown allowlist in
copr/kernels is keyed on them (the canFuncBePushed analog,
reference expression/expression.go:921).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..types.field_type import FieldType, TypeKind, boolean_type
from ..types.value import Decimal


class ExprError(Exception):
    pass


class PlanExpr:
    ftype: FieldType


@dataclass
class Col(PlanExpr):
    idx: int  # offset into the child plan's output schema
    ftype: FieldType
    name: str = ""  # for explain output

    def __repr__(self) -> str:
        return self.name or f"col#{self.idx}"


@dataclass
class Const(PlanExpr):
    value: Any  # physical encoding; None = NULL
    ftype: FieldType

    def __repr__(self) -> str:
        if self.ftype.is_decimal and self.value is not None:
            return str(Decimal(self.value, self.ftype.scale))
        return repr(self.value)


@dataclass
class Call(PlanExpr):
    """Scalar function call. op tags:

    arithmetic: add sub mul div intdiv mod neg
    comparison: eq ne lt le gt ge
    logic:      and or not
    null:       isnull ifnull coalesce
    membership: in_values (args[0] vs consts), like
    control:    case (when1, then1, ..., [else]) if
    conversion: cast (target = ftype)
    string-pred lowering produces: dict_lookup (see copr) — not built here
    """

    op: str
    args: list[PlanExpr]
    ftype: FieldType
    # op-specific payload (e.g. 'in_values' constant list, like pattern)
    extra: Any = None

    def __repr__(self) -> str:
        inner = ", ".join(map(repr, self.args))
        if self.extra is not None:
            return f"{self.op}({inner}; {self.extra!r})"
        return f"{self.op}({inner})"


@dataclass
class ScalarSubq(PlanExpr):
    """Uncorrelated scalar subquery. Materialized to a Const once per
    statement before execution (counterpart of the reference's scalar
    subquery rewrite, planner/core/expression_rewriter.go — which also
    evaluates uncorrelated subqueries eagerly)."""

    logical: Any  # LogicalPlan (typed loosely to avoid an import cycle)
    ftype: FieldType
    phys: Any = None  # PhysicalPlan, filled during optimize()

    def __repr__(self) -> str:
        return "scalar_subquery()"


@dataclass
class AggDesc:
    """One aggregate: func in {sum,count,avg,min,max}, arg expr (None for
    COUNT(*)), result type. Counterpart of expression/aggregation descriptors
    (reference: expression/aggregation/descriptor.go)."""

    func: str
    arg: Optional[PlanExpr]
    ftype: FieldType
    distinct: bool = False
    name: str = ""
    # constant extra parameters (e.g. APPROX_PERCENTILE's percent)
    params: tuple = ()

    def __repr__(self) -> str:
        inner = "*" if self.arg is None else repr(self.arg)
        d = "distinct " if self.distinct else ""
        return f"{self.func}({d}{inner})"


# ---- type inference ---------------------------------------------------------

_NUMERIC_RANK = {
    TypeKind.BOOLEAN: 0, TypeKind.TINYINT: 1, TypeKind.SMALLINT: 2,
    TypeKind.YEAR: 2, TypeKind.BIT: 3, TypeKind.INT: 3, TypeKind.BIGINT: 4,
    TypeKind.DECIMAL: 5, TypeKind.FLOAT: 6, TypeKind.DOUBLE: 7,
}


def is_numeric(ft: FieldType) -> bool:
    return ft.kind in _NUMERIC_RANK


def arith_result_type(op: str, a: FieldType, b: FieldType) -> FieldType:
    """MySQL numeric result typing (reference: types/field_type.go merge +
    expression/builtin_arithmetic.go scale rules)."""
    if a.kind == TypeKind.DATE or a.kind == TypeKind.DATETIME:
        # date arithmetic handled by caller (interval ops)
        raise ExprError(f"arith on temporal requires INTERVAL (op {op})")
    if not (is_numeric(a) and is_numeric(b)):
        raise ExprError(f"non-numeric operand for {op}: {a!r}, {b!r}")
    if a.kind == TypeKind.DOUBLE or b.kind == TypeKind.DOUBLE or \
            a.kind == TypeKind.FLOAT or b.kind == TypeKind.FLOAT:
        return FieldType(TypeKind.DOUBLE)
    a_dec, b_dec = a.is_decimal, b.is_decimal
    if op == "div":
        # decimal division: scale = s1 + 4 (div_precincrement)
        s = (a.scale if a_dec else 0) + 4
        return FieldType(TypeKind.DECIMAL, flen=18, scale=min(s, 12))
    if a_dec or b_dec:
        sa = a.scale if a_dec else 0
        sb = b.scale if b_dec else 0
        if op in ("add", "sub", "mod"):
            s = max(sa, sb)
        elif op == "mul":
            s = sa + sb
        elif op == "intdiv":
            return FieldType(TypeKind.BIGINT)
        else:
            raise ExprError(f"unknown arith op {op}")
        if s > 12:
            raise ExprError(f"decimal scale {s} exceeds device precision")
        return FieldType(TypeKind.DECIMAL, flen=18, scale=s)
    return FieldType(TypeKind.BIGINT)


def agg_result_type(func: str, arg: Optional[PlanExpr]) -> FieldType:
    if func in ("count", "approx_count_distinct"):
        # reference: executor/aggfuncs/builder.go:63 buildApproxCountDistinct
        # -> BIGINT, never NULL (0 on empty input), like COUNT
        return FieldType(TypeKind.BIGINT, nullable=False)
    assert arg is not None
    at = arg.ftype
    if func in ("std", "stddev", "stddev_pop", "stddev_samp",
                "variance", "var_pop", "var_samp"):
        # reference: executor/aggfuncs/func_varpop.go family -> DOUBLE
        return FieldType(TypeKind.DOUBLE)
    if func in ("bit_and", "bit_or", "bit_xor"):
        # reference: executor/aggfuncs/func_bitfuncs.go -> BIGINT UNSIGNED
        return FieldType(TypeKind.BIGINT, nullable=False)
    if func in ("any_value", "approx_percentile"):
        # reference: executor/aggfuncs/builder.go:110
        # buildApproxPercentile -> the argument's type
        return at
    if func == "group_concat":
        # reference: executor/aggfuncs/func_group_concat.go -> TEXT
        return FieldType(TypeKind.VARCHAR, flen=1024)
    if func in ("json_arrayagg", "json_objectagg"):
        # reference: executor/aggfuncs/func_json_arrayagg.go /
        # func_json_objectagg.go -> JSON
        return FieldType(TypeKind.JSON)
    if func in ("min", "max"):
        return at
    if func == "sum":
        if at.is_decimal:
            return FieldType(TypeKind.DECIMAL, flen=18, scale=at.scale)
        if at.is_float:
            return FieldType(TypeKind.DOUBLE)
        if at.is_integer:
            # MySQL: SUM(int) -> DECIMAL; we keep BIGINT on device and let the
            # host render; overflow beyond int64 is a known limitation
            return FieldType(TypeKind.BIGINT)
        raise ExprError(f"SUM over non-numeric {at!r}")
    if func == "avg":
        if at.is_decimal or at.is_integer:
            s = (at.scale if at.is_decimal else 0) + 4
            return FieldType(TypeKind.DECIMAL, flen=18, scale=min(s, 12))
        if at.is_float:
            return FieldType(TypeKind.DOUBLE)
        raise ExprError(f"AVG over non-numeric {at!r}")
    raise ExprError(f"unknown aggregate {func}")


def comparable(a: FieldType, b: FieldType) -> bool:
    if is_numeric(a) and is_numeric(b):
        return True
    if a.is_string and b.is_string:
        return True
    if a.is_temporal and (b.is_temporal or b.is_string):
        return True
    if b.is_temporal and a.is_string:
        return True
    from ..types.field_type import TypeKind as _TK
    if a.kind == _TK.SET and b.kind == _TK.SET:
        return True  # bitmask compare after const coercion
    return False


def bool_call(op: str, args: list[PlanExpr], extra: Any = None) -> Call:
    return Call(op, args, boolean_type(), extra=extra)
