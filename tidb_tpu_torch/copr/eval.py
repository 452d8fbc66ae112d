"""Columnar expression evaluation as PyTorch tensor programs.

Port of `tidb_tpu/copr/eval.py`: every expression lowers to elementwise
tensor ops over (value, validity) pairs. Device dtypes follow the
reference exactly — integers, decimals, dates and dictionary codes are
int32, floats float32 — so results agree bit for bit and the host-side
interval analysis (`bounds.py`) that proves int32 exactness stays valid.
Python scalars never promote an int32 tensor in torch, as weak-typed
scalars never do in JAX.

Null semantics: SQL three-valued logic via Kleene AND/OR; comparisons and
arithmetic propagate NULL; predicates treat NULL as false at the filter.

String columns arrive as int32 dictionary codes; the client resolved all
string constants/predicates to codes or per-code lookup tables host-side,
so only integer ops reach the device.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..plan.expr import Call, Col, Const, PlanExpr
from ..types.field_type import FieldType, TypeKind

# A column on device: (values, validity). validity True = not NULL.
VV = tuple[torch.Tensor, torch.Tensor]


class CompileError(Exception):
    """Raised when an expression can't lower to device ops."""


def _device_dtype(ft: FieldType) -> torch.dtype:
    """int64 -> int32 and float64 -> float32 (exactness guaranteed by the
    interval analysis + limb decomposition); int32 stays."""
    host = ft.np_dtype
    if host == np.dtype(np.int64) or host == np.dtype(np.int32):
        return torch.int32
    if host == np.dtype(np.float64):
        return torch.float32
    raise CompileError(f"no device dtype for {ft!r}")


def _scale_factor(diff: int) -> int:
    return 10 ** diff


def eval_expr(
    e: PlanExpr,
    columns: list[VV],
    prepared: dict[Any, Any],
) -> VV:
    """Lower a resolved expression to tensor ops.

    columns: scan output columns as (value, valid) pairs.
    prepared: client-resolved payloads by id(expr-node) — string constants
    as codes, LIKE code tables, etc.
    """
    if isinstance(e, Col):
        return columns[e.idx]
    if isinstance(e, Const):
        n = columns[0][0].shape[0] if columns else 1
        dev = columns[0][0].device if columns else torch.device("cpu")
        if e.value is None:
            return (torch.zeros(n, dtype=_device_dtype(e.ftype), device=dev),
                    torch.zeros(n, dtype=torch.bool, device=dev))
        v = prepared.get(id(e), e.value)
        arr = torch.full((n,), v, dtype=_device_dtype(e.ftype), device=dev)
        return arr, torch.ones(n, dtype=torch.bool, device=dev)
    assert isinstance(e, Call)
    return _eval_call(e, columns, prepared)


def _eval_call(e: Call, columns: list[VV], prepared: dict[Any, Any]) -> VV:
    op = e.op

    def ev(x: PlanExpr) -> VV:
        return eval_expr(x, columns, prepared)

    # ---- logic (Kleene 3VL) ------------------------------------------------
    if op == "and":
        av, aval = _as_bool(ev(e.args[0]))
        bv, bval = _as_bool(ev(e.args[1]))
        value = av & bv
        known_false = (aval & ~av) | (bval & ~bv)
        valid = (aval & bval) | known_false
        return value & valid, valid
    if op == "or":
        av, aval = _as_bool(ev(e.args[0]))
        bv, bval = _as_bool(ev(e.args[1]))
        value = (av & aval) | (bv & bval)
        known_true = (aval & av) | (bval & bv)
        valid = (aval & bval) | known_true
        return value, valid
    if op == "not":
        av, aval = _as_bool(ev(e.args[0]))
        return (~av) & aval, aval
    if op == "isnull":
        _, aval = ev(e.args[0])
        return ~aval, torch.ones_like(aval)

    # ---- comparisons -------------------------------------------------------
    if op in ("eq", "ne", "lt", "le", "gt", "ge"):
        a, b = e.args
        av, avl = ev(a)
        bv, bvl = ev(b)
        av, bv = _align_numeric(a, av, b, bv)
        fn: Callable = {
            "eq": torch.eq, "ne": torch.ne, "lt": torch.lt,
            "le": torch.le, "gt": torch.gt, "ge": torch.ge,
        }[op]
        valid = avl & bvl
        return fn(av, bv) & valid, valid

    # ---- membership / pattern ---------------------------------------------
    if op == "in_values":
        av, avl = ev(e.args[0])
        values = prepared.get(id(e), e.extra)
        hit = torch.zeros_like(avl)
        for v in values:
            hit = hit | (av == v)
        return hit & avl, avl
    if op in ("like", "dict_lookup"):
        # prepared: bool code-table over the dictionary (device tensor)
        av, avl = ev(e.args[0])
        table = prepared[id(e)]
        safe = torch.clamp(av, 0, table.shape[0] - 1).long()
        return table[safe] & avl, avl

    # ---- arithmetic --------------------------------------------------------
    if op in ("add", "sub"):
        a, b = e.args
        av, avl = ev(a)
        bv, bvl = ev(b)
        av, bv = _align_decimal_args(a, av, b, bv, e.ftype)
        out = av + bv if op == "add" else av - bv
        return out, avl & bvl
    if op == "mul":
        a, b = e.args
        av, avl = ev(a)
        bv, bvl = ev(b)
        if e.ftype.is_float:
            av = _to_float(av)
            bv = _to_float(bv)
        # decimal mul: scales add up; no rescale needed
        return av * bv, avl & bvl
    if op == "div":
        a, b = e.args
        av, avl = ev(a)
        bv, bvl = ev(b)
        if not e.ftype.is_float:
            raise CompileError("decimal division is host-only")
        av = _to_float(av)
        bv = _to_float(bv)
        nonzero = bv != 0
        out = torch.where(nonzero, av / torch.where(nonzero, bv, 1.0), 0.0)
        return out, avl & bvl & nonzero  # MySQL: x/0 -> NULL
    if op == "intdiv":
        a, b = e.args
        av, avl = ev(a)
        bv, bvl = ev(b)
        nonzero = bv != 0
        safe_b = torch.where(nonzero, bv, 1)
        q = torch.abs(av) // torch.abs(safe_b)
        q = torch.where((av < 0) != (bv < 0), -q, q)  # trunc toward zero
        return q, avl & bvl & nonzero
    if op == "mod":
        a, b = e.args
        av, avl = ev(a)
        bv, bvl = ev(b)
        nonzero = bv != 0
        safe_b = torch.where(nonzero, bv, 1)
        r = torch.abs(av) % torch.abs(safe_b)
        r = torch.where(av < 0, -r, r)  # MySQL mod takes dividend sign
        return r, avl & bvl & nonzero
    if op == "neg":
        av, avl = ev(e.args[0])
        return -av, avl
    if op == "abs":
        av, avl = ev(e.args[0])
        return torch.abs(av), avl

    # ---- control flow ------------------------------------------------------
    if op == "if":
        cv, cvl = _as_bool(ev(e.args[0]))
        tv, tvl = _cast_to(ev(e.args[1]), e.args[1].ftype, e.ftype)
        fv, fvl = _cast_to(ev(e.args[2]), e.args[2].ftype, e.ftype)
        cond = cv & cvl
        return torch.where(cond, tv, fv), torch.where(cond, tvl, fvl)
    if op == "ifnull":
        av, avl = _cast_to(ev(e.args[0]), e.args[0].ftype, e.ftype)
        bv, bvl = _cast_to(ev(e.args[1]), e.args[1].ftype, e.ftype)
        return torch.where(avl, av, bv), avl | bvl
    if op == "coalesce":
        out_v, out_vl = _cast_to(ev(e.args[0]), e.args[0].ftype, e.ftype)
        for a in e.args[1:]:
            av, avl = _cast_to(ev(a), a.ftype, e.ftype)
            out_v = torch.where(out_vl, out_v, av)
            out_vl = out_vl | avl
        return out_v, out_vl
    if op == "case":
        args = e.args
        has_else = len(args) % 2 == 1
        pairs = (len(args) - 1) // 2 if has_else else len(args) // 2
        if has_else:
            out_v, out_vl = _cast_to(ev(args[-1]), args[-1].ftype, e.ftype)
        else:
            n = columns[0][0].shape[0] if columns else 1
            dev = columns[0][0].device if columns else torch.device("cpu")
            out_v = torch.zeros(n, dtype=_device_dtype(e.ftype), device=dev)
            out_vl = torch.zeros(n, dtype=torch.bool, device=dev)
        decided = torch.zeros_like(out_vl)
        for i in range(pairs):
            cv, cvl = _as_bool(ev(args[2 * i]))
            tv, tvl = _cast_to(ev(args[2 * i + 1]), args[2 * i + 1].ftype,
                               e.ftype)
            take = (cv & cvl) & ~decided
            out_v = torch.where(take, tv, out_v)
            out_vl = torch.where(take, tvl, out_vl)
            decided = decided | take
        return out_v, out_vl

    # ---- temporal ----------------------------------------------------------
    if op in ("year", "month", "day"):
        av, avl = ev(e.args[0])
        if e.args[0].ftype.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
            av = av // 86_400_000_000  # micros -> days
        y, m, d = _civil_from_days(av)
        out = {"year": y, "month": m, "day": d}[op]
        return out.to(torch.int32), avl
    if op == "date_add_days":
        av, avl = ev(e.args[0])
        return av + int(e.extra), avl

    # ---- limb splits (wide-aggregate term decomposition, bounds.py) --------
    if op == "shr15":
        av, avl = ev(e.args[0])
        return av >> 15, avl
    if op == "and15":
        av, avl = ev(e.args[0])
        return av & 0x7FFF, avl

    # ---- casts -------------------------------------------------------------
    if op == "cast":
        src = e.args[0]
        return _cast_to(ev(src), src.ftype, e.ftype)

    raise CompileError(f"no device lowering for op {op!r}")


# ---- helpers ----------------------------------------------------------------

def _as_bool(vv: VV) -> VV:
    v, vl = vv
    if v.dtype != torch.bool:
        v = v != 0
    return v, vl


def _to_float(v: torch.Tensor) -> torch.Tensor:
    if not v.is_floating_point():
        return v.to(torch.float32)
    return v


def _align_numeric(a: PlanExpr, av, b: PlanExpr, bv):
    """Align operands for comparison: decimal scales, float promotion."""
    at, bt = a.ftype, b.ftype
    if at.is_float or bt.is_float:
        fa = _to_float(av)
        fb = _to_float(bv)
        if at.is_decimal:
            fa = fa / _scale_factor(at.scale)
        if bt.is_decimal:
            fb = fb / _scale_factor(bt.scale)
        return fa, fb
    sa = at.scale if at.is_decimal else 0
    sb = bt.scale if bt.is_decimal else 0
    if sa < sb:
        av = av * _scale_factor(sb - sa)
    elif sb < sa:
        bv = bv * _scale_factor(sa - sb)
    return av, bv


def _align_decimal_args(a: PlanExpr, av, b: PlanExpr, bv, out_t: FieldType):
    """Align for add/sub where the result type dictates the common scale."""
    if out_t.is_float:
        return _align_numeric(a, av, b, bv)
    if out_t.is_decimal:
        sa = a.ftype.scale if a.ftype.is_decimal else 0
        sb = b.ftype.scale if b.ftype.is_decimal else 0
        s = out_t.scale
        if sa < s:
            av = av * _scale_factor(s - sa)
        if sb < s:
            bv = bv * _scale_factor(s - sb)
        return av, bv
    return av, bv


def _cast_to(vv: VV, src: FieldType, dst: FieldType) -> VV:
    v, vl = vv
    if src.kind == dst.kind and src.scale == dst.scale:
        return v, vl
    if dst.is_float:
        f = _to_float(v)
        if src.is_decimal:
            f = f / _scale_factor(src.scale)
        return f, vl
    if dst.is_decimal:
        if src.is_decimal:
            if src.scale < dst.scale:
                return v * _scale_factor(dst.scale - src.scale), vl
            if src.scale > dst.scale:
                # rescale with half-away rounding
                f = _scale_factor(src.scale - dst.scale)
                q = (torch.abs(v) + f // 2) // f
                return torch.where(v < 0, -q, q), vl
            return v, vl
        if src.is_integer:
            return v * _scale_factor(dst.scale), vl
        if src.is_float:
            scaled = v * _scale_factor(dst.scale)
            q = torch.floor(torch.abs(scaled) + 0.5)
            return torch.where(scaled < 0, -q, q).to(torch.int32), vl
        raise CompileError(f"cast {src!r} -> {dst!r} not on device")
    if dst.is_integer:
        if src.is_decimal:
            f = _scale_factor(src.scale)
            q = (torch.abs(v) + f // 2) // f
            return torch.where(v < 0, -q, q), vl
        if src.is_float:
            q = torch.floor(torch.abs(v) + 0.5)
            return torch.where(v < 0, -q, q).to(torch.int32), vl
        if src.is_integer or src.kind == TypeKind.BOOLEAN:
            return v.to(torch.int32), vl
    raise CompileError(f"cast {src!r} -> {dst!r} not on device")


def _civil_from_days(z: torch.Tensor):
    """days-since-epoch -> (year, month, day), branch-free integer math
    (Howard Hinnant's civil_from_days; public-domain algorithm)."""
    z = z.to(torch.int32) + 719_468
    era = torch.where(z >= 0, z, z - 146_096) // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def selection_mask(
    conditions: list[PlanExpr],
    columns: list[VV],
    prepared: dict[Any, Any],
    base: torch.Tensor,
) -> torch.Tensor:
    """Conjunctive filter: NULL condition results are false (SQL WHERE)."""
    mask = base
    for c in conditions:
        v, vl = _as_bool(eval_expr(c, columns, prepared))
        mask = mask & v & vl
    return mask
