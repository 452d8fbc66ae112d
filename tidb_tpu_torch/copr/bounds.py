"""Host-side integer interval analysis over plan expressions.

Mirrors the device lowering in eval.py (including its decimal scale
alignment) to compute a conservative [lo, hi] bound for each integer-valued
expression, from per-column min/max epoch statistics. Two uses:

* staging: an int64 column whose values fit int32 uploads as int32 (halves
  HBM footprint and host->device transfer);
* exact MXU aggregation: the one-hot einsum segment-sum (client.py) splits
  values into 12-bit limbs accumulated in float32; the bound picks the
  minimal limb count that keeps every partial sum exactly representable.

Returns None when a bound can't be established (floats, strings, unknown
ops) — callers then assume the full int64 range.

Reference analog: TiDB's planner tracks field length/decimal for overflow
decisions (types/field_type.go flen/decimal); here the same metadata drives
physical kernel layout instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..plan.expr import Call, Col, Const, PlanExpr

Bound = Optional[tuple[int, int]]

_I64 = (-(2**63), 2**63 - 1)


def _scale(diff: int) -> int:
    return 10 ** diff


def _mul_bound(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    cands = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
    return (min(cands), max(cands))


def _union(a: Bound, b: Bound) -> Bound:
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def expr_bounds(e: PlanExpr, col_bounds: list[Bound]) -> Bound:
    """[lo, hi] of the expression's device value (scaled-int semantics)."""
    if isinstance(e, Col):
        ft = e.ftype
        if ft.is_float:
            return None
        if ft.is_string:
            return col_bounds[e.idx]  # dict codes
        return col_bounds[e.idx]
    if isinstance(e, Const):
        if e.value is None:
            return (0, 0)
        if isinstance(e.value, (bool, np.bool_)):
            return (0, 1)
        if isinstance(e.value, (int, np.integer)):
            v = int(e.value)
            return (v, v)
        return None
    if not isinstance(e, Call):
        return None

    op = e.op

    def sub(i: int) -> Bound:
        return expr_bounds(e.args[i], col_bounds)

    if op in ("and", "or", "not", "isnull", "eq", "ne", "lt", "le", "gt",
              "ge", "in_values", "like", "dict_lookup"):
        return (0, 1)
    if op in ("add", "sub"):
        a, b = sub(0), sub(1)
        if a is None or b is None:
            return None
        at, bt = e.args[0].ftype, e.args[1].ftype
        if e.ftype.is_decimal:
            sa = at.scale if at.is_decimal else 0
            sb = bt.scale if bt.is_decimal else 0
            s = e.ftype.scale
            if sa < s:
                a = (a[0] * _scale(s - sa), a[1] * _scale(s - sa))
            if sb < s:
                b = (b[0] * _scale(s - sb), b[1] * _scale(s - sb))
        if op == "add":
            return (a[0] + b[0], a[1] + b[1])
        return (a[0] - b[1], a[1] - b[0])
    if op == "mul":
        a, b = sub(0), sub(1)
        if a is None or b is None or e.ftype.is_float:
            return None
        return _mul_bound(a, b)
    if op == "neg":
        a = sub(0)
        return None if a is None else (-a[1], -a[0])
    if op == "abs":
        a = sub(0)
        if a is None:
            return None
        m = max(abs(a[0]), abs(a[1]))
        lo = 0 if a[0] <= 0 <= a[1] else min(abs(a[0]), abs(a[1]))
        return (lo, m)
    if op in ("intdiv", "mod"):
        a, b = sub(0), sub(1)
        if a is None:
            return None
        m = max(abs(a[0]), abs(a[1]))
        return (-m, m)
    if op in ("if",):
        return _union(_branch_bound(e.args[1], e.ftype, col_bounds),
                      _branch_bound(e.args[2], e.ftype, col_bounds))
    if op == "ifnull":
        return _union(_branch_bound(e.args[0], e.ftype, col_bounds),
                      _branch_bound(e.args[1], e.ftype, col_bounds))
    if op == "coalesce":
        out = _branch_bound(e.args[0], e.ftype, col_bounds)
        for i in range(1, len(e.args)):
            out = _union(out, _branch_bound(e.args[i], e.ftype, col_bounds))
        return out
    if op == "case":
        has_else = len(e.args) % 2 == 1
        pairs = (len(e.args) - 1) // 2 if has_else else len(e.args) // 2
        out: Bound = _branch_bound(e.args[-1], e.ftype, col_bounds) \
            if has_else else (0, 0)
        for i in range(pairs):
            out = _union(out, _branch_bound(e.args[2 * i + 1], e.ftype,
                                            col_bounds))
        return out
    if op == "year":
        # YEAR over a bounded date/datetime column narrows to the years
        # its values span (monotone in the day number) — the static
        # [0, 9999] span would push an EXTRACT(YEAR ...) group key past
        # the dense-segment gate (TPC-H Q7/Q8 group by l_year/o_year)
        a = sub(0)
        ft = e.args[0].ftype
        from ..types.field_type import TypeKind as _TK
        if a is not None and ft.kind in (_TK.DATE, _TK.DATETIME,
                                         _TK.TIMESTAMP):
            lo, hi = a
            if ft.kind in (_TK.DATETIME, _TK.TIMESTAMP):
                lo //= 86_400_000_000  # micros -> days
                hi //= 86_400_000_000
            if -1_000_000 <= lo <= hi <= 3_000_000:  # civil range guard
                return (_year_of_day(lo), _year_of_day(hi))
        return (0, 9999)
    if op == "month":
        return (0, 12)
    if op == "day":
        return (0, 31)
    if op == "date_add_days":
        a = sub(0)
        if a is None:
            return None
        d = int(e.extra)
        return (a[0] + min(d, 0), a[1] + max(d, 0))
    if op == "shr15":
        a = sub(0)
        if a is None:
            return None
        return (a[0] >> 15, a[1] >> 15)
    if op == "and15":
        return (0, (1 << 15) - 1)
    if op == "cast":
        src = e.args[0].ftype
        dst = e.ftype
        a = sub(0)
        if a is None:
            return None
        if dst.is_float:
            return None
        if dst.is_decimal:
            ss = src.scale if src.is_decimal else 0
            if ss < dst.scale:
                f = _scale(dst.scale - ss)
                return (a[0] * f, a[1] * f)
            if ss > dst.scale:
                f = _scale(ss - dst.scale)
                return (a[0] // f - 1, a[1] // f + 1)
            return a
        if dst.is_integer:
            if src.is_decimal:
                f = _scale(src.scale)
                return (a[0] // f - 1, a[1] // f + 1)
            return a
        return None
    return None


def _year_of_day(z: int) -> int:
    """days-since-epoch -> civil year (host twin of eval._civil_from_days)."""
    z = int(z) + 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    return y + (1 if mp >= 10 else 0)


def _branch_bound(arg: PlanExpr, out_t, col_bounds: list[Bound]) -> Bound:
    """Bound of a control-flow branch AFTER eval's cast to the result type
    (eval.py _cast_to rescales decimals to out_t.scale on device)."""
    b = expr_bounds(arg, col_bounds)
    if b is None:
        return None
    st = arg.ftype
    if out_t.is_decimal:
        ss = st.scale if st.is_decimal else 0
        if ss < out_t.scale:
            f = _scale(out_t.scale - ss)
            return (b[0] * f, b[1] * f)
        if ss > out_t.scale:
            f = _scale(ss - out_t.scale)
            return (b[0] // f - 1, b[1] // f + 1)
    return b


def _cmp_aligned_bounds(a: PlanExpr, b: PlanExpr,
                        col_bounds: list[Bound]) -> tuple[Bound, Bound]:
    """Operand bounds AFTER eval's comparison scale alignment
    (eval.py _align_numeric multiplies the lower-scale side by 10^diff
    on device, which itself must fit int32)."""
    ba = expr_bounds(a, col_bounds)
    bb = expr_bounds(b, col_bounds)
    at, bt = a.ftype, b.ftype
    if at.is_float or bt.is_float:
        return ba, bb  # compared in f32; no integer overflow
    sa = at.scale if at.is_decimal else 0
    sb = bt.scale if bt.is_decimal else 0
    if sa < sb and ba is not None:
        f = _scale(sb - sa)
        ba = (ba[0] * f, ba[1] * f)
    elif sb < sa and bb is not None:
        f = _scale(sa - sb)
        bb = (bb[0] * f, bb[1] * f)
    return ba, bb


def fits_int32(b: Bound) -> bool:
    return b is not None and b[0] >= -(2**31) and b[1] < 2**31


_I31 = (-(2**31), 2**31 - 1)


def _safe(b: Bound) -> bool:
    return b is not None and b[0] >= _I31[0] and b[1] <= _I31[1]


def expr_device_safe(e: PlanExpr, col_bounds: list[Bound]) -> bool:
    """True iff every integer-valued node of the tree fits int32 — i.e.
    int32 device arithmetic computes the expression exactly. Floats and
    booleans are always "safe" (they lower to f32/bool); the caller decides
    whether f32 precision is acceptable for the context."""
    if isinstance(e, Col) or isinstance(e, Const):
        ft = e.ftype
        if ft.is_float or ft.is_string:
            return True
        return _safe(expr_bounds(e, col_bounds))
    assert isinstance(e, Call)
    if e.ftype.is_float:
        return all(expr_device_safe(a, col_bounds) for a in e.args)
    if e.op in ("eq", "ne", "lt", "le", "gt", "ge") and len(e.args) == 2:
        # eval aligns decimal scales by multiplying the lower-scale side
        # by 10^diff ON DEVICE — the scaled operand must itself fit int32
        a, b = e.args
        if not (expr_device_safe(a, col_bounds)
                and expr_device_safe(b, col_bounds)):
            return False
        if a.ftype.is_string or b.ftype.is_string:
            return True
        ba, bb = _cmp_aligned_bounds(a, b, col_bounds)
        if a.ftype.is_float or b.ftype.is_float:
            return True
        return _safe(ba) and _safe(bb)
    if e.op in ("and", "or", "not", "isnull", "in_values", "like",
                "dict_lookup"):
        # the predicate itself is boolean; its operands must be safe
        return all(expr_device_safe(a, col_bounds) for a in e.args)
    if not _safe(expr_bounds(e, col_bounds)):
        return False
    return all(expr_device_safe(a, col_bounds) for a in e.args)


def decompose_terms(
    e: PlanExpr, col_bounds: list[Bound], max_terms: int = 8
) -> Optional[list[tuple[PlanExpr, int]]]:
    """Split an integer expression into [(term, shift)] with
    value == sum(term_i << shift_i), every term int32-safe on device.

    Used for aggregate arguments whose per-row value overflows int32
    (e.g. TPC-H Q1's price*(1-disc)*(1+tax), ~37 bits): the wide factor of
    a product is split at bit 15 (hi = a >> 15 arithmetic, lo = a & 0x7fff,
    a == (hi << 15) + lo in two's complement), distributing the multiply.
    Each term is summed exactly on device (sumexact.py) and the host
    recombines sum(e) = sum_i (sum(term_i) << shift_i) in int64.

    Returns None when no safe decomposition exists (caller falls back to
    the host path). Reference analog: the decimal value words of
    types/mydecimal.go — multi-word exact arithmetic, here driven by
    interval analysis instead of a fixed word count.
    """
    if expr_device_safe(e, col_bounds):
        return [(e, 0)]
    if not isinstance(e, Call):
        return None
    if e.op == "neg":
        inner = decompose_terms(e.args[0], col_bounds, max_terms)
        if inner is None:
            return None
        return [(Call("neg", [t], e.ftype), s) for t, s in inner]
    if e.op != "mul":
        return None
    a, b = e.args
    ba = expr_bounds(a, col_bounds)
    bb = expr_bounds(b, col_bounds)
    if ba is None or bb is None:
        return None
    # put the narrow factor on the right; it must fit 15 bits so that
    # (a & 0x7fff) * b and (a >> 15) * b stay int32-safe after splitting
    amax = max(abs(ba[0]), abs(ba[1]))
    bmax = max(abs(bb[0]), abs(bb[1]))
    if amax < bmax:
        a, b, ba, bb, amax, bmax = b, a, bb, ba, bmax, amax
    if not expr_device_safe(b, col_bounds):
        return None
    wide = decompose_terms(a, col_bounds, max_terms)
    if wide is None:
        return None
    out: list[tuple[PlanExpr, int]] = []
    for ta, sa in wide:
        hi = Call("shr15", [ta], ta.ftype)
        lo = Call("and15", [ta], ta.ftype)
        for part, shift in ((Call("mul", [hi, b], e.ftype), sa + 15),
                            (Call("mul", [lo, b], e.ftype), sa)):
            if expr_device_safe(part, col_bounds):
                out.append((part, shift))
            else:
                sub2 = decompose_terms(part, col_bounds, max_terms)
                if sub2 is None:
                    return None
                out.extend((t, s + shift) for t, s in sub2)
            if len(out) > max_terms:
                return None
    return out


def limbs_for(b: Bound, limb_bits: int = 12, max_limbs: int = 6) -> int:
    """Number of signed limb_bits-bit limbs covering [lo, hi] exactly."""
    if b is None:
        return max_limbs
    need = max(int(abs(b[0])), int(abs(b[1])), 1).bit_length() + 1
    n = -(-need // limb_bits)
    return max(1, min(n, max_limbs))
