"""Multi-key TopN on the device: lexicographic composites of bounded keys.

Port of `tidb_tpu/copr/topnpack.py`. The programs stay 64-bit-free, as in
the reference, so a multi-key ORDER BY ranks rows by ONE int32 composite
that order-embeds the lexicographic (item1, item2, ...) comparison:

* every key gets a dense "goodness" code in [0, card): larger code =
  earlier in the result. ASC keys complement against the upper bound
  (hi - v), DESC keys shift by one (v - lo + 1), with the per-key [lo, hi]
  bounds of the host interval analysis (copr/bounds.py);
* MySQL NULL ordering (first in ASC, last in DESC) is a dedicated code at
  the top (ASC) or bottom (DESC) of each key's range;
* dictionary-encoded string keys go through an order-preserving rank table
  (Dictionary.sort_ranks, the ranks the host sort uses);
* the composite is a Horner accumulation; it packs iff the product of the
  cards fits int32.

Ties on every packed key resolve by ROW ORDER: `topk_desc` ranks the larger
score first and, among equal scores, the lower row first (the index-stable
order of the reference's `lax.top_k`).

The second half serves the fused join+agg+topn cut: exact per-candidate
aggregate values arrive as 12-bit limb PAIR sums (sumexact layout) and
`pair_digits` re-normalizes them into canonical base-4096 digit vectors
(signed head) whose componentwise comparison IS the numeric comparison.

Every tensor here is int32 (or bool): Python scalars never promote an int32
tensor, `>>` on int32 is arithmetic and `//` floors, as in JAX.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..chunk.column import Column
from ..plan.expr import Col
from .bounds import expr_bounds, expr_device_safe

# composite must stay strictly inside int32: the drop sentinel is I32_MIN
# and every packed score is >= 0
PACK_CAP = 2**31 - 2

# max (term, limb) pair count the digit accumulator admits: per-digit
# partial sums are < pairs * 2^27 before carry normalization and must not
# wrap int32
MAX_DIGIT_PAIRS = 8

N_DIGITS = 7  # base-4096 digits cover the planner's 2^62 sum gate

_LIMB_BITS = 12
_LIMB_MASK = (1 << _LIMB_BITS) - 1
I32_MIN = -(2**31)
I32_MAX = 2**31 - 1


def plan_pack(items, col_bounds, dicts=None):
    """Pack plan for sort items resolved to the evaluation column space.

    items: [(expr, desc)]; col_bounds: per-column host interval bounds;
    dicts: per-column dictionaries for string keys (None rejects them).
    Returns (specs, None) on success or (None, reason)."""
    specs: list[dict[str, Any]] = []
    prod = 1
    for e, desc in items:
        if e.ftype.is_float:
            return None, "float key in multi-key TopN is host-side"
        if e.ftype.is_string:
            if not isinstance(e, Col) or dicts is None or \
                    e.idx >= len(dicts) or dicts[e.idx] is None:
                return None, "computed string TopN key is host-side"
            d = dicts[e.idx]
            card = len(d) + 1  # ranks 0..len-1 plus the NULL slot
            if card < 2:
                card = 2
            specs.append({"expr": e, "desc": bool(desc), "kind": "rank",
                          "dict": d, "ci": bool(e.ftype.is_ci),
                          "card": card})
        else:
            if not expr_device_safe(e, col_bounds):
                return None, "TopN key too wide for int32 device"
            b = expr_bounds(e, col_bounds)
            if b is None:
                return None, "unbounded multi-key TopN key"
            lo, hi = int(b[0]), int(b[1])
            card = hi - lo + 2  # value span plus the NULL slot
            specs.append({"expr": e, "desc": bool(desc), "kind": "int",
                          "lo": lo, "hi": hi, "card": card})
        prod *= card
        if prod > PACK_CAP:
            return None, (f"multi-key TopN space {prod} too wide to "
                          "pack int32")
    return specs, None


def stage_rank_table(prepared: dict, key, d, ci: bool, device) -> None:
    """Stash one dictionary's order-preserving rank table (int32 on
    `device`) in `prepared` under `key`. Shared by the packed TopN keys and
    the fused hc cut's string group items."""
    ranks = d.sort_ranks(ci=ci)
    if not len(ranks):
        ranks = [0]
    prepared[key] = torch.as_tensor(ranks, dtype=torch.int32, device=device)


def stage_rank_tables(specs, prepared: dict, device) -> None:
    """Resolve every string key's rank table for a pack plan."""
    for i, s in enumerate(specs):
        if s["kind"] == "rank":
            stage_rank_table(prepared, ("topn_rank", i), s["dict"], s["ci"],
                             device)


def composite_score(specs, cols, prepared, eval_fn) -> torch.Tensor:
    """int32 composite over the evaluated keys: larger = earlier in the
    result. Invalid/padded lanes are clipped before packing so no lane
    overflows; masked-out rows are the caller's job (replace them with the
    drop sentinel)."""
    comp: Optional[torch.Tensor] = None
    for i, s in enumerate(specs):
        v, vl = eval_fn(s["expr"], cols, prepared)
        v = v.to(torch.int32)
        if s["kind"] == "rank":
            table = prepared[("topn_rank", i)]
            d_len = table.shape[0]
            r = table[torch.clamp(v, 0, d_len - 1)]
            if s["desc"]:
                code = torch.where(vl, r + 1, 0)
            else:
                code = torch.where(vl, (d_len - 1) - r, d_len)
        else:
            lo, hi = s["lo"], s["hi"]
            vc = torch.clamp(v, lo, hi)
            if s["desc"]:
                code = torch.where(vl, vc - lo + 1, 0)
            else:
                code = torch.where(vl, hi - vc, hi - lo + 1)
        comp = code if comp is None else comp * s["card"] + code
    assert comp is not None
    return comp


def packed_score(specs, cols, prepared, mask, eval_fn) -> torch.Tensor:
    """The composite of `composite_score`, with the rows the mask drops at
    the int32 floor (every packed score is >= 0)."""
    return torch.where(mask, composite_score(specs, cols, prepared, eval_fn),
                       I32_MIN)


def top_rows(score, mask, n: int, outs) -> dict:
    """One tile's n best rows in order (`topk_desc`), their output columns
    gathered on the device so that the k rows are the only bytes fetched.
    Serves the single-table TopN (client.py) and the fragment's "topn"
    mode alike. outs: [(data, valid, is_float)] per output column.
    -> {"ints": int32[2 + 2 * n_int, k] (row, picked, then (data, valid)
    per integer column), "flts": f32[2 * n_float, k]}."""
    k = min(n, score.shape[0])
    idx = topk_desc(score, k)
    picked = mask[idx]
    int_rows = [idx.to(torch.int32), picked.to(torch.int32)]
    flt_rows = []
    for d, v, is_float in outs:
        pvk = d[idx]
        pvlk = v[idx] & picked
        if is_float:
            flt_rows += [pvk.to(torch.float32), pvlk.to(torch.float32)]
        else:
            int_rows += [pvk.to(torch.int32), pvlk.to(torch.int32)]
    res = {"ints": torch.stack(int_rows)}
    if flt_rows:
        res["flts"] = torch.stack(flt_rows)
    return res


def top_columns(out: dict, types, dicts) -> list:
    """Fetched `top_rows` output -> the picked rows' result columns, one
    per output type (floats as the f32 values the device shipped; string
    columns as dictionary codes with their dictionary)."""
    ints, flts = out["ints"], out.get("flts")
    picked = ints[1].astype(bool)
    columns = []
    ii = fi = 0
    for ft, dictionary in zip(types, dicts):
        if ft.is_float:
            data = flts[fi][picked]
            valid = flts[fi + 1][picked] > 0
            fi += 2
        else:
            data = ints[2 + ii][picked]
            valid = ints[2 + ii + 1][picked].astype(bool)
            ii += 2
        columns.append(Column(ft, data.astype(ft.np_dtype),
                              None if valid.all() else valid, dictionary))
    return columns


def topk_desc(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores in order: the larger score first,
    and among equal scores the lower index first (the index-stable order
    of `lax.top_k`, which `torch.topk` does not promise). One int64 topk
    over (order-preserving int32 image of the score) * 2^32 + (2^32 - 1 -
    index), on the CPU and on the card alike. score: int32 or float32
    (floats in their IEEE total order, -0.0 below +0.0)."""
    n = score.shape[0]
    assert n < 2**32
    if score.dtype == torch.float32:
        bits = score.view(torch.int32)
        ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    else:
        ordered = score.to(torch.int32)
    low = (2**32 - 1) - torch.arange(n, dtype=torch.int64,
                                     device=score.device)
    key = ordered.to(torch.int64) * 2**32 + low
    return torch.topk(key, k, sorted=True).indices


# ==================== exact limb-pair digit comparison ====================

def digits_fit(sched_entry: dict) -> bool:
    """True when every (term, limb) weight of the schedule entry lands
    inside the N_DIGITS digit window (pair_digits would raise)."""
    if sched_entry["kind"] == "count":
        return True
    for _t, shift, L in sched_entry.get("terms", ()):
        for li in range(L):
            q, r = divmod(_LIMB_BITS * li + int(shift), _LIMB_BITS)
            if (q if r == 0 else q + 1) >= N_DIGITS:
                return False
    return True


def count_pairs(sched_entry: dict) -> int:
    """(term, limb) pair count of one agg schedule entry: the digit
    accumulator's overflow budget (MAX_DIGIT_PAIRS)."""
    if sched_entry["kind"] == "count":
        return 1
    return sum(L for _, _, L in sched_entry.get("terms", ()))


def pair_digits(contribs) -> list[torch.Tensor]:
    """Exact canonical digits of sum_t 2^shift_t * value(pairs_t).

    contribs: [(shift, pairs)] with pairs int32[L, 2, n] in the sumexact
    layout (limb l value = hi*4096 + lo, hi <= n/4096, lo < 2^25, top limb
    signed). Returns N_DIGITS int32[n] tensors MOST-significant first: all
    but the head are canonical [0, 4096) digits, the head keeps the sign,
    so componentwise (head signed, rest unsigned) lexicographic comparison
    equals numeric comparison."""
    digits: list[Optional[torch.Tensor]] = [None] * N_DIGITS

    def acc(q, arr):
        digits[q] = arr if digits[q] is None else digits[q] + arr

    for shift, pairs in contribs:
        L = pairs.shape[0]
        for li in range(L):
            limb_val = pairs[li, 0] * (1 << _LIMB_BITS) + pairs[li, 1]
            q, r = divmod(_LIMB_BITS * li + int(shift), _LIMB_BITS)
            if q >= N_DIGITS:
                raise ValueError("digit span exceeds N_DIGITS")
            if r == 0:
                acc(q, limb_val)
            else:
                # split the shifted limb across two digits without ever
                # materializing the (int32-overflowing) shifted value
                low = (limb_val & ((1 << (_LIMB_BITS - r)) - 1)) << r
                high = limb_val >> (_LIMB_BITS - r)  # arithmetic: sign
                acc(q, low)
                if q + 1 >= N_DIGITS:
                    raise ValueError("digit span exceeds N_DIGITS")
                acc(q + 1, high)

    first = next(d for d in digits if d is not None)
    zero = torch.zeros_like(first)
    carry = zero
    out = []
    for i in range(N_DIGITS):
        t = (digits[i] if digits[i] is not None else zero) + carry
        if i < N_DIGITS - 1:
            out.append(t & _LIMB_MASK)
            carry = t >> _LIMB_BITS  # arithmetic shift: floor carry
        else:
            out.append(t)  # signed head absorbs the final carry
    out.reverse()
    return out


# AVG items: every long-division step computes r*4096 + digit with r < cnt,
# so counts must stay under 2^18 for int32 exactness; the executor gates
# the fused cut on the dispatch's total row count
AVG_CNT_CAP = 1 << 18
_AVG_SCALE_UP = 10_000  # div_precincrement=4: out scale = arg scale + 4
_AVG_DIGITS = N_DIGITS + 2  # |sum| * 10^4 < 2^62 * 10^4 fits 9 digits


def avg_sort_keys(digs, cnt, isnull, desc: bool) -> list[torch.Tensor]:
    """Ascending-sort operands ordering candidates by EXACTLY the value the
    host's AVG produces: round-half-away-from-zero of sum * 10^4 / cnt
    (types/value.Decimal.div with div_precincrement=4; the executor gates
    fused AVG items on out_scale == arg_scale + 4).

    digs: the SUM's signed-head canonical base-4096 digits (pair_digits,
    MSB first); cnt: int32 counts < AVG_CNT_CAP; isnull: cnt == 0. All
    int32-exact: sign-magnitude split, scale by 10^4 with carry
    renormalization, base-4096 long division by cnt, half-away rounding on
    the true remainder, then packed sign-applied digit operands with MySQL
    NULL placement folded into the leading operand."""
    neg = digs[0] < 0
    # |sum| digits, LSB-first borrow propagation over the canonical form
    mags_lsb = []
    borrow = torch.zeros_like(digs[0])
    for i in range(N_DIGITS - 1, 0, -1):
        d = digs[i]
        mags_lsb.append(torch.where(neg, (-d - borrow) & _LIMB_MASK, d))
        nb = ((d + borrow) > 0).to(torch.int32)
        borrow = torch.where(neg, nb, borrow)
    head = torch.where(neg, -digs[0] - borrow, digs[0])
    # scale magnitude by 10^4 (digit * 10^4 < 2^26, carries renormalize)
    carry = torch.zeros_like(head)
    scaled_lsb = []
    for m in mags_lsb + [head]:
        cur = m * _AVG_SCALE_UP + carry
        scaled_lsb.append(cur & _LIMB_MASK)
        carry = cur >> _LIMB_BITS
    while len(scaled_lsb) < _AVG_DIGITS:
        scaled_lsb.append(carry & _LIMB_MASK)
        carry = carry >> _LIMB_BITS
    # long division MSB-first: quotient digits < 4096, remainder < cnt
    c = torch.clamp(cnt, min=1)  # cnt == 0 folds via isnull below
    r = torch.zeros_like(head)
    q_msb = []
    for m in reversed(scaled_lsb):
        t = r * (1 << _LIMB_BITS) + m
        q = t // c
        q_msb.append(q)
        r = t - q * c
    # half away from zero on the magnitude (the host rounds |num|/|den|)
    up = (2 * r >= c).to(torch.int32)
    k_lsb = []
    carry = up
    for q in reversed(q_msb):
        cur = q + carry
        k_lsb.append(cur & _LIMB_MASK)
        carry = cur >> _LIMB_BITS
    k_msb = list(reversed(k_lsb))
    is_zero = None
    for d in k_msb:
        z = d == 0
        is_zero = z if is_zero is None else (is_zero & z)
    sgn = torch.where(is_zero, 0, torch.where(neg, -1, 1)).to(torch.int32)
    # pack digit pairs (24 bits per operand) and apply the sign: for equal
    # signs, negated digits reverse the order componentwise
    packed = []
    i = 0
    while i < len(k_msb):
        if i + 1 < len(k_msb):
            packed.append(k_msb[i] * (1 << _LIMB_BITS) + k_msb[i + 1])
            i += 2
        else:
            packed.append(k_msb[i])
            i += 1
    keys = [sgn] + [sgn * p for p in packed]
    if desc:
        keys = [-k for k in keys]
    sent = 2 if desc else -2  # NULL first-ASC / last-DESC
    return [torch.where(isnull, sent, keys[0])] + \
        [torch.where(isnull, 0, k) for k in keys[1:]]


def digit_sort_keys(digs, desc: bool) -> list[torch.Tensor]:
    """Ascending-sort keys for a digit vector: packed pairs of canonical
    digits (24 bits per int32 operand), identity for ASC (smaller value
    first), componentwise reversal for DESC. The signed head negates; a
    packed pair p = a*4096+b complements to (2^24-1) - p, which IS the
    componentwise (4095-a, 4095-b) pair."""
    head, rest = digs[0], list(digs[1:])
    packed = [head]
    widths = []
    i = 0
    while i < len(rest):
        if i + 1 < len(rest):
            packed.append(rest[i] * (1 << _LIMB_BITS) + rest[i + 1])
            widths.append(2 * _LIMB_BITS)
            i += 2
        else:
            packed.append(rest[i])
            widths.append(_LIMB_BITS)
            i += 1
    if not desc:
        return packed
    out = [-head]
    for w, p in zip(widths, packed[1:]):
        out.append(((1 << w) - 1) - p)
    return out
