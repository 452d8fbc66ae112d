"""tidb_tpu_torch sumexact and eval vs the JAX reference's, on the CPU.

The same numpy inputs (made from a seed) go through the reference's jnp
function and the port's torch function.

Tolerances, with their reasons:
* exact (`==`) for limbs, limb partials and every integer/decimal/bool
  expression: both sides compute in int32/bool with the same operations
  (the repo's device-vs-host standard), and limb sums are f32 sums of
  integers below 2^24, exact in any order;
* exact for f32 expressions too: elementwise IEEE f32 ops (division,
  scaling) round the same way in both frameworks;
* rtol 1e-6 for `float_seg_sums`: f32 block sums taken in another order
  differ in the last bits (blocks of n/32 rows, relative error well
  under 1e-6 at these sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import eval as JE
from tidb_tpu.copr import sumexact as JS
from tidb_tpu.plan.expr import Call, Col, Const
from tidb_tpu.types.field_type import FieldType, TypeKind
from tidb_tpu_torch.convert import request_from_reference
from tidb_tpu_torch.copr import eval as TE
from tidb_tpu_torch.copr import sumexact as TS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- sumexact ---------------------------------------------------------------

@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
def test_limbs_of_equal(n_limbs):
    rng = np.random.default_rng(n_limbs)
    v = rng.integers(-(2**31), 2**31 - 1, 5000, dtype=np.int64).astype(
        np.int32)
    want = JS.limbs_of(jnp.asarray(v), n_limbs)
    got = TS.limbs_of(_t(v), n_limbs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def _seg_inputs(seed, n, segments, lo, hi):
    rng = np.random.default_rng(seed)
    v = rng.integers(lo, hi, n).astype(np.int32)
    seg = rng.integers(-1, segments, n).astype(np.int32)  # -1 = excluded
    return v, seg


@pytest.mark.parametrize("n,segments,n_limbs,lo,hi", [
    (1, 1, 1, 0, 2), (4096, 3, 1, 0, 4096), (10001, 7, 2, -(2**20), 2**20),
    (9000, 64, 3, -(2**30), 2**30)])
def test_seg_sum_partials_loop_equal(n, segments, n_limbs, lo, hi):
    v, seg = _seg_inputs(n, n, segments, lo, hi)
    want = np.asarray(JS.seg_sum_partials(jnp.asarray(v), jnp.asarray(seg),
                                          segments, n_limbs))
    got = TS.seg_sum_partials(_t(v), _t(seg), segments, n_limbs)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the host recombination sees the same totals
    assert np.array_equal(TS.combine_partials(got.numpy()),
                          JS.combine_partials(want))


@pytest.mark.parametrize("n,segments,n_limbs", [(5000, 65, 2), (2048, 300, 1),
                                                (7777, 1024, 3)])
def test_seg_sum_partials_einsum_equal(n, segments, n_limbs):
    # values inside what n_limbs covers (bounds.limbs_for's contract)
    half = 2 ** (12 * n_limbs - 2)
    v, seg = _seg_inputs(n + 1, n, segments, -half, half)
    j_oh = JS.make_one_hot(jnp.asarray(seg), segments)
    t_oh = TS.make_one_hot(_t(seg), segments)
    assert np.array_equal(t_oh.numpy(), np.asarray(j_oh))
    want = np.asarray(JS.seg_sum_partials(jnp.asarray(v), jnp.asarray(seg),
                                          segments, n_limbs, one_hot=j_oh))
    got = TS.seg_sum_partials(_t(v), _t(seg), segments, n_limbs,
                              one_hot=t_oh)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,segments", [(100, 1), (50000, 5), (12345, 9)])
def test_float_seg_sums_close(n, segments):
    rng = np.random.default_rng(n)
    # positive values: the tolerance is relative to the sum, so sums must
    # not cancel
    v = (rng.random(n) * 1000).astype(np.float32)
    seg = rng.integers(-1, segments, n).astype(np.int32)
    want = np.asarray(JS.float_seg_sums(jnp.asarray(v), jnp.asarray(seg),
                                        segments))
    got = TS.float_seg_sums(_t(v), _t(seg), segments)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(TS.combine_float(got.numpy()),
                               JS.combine_float(want), rtol=1e-6)


def test_merge_additive_equal():
    rng = np.random.default_rng(5)
    parts = [rng.integers(-(2**31), 2**31 - 1, (3, 2, 11)).astype(np.int32)
             for _ in range(4)]
    assert np.array_equal(TS.merge_additive(parts), JS.merge_additive(parts))


# ---- eval --------------------------------------------------------------------

_DEC2 = FieldType(TypeKind.DECIMAL, flen=15, scale=2, nullable=False)
_DEC2N = FieldType(TypeKind.DECIMAL, flen=15, scale=2)
_DEC1 = FieldType(TypeKind.DECIMAL, flen=18, scale=1)
_DEC0 = FieldType(TypeKind.DECIMAL, flen=18, scale=0)
_BIG = FieldType(TypeKind.BIGINT)
_BIGNN = FieldType(TypeKind.BIGINT, nullable=False)
_DATE = FieldType(TypeKind.DATE, nullable=False)
_DBL = FieldType(TypeKind.DOUBLE)
_BOOL = FieldType(TypeKind.BOOLEAN)

QTY, PRICE, DISC, SHIP = (Col(0, _DEC2, "qty"), Col(1, _DEC2, "price"),
                          Col(2, _DEC2, "disc"), Col(3, _DATE, "ship"))
SDEC, INT, DIV, DBL = (Col(4, _DEC2N, "sdec"), Col(5, _BIG, "i"),
                       Col(6, _BIG, "d"), Col(7, _DBL, "x"))


def _columns(n=3000, seed=11):
    """Staged device columns (int32 / f32) and validity, as numpy."""
    rng = np.random.default_rng(seed)
    cols = [
        (rng.integers(100, 5001, n), None),            # qty, scale 2
        (rng.integers(90000, 1_000_000, n), None),     # price
        (rng.integers(0, 11, n), None),                # disc
        (rng.integers(8000, 10600, n), None),          # ship (days)
        (rng.integers(-99999, 99999, n), rng.random(n) > 0.1),  # sdec
        (rng.integers(-1000, 1000, n), rng.random(n) > 0.2),    # i
        (rng.integers(-3, 4, n), rng.random(n) > 0.1),  # d (zeros too)
        (rng.normal(0, 100, n), rng.random(n) > 0.1),   # x
    ]
    out = []
    for data, valid in cols:
        dt = np.float32 if data.dtype.kind == "f" else np.int32
        out.append((data.astype(dt),
                    np.ones(n, bool) if valid is None else valid))
    return out


def _b(op, *args, extra=None):
    return Call(op, list(args), _BOOL, extra)


def _dec(op, a, b, ft):
    return Call(op, [a, b], ft)


EXPRS = {
    "q6_ship_ge": _b("ge", SHIP, Const(8766, _DATE)),
    "q6_and": _b("and", _b("lt", QTY, Const(2400, _DEC2)),
                 _b("ge", DISC, Const(5, _DEC2))),
    "kleene_or": _b("or", _b("isnull", SDEC), _b("gt", INT, Const(0, _BIG))),
    "kleene_and_null": _b("and", _b("gt", INT, Const(10, _BIG)),
                          _b("lt", SDEC, Const(0, _DEC2N))),
    "not": _b("not", _b("eq", INT, Const(7, _BIG))),
    "cmp_scale_align": _b("lt", QTY, Const(24, _BIGNN)),
    "cmp_float": _b("lt", QTY, DBL),
    "in_values": _b("in_values", INT, extra=[1, 2, 3, -5]),
    "q1_disc_price": _dec("mul", PRICE, _dec(
        "sub", Const(1, _BIGNN), DISC, FieldType(TypeKind.DECIMAL, 18, 2)),
        FieldType(TypeKind.DECIMAL, 18, 4)),
    "q1_one_plus_tax": _dec("add", Const(1, _BIGNN), DISC,
                            FieldType(TypeKind.DECIMAL, 18, 2)),
    "dec_add_int": _dec("add", SDEC, INT, FieldType(TypeKind.DECIMAL, 18, 2)),
    "shr15": Call("shr15", [PRICE], _DEC2),
    "and15": Call("and15", [PRICE], _DEC2),
    "cast_dec_down": Call("cast", [SDEC], _DEC1),
    "cast_dec_int": Call("cast", [SDEC], _BIG),
    "cast_int_dec": Call("cast", [INT], FieldType(TypeKind.DECIMAL, 18, 2)),
    "cast_dbl_dec": Call("cast", [DBL], FieldType(TypeKind.DECIMAL, 18, 2)),
    "cast_dbl_int": Call("cast", [DBL], _BIG),
    "cast_dec_dbl": Call("cast", [SDEC], _DBL),
    "intdiv": Call("intdiv", [INT, DIV], _BIG),
    "mod": Call("mod", [INT, DIV], _BIG),
    "div_float": Call("div", [DBL, INT], _DBL),
    "mul_float": Call("mul", [DBL, SDEC], _DBL),
    "neg_abs": Call("abs", [Call("neg", [SDEC], _DEC2N)], _DEC2N),
    "case": Call("case", [_b("gt", INT, Const(0, _BIG)), PRICE,
                          _b("isnull", SDEC), Const(5, _DEC0), SDEC],
                 FieldType(TypeKind.DECIMAL, 18, 2)),
    "case_no_else": Call("case", [_b("gt", INT, Const(0, _BIG)), INT], _BIG),
    "if": Call("if", [_b("isnull", SDEC), Const(0, _DEC0), SDEC],
               FieldType(TypeKind.DECIMAL, 18, 2)),
    "ifnull": Call("ifnull", [SDEC, QTY], FieldType(TypeKind.DECIMAL, 18, 2)),
    "coalesce": Call("coalesce", [INT, Const(None, _BIG), Const(9, _BIG)],
                     _BIG),
    "year": Call("year", [SHIP], _BIG),
    "month": Call("month", [SHIP], _BIG),
    "day": Call("day", [SHIP], _BIG),
    "date_add": Call("date_add_days", [SHIP], _DATE, 30),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_eval_expr_equal(name):
    e = EXPRS[name]
    cols = _columns()
    jv, jvl = JE.eval_expr(e, [(jnp.asarray(d), jnp.asarray(v))
                               for d, v in cols], {})
    tv, tvl = TE.eval_expr(request_from_reference(e),
                           [(_t(d), _t(v)) for d, v in cols], {})
    jv, jvl = np.asarray(jv), np.asarray(jvl)
    assert tv.numpy().dtype == jv.dtype, (tv.dtype, jv.dtype)
    assert np.array_equal(tvl.numpy(), jvl)
    assert np.array_equal(tv.numpy(), jv)


def test_selection_mask_q6_equal():
    conds = [
        _b("ge", SHIP, Const(8766, _DATE)), _b("lt", SHIP, Const(9131, _DATE)),
        _b("ge", DISC, Const(5, _DEC2)), _b("le", DISC, Const(7, _DEC2)),
        _b("lt", QTY, Const(2400, _DEC2)), _b("ne", INT, Const(3, _BIG)),
    ]
    cols = _columns(seed=4)
    base = np.random.default_rng(2).random(len(cols[0][0])) > 0.05
    want = JE.selection_mask(conds, [(jnp.asarray(d), jnp.asarray(v))
                                     for d, v in cols], {}, jnp.asarray(base))
    got = TE.selection_mask(request_from_reference(conds),
                            [(_t(d), _t(v)) for d, v in cols], {}, _t(base))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_decimal_division_is_not_on_device_in_both():
    e = Call("div", [SDEC, QTY], FieldType(TypeKind.DECIMAL, 18, 6))
    cols = _columns(n=10)
    with pytest.raises(JE.CompileError):
        JE.eval_expr(e, [(jnp.asarray(d), jnp.asarray(v)) for d, v in cols],
                     {})
    with pytest.raises(TE.CompileError, match="decimal division"):
        TE.eval_expr(request_from_reference(e),
                     [(_t(d), _t(v)) for d, v in cols], {})
