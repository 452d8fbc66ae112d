"""tidb_tpu_torch sumexact and eval vs the JAX reference's, on the CPU.

The same numpy inputs (made from a seed) go through the reference's jnp
function and the port's torch function. The einsum strategy's partials
are held to the reference's one-hot product and to the port's own former
one-hot product (up to 8,192 segments, masked rows included), and TPC-H
Q7, the request that takes that strategy at SF1, to the reference: its
hand-built fragment, its rows at SF0.01, and its gate decision at SF1's
row count.

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

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.bench.tpch_data import load_tpch
from tidb_tpu.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu.copr import client as JC
from tidb_tpu.copr import eval as JE
from tidb_tpu.copr import fragment as JF
from tidb_tpu.copr import sumexact as JS
from tidb_tpu.plan.expr import Call, Col, Const
from tidb_tpu.session import Session
from tidb_tpu.types.field_type import FieldType, TypeKind
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.convert import (request_from_reference,
                                    snapshot_from_reference)
from tidb_tpu_torch.copr import eval as TE
from tidb_tpu_torch.copr import fragment as PF
from tidb_tpu_torch.copr import sumexact as TS
from tidb_tpu_torch.copr.client import CopClient


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
    # values inside what n_limbs covers (bounds.limbs_for's contract); the
    # reference's one-hot product against the port's blocked scatter-add
    half = 2 ** (12 * n_limbs - 2)
    v, seg = _seg_inputs(n + 1, n, segments, -half, half)
    j_oh = JS.make_one_hot(jnp.asarray(seg), segments)
    want = np.asarray(JS.seg_sum_partials(jnp.asarray(v), jnp.asarray(seg),
                                          segments, n_limbs, one_hot=j_oh))
    got = TS.seg_sum_partials(_t(v), _t(seg), segments, n_limbs, "einsum")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _one_hot_einsum(v, seg, segments, n_limbs):
    """The port's einsum strategy before it stopped building a one-hot:
    f32[blocks, 2048, segments] one-hot, one full-f32 product per limb."""
    n = v.shape[0]
    nblk = -(-n // TS.EINSUM_BLOCK)
    pad = nblk * TS.EINSUM_BLOCK - n
    seg2 = TS._pad1(seg, pad, -1).reshape(nblk, TS.EINSUM_BLOCK)
    one_hot = (seg2[..., None] == torch.arange(segments, dtype=seg.dtype)
               ).to(torch.float32)
    outs = []
    for li in TS.limbs_of(v, n_limbs):
        lb = TS._pad1(li.to(torch.float32), pad).reshape(nblk,
                                                          TS.EINSUM_BLOCK)
        outs.append(TS._two_level(torch.einsum("cb,cbk->ck", lb, one_hot)))
    return torch.stack(outs)


@pytest.mark.parametrize("n,segments,n_limbs", [
    (3000, 65, 1), (4097, 2500, 3), (6144, 5408, 2), (2049, 8192, 3)])
def test_einsum_partials_equal_the_one_hot_product(n, segments, n_limbs):
    # every block gets rows of segment -1 (masked), full-width limbs, and
    # blocks whose rows all land in few segments (the largest per-cell sums)
    rng = np.random.default_rng(segments)
    half = min(2 ** (12 * n_limbs - 2), 2**30)  # int32 values
    v = rng.integers(-half, half, n).astype(np.int32)
    seg = rng.integers(-1, segments, n).astype(np.int32)
    seg[: n // 3] = rng.integers(-1, 3, n // 3)
    v[: n // 3] = half - 1
    want = _one_hot_einsum(_t(v), _t(seg), segments, n_limbs)
    got = TS.seg_sum_partials(_t(v), _t(seg), segments, n_limbs, "einsum")
    assert torch.equal(got, want)
    assert np.array_equal(
        got.numpy(), np.asarray(JS.seg_sum_partials(
            jnp.asarray(v), jnp.asarray(seg), segments, n_limbs,
            one_hot=JS.make_one_hot(jnp.asarray(seg), segments))))


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


# ---- TPC-H Q7: the request that takes the einsum strategy at SF1 ------------

@pytest.fixture(scope="module")
def q7_call():
    """(reference fragment, snapshots, answer) of TPC-H Q7 at SF0.01."""
    s = Session()
    load_tpch(s, sf=0.01, seed=42)
    calls = []
    run = JF.execute_fragment

    def frag_call(cop, frag, snaps):
        r = run(cop, frag, snaps)
        calls.append((frag, snaps, r))
        return r

    with mock.patch.object(JF, "execute_fragment", frag_call):
        s.query(TPCH_QUERIES["q7"])
    assert len(calls) == 1
    return calls[0]


def _blank_agg_names(frag):
    """AggDesc.name is the SQL text of the call, for display only."""
    agg = dataclasses.replace(frag.agg, aggs=[
        dataclasses.replace(d, name="") for d in frag.agg.aggs])
    return dataclasses.replace(frag, agg=agg)


def test_q7_frag_matches_reference(q7_call):
    # at SF0.01 the 5,408-slot space holds ~11 rows a slot: the sparse
    # gate sends it to the sorted-run group mode, in both packages
    frag, snaps, ref = q7_call
    assert ref.engine == "device[group]"
    tables = {}
    for t in frag.tables:
        tables[t.table.name] = TR.tpch_table(t.table.name, t.table.id,
                                             t.table.columns[0].id)
    built = TR.q7_frag(tables)
    assert _blank_agg_names(built) == \
        _blank_agg_names(request_from_reference(frag))
    psnaps = {tid: snapshot_from_reference(s) for tid, s in snaps.items()}
    got = PF.execute_fragment(CopClient("cpu"), built, psnaps)
    assert got.engine == ref.engine
    rows = TR.partial_rows(got.chunks)
    assert rows and rows == TR.partial_rows(ref.chunks)
    assert rows == TR.q7_oracle(TD.generate_tpch(0.01, 42))


def test_q7_at_sf1_rows_takes_the_einsum_as_reference(q7_call):
    # lineitem repeated 100 times (SF1's ~6M rows; every bound the same):
    # >= 128 rows a slot, so the dense gate keeps the 5,408-slot einsum.
    # Both packages decide it in their gates; the programs do not run
    frag, snaps, _ = q7_call
    probe = frag.tables[0]
    li = snaps[probe.table.id]
    n = li.epoch.num_rows * 100
    cols = [np.tile(c, 100) if off in probe.col_offsets
            else np.zeros(n, c.dtype)
            for off, c in enumerate(li.epoch.columns)]
    epoch = dataclasses.replace(
        li.epoch, handles=np.arange(1, n + 1, dtype=np.int64), columns=cols,
        valids=[None] * len(cols), handle_pos=None)
    snaps = dict(snaps)
    snaps[probe.table.id] = dataclasses.replace(
        li, epoch=epoch, base_visible=np.ones(n, bool))
    seen = {}

    def no_run(cop, frag_, snaps_, prepared, spans, builds, mode, **kw):
        seen["mode"], seen["prepared"] = mode, prepared
        return []

    with mock.patch.object(JF, "_run_frag_batch", no_run):
        ref = JF.execute_fragment(JC.CopClient(), frag, snaps)
    assert ref.engine == "device[agg]" and seen["mode"] == "agg"
    assert seen["prepared"]["__strategy__"] == "einsum"
    seen.clear()
    with mock.patch.object(PF, "_run_frag_batch", no_run):
        got = PF.execute_fragment(
            CopClient("cpu"), request_from_reference(frag),
            {tid: snapshot_from_reference(s) for tid, s in snaps.items()})
    assert got.engine == ref.engine and seen["mode"] == "agg"
    prepared = seen["prepared"]
    assert prepared["__strategy__"] == "einsum"
    assert int(np.prod(prepared["__dense_cards__"])) == 5408
