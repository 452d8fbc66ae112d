"""The port's host expression evaluator against the JAX package's.

`tidb_tpu_torch/copr/npeval.py` is the port's own copy of
`tidb_tpu/copr/npeval.py`. The coprocessor runs it on the host for two
things: the row path's projections and the build filters of semi/anti
edges. Every op the planner pushes down (`_DEVICE_OPS` of
`tidb_tpu/plan/physical.py`) is evaluated here by both over one seeded
corpus: BIGINTs with NULLs and zeros, decimals of two scales, a double,
dates, and dictionary strings in two dictionaries, in the numeric and the
string domain (`eval_str`) alike; so are registry builtins (`fx:` ops) on
the row-wise and the dictionary path, with their row-eval counts.
Expressions are built with the reference's classes and carried over with
`convert`.

Tolerance: exact. Values (every lane, NULL lanes included) and validity
must be identical arrays.
"""

import numpy as np
import pytest

from tidb_tpu.chunk.column import Dictionary as RefDictionary
from tidb_tpu.copr.npeval import NumpyEval as RefNumpyEval
from tidb_tpu.plan.expr import Call, Col, Const, arith_result_type, bool_call
from tidb_tpu.types.field_type import FieldType, TypeKind
from tidb_tpu_torch.chunk.column import Dictionary
from tidb_tpu_torch.convert import request_from_reference
from tidb_tpu_torch.copr.npeval import NumpyEval

N = 4000
BIGINT = FieldType(TypeKind.BIGINT)
DEC2 = FieldType(TypeKind.DECIMAL, flen=15, scale=2)
DEC4 = FieldType(TypeKind.DECIMAL, flen=15, scale=4)
DOUBLE = FieldType(TypeKind.DOUBLE)
DATE = FieldType(TypeKind.DATE)
STR = FieldType(TypeKind.VARCHAR, flen=10)
WORDS_A = ["apple", "banana", "cherry", "apricot", "b_x", "Apple"]
WORDS_B = ["cherry", "date", "apple", "fig"]

# corpus columns: (name, type)
A, B, X, Y, F, D, S1, S2 = (Col(i, ft, nm) for i, (nm, ft) in enumerate([
    ("a", BIGINT), ("b", BIGINT), ("x", DEC2), ("y", DEC4), ("f", DOUBLE),
    ("d", DATE), ("s1", STR), ("s2", STR)]))


def _corpus():
    """(columns as (data, valid) pairs, dictionary values per column)."""
    rng = np.random.default_rng(17)
    cols = [
        rng.integers(-50, 51, N),                      # a: zeros, signs
        rng.integers(-7, 8, N),                        # b: divisor, zeros
        rng.integers(-99_999, 100_000, N),             # x: decimal(15,2)
        rng.integers(-9_999_999, 10_000_000, N),       # y: decimal(15,4)
        np.round(rng.normal(0, 100, N), 3),            # f: double
        rng.integers(8000, 11000, N).astype(np.int32),  # d: days
        rng.integers(0, len(WORDS_A), N),              # s1: codes
        rng.integers(0, len(WORDS_B), N),              # s2: codes
    ]
    cols[4][::97] = 0.0
    valids = [rng.random(N) > p for p in (0.1, 0.15, 0.1, 0.2, 0.1, 0.1,
                                          0.1, 0.2)]
    dict_values = [None] * 6 + [WORDS_A, WORDS_B]
    return list(zip(cols, valids)), dict_values


def _const(v, ft):
    return Const(v, ft)


def _arith(op, a, b):
    return Call(op, [a, b], arith_result_type(op, a.ftype, b.ftype))


def _gt0(e):
    return bool_call("gt", [e, _const(0, e.ftype)])


# name: (expression over the corpus, domain): "num" -> eval, "str" -> eval_str
EXPRS = {
    "add_int": (_arith("add", A, B), "num"),
    "add_two_scales": (_arith("add", X, Y), "num"),
    "add_float": (_arith("add", X, F), "num"),
    "sub_int_decimal": (_arith("sub", X, A), "num"),
    "sub_const_decimal": (_arith("sub", _const(1, BIGINT), X), "num"),
    "mul_two_scales": (_arith("mul", X, Y), "num"),
    "mul_float": (_arith("mul", A, F), "num"),
    "div_decimal": (_arith("div", X, Y), "num"),
    "div_int": (_arith("div", A, B), "num"),
    "div_float": (_arith("div", F, A), "num"),
    "intdiv": (_arith("intdiv", A, B), "num"),
    "mod": (_arith("mod", A, B), "num"),
    "neg": (Call("neg", [X], DEC2), "num"),
    "abs": (Call("abs", [A], BIGINT), "num"),
    "eq_int": (bool_call("eq", [A, B]), "num"),
    "ne_scales": (bool_call("ne", [X, Y]), "num"),
    "lt_int_decimal": (bool_call("lt", [A, X]), "num"),
    "le_float_decimal": (bool_call("le", [F, X]), "num"),
    "gt_date": (bool_call("gt", [D, _const(9500, DATE)]), "num"),
    "ge_decimal_const": (bool_call("ge", [Y, _const(12345, DEC2)]), "num"),
    "eq_string_const": (bool_call("eq", [S1, _const("cherry", STR)]),
                        "num"),
    "ne_string_missing": (bool_call("ne", [S1, _const("zzz", STR)]), "num"),
    "eq_two_dictionaries": (bool_call("eq", [S1, S2]), "num"),
    "lt_string_order": (bool_call("lt", [S1, _const("b", STR)]), "num"),
    "and": (bool_call("and", [_gt0(A), bool_call("lt", [B, _const(3,
                                                                  BIGINT)])]),
            "num"),
    "or": (bool_call("or", [_gt0(A), _gt0(X)]), "num"),
    "not": (bool_call("not", [_gt0(B)]), "num"),
    "isnull_int": (bool_call("isnull", [A]), "num"),
    "isnull_string": (bool_call("isnull", [S1]), "num"),
    "in_values_int": (bool_call("in_values", [A], [0, 3, -7, 50, 99]),
                      "num"),
    "in_values_string": (bool_call("in_values", [S1],
                                   ["apple", "fig", "cherry"]), "num"),
    "like_prefix": (bool_call("like", [S1], "ap%"), "num"),
    "like_underscore": (bool_call("like", [S1], "b\\_%"), "num"),
    "like_any": (bool_call("like", [S2], "%a%"), "num"),
    "if_numeric": (Call("if", [_gt0(A), X, _arith("sub", X, X)], DEC2),
                   "num"),
    "ifnull_numeric": (Call("ifnull", [A, B], BIGINT), "num"),
    "coalesce_numeric": (Call("coalesce", [A, B, _const(-1, BIGINT)],
                              BIGINT), "num"),
    "case_else": (Call("case", [_gt0(A), _const(1, BIGINT), _gt0(B),
                                _const(2, BIGINT), _const(3, BIGINT)],
                       BIGINT), "num"),
    "case_no_else": (Call("case", [_gt0(X), Y], DEC4), "num"),
    "if_string": (Call("if", [_gt0(A), S1, S2], STR), "str"),
    "ifnull_string": (Call("ifnull", [S1, S2], STR), "str"),
    "coalesce_string": (Call("coalesce", [S1, S2, _const("zz", STR)], STR),
                        "str"),
    "case_string": (Call("case", [_gt0(B), S2, _gt0(A), S1,
                                  _const("none", STR)], STR), "str"),
    "year": (Call("year", [D], BIGINT), "num"),
    "month": (Call("month", [D], BIGINT), "num"),
    "day": (Call("day", [D], BIGINT), "num"),
    "date_add_days": (Call("date_add_days", [D], DATE, 30), "num"),
    "cast_decimal_down": (Call("cast", [Y], DEC2), "num"),
    "cast_decimal_up": (Call("cast", [X], DEC4), "num"),
    "cast_int_decimal": (Call("cast", [A], DEC2), "num"),
    "cast_float_decimal": (Call("cast", [F], DEC2), "num"),
    "cast_decimal_int": (Call("cast", [X], BIGINT), "num"),
    "cast_float_int": (Call("cast", [F], BIGINT), "num"),
    "cast_int_double": (Call("cast", [A], DOUBLE), "num"),
    "cast_decimal_double": (Call("cast", [Y], DOUBLE), "num"),
}


@pytest.fixture(scope="module")
def evaluators():
    cols, dict_values = _corpus()
    ref = RefNumpyEval(cols, [None if v is None else RefDictionary(v)
                              for v in dict_values], N)
    port = NumpyEval(cols, [None if v is None else Dictionary(v)
                            for v in dict_values], N)
    return ref, port


def test_corpus_covers_every_device_op():
    ops = set()

    def walk(e):
        if isinstance(e, Call):
            ops.add(e.op)
            for a in e.args:
                walk(a)
    for e, _ in EXPRS.values():
        walk(e)
    device_ops = set("""add sub mul div intdiv mod neg abs eq ne lt le gt ge
                        and or not isnull in_values like if ifnull coalesce
                        case year month day date_add_days cast""".split())
    assert device_ops <= ops


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_numpy_eval_matches_reference(evaluators, name):
    ref, port = evaluators
    e, domain = EXPRS[name]
    pe = request_from_reference(e)
    if domain == "str":
        want, got = ref.eval_str(e), port.eval_str(pe)
    else:
        want, got = ref.eval(e), port.eval(pe)
    (wv, wvl), (gv, gvl) = want, got
    wv, gv = np.asarray(wv), np.asarray(gv)
    assert gv.dtype == wv.dtype and gv.shape == wv.shape == (N,)
    assert np.array_equal(gv, wv)
    assert np.array_equal(np.asarray(gvl), np.asarray(wvl))
    assert np.asarray(gvl).any()


def _fx(name, args, ftype):
    return Call(f"fx:{name}", args, ftype)


# registry builtins (fx: ops, copr/funcs.py): row-wise, dictionary-
# vectorized (SUBSTRING_INDEX, REGEXP_LIKE over one dictionary column and
# constants) and the exact decimal domain (MOD returns its arg0 type)
FX_EXPRS = {
    "soundex": (_fx("SOUNDEX", [S1], STR), "str"),
    "substring_index_dict": (_fx("SUBSTRING_INDEX", [
        S1, _const("p", STR), _const(1, BIGINT)], STR), "str"),
    "regexp_like_dict": (_fx("REGEXP_LIKE", [S2, _const("^[cd]", STR)],
                             BIGINT), "num"),
    "mod_decimal": (_fx("MOD", [X, _const(700, DEC2)], DEC2), "num"),
    "format_decimal": (_fx("FORMAT", [Y, _const(2, BIGINT)], STR), "str"),
    "date_format": (_fx("DATE_FORMAT", [D, _const("%Y-%m", STR)], STR),
                    "str"),
    "conv_int": (_fx("CONV", [A, _const(10, BIGINT), _const(16, BIGINT)],
                     STR), "str"),
    "degrees_float": (_fx("DEGREES", [F], DOUBLE), "num"),
}


@pytest.mark.parametrize("name", sorted(FX_EXPRS))
def test_registry_builtin_matches_reference(evaluators, name):
    """Both evaluators give the same lanes, and count the same rows on
    their registry row-eval counter (0 on the dictionary path)."""
    from tidb_tpu import obs as ref_obs
    from tidb_tpu_torch import obs

    ref, port = evaluators
    e, domain = FX_EXPRS[name]
    fn = e.op[3:]
    before = (ref_obs.REGISTRY_ROW_EVALS.get(func=fn),
              obs.REGISTRY_ROW_EVALS.get(func=fn))
    pe = request_from_reference(e)
    if domain == "str":
        want, got = ref.eval_str(e), port.eval_str(pe)
    else:
        want, got = ref.eval(e), port.eval(pe)
    (wv, wvl), (gv, gvl) = want, got
    wv, gv = np.asarray(wv), np.asarray(gv)
    assert gv.dtype == wv.dtype and gv.shape == wv.shape == (N,)
    assert np.array_equal(gv, wv)
    assert np.array_equal(np.asarray(gvl), np.asarray(wvl))
    assert np.asarray(gvl).any()
    rows = (ref_obs.REGISTRY_ROW_EVALS.get(func=fn) - before[0],
            obs.REGISTRY_ROW_EVALS.get(func=fn) - before[1])
    assert rows[0] == rows[1]
    assert rows[1] == (0 if name.endswith("_dict") else N)