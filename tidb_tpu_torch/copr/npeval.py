"""NumpyEval: vectorized host-side expression evaluation.

Port of `tidb_tpu/copr/npeval.py`, the numpy twin of copr/eval.py. The
coprocessor evaluates two things on the host with it, exactly as the
reference does: the row path's projections over the selected rows
(`client._host_rows`) and the build-side filters of semi/anti membership
edges (`fragment._semi_build_facts`). Both are host work on purpose: a build
filter never faces a device gate, and a projection reads only the selected
rows. Every op keeps the reference's semantics (three-valued logic, LIKE and
IN over dictionary codes, decimal scale alignment, MySQL `DIV`/`MOD` signs,
date parts, casts).

The registry builtins (`fx:` ops, `copr/funcs.py`) evaluate here too, on the
root's rows: pushdown never sends one to the coprocessor (the planner's
device op set has no `fx:` op). A call whose one string argument is a
dictionary-coded column and whose other arguments are constants runs once
per dictionary value and gathers by code (`_dict_vec_call`); every other
call runs row by row (`_registry_call`) and counts its rows on
`obs.REGISTRY_ROW_EVALS`. DECIMAL arguments reach the builtin as exact
`decimal.Decimal`s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..chunk.column import Dictionary
from ..plan.expr import Call, Col, Const, PlanExpr
from ..types.field_type import FieldType, TypeKind

VV = tuple[np.ndarray, np.ndarray]


class NumpyEval:
    """Evaluates resolved expressions over (data, valid) numpy column pairs."""

    def __init__(
        self,
        cols: list[VV],
        dicts: list[Optional[Dictionary]],
        n: int,
    ) -> None:
        self.cols = cols
        self.dicts = dicts
        self.n = n

    # ---- string-domain evaluation -------------------------------------------
    def _registry_call(self, e: Call) -> VV:
        """Breadth-layer builtins (copr/funcs.py): rowwise Python with
        the registry's NULL semantics; args arrive in their natural
        domains (str / day-number int / EXACT stdlib decimal.Decimal for
        DECIMAL columns / int). The reference keeps exact MyDecimal
        semantics through every builtin (types/mydecimal.go): a float
        round trip would lose precision silently."""
        import decimal as _pydec

        from .. import obs
        from .funcs import REGISTRY

        fd = REGISTRY[e.op[3:]]
        vec = self._dict_vec_call(e, fd)
        if vec is not None:
            return vec
        # the de-vectorization tax, attributed per function (the
        # reference surfaces it through metrics_schema and its
        # registry-row-eval inspection rule)
        obs.REGISTRY_ROW_EVALS.inc(self.n, func=fd.name)
        arg_vv = []
        for a in e.args:
            if a.ftype.is_string:
                v, vl = self.eval_str(a)
                dec_scale = None
            else:
                v, vl = self.eval(a)
                v = np.asarray(v)
                dec_scale = a.ftype.scale if a.ftype.is_decimal else None
            arg_vv.append((v, np.asarray(vl), dec_scale))
        n = self.n
        out = np.empty(n, dtype=object)
        valid = np.zeros(n, bool)
        for i in range(n):
            vals = []
            has_null = False
            for v, vl, dec_scale in arg_vv:
                if vl[i]:
                    x = v[i]
                    x = x.item() if hasattr(x, "item") else x
                    if dec_scale is not None:
                        # exact: unscaled int / 10**scale in the decimal
                        # domain, no float round trip
                        x = _pydec.Decimal(int(x)).scaleb(-dec_scale)
                    vals.append(x)
                else:
                    vals.append(None)
                    has_null = True
            if has_null and fd.null_prop:
                continue
            try:
                r = fd.fn(*vals)
            except (ValueError, TypeError, OverflowError,
                    ZeroDivisionError):
                r = None
            if r is not None:
                out[i] = r
                valid[i] = True
        return self._coerce_registry(e, fd, out, valid)

    def _dict_vec_call(self, e: Call, fd) -> Optional[VV]:
        """Dictionary-vectorized registry call: when the ONE string
        argument is a plain dict-coded column and every other argument
        is a constant, evaluate the builtin once per DISTINCT dictionary
        value and gather per row by code — len(dict) Python calls
        instead of n (the de-vectorization the registry-row-eval rule
        watches). Returns None when the shape doesn't apply and the
        per-row path must run."""
        import decimal as _pydec

        if not fd.dict_vec or not fd.null_prop:
            return None
        col_pos = None
        consts: dict[int, object] = {}
        for i, a in enumerate(e.args):
            if isinstance(a, Col) and a.ftype.is_string:
                if col_pos is not None:
                    return None  # two string columns: no single domain
                col_pos = i
            elif isinstance(a, Const):
                if a.value is None:
                    return None  # NULL const: per-row path propagates
                if a.ftype.is_string:
                    consts[i] = str(a.value)
                elif a.ftype.is_decimal:
                    consts[i] = _pydec.Decimal(
                        int(a.value)).scaleb(-a.ftype.scale)
                elif isinstance(a.value, (int, float, bool)):
                    consts[i] = a.value
                else:
                    return None
            else:
                return None
        if col_pos is None:
            return None
        c = e.args[col_pos]
        d = self.dicts[c.idx] if c.idx < len(self.dicts) else None
        if d is None or len(d) == 0 or len(d) > max(self.n, 1):
            return None  # fewer rows than values: per-row is cheaper
        codes, vl = self.cols[c.idx]
        dvals = np.empty(len(d), dtype=object)
        dok = np.zeros(len(d), bool)
        args = [consts.get(i) for i in range(len(e.args))]
        for ci, sval in enumerate(d.values):
            args[col_pos] = sval
            try:
                r = fd.fn(*args)
            except (ValueError, TypeError, OverflowError,
                    ZeroDivisionError):
                r = None
            if r is not None:
                dvals[ci] = r
                dok[ci] = True
        safe = np.clip(codes, 0, len(d) - 1)
        out = dvals[safe]
        valid = np.asarray(vl) & dok[safe]
        out = np.where(valid, out, None)
        return self._coerce_registry(e, fd, out, valid)

    def _coerce_registry(self, e: Call, fd, out: np.ndarray,
                         valid: np.ndarray) -> VV:
        """Registry results (object array) -> the typed (data, valid)
        pair per the FuncDef's declared return domain."""
        import decimal as _pydec

        n = self.n
        if fd.ret == "str":
            # string consumers read through eval_str (object array)
            for i in range(n):
                if not valid[i]:
                    out[i] = ""
            return out, valid
        idx = np.nonzero(valid)[0]
        if fd.ret == "float" or (fd.ret == "arg0" and e.ftype.is_float):
            arr = np.zeros(n, np.float64)
            if len(idx):
                arr[idx] = [float(out[i]) for i in idx]
        elif fd.ret == "arg0" and e.ftype.is_decimal:
            # exact fixed-point: Decimal/int results rescale without a
            # float round trip (MySQL half-away-from-zero on narrowing);
            # float results (float-natured fns) round at their precision
            import decimal as _pydec

            arr = np.zeros(n, np.int64)
            if len(idx):
                m = e.ftype.scale

                def _fix(r):
                    if isinstance(r, float):
                        r = _pydec.Decimal(repr(r))
                    elif not isinstance(r, _pydec.Decimal):
                        r = _pydec.Decimal(int(r))
                    return int(r.scaleb(m).to_integral_value(
                        rounding=_pydec.ROUND_HALF_UP))

                arr[idx] = [_fix(out[i]) for i in idx]
        else:
            arr = np.zeros(n, np.int64)
            if len(idx):
                arr[idx] = [int(out[i]) for i in idx]
        return arr, valid

    def eval_str(self, e: PlanExpr) -> VV:
        """Evaluate a string-typed expression to (object array of str, valid).

        Used when the value crosses dictionary domains (CASE branches,
        IFNULL over different columns, literals) — the caller re-encodes the
        result into a fresh dictionary."""
        if isinstance(e, Col):
            codes, vl = self.cols[e.idx]
            d = self.dicts[e.idx]
            if d is None or len(d) == 0:
                return np.full(self.n, "", dtype=object), \
                    np.zeros(self.n, bool) if d is None else vl
            vals = np.array(d.values, dtype=object)
            return vals[np.clip(codes, 0, len(d) - 1)], vl
        if isinstance(e, Const):
            if e.value is None:
                return (np.full(self.n, "", dtype=object),
                        np.zeros(self.n, bool))
            return (np.full(self.n, str(e.value), dtype=object),
                    np.ones(self.n, bool))
        assert isinstance(e, Call)
        op = e.op
        A = e.args
        if op.startswith("fx:"):
            return self._registry_call(e)
        if op == "if":
            cv, cvl = _b(self.eval(A[0]))
            tv, tvl = self.eval_str(A[1])
            fv, fvl = self.eval_str(A[2])
            cond = cv & cvl
            return np.where(cond, tv, fv), np.where(cond, tvl, fvl)
        if op == "ifnull":
            av, avl = self.eval_str(A[0])
            bv, bvl = self.eval_str(A[1])
            return np.where(avl, av, bv), avl | bvl
        if op == "coalesce":
            out_v, out_vl = self.eval_str(A[0])
            for a in A[1:]:
                av, avl = self.eval_str(a)
                out_v = np.where(out_vl, out_v, av)
                out_vl = out_vl | avl
            return out_v, out_vl
        if op == "case":
            has_else = len(A) % 2 == 1
            pairs = (len(A) - 1) // 2 if has_else else len(A) // 2
            if has_else:
                out_v, out_vl = self.eval_str(A[-1])
                out_v = np.array(out_v, copy=True)
                out_vl = np.array(out_vl, copy=True)
            else:
                out_v = np.full(self.n, "", dtype=object)
                out_vl = np.zeros(self.n, bool)
            decided = np.zeros(self.n, bool)
            for i in range(pairs):
                cv, cvl = _b(self.eval(A[2 * i]))
                tv, tvl = self.eval_str(A[2 * i + 1])
                take = cv & cvl & ~decided
                out_v = np.where(take, tv, out_v)
                out_vl = np.where(take, tvl, out_vl)
                decided |= take
            return out_v, out_vl
        if op == "substring":
            av, avl = self.eval_str(A[0])
            start, length = e.extra
            out = np.empty(self.n, dtype=object)
            for i, s in enumerate(av):
                out[i] = _substring(s, start, length)
            return out, avl
        if op in ("greatest", "least"):
            # string-domain comparison (numeric GREATEST lives in _call)
            fn = max if op == "greatest" else min
            parts = [self.eval_str(a) for a in A]
            valid = parts[0][1].copy()
            for _, vl in parts[1:]:
                valid = valid & vl  # MySQL: any NULL -> NULL
            out = np.array([fn(p[0][i] for p in parts)
                            for i in range(self.n)], dtype=object)
            return out, valid
        if op in ("upper", "lower", "trim", "ltrim", "rtrim", "reverse"):
            av, avl = self.eval_str(A[0])
            fn = {"upper": str.upper, "lower": str.lower,
                  "trim": str.strip, "ltrim": str.lstrip,
                  "rtrim": str.rstrip,
                  "reverse": lambda s: s[::-1]}[op]
            return (np.array([fn(s) for s in av], dtype=object), avl)
        if op in ("concat", "concat_ws"):
            parts = [self._any_str(a) for a in A]
            n = self.n
            if op == "concat":
                # MySQL: any NULL argument -> NULL
                valid = parts[0][1].copy()
                for _, vl in parts[1:]:
                    valid = valid & vl
                out = np.array(
                    ["".join(p[0][i] for p in parts) for i in range(n)],
                    dtype=object)
                return out, valid
            sep, sep_ok = parts[0]
            out = np.empty(n, dtype=object)
            for i in range(n):
                out[i] = sep[i].join(p[0][i] for p in parts[1:]
                                     if p[1][i])  # NULL args skipped
            return out, sep_ok
        if op in ("left", "right", "repeat"):
            av, avl = self.eval_str(A[0])
            nv, nvl = self.eval(A[1])
            out = np.empty(self.n, dtype=object)
            for i, (s, k) in enumerate(zip(av, nv)):
                k = max(int(k), 0)
                out[i] = (s[:k] if op == "left" else
                          s[-k:] if (op == "right" and k) else
                          s * k if op == "repeat" else "")
            return out, avl & nvl
        if op == "replace":
            av, avl = self.eval_str(A[0])
            fv, fvl = self.eval_str(A[1])
            tv, tvl = self.eval_str(A[2])
            if any(a.ftype.is_ci for a in A):
                import re as _re
                out = np.array(
                    [_re.sub(_re.escape(f), t.replace("\\", "\\\\"), s,
                             flags=_re.IGNORECASE) if f else s
                     for s, f, t in zip(av, fv, tv)], dtype=object)
            else:
                out = np.array([s.replace(f, t) if f else s
                                for s, f, t in zip(av, fv, tv)],
                               dtype=object)
            return out, avl & fvl & tvl
        if op in ("lpad", "rpad"):
            av, avl = self.eval_str(A[0])
            nv, nvl = self.eval(A[1])
            pv, pvl = self.eval_str(A[2])
            out = np.empty(self.n, dtype=object)
            ok = avl & nvl & pvl
            for i, (s, k, p) in enumerate(zip(av, nv, pv)):
                k = int(k)
                if k < 0:  # MySQL: negative length -> NULL
                    out[i] = ""
                    ok[i] = False
                elif k < len(s):
                    out[i] = s[:k]
                elif not p:
                    out[i] = s if k <= len(s) else ""
                    ok[i] = ok[i] and k <= len(s)
                else:
                    pad = (p * ((k - len(s)) // len(p) + 1))[:k - len(s)]
                    out[i] = pad + s if op == "lpad" else s + pad
            return out, ok
        if op == "json_extract":
            av, avl = self.eval_str(A[0])
            out = np.full(self.n, "", dtype=object)
            ok = np.zeros(self.n, bool)
            for i, (s, v) in enumerate(zip(av, avl)):
                if not v:
                    continue
                r = _json_extract(s, str(e.extra))
                if r is not None:
                    out[i] = r
                    ok[i] = True
            return out, ok
        if op == "json_unquote":
            av, avl = self.eval_str(A[0])
            out = np.empty(self.n, dtype=object)
            for i, s in enumerate(av):
                out[i] = _json_unquote(s)
            return out, avl
        if op == "json_type":
            import json as _json

            av, avl = self.eval_str(A[0])
            out = np.full(self.n, "", dtype=object)
            ok = np.zeros(self.n, bool)
            for i, (s, v) in enumerate(zip(av, avl)):
                if not v:
                    continue
                try:
                    out[i] = _json_type_name(_json.loads(s))
                    ok[i] = True
                except ValueError:
                    pass
            return out, ok
        raise NotImplementedError(f"string eval: {op}")

    # ---- evaluation ---------------------------------------------------------
    def eval(self, e: PlanExpr) -> VV:
        if isinstance(e, Col):
            return self.cols[e.idx]
        if isinstance(e, Const):
            if e.value is None:
                return (np.zeros(self.n, dtype=e.ftype.np_dtype),
                        np.zeros(self.n, dtype=bool))
            v = e.value
            if e.ftype.is_string:
                # resolved per comparison; free-standing only for eq against
                # another string expr handled below
                return (np.full(self.n, -2, dtype=np.int64),
                        np.ones(self.n, dtype=bool))
            return (np.full(self.n, v, dtype=e.ftype.np_dtype),
                    np.ones(self.n, dtype=bool))
        assert isinstance(e, Call)
        return self._call(e)

    def _call(self, e: Call) -> VV:
        op = e.op
        A = e.args

        if op.startswith("fx:"):
            return self._registry_call(e)
        if op == "and":
            av, avl = _b(self.eval(A[0]))
            bv, bvl = _b(self.eval(A[1]))
            known_false = (avl & ~av) | (bvl & ~bv)
            valid = (avl & bvl) | known_false
            return av & bv & valid, valid
        if op == "or":
            av, avl = _b(self.eval(A[0]))
            bv, bvl = _b(self.eval(A[1]))
            value = (av & avl) | (bv & bvl)
            valid = (avl & bvl) | value
            return value, valid
        if op == "not":
            av, avl = _b(self.eval(A[0]))
            return (~av) & avl, avl
        if op == "isnull":
            _, avl = self.eval(A[0])
            return ~avl, np.ones_like(avl)
        if op == "rand_seeded":
            # one Random(seed) per evaluation, successive draws per row
            # (MySQL RAND(N) semantics, builtin_math.go randWithSeed)
            import random as _random
            rng = _random.Random(int(A[0].value))
            vals = np.fromiter((rng.random() for _ in range(self.n)),
                               np.float64, count=self.n)
            return vals, np.ones(self.n, bool)

        if op in ("eq", "ne", "lt", "le", "gt", "ge"):
            return self._compare(e)

        if op == "in_values":
            arg = A[0]
            if arg.ftype.is_string and isinstance(arg, Col):
                av, avl = self.eval(arg)
                d = self.dicts[arg.idx]
                assert d is not None
                if arg.ftype.is_ci:
                    canon = d.ci_canonical() if len(d) else \
                        np.zeros(0, np.int64)
                    codes = [d.lookup_ci(str(v)) for v in e.extra]
                    av = canon[np.clip(av, 0, max(len(d) - 1, 0))] \
                        if len(d) else av
                else:
                    codes = [d.lookup(str(v)) for v in e.extra]
                hit = np.isin(av, [c for c in codes if c >= 0])
            elif arg.ftype.is_string:
                # computed string (e.g. substring): string-domain membership
                sv, svl = self.eval_str(arg)
                hit = np.isin(sv, np.array([str(v) for v in e.extra],
                                           dtype=object))
                return hit & svl, svl
            else:
                av, avl = self.eval(arg)
                vals = e.extra
                hit = np.isin(av, np.array(vals))
            return hit & avl, avl
        if op == "like":
            import re

            from .client import _like_to_regex
            arg = A[0]
            flags = re.DOTALL
            if arg.ftype.is_ci:
                flags |= re.IGNORECASE  # ci collation LIKE
            rx = re.compile(_like_to_regex(str(e.extra)), flags)
            if not isinstance(arg, Col):
                sv, svl = self.eval_str(arg)
                hit = np.fromiter((rx.fullmatch(s) is not None for s in sv),
                                  bool, count=self.n)
                return hit & svl, svl
            av, avl = self.eval(arg)
            d = self.dicts[arg.idx]
            assert d is not None
            if len(d):
                table = np.fromiter((rx.fullmatch(s) is not None
                                     for s in d.values), bool, count=len(d))
                return table[np.clip(av, 0, len(d) - 1)] & avl, avl
            return np.zeros(self.n, bool), avl

        if op in ("add", "sub", "mul"):
            av, avl = self.eval(A[0])
            bv, bvl = self.eval(A[1])
            if e.ftype.is_float:
                av = _f(av, A[0].ftype)
                bv = _f(bv, A[1].ftype)
            elif e.ftype.is_decimal and op in ("add", "sub"):
                av = _rescale(av, A[0].ftype, e.ftype.scale)
                bv = _rescale(bv, A[1].ftype, e.ftype.scale)
            fn = {"add": np.add, "sub": np.subtract, "mul": np.multiply}[op]
            return fn(av, bv), avl & bvl
        if op == "div":
            av, avl = self.eval(A[0])
            bv, bvl = self.eval(A[1])
            if e.ftype.is_float:
                av = _f(av, A[0].ftype)
                bv = _f(bv, A[1].ftype)
                nz = bv != 0
                return np.where(nz, av / np.where(nz, bv, 1.0), 0.0), \
                    avl & bvl & nz
            # exact decimal division via object ints
            sa = A[0].ftype.scale if A[0].ftype.is_decimal else 0
            sb = A[1].ftype.scale if A[1].ftype.is_decimal else 0
            target = e.ftype.scale
            nz = bv != 0
            ao = av.astype(object) * (10 ** (target - sa + sb))
            bo = np.where(nz, bv, 1).astype(object)
            q = np.abs(ao) // np.abs(bo)
            r = np.abs(ao) - q * np.abs(bo)
            q = q + (2 * r >= np.abs(bo))
            q = np.where((av < 0) != (bv < 0), -q, q)
            return q.astype(np.int64), avl & bvl & nz
        if op == "intdiv":
            av, avl = self.eval(A[0])
            bv, bvl = self.eval(A[1])
            nz = bv != 0
            sb = np.where(nz, bv, 1)
            q = np.abs(av) // np.abs(sb)
            q = np.where((av < 0) != (bv < 0), -q, q)
            return q, avl & bvl & nz
        if op == "mod":
            av, avl = self.eval(A[0])
            bv, bvl = self.eval(A[1])
            nz = bv != 0
            sb = np.where(nz, bv, 1)
            r = np.abs(av) % np.abs(sb)
            r = np.where(av < 0, -r, r)
            return r, avl & bvl & nz
        if op == "neg":
            av, avl = self.eval(A[0])
            return -av, avl
        if op == "abs":
            av, avl = self.eval(A[0])
            return np.abs(av), avl

        if op == "if":
            cv, cvl = _b(self.eval(A[0]))
            tv, tvl = self.eval(A[1])
            fv, fvl = self.eval(A[2])
            cond = cv & cvl
            return np.where(cond, tv, fv), np.where(cond, tvl, fvl)
        if op == "ifnull":
            av, avl = self.eval(A[0])
            bv, bvl = self.eval(A[1])
            return np.where(avl, av, bv), avl | bvl
        if op == "coalesce":
            out_v, out_vl = self.eval(A[0])
            for a in A[1:]:
                av, avl = self.eval(a)
                out_v = np.where(out_vl, out_v, av)
                out_vl = out_vl | avl
            return out_v, out_vl
        if op == "case":
            has_else = len(A) % 2 == 1
            pairs = (len(A) - 1) // 2 if has_else else len(A) // 2
            if has_else:
                out_v, out_vl = self.eval(A[-1])
                out_v = np.array(out_v, copy=True)
                out_vl = np.array(out_vl, copy=True)
            else:
                out_v = np.zeros(self.n, dtype=e.ftype.np_dtype)
                out_vl = np.zeros(self.n, dtype=bool)
            decided = np.zeros(self.n, dtype=bool)
            for i in range(pairs):
                cv, cvl = _b(self.eval(A[2 * i]))
                tv, tvl = self.eval(A[2 * i + 1])
                take = cv & cvl & ~decided
                out_v = np.where(take, tv, out_v)
                out_vl = np.where(take, tvl, out_vl)
                decided |= take
            return out_v, out_vl

        if op in ("year", "month", "day"):
            av, avl = self.eval(A[0])
            days = av
            if A[0].ftype.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
                days = av // 86_400_000_000
            y, m, d = _civil(days.astype(np.int64))
            return {"year": y, "month": m, "day": d}[op], avl
        if op == "date_add_days":
            av, avl = self.eval(A[0])
            return av + int(e.extra), avl
        if op == "cast":
            return self._cast(self.eval(A[0]), A[0].ftype, e.ftype)

        if op == "json_valid":
            import json as _json

            av, avl = self.eval_str(A[0])
            out = np.zeros(self.n, np.int64)
            for i, (s, v) in enumerate(zip(av, avl)):
                if v:
                    try:
                        _json.loads(s)
                        out[i] = 1
                    except ValueError:
                        pass
            return out, avl
        if op == "json_length":
            import json as _json

            av, avl = self.eval_str(A[0])
            out = np.zeros(self.n, np.int64)
            ok = np.zeros(self.n, bool)
            for i, (s, v) in enumerate(zip(av, avl)):
                if not v:
                    continue
                try:
                    doc = _json.loads(s)
                except ValueError:
                    continue
                out[i] = len(doc) if isinstance(doc, (list, dict)) else 1
                ok[i] = True
            return out, ok
        if op == "find_in_set":
            needle, nvl = self.eval_str(A[0])
            target = A[1]
            out = np.zeros(self.n, np.int64)
            if target.ftype.kind == TypeKind.SET:
                mv, mvl = self.eval(target)
                elems = target.ftype.elems
                for i, (s, m) in enumerate(zip(needle, mv)):
                    labels = [e for j, e in enumerate(elems)
                              if int(m) >> j & 1]
                    if s in labels:
                        out[i] = labels.index(s) + 1
                return out, nvl & mvl
            hv, hvl = self.eval_str(target)
            for i, (s, h) in enumerate(zip(needle, hv)):
                parts = h.split(",") if h else []
                if s in parts:
                    out[i] = parts.index(s) + 1
            return out, nvl & hvl

        if op in ("length", "char_length", "ascii"):
            sv, svl = self.eval_str(A[0])
            if op == "ascii":
                out = np.array([ord(s[0]) if s else 0 for s in sv],
                               np.int64)
            elif op == "length":
                out = np.array([len(s.encode("utf-8")) for s in sv],
                               np.int64)
            else:
                out = np.array([len(s) for s in sv], np.int64)
            return out, svl
        if op == "locate":
            nv, nvl = self.eval_str(A[0])
            hv, hvl = self.eval_str(A[1])
            if any(a.ftype.is_ci for a in A):
                out = np.array(
                    [h.casefold().find(sub.casefold()) + 1
                     for sub, h in zip(nv, hv)], np.int64)
            else:
                out = np.array([h.find(sub) + 1
                                for sub, h in zip(nv, hv)], np.int64)
            return out, nvl & hvl

        if op in ("round", "truncate"):
            av, avl = self.eval(A[0])
            d = int(e.extra or 0)
            at = A[0].ftype
            if at.is_float:
                scaled = np.asarray(av, np.float64) * (10.0 ** d)
                if op == "round":
                    q = np.floor(np.abs(scaled) + 0.5)
                else:
                    q = np.floor(np.abs(scaled))
                return np.where(scaled < 0, -q, q) / (10.0 ** d), avl
            s = at.scale if at.is_decimal else 0
            target = e.ftype.scale if e.ftype.is_decimal else 0
            v = np.asarray(av, np.int64)
            if d < 0:
                # single division covering both the scale drop and the
                # coarse digits (two-step rounding would compound:
                # ROUND(44.5, -1) must be 40, not 50)
                f = 10 ** (s - d)
                q = (np.abs(v) + (f // 2 if op == "round" else 0)) // f
                q = q * 10 ** (-d)
                return np.where(v < 0, -q, q), avl
            drop = s - max(target, 0) if s > max(target, 0) else 0
            if drop > 0:
                f = 10 ** drop
                q = (np.abs(v) + (f // 2 if op == "round" else 0)) // f
                v = np.where(v < 0, -q, q)
            return v, avl
        if op in ("floor", "ceil"):
            av, avl = self.eval(A[0])
            at = A[0].ftype
            if at.is_float:
                f = np.floor if op == "floor" else np.ceil
                return f(np.asarray(av, np.float64)), avl
            if at.is_decimal:
                s = 10 ** at.scale
                v = np.asarray(av, np.int64)
                if op == "floor":
                    return v // s, avl
                return -((-v) // s), avl
            return np.asarray(av, np.int64), avl
        if op in ("sqrt", "exp", "ln", "log2", "log10"):
            av, avl = self.eval(A[0])
            f = _f(np.asarray(av), A[0].ftype)
            fn = {"sqrt": np.sqrt, "exp": np.exp, "ln": np.log,
                  "log2": np.log2, "log10": np.log10}[op]
            with np.errstate(invalid="ignore", divide="ignore"):
                out = fn(f)
            ok = np.isfinite(out)  # MySQL: out-of-domain -> NULL
            return np.where(ok, out, 0.0), avl & ok
        if op == "log_base":
            bv, bvl = self.eval(A[0])
            xv, xvl = self.eval(A[1])
            b = _f(np.asarray(bv), A[0].ftype)
            x = _f(np.asarray(xv), A[1].ftype)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = np.log(x) / np.log(b)
            ok = np.isfinite(out)
            return np.where(ok, out, 0.0), bvl & xvl & ok
        if op == "pow":
            av, avl = self.eval(A[0])
            bv, bvl = self.eval(A[1])
            with np.errstate(invalid="ignore", over="ignore"):
                out = np.power(_f(np.asarray(av), A[0].ftype),
                               _f(np.asarray(bv), A[1].ftype))
            ok = np.isfinite(out)
            return np.where(ok, out, 0.0), avl & bvl & ok
        if op == "sign":
            av, avl = self.eval(A[0])
            return np.sign(np.asarray(av)).astype(np.int64), avl
        if op in ("greatest", "least"):
            if e.ftype.is_string:
                raise NotImplementedError(
                    "string GREATEST/LEAST evaluates via eval_str")
            fn = np.maximum if op == "greatest" else np.minimum
            out_v, out_vl = None, None
            for a in A:
                v, vl = self.eval(a)
                v = np.asarray(v)
                if e.ftype.is_float:
                    v = _f(v, a.ftype)
                elif e.ftype.is_decimal:
                    v = _rescale(v, a.ftype, e.ftype.scale)
                if out_v is None:
                    out_v, out_vl = v, vl
                else:
                    out_v = fn(out_v, v)
                    out_vl = out_vl & vl  # MySQL: any NULL -> NULL
            return out_v, out_vl

        if op in ("dayofweek", "weekday", "dayofyear", "quarter"):
            av, avl = self.eval(A[0])
            days = np.asarray(av, np.int64)
            if A[0].ftype.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
                days = days // 86_400_000_000
            if op == "dayofweek":   # 1 = Sunday (1970-01-01 is Thursday)
                return (days + 4) % 7 + 1, avl
            if op == "weekday":     # 0 = Monday
                return (days + 3) % 7, avl
            y, m, d = _civil(days)
            if op == "quarter":
                return ((m - 1) // 3 + 1).astype(np.int64), avl
            jan1 = _days_from_civil(y, np.ones_like(m), np.ones_like(d))
            return days - jan1 + 1, avl
        if op in ("hour", "minute", "second"):
            av, avl = self.eval(A[0])
            us = np.asarray(av, np.int64)
            if A[0].ftype.kind == TypeKind.TIME:
                # TIME is a signed duration: components of |t|, hours
                # unbounded (MySQL HOUR('-26:30:00') = 26)
                sec = np.abs(us) // 1_000_000
                if op == "hour":
                    return sec // 3600, avl
            else:
                sec = us // 1_000_000
                if op == "hour":
                    return (sec // 3600) % 24, avl
            if op == "minute":
                return (sec // 60) % 60, avl
            return sec % 60, avl
        if op == "to_date":
            av, avl = self.eval(A[0])
            v = np.asarray(av, np.int64)
            if A[0].ftype.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
                v = v // 86_400_000_000
            return v.astype(np.int32), avl
        if op == "last_day":
            av, avl = self.eval(A[0])
            days = np.asarray(av, np.int64)
            if A[0].ftype.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
                days = days // 86_400_000_000
            y, m, _d = _civil(days)
            ny = np.where(m == 12, y + 1, y)
            nm = np.where(m == 12, 1, m + 1)
            nxt = _days_from_civil(ny, nm, np.ones_like(nm))
            return (nxt - 1).astype(np.int32), avl
        if op == "datediff":
            av, avl = self.eval(A[0])
            bv, bvl = self.eval(A[1])

            def to_days(v, ft):
                v = np.asarray(v, np.int64)
                if ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
                    v = v // 86_400_000_000
                return v
            return (to_days(av, A[0].ftype) - to_days(bv, A[1].ftype),
                    avl & bvl)

        raise NotImplementedError(f"host eval: {op}")

    def _any_str(self, a: PlanExpr) -> VV:
        """Any-typed expression stringified MySQL-style (CONCAT coercion:
        ints plain, decimals at column scale, dates ISO)."""
        if a.ftype.is_string:
            return self.eval_str(a)
        v, vl = self.eval(a)
        v = np.asarray(v)
        ft = a.ftype
        out = np.empty(self.n, dtype=object)
        if ft.is_decimal:
            from ..types.value import Decimal as _D
            s = ft.scale
            for i, x in enumerate(v):
                out[i] = str(_D(int(x), s))
        elif ft.kind == TypeKind.DATE:
            from ..types.value import decode_date
            for i, x in enumerate(v):
                out[i] = decode_date(int(x)).isoformat()
        elif ft.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
            from ..types.value import decode_datetime
            for i, x in enumerate(v):
                out[i] = decode_datetime(int(x)).isoformat(" ")
        elif ft.is_float:
            for i, x in enumerate(v):
                f = float(x)
                out[i] = repr(f) if not f.is_integer() else str(int(f))
        else:
            for i, x in enumerate(v):
                out[i] = str(int(x))
        return out, np.asarray(vl)

    def _compare(self, e: Call) -> VV:
        op = e.op
        a, b = e.args
        if a.ftype.is_string or b.ftype.is_string:
            ci = a.ftype.is_ci or b.ftype.is_ci
            if ci or isinstance(a, Call) or isinstance(b, Call):
                # ci collation or computed strings: compare in the
                # (casefolded) string domain (reference: collation-aware
                # compare, util/collate/collate.go:141)
                av2, avl = self.eval_str(a)
                bv2, bvl = self.eval_str(b)
                if ci:
                    av2 = np.array([s.casefold() for s in av2],
                                   dtype=object)
                    bv2 = np.array([s.casefold() for s in bv2],
                                   dtype=object)
            else:
                av, avl = self.eval(a)
                bv, bvl = self.eval(b)
                av2, bv2 = self._string_operands(a, av, b, bv, op)
        else:
            av, avl = self.eval(a)
            bv, bvl = self.eval(b)
            av2, bv2 = _align(a.ftype, av, b.ftype, bv)
        fn = {"eq": np.equal, "ne": np.not_equal, "lt": np.less,
              "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal}[op]
        valid = avl & bvl
        return fn(av2, bv2) & valid, valid

    def _string_operands(self, a, av, b, bv, op):
        # code-space equality is only valid within ONE dictionary; any
        # cross-dictionary compare must go through the string domain
        same_dict = (
            isinstance(a, Col) and isinstance(b, Col)
            and a.ftype.is_string and b.ftype.is_string
            and self.dicts[a.idx] is self.dicts[b.idx]
        )
        col_vs_const = (
            (isinstance(a, Col) and isinstance(b, Const))
            or (isinstance(b, Col) and isinstance(a, Const))
        )

        def decode(e, v):
            if isinstance(e, Col) and e.ftype.is_string:
                d = self.dicts[e.idx]
                assert d is not None
                if op in ("eq", "ne") and (same_dict or col_vs_const):
                    return v  # codes compare fine within one dictionary
                vals = np.array(d.values + [""], dtype=object)
                return vals[np.clip(v, 0, len(d))]
            if isinstance(e, Const) and e.ftype.is_string:
                if op in ("eq", "ne"):
                    other = b if e is a else a
                    if isinstance(other, Col) and other.ftype.is_string:
                        d = self.dicts[other.idx]
                        assert d is not None
                        return np.full(self.n, d.lookup(str(e.value)),
                                       np.int64)
                return np.full(self.n, str(e.value), dtype=object)
            return v

        return decode(a, av), decode(b, bv)

    def _cast(self, vv: VV, src: FieldType, dst: FieldType) -> VV:
        v, vl = vv
        if dst.is_float:
            f = _f(v, src)
            return f, vl
        if dst.is_decimal:
            if src.is_decimal:
                return _rescale_round(v, src.scale, dst.scale), vl
            if src.is_integer:
                return v.astype(np.int64) * 10 ** dst.scale, vl
            if src.is_float:
                scaled = v * 10 ** dst.scale
                q = np.floor(np.abs(scaled) + 0.5)
                return np.where(scaled < 0, -q, q).astype(np.int64), vl
        if dst.is_integer:
            if src.is_decimal:
                return _rescale_round(v, src.scale, 0), vl
            if src.is_float:
                q = np.floor(np.abs(v) + 0.5)
                return np.where(v < 0, -q, q).astype(np.int64), vl
            return v.astype(np.int64), vl
        if dst.is_string and src.is_string:
            return v, vl
        raise NotImplementedError(f"host cast {src!r} -> {dst!r}")


# ---- helpers ----------------------------------------------------------------

def _truthy(v: np.ndarray) -> np.ndarray:
    if v.dtype != np.bool_:
        return v != 0
    return v


def _substring(s: str, start: int, length: Optional[int]) -> str:
    """MySQL SUBSTRING: 1-based; negative start counts from the end;
    start=0 yields ''. (reference: expression/builtin_string.go substring)"""
    if start == 0:
        return ""
    if start > 0:
        i = start - 1
    else:
        i = len(s) + start
        if i < 0:
            return ""
    if length is None:
        return s[i:]
    if length <= 0:
        return ""
    return s[i:i + length]


def _json_path_steps(path: str) -> Optional[list]:
    """'$.a.b[2]' -> ['a', 'b', 2]; None for malformed paths.
    Subset of the reference's path grammar (types/json/path_expr.go):
    member access and array indexing, no wildcards."""
    import re as _re

    if not path.startswith("$"):
        return None
    steps: list = []
    for m in _re.finditer(r"\.(\w+)|\.\"([^\"]+)\"|\[(\d+)\]|(.)",
                          path[1:]):
        if m.group(4) is not None:
            return None  # junk character
        if m.group(3) is not None:
            steps.append(int(m.group(3)))
        else:
            steps.append(m.group(1) or m.group(2))
    return steps


def _json_extract(doc: str, path: str):
    """JSON-serialized value at path, or None (missing/invalid)."""
    import json as _json

    try:
        v = _json.loads(doc)
    except ValueError:
        return None
    steps = _json_path_steps(path)
    if steps is None:
        return None
    for s in steps:
        if isinstance(s, int):
            if not isinstance(v, list) or s >= len(v):
                return None
            v = v[s]
        else:
            if not isinstance(v, dict) or s not in v:
                return None
            v = v[s]
    return _json.dumps(v, sort_keys=True, separators=(", ", ": "))


def _json_unquote(s: str) -> str:
    import json as _json

    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        try:
            return str(_json.loads(s))
        except ValueError:
            return s
    return s


def _json_type_name(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "DOUBLE"
    if isinstance(v, str):
        return "STRING"
    if isinstance(v, list):
        return "ARRAY"
    return "OBJECT"


def _b(vv: VV) -> VV:
    v, vl = vv
    return _truthy(np.asarray(v)), vl


def _f(v: np.ndarray, ft: FieldType) -> np.ndarray:
    out = v.astype(np.float64)
    if ft.is_decimal:
        out = out / 10 ** ft.scale
    return out


def _rescale(v: np.ndarray, ft: FieldType, target_scale: int) -> np.ndarray:
    s = ft.scale if ft.is_decimal else 0
    if s < target_scale:
        return v.astype(np.int64) * 10 ** (target_scale - s)
    return v


def _rescale_round(v: np.ndarray, s: int, target: int) -> np.ndarray:
    if s == target:
        return v
    if s < target:
        return v * 10 ** (target - s)
    f = 10 ** (s - target)
    q = (np.abs(v) + f // 2) // f
    return np.where(v < 0, -q, q)


def _align(at: FieldType, av, bt: FieldType, bv):
    if at.is_float or bt.is_float:
        return _f(av, at), _f(bv, bt)
    sa = at.scale if at.is_decimal else 0
    sb = bt.scale if bt.is_decimal else 0
    if sa < sb:
        av = av.astype(np.int64) * 10 ** (sb - sa)
    elif sb < sa:
        bv = bv.astype(np.int64) * 10 ** (sa - sb)
    return av, bv


def _days_from_civil(y: np.ndarray, m: np.ndarray,
                     d: np.ndarray) -> np.ndarray:
    """(year, month, day) -> days since 1970-01-01 (inverse of _civil;
    Hinnant's days_from_civil)."""
    y = np.asarray(y, np.int64) - (np.asarray(m, np.int64) <= 2)
    m = np.asarray(m, np.int64)
    d = np.asarray(d, np.int64)
    era = np.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def _civil(z: np.ndarray):
    z = z + 719_468
    era = np.where(z >= 0, z, z - 146_096) // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = np.where(m <= 2, y + 1, y)
    return y, m, d
