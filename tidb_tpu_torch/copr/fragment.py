"""Fragment executor: the single-table FragmentDAG paths.

Port of the part of `tidb_tpu/copr/fragment.py` that serves a one-table
fragment with an aggregation:

* mode "agg": the dense-segment aggregation of `client.agg_partials` over
  the probe's filtered rows, tiled like the single-table path;
* mode "hc" over a run-ordered epoch: `_hc_rank_body`, which turns the
  per-row masked value arrays into exact per-group sums in rank space with
  `streamseg.rank_sums` (the CUDA kernel on the card), then keeps the
  groups that pass the HAVING predicates (HAVING consumer, e.g. TPC-H
  Q18's inner block) or every group (all-groups "group" mode, e.g. a
  lifted single-table GROUP BY whose group space is too wide to be dense).

Gates decide exactly as the reference's: where the reference raises its
`_Fallback(reason)` and serves the fragment on the host, this executor
raises `NotInSlice(reason)`. Joins, semi-joins, row and TopN modes, a TopN
consumer of the hc path, and the sorted-run hc body (for epochs that are
not run-ordered or fail a streamseg gate) raise `NotInSlice` until their
slice lands.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..chunk.chunk import Chunk
from ..chunk.column import Column
from ..errors import NotInSlice
from ..plan.dag import CopDAG, DAGScan
from ..plan.expr import Col
from ..plan.fragment import FragmentDAG, FragTable
from ..types.field_type import FieldType, TypeKind
from . import sumexact as SE
from .bounds import (
    decompose_terms,
    expr_bounds,
    expr_device_safe,
    fits_int32,
    limbs_for,
)
from .client import (
    CopClient,
    CopResult,
    _merge_tile_outs,
    agg_partials,
    decode_agg_partials,
    fetch,
    widen32,
)
from .eval import CompileError, eval_expr, selection_mask


class _Fallback(Exception):
    """Raised by a device gate; carries the gate's reason."""

    def __init__(self, reason: str = "gate") -> None:
        super().__init__(reason)
        self.reason = reason


def execute_fragment(cop: CopClient, frag: FragmentDAG, snaps: dict
                     ) -> CopResult:
    """snaps: table_id -> TableSnapshot for every fragment table."""
    try:
        return _device_fragment(cop, frag, snaps)
    except (_Fallback, CompileError) as e:
        # the reference serves these on its host interpreter, tagged
        # host(fragment:<reason>)
        raise NotInSlice(getattr(e, "reason", None) or "compile") from e


# ==================== device path ====================

def _device_fragment(cop, frag, snaps) -> CopResult:
    if frag.joins:
        raise NotInSlice("joins")
    if frag.semis:
        raise NotInSlice("semi-joins")
    probe = frag.tables[0]
    psnap = snaps[probe.table.id]

    # ---- eligibility over this snapshot ----
    b = cop._scan_bounds(_facade_dag(probe), psnap)
    for ci, off in enumerate(probe.col_offsets):
        if psnap.epoch.columns[off].dtype == np.int64 and \
                not fits_int32(b[ci]):
            raise _Fallback("int64-column")
    dicts = [psnap.dictionaries[off] for off in probe.col_offsets]
    cop._evict_stale(probe.table.id, psnap.epoch.epoch_id)
    comb_bounds = list(b)
    comb_dicts = list(dicts)

    prepared: dict[Any, Any] = {"__col_bounds__": comb_bounds}

    for c in probe.filters:
        cop._prepare_expr(c, dicts, prepared)
        if not expr_device_safe(c, b):
            raise _Fallback("filter-unsafe")
    for c in frag.selection:
        cop._prepare_expr(c, comb_dicts, prepared)
        if not expr_device_safe(c, comb_bounds):
            raise _Fallback("selection-unsafe")
    if frag.agg is None:
        raise NotInSlice("fragment row and TopN modes")
    # group keys and aggregate arguments can embed string predicates
    for g in frag.agg.group_by:
        cop._prepare_expr(g, comb_dicts, prepared)
    for d in frag.agg.aggs:
        if d.arg is not None:
            cop._prepare_expr(d.arg, comb_dicts, prepared)

    mode = "agg"
    n_rows = psnap.epoch.num_rows + len(psnap.overlay_handles)
    facade = _agg_facade(frag)
    err = cop._prepare_agg(facade, comb_dicts, comb_bounds, prepared,
                           n_rows)
    if err is not None:
        # dense segment space rejected (or skipped by the sparse-occupancy
        # gate): the sorted-run candidate machinery covers the rest
        if len(psnap.overlay_handles) > 0 or \
                not _prepare_hc(frag, comb_bounds, prepared, n_rows):
            if not err.startswith("sparse segment space") or \
                    cop._prepare_agg(facade, comb_dicts, comb_bounds,
                                     prepared, n_rows,
                                     sparse_gate=False) is not None:
                raise _Fallback("group-space")
            # the dense einsum still serves the query on device
        else:
            mode = "hc"
            if frag.hc is None and not frag.having:
                prepared["__hc_all__"] = True

    if mode == "hc":
        # run-ordered fast path: storage order already groups the segment
        # keys, so segment boundaries are raw key-change points and
        # filtered-out rows contribute zeros
        segcols = prepared.get("__hc_segcols__")
        has_mm = any(s["kind"] in ("min", "max")
                     for s in prepared["__hc_sched__"])
        if segcols is not None and not has_mm and \
                cop._runs_ordered(psnap, segcols):
            # streamseg eligibility: K value arrays within the kernel's
            # cap, per-key row counts within its f32 exactness bound
            from . import streamseg as SS
            n_arrays = 1
            for s_ in prepared["__hc_sched__"]:
                n_arrays += 1 + sum(t[2] for t in s_.get("terms", ()))
            if n_arrays <= SS.MAX_ARRAYS:
                meta = cop._rank_meta(psnap, segcols)
                if meta is not None:
                    prepared["__rank_meta__"] = meta
        if frag.hc is not None:
            raise NotInSlice("hc TopN consumer")
        if prepared.get("__rank_meta__") is None:
            raise NotInSlice("hc sorted-run body")

    if len(psnap.overlay_handles) > 0:
        raise NotInSlice("overlay rows")
    chunks: list[Chunk] = []
    if psnap.epoch.num_rows > 0:
        chunks.extend(_run_frag_batch(cop, frag, snaps, prepared, mode))
    if not chunks:
        chunks = [_empty_chunk(frag, comb_dicts)]
    emode = "group" if prepared.get("__hc_all__") else mode
    return CopResult(chunks, is_partial_agg=True, engine=f"device[{emode}]")


def lift_group_dag(dag, snap) -> Optional[FragmentDAG]:
    """Degenerate one-table FragmentDAG for a pushed-down CopDAG agg
    whose dense segment space failed (client._try_group_fragment): same
    scan columns / filters / aggregation, partial layout unchanged."""
    table = snap.table
    by_off = {c.offset: c.ftype for c in table.columns}
    try:
        col_types = [by_off[off] for off in dag.scan.col_offsets]
    except KeyError:
        return None
    t = FragTable(table, list(dag.scan.col_offsets),
                  list(dag.selection.conditions) if dag.selection else [],
                  col_types)
    frag = FragmentDAG([t], [])
    frag.agg = dag.agg
    frag.output_types = list(dag.output_types)
    return frag


def _facade_dag(t):
    """Minimal CopDAG stand-in for CopClient staging/bounds helpers."""
    return CopDAG(scan=DAGScan(t.table.id, list(t.col_offsets)),
                  output_types=list(t.col_types))


def _agg_facade(frag):
    combined_offsets = []
    for t in frag.tables:
        combined_offsets.extend(t.col_offsets)
    return CopDAG(scan=DAGScan(frag.tables[0].table.id, combined_offsets),
                  agg=frag.agg, output_types=list(frag.output_types))


def _run_frag_batch(cop, frag, snaps, prepared, mode) -> list[Chunk]:
    probe = frag.tables[0]
    psnap = snaps[probe.table.id]
    kernel = _build_frag_kernel(frag, prepared, mode)
    if mode == "agg":
        # big epochs stream through tiles exactly like the single-table
        # path; per-tile partials merge host-side
        tiles = cop._stage_tiles(_facade_dag(probe), psnap)
        outs = fetch([kernel(cols, vis) for cols, vis, _ in tiles])
        out = _merge_tile_outs(outs, prepared["__agg_sched__"])
        return _decode_frag_agg(frag, snaps, prepared, out)
    # the rank-space hc path stages the whole epoch: rank metadata and
    # key runs are per epoch
    pcols, pvis = cop._stage_inputs(_facade_dag(probe), psnap)
    aux = _stage_rank_aux(cop, psnap, prepared)
    out = fetch([kernel(pcols, pvis, aux)])[0]
    chunk = _decode_hc(frag, snaps, prepared, out)
    return [] if chunk is None else [chunk]


def _decode_frag_agg(frag, snaps, prepared, out) -> list[Chunk]:
    """Fetched dense-agg partials -> partial-layout chunks."""
    cards = prepared["__dense_cards__"]
    comb_dicts = []
    for t in frag.tables:
        snap = snaps[t.table.id]
        comb_dicts.extend(snap.dictionaries[off] for off in t.col_offsets)
    group_dicts = [
        comb_dicts[g.idx]
        if g.ftype.is_string and isinstance(g, Col) else None
        for g in frag.agg.group_by
    ]
    chunk = decode_agg_partials(
        frag.agg, prepared, cards, out, group_dicts,
        frag.output_types[len(frag.agg.group_by):])
    return [] if chunk is None else [chunk]


def _stage_rank_aux(cop, snap, prepared):
    """Device-resident epoch arrays for the streamseg rank kernel: change
    flags f and first-row-per-rank r0 (cached per epoch)."""
    meta = prepared["__rank_meta__"]
    key = (snap.epoch.epoch_id, "rankaux", meta["n0"], meta["nd"])
    with cop._lock:
        hit = cop._col_cache.get(key)
        cacheable = cop._live_epochs.get(snap.table.id) \
            == snap.epoch.epoch_id
    if hit is None:
        hit = {"f": cop._place(meta["f"]), "r0": cop._place(meta["r0"])}
        if cacheable:
            with cop._lock:
                cop._col_cache[key] = hit
    return hit


def _prepare_hc(frag, comb_bounds, prepared, n_rows) -> bool:
    """Gates + schedule for the sorted-run candidate path. Group keys must
    be int32-encodable with a collision-free NULL code (bounds hi + 1);
    aggregates must be additive (count / int-decomposable sum / avg)."""
    nulls: list[int] = []
    spans_ = []
    for g in frag.agg.group_by:
        if g.ftype.is_float:
            return False
        if not expr_device_safe(g, comb_bounds):
            return False
        b = expr_bounds(g, comb_bounds)
        if b is None or b[1] + 1 >= 2**31 - 1:
            return False
        nulls.append(b[1] + 1)
        spans_.append(b[1] - b[0])

    # ---- segment-key selection (functional dependencies) ----
    # sort only by group keys that DETERMINE the rest: the table's PK
    # handle column determines every other column (the reference also
    # follows unique joins; a fragment here has one table and no joins)
    probe = frag.tables[0]
    all_cols = set(range(len(probe.col_offsets)))
    off = getattr(probe.table, "pk_handle_offset", None)
    pk = probe.col_offsets.index(off) \
        if off is not None and off in probe.col_offsets else None

    def cols_of(e) -> set:
        out = set()

        def walk(x):
            if isinstance(x, Col):
                out.add(x.idx)
            elif hasattr(x, "args"):
                for a in x.args:
                    walk(a)
        walk(e)
        return out

    def closure(det: set) -> set:
        return det | all_cols if pk in det else set(det)

    order = sorted(range(len(frag.agg.group_by)),
                   key=lambda gi: -spans_[gi])
    all_needed: set = set()
    for g in frag.agg.group_by:
        all_needed |= cols_of(g)
    # one plain key that determines every group column sorts alone
    seg_keys: list[int] = []
    for gi in order:
        g = frag.agg.group_by[gi]
        if isinstance(g, Col) and all_needed <= closure({g.idx}):
            seg_keys = [gi]
            break
    if not seg_keys:
        det: set = set()
        for gi in order:
            g = frag.agg.group_by[gi]
            need = cols_of(g)
            if need and not need <= closure(det):
                seg_keys.append(gi)
                # only a PLAIN column key determines its column
                if isinstance(g, Col):
                    det |= need
    if not seg_keys:
        seg_keys = [0]
    if len(seg_keys) > 2:
        # the reference's group-key packing gate: the segment keys must
        # fold into at most two int32 operands, each a product of
        # (span+2) code spaces
        packs, prod = 1, 1
        for gi in seg_keys:
            card = spans_[gi] + 2
            if card > 2**31 - 2:
                return False
            if prod * card > 2**31 - 2 and prod > 1:
                packs, prod = packs + 1, 1
            prod *= card
        if packs > 2:
            return False
    sched: list[dict] = []
    n_minmax = 0
    for d in frag.agg.aggs:
        if d.arg is None or d.func == "count":
            sched.append({"kind": "count"})
            continue
        if d.func in ("min", "max"):
            # min/max ride the sort as one extra operand: one per fragment
            n_minmax += 1
            if n_minmax > 1 or d.arg.ftype.is_float or \
                    not expr_device_safe(d.arg, comb_bounds):
                return False
            vb = expr_bounds(d.arg, comb_bounds)
            if vb is None or vb[0] <= -(2**31) + 2 or vb[1] >= 2**31 - 2:
                return False
            sched.append({"kind": d.func})
            continue
        if d.func not in ("sum", "avg") or d.arg.ftype.is_float:
            return False
        terms = decompose_terms(d.arg, comb_bounds)
        if terms is None:
            return False
        b = expr_bounds(d.arg, comb_bounds)
        if b is None:
            return False
        if max(abs(b[0]), abs(b[1])) * max(n_rows, 1) >= 2**62:
            return False
        sched.append({
            "kind": "isum",
            "terms": [(t, s, limbs_for(expr_bounds(t, comb_bounds),
                                       SE.LIMB_BITS))
                      for t, s in terms],
        })
    prepared["__hc_nulls__"] = nulls
    prepared["__hc_sched__"] = sched
    # run-order eligibility: every segment key must be a plain column
    segcols: Optional[list[int]] = []
    for gi in seg_keys:
        g = frag.agg.group_by[gi]
        if not isinstance(g, Col):
            segcols = None
            break
        segcols.append(probe.col_offsets[g.idx])
    prepared["__hc_segcols__"] = segcols
    return True


def _build_frag_kernel(frag, prepared, mode):
    """(probe cols, visibility[, rank aux]) -> device partials."""
    agg = frag.agg
    if mode == "agg":
        cards = prepared["__dense_cards__"]
        segments = 1
        for c in cards:
            segments *= max(c, 1)

    def kernel(pcols, pvis, aux=None):
        cols = widen32(list(pcols))
        mask = pvis
        if frag.tables[0].filters:
            mask = selection_mask(frag.tables[0].filters, cols, prepared,
                                  mask)
        if frag.selection:
            mask = selection_mask(frag.selection, cols, prepared, mask)
        if mode == "agg":
            return agg_partials(agg, prepared, cards, segments, cols, mask)
        return _hc_rank_body(frag, prepared, cols, mask, aux)

    return kernel


def _hc_rank_body(frag, prepared, cols, mask, aux):
    """Rank-space hc aggregation over run-ordered input (streamseg).

    `streamseg.rank_sums` turns per-row masked value arrays into exact
    per-GROUP sums indexed by rank (= position among distinct key runs);
    the HAVING score and the candidate buffer then work on the rank axis.
    Group keys for candidates are gathered at each rank's first row (r0):
    within a run every group key is constant, so any row serves;
    fully-masked runs are gated by a zero row count."""
    from . import streamseg as SS

    agg = frag.agg
    nulls = prepared["__hc_nulls__"]
    sched = prepared["__hc_sched__"]
    meta = prepared["__rank_meta__"]

    encs = []
    for gi, g in enumerate(agg.group_by):
        v, vl = eval_expr(g, cols, prepared)
        if v.dtype == torch.bool:
            v = v.to(torch.int32)
        encs.append(torch.where(vl, v.to(torch.int32), nulls[gi]))

    arrs = [mask.to(torch.float32)]
    cnt_ix: list[int] = []
    term_ix: list[list] = []
    for ai, (d, s_) in enumerate(zip(agg.aggs, sched)):
        if s_["kind"] == "count":
            if d.arg is not None:
                _, vl = eval_expr(d.arg, cols, prepared)
                arrs.append((mask & vl).to(torch.float32))
            else:
                arrs.append(mask.to(torch.float32))
            cnt_ix.append(len(arrs) - 1)
            term_ix.append([])
            continue
        _, vl = eval_expr(d.arg, cols, prepared)
        contrib = mask & vl
        arrs.append(contrib.to(torch.float32))
        cnt_ix.append(len(arrs) - 1)
        t_list = []
        for (t, shift, L) in s_["terms"]:
            tv, _ = eval_expr(t, cols, prepared)
            tv32 = torch.where(contrib, tv.to(torch.int32), 0)
            limb_ids = []
            for li in SE.limbs_of(tv32, L):
                arrs.append(li.to(torch.float32))
                limb_ids.append(len(arrs) - 1)
            t_list.append((shift, limb_ids))
        term_ix.append(t_list)

    tot = SS.rank_sums(torch.stack(arrs), aux["f"], meta)  # f32[K, nd_pad]
    gate = tot[0] > 0
    r0 = aux["r0"]

    def agg_f32(ai):
        """Approximate f32 value of aggregate ai per rank."""
        cnt = tot[cnt_ix[ai]]
        if sched[ai]["kind"] == "count":
            return cnt
        sv = torch.zeros_like(cnt)
        for shift, limb_ids in term_ix[ai]:
            t = torch.zeros_like(cnt)
            for pos, ix in enumerate(limb_ids):
                t = t + tot[ix] * float(1 << (SE.LIMB_BITS * pos))
            sv = sv + t * float(1 << shift)
        return sv

    # HAVING-filtered groups: a safely WIDENED predicate (f32 relative
    # error margin) — completeness is what matters; the host Selection
    # above re-applies it exactly. All-groups mode passes every group.
    pass_m = gate
    for (ai, op, thr) in (frag.having or ()):
        sv = agg_f32(ai)
        eps = torch.abs(sv) * 2.0 ** -18 + 2.0
        thr_f = float(np.float32(thr))  # the threshold as an f32 value
        if op == "gt":
            ok = sv > thr_f - eps
        elif op == "ge":
            ok = sv >= thr_f - eps
        elif op == "lt":
            ok = sv < thr_f + eps
        else:
            ok = sv <= thr_f + eps
        pass_m = pass_m & ok
    score = torch.where(pass_m, 1.0, float("-inf"))
    # exact top-k by score: every passing rank scores 1.0, so whenever
    # fewer than k_cap ranks pass, the candidate set holds all of them
    # (the reference's approx_max_k at recall 1.0 keeps the same set);
    # which non-passing ranks fill the rest does not matter (picked = 0)
    k_cap = min(FragmentDAG.HAVING_CAP, score.shape[0])
    cand = torch.topk(score, k_cap).indices
    rows_of = r0[cand].long()
    res = {"picked": pass_m[cand].to(torch.int32), "score": score[cand]}
    for gi in range(len(agg.group_by)):
        res[f"gk{gi}"] = encs[gi][rows_of]
    _emit_pairs(res, sched, term_ix, cnt_ix, tot, cand)
    return res


def _emit_pairs(res, sched, term_ix, cnt_ix, tot, cand):
    """Candidate rank sums -> the decode's [limbs, 2, cap] pair layout
    (hi*4096 + lo == value; exact for the gated per-rank totals)."""

    def pairs(v_f32):
        v = v_f32.to(torch.int32)
        return torch.stack([v >> SE.LIMB_BITS,
                            v & ((1 << SE.LIMB_BITS) - 1)])

    for ai, s_ in enumerate(sched):
        res[f"cnt{ai}"] = pairs(tot[cnt_ix[ai]][cand])[None]
        for ti, (shift, limb_ids) in enumerate(term_ix[ai]):
            res[f"s{ai}_{ti}"] = torch.stack(
                [pairs(tot[ix][cand]) for ix in limb_ids])


def _decode_hc(frag, snaps, prepared, out) -> Optional[Chunk]:
    """Candidate partials -> partial-layout chunk (the groups passing the
    widened HAVING, or every group in all-groups mode)."""
    picked = out["picked"].astype(bool)
    if not picked.any():
        return None
    # sound iff the candidate buffer was not exhausted (every passing
    # group fit it); one candidate block on a single device
    if picked.all():
        raise _Fallback("group-overflow")
    return _decode_hc_rows(frag, snaps, prepared, out, picked)


def _decode_hc_rows(frag, snaps, prepared, out, picked) -> Chunk:
    """Materialize the picked candidates as a partial-layout chunk."""
    agg = frag.agg
    sched = prepared["__hc_sched__"]
    nulls = prepared["__hc_nulls__"]
    sel = np.nonzero(picked)[0]

    comb_dicts = []
    for t in frag.tables:
        snap = snaps[t.table.id]
        comb_dicts.extend(snap.dictionaries[off] for off in t.col_offsets)

    columns = []
    for gi, g in enumerate(agg.group_by):
        raw = out[f"gk{gi}"][sel]
        is_null = raw == nulls[gi]
        data = raw.astype(g.ftype.np_dtype)
        dictionary = comb_dicts[g.idx] \
            if g.ftype.is_string and isinstance(g, Col) else None
        columns.append(Column(
            g.ftype, data, None if not is_null.any() else ~is_null,
            dictionary))
    for ai, (d, s) in enumerate(zip(agg.aggs, sched)):
        # pair layout matches sumexact partials: value = hi*4096 + lo
        cnt = SE.combine_partials(out[f"cnt{ai}"])[sel]
        val_t = frag.output_types[len(agg.group_by) + 2 * ai]
        if s["kind"] == "count":
            vcol = Column(val_t, cnt.astype(np.int64))
        else:
            total = np.zeros(len(picked), dtype=np.int64)
            for ti, (_, shift, _) in enumerate(s["terms"]):
                total += SE.combine_partials(out[f"s{ai}_{ti}"]) << shift
            val = total[sel]
            vcol = Column(val_t, val.astype(val_t.np_dtype),
                          None if (cnt > 0).all() else (cnt > 0))
        columns.append(vcol)
        columns.append(Column(FieldType(TypeKind.BIGINT, nullable=False),
                              cnt.astype(np.int64)))
    return Chunk(columns)


def _empty_chunk(frag: FragmentDAG, comb_dicts) -> Chunk:
    columns = []
    for g in frag.agg.group_by:
        dictionary = comb_dicts[g.idx] \
            if g.ftype.is_string and isinstance(g, Col) else None
        columns.append(Column(g.ftype, np.empty(0, g.ftype.np_dtype),
                              None, dictionary))
    for ai, d in enumerate(frag.agg.aggs):
        vt = frag.output_types[len(frag.agg.group_by) + 2 * ai]
        columns.append(Column(vt, np.empty(0, vt.np_dtype)))
        columns.append(Column(
            FieldType(TypeKind.BIGINT, nullable=False),
            np.empty(0, np.int64)))
    return Chunk(columns)
