"""Fragment executor: gather-join trees as PyTorch programs.

Port of `tidb_tpu/copr/fragment.py`; on one device:

* build (dimension) tables are staged whole on the device, beside an int32
  permutation table perm[key - lo] -> epoch row (-1 = absent) that the host
  builds once per (epoch, key column, visibility) and the device caches;
* the probe (fact) table streams through in tiles. A join maps its key
  through perm (`idx = perm[key - lo]`, `found = idx >= 0`) and gathers the
  build columns per probe row; a join whose probe key is a plain column
  runs its gathers once per (probe epoch, build epoch, tile) and keeps the
  ALIGNED build columns cached, so later queries over the same epochs only
  apply their build filters. Chained joins (a gathered column as the next
  join's key) cost one gather each;
* four modes follow the joins:
  - "agg": the dense-segment aggregation of `client.agg_partials`;
  - "rows": a packed probe-row bitmask (8 rows a byte, first row in the
    most significant bit); the host replays the gathers for the passing
    rows and returns them in probe-row order (`out_map` columns);
  - "topn": rows with a TopN consumer whose ORDER BY packs into one int32
    composite (topnpack.py); each tile returns its top n rows, output
    columns gathered on the device, in composite order (ties: lower row
    first). An unpackable key set stays in "rows" mode;
  - "hc" (high-cardinality GROUP BY): per-group sums and a candidate
    buffer of groups, for a HAVING consumer, for a TopN consumer, or for
    every group (all-groups "group" mode). Over a run-ordered probe epoch
    `_hc_rank_body` sums in rank space with `streamseg.rank_sums` (the
    CUDA kernel on the card); otherwise `_hc_body` sorts by the segment
    keys (hcagg.py), or, run-ordered but outside streamseg's gates, takes
    raw key-change bounds. A group key that is a join's unique build key
    stands for the join's probe key (o_orderkey -> l_orderkey). When every
    ORDER BY item of a TopN consumer resolves to a group key or an exact
    SUM/COUNT/AVG, `_maybe_fused_cut` sorts the candidates by the complete
    ORDER BY on the device and ships k+1 of them ("fat" engine tag);
* semi/anti membership edges (EXISTS, IN, NOT EXISTS, NULL-aware NOT IN)
  gate the rows of every mode after the joins: the host builds a
  bool[span] bitmap of the build side's filter-passing keys (build filters
  through the host `NumpyEval`, as in the reference), the device caches it
  per epoch, and the program looks each probe key up in it. The engine
  tag gains "+semi".

Overlay rows of the probe table (committed or buffered after its epoch)
run as a second batch through the same program, gathering per query; an
overlay on a build or semi table, or on a group-space request (a group
split across batches would break the candidate buffer's guarantee), goes
to the host as in the reference.

On the mesh (a client with a `frag_axis`, `parallel/dist.py`) the probe
epoch is staged whole and sharded over the slots, the program runs once
per slot (`cop._frag_jit`), builds replicate or, for the largest build
past the client's threshold (`_partition_build`: the partitioned-join
election of an agg/hc fragment whose join key is a probe column), shard
by key with probe rows routed to their key's slot before the gathers;
the hc modes route joined rows by group-key hash before the candidate
aggregation, and the decode checks each slot's candidate block. The
run-ordered (streamseg) path, tiling and aligned build columns stay
single-device, as in the reference. An exchange overflow takes the
reference's typed route to the host tier (`exchange-overflow`).

Gates decide exactly as the reference's: where the reference raises its
`_Fallback(reason)`, the fragment runs on the port's host interpreter
(`_host_fragment`, numpy: the joins, semi/anti edges, selection and
aggregation over every visible row), tagged `host(fragment:<reason>)`.
No torch or CUDA error is caught.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import obs
from ..chunk.chunk import Chunk
from ..chunk.column import Column
from ..plan.dag import CopDAG, DAGScan
from ..plan.expr import Col
from ..plan.fragment import FragmentDAG, FragTable
from ..types.field_type import FieldType, TypeKind
from ..types.value import Decimal
from . import hcagg as HC
from . import sumexact as SE
from . import topnpack as TP
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
    _note_transfer,
    agg_partials,
    decode_agg_partials,
    fetch,
    packbits,
    widen32,
)
from .eval import CompileError, eval_expr, selection_mask
from .npeval import NumpyEval, _truthy

# widest admissible build-key span: a perm table of 64M int32 = 256 MB
FRAG_SPAN_CAP = 1 << 26


class _Fallback(Exception):
    """Raised by a device gate; carries the gate's reason."""

    def __init__(self, reason: str = "gate") -> None:
        super().__init__(reason)
        self.reason = reason


def execute_fragment(cop: CopClient, frag: FragmentDAG, snaps: dict
                     ) -> CopResult:
    """snaps: table_id -> TableSnapshot for every fragment table."""
    # placement is decided by the PROBE (fact) epoch: a sharded probe
    # makes this a mesh fragment (builds replicate or key-partition), a
    # small probe keeps the whole tree on the single-device path
    with cop.placement_scope(snaps[frag.tables[0].table.id]):
        try:
            with obs.span("copr.fragment") as sp:
                if sp:
                    sp.note = f"{len(frag.tables)} tables"
                r = _device_fragment(cop, frag, snaps)
            obs.COPR_REQUESTS.inc(engine="device-fragment")
            return r
        except (_Fallback, CompileError) as e:
            reason = getattr(e, "reason", None) or "compile"
        obs.COPR_REQUESTS.inc(engine="host-fragment")
        obs.FRAG_FALLBACKS.inc(reason=reason)
        # the host interpreter's time is join work
        with obs.operator("join"):
            r = _host_fragment(frag, snaps)
        r.engine = f"host(fragment:{reason})"
        return r


# ==================== device path ====================

def _device_fragment(cop, frag, snaps) -> CopResult:
    probe = frag.tables[0]
    psnap = snaps[probe.table.id]

    # ---- eligibility over these snapshots ----
    tab_bounds = []
    tab_dicts = []
    for ti, t in enumerate(frag.tables):
        snap = snaps[t.table.id]
        if ti > 0 and len(snap.overlay_handles) > 0:
            raise _Fallback("build-overlay")  # uncommitted build rows
        b = cop._scan_bounds(_facade_dag(t), snap)
        for ci, off in enumerate(t.col_offsets):
            if snap.epoch.columns[off].dtype == np.int64 and \
                    not fits_int32(b[ci]):
                raise _Fallback("int64-column")
        tab_bounds.append(b)
        tab_dicts.append([snap.dictionaries[off] for off in t.col_offsets])
        cop._evict_stale(t.table.id, snap.epoch.epoch_id)
    comb_bounds = [x for b in tab_bounds for x in b]
    comb_dicts = [d for ds in tab_dicts for d in ds]

    prepared: dict[Any, Any] = {"__col_bounds__": comb_bounds,
                                "__frag__": frag}

    # per-table filters resolve against their own dictionaries
    for ti, t in enumerate(frag.tables):
        for c in t.filters:
            cop._prepare_expr(c, tab_dicts[ti], prepared)
            if not expr_device_safe(c, tab_bounds[ti]):
                raise _Fallback("filter-unsafe")
    for c in frag.selection:
        cop._prepare_expr(c, comb_dicts, prepared)
        if not expr_device_safe(c, comb_bounds):
            raise _Fallback("selection-unsafe")
    if frag.agg is not None:
        # group keys and aggregate arguments can embed string predicates
        for g in frag.agg.group_by:
            cop._prepare_expr(g, comb_dicts, prepared)
        for d in frag.agg.aggs:
            if d.arg is not None:
                cop._prepare_expr(d.arg, comb_dicts, prepared)

    # join key spans: the perm table covers the build key's [lo, hi]
    spans = []
    for j in frag.joins:
        kb = tab_bounds[j.build][j.build_key_local]
        pb = expr_bounds(j.probe_key, comb_bounds)
        if kb is None or pb is None or not fits_int32(pb):
            raise _Fallback("key-width")
        lo, hi = kb
        span = hi - lo + 1
        if span > FRAG_SPAN_CAP:
            raise _Fallback("key-span")
        spans.append((lo, span))

    # semi/anti membership edges: the probe key must compute on the device;
    # the build side only needs a bounded integer key span (its bitmap is
    # built on the host, so build filters never face device gates)
    semi_spans = []
    for sm in frag.semis:
        snap = snaps[sm.table.table.id]
        if len(snap.overlay_handles) > 0:
            raise _Fallback("build-overlay")
        cop._evict_stale(sm.table.table.id, snap.epoch.epoch_id)
        cop._prepare_expr(sm.probe_key, comb_dicts, prepared)
        if not expr_device_safe(sm.probe_key, comb_bounds):
            raise _Fallback("key-width")
        kb = cop._col_stats(snap, sm.table.col_offsets[sm.build_key_local])
        pb = expr_bounds(sm.probe_key, comb_bounds)
        if kb is None or pb is None or not fits_int32(pb):
            raise _Fallback("key-width")
        lo, span = kb[0], kb[1] - kb[0] + 1
        if span > FRAG_SPAN_CAP:
            raise _Fallback("key-span")
        semi_spans.append((lo, span))
    prepared["__semi_spans__"] = semi_spans
    prepared["__n_semis__"] = len(frag.semis)

    mode = "agg" if frag.agg is not None else "rows"
    if mode == "rows" and frag.topn is not None:
        # join+topn: the consumer's ORDER BY packs into one int32
        # composite, so each tile returns only its top-n rows. An
        # unpackable key set stays in the row-bitmask mode.
        try:
            for e, _ in frag.topn.items:
                cop._prepare_expr(e, comb_dicts, prepared)
            specs, _ = TP.plan_pack(frag.topn.items, comb_bounds,
                                    comb_dicts)
        except CompileError:
            specs = None
        if specs is not None:
            TP.stage_rank_tables(specs, prepared, cop.device)
            prepared["__topn_pack__"] = specs
            mode = "topn"

    # ---- partitioned (non-broadcast) join election ----
    # a build too large to replicate is sharded by key; probe rows route
    # to the owning slot before the gathers (the MPP hash-partition
    # exchange mode vs broadcast, planner/core/fragment.go:45). One
    # partitioned join per fragment; output must be merge-safe partials
    # (agg/hc), since routed rows lose probe-row identity.
    part_ji = None
    if frag.agg is not None and cop.frag_axis is not None:
        n_probe_cols = len(frag.tables[0].col_offsets)

        def probe_prefix_only(e) -> bool:
            # the exchange routes BEFORE any gathers, so the routing key
            # must be computable from the probe table's own columns
            if isinstance(e, Col):
                return e.idx < n_probe_cols
            return all(probe_prefix_only(a) for a in getattr(e, "args", ()))

        # a build too large to replicate, by row count or by bytes (the
        # mesh client's replicate-threshold-bytes): the client decides
        big = [(snaps[frag.tables[j.build].table.id].epoch.num_rows, ji)
               for ji, j in enumerate(frag.joins)
               if cop._partition_build(snaps[frag.tables[j.build].table.id])
               and probe_prefix_only(j.probe_key)]
        if big:
            part_ji = max(big)[1]
    prepared["__part_join__"] = part_ji
    prepared["__n_joins__"] = len(frag.joins)

    if frag.agg is not None:
        n_rows = psnap.epoch.num_rows + len(psnap.overlay_handles)
        facade = _agg_facade(frag)
        err = cop._prepare_agg(facade, comb_dicts, comb_bounds, prepared,
                               n_rows)
        if err is not None:
            # dense segment space rejected (or skipped by the sparse-
            # occupancy gate): the sorted-run candidate machinery covers
            # the rest
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
        # filtered-out rows contribute zeros. Exchanges (group hash or a
        # partitioned join) re-order rows across slots, so the path is
        # single-device only.
        segcols = prepared.get("__hc_segcols__")
        has_mm = any(s["kind"] in ("min", "max")
                     for s in prepared["__hc_sched__"])
        if segcols is not None and part_ji is None and not has_mm and \
                cop.frag_axis is None and \
                cop._runs_ordered(psnap, segcols):
            prepared["__hc_runordered__"] = True
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

    if mode == "hc" and frag.hc is not None and frag.hc.items:
        _elect_fused_cut(frag, prepared, comb_dicts, n_rows, cop.device)

    # ---- build staging: whole build tables + perm tables (join work
    # in the per-operator attribution) ----
    builds = []
    with obs.operator("join"), \
            obs.stage("staging", span_name="copr.staging"):
        for ji, (j, (lo, span)) in enumerate(zip(frag.joins, spans)):
            t = frag.tables[j.build]
            snap = snaps[t.table.id]
            if ji == part_ji:
                builds.append(cop._stage_partitioned_build(
                    t, snap, lo, span, j))
                continue
            cols, vis, _, _ = cop._stage_build_table(_facade_dag(t), snap)
            key_off = t.col_offsets[j.build_key_local]
            perm = cop._place_build_array(
                _perm_array(cop, snap, key_off, lo, span),
                key=(snap.epoch.epoch_id, "perm-rep", key_off, lo, span,
                     snap.visible_digest))
            builds.append({"cols": cols, "vis": vis, "perm": perm})
        # membership bitmaps ride behind the join builds; their host-side
        # (has_null, empty) facts decide the NOT IN gates' form
        semi_flags = []
        for sm, (lo, span) in zip(frag.semis, semi_spans):
            entry = _stage_semi_bitmap(cop, sm, snaps[sm.table.table.id],
                                       lo, span)
            semi_flags.append((entry["has_null"], entry["empty"]))
            builds.append({"bm": entry["bm"]})
    prepared["__semi_flags__"] = semi_flags

    chunks: list[Chunk] = []
    if psnap.epoch.num_rows > 0:
        chunks.extend(_run_frag_batch(cop, frag, snaps, prepared, spans,
                                      builds, mode, overlay=False))
    if len(psnap.overlay_handles) > 0:
        # the hc modes gated overlay rows out above: a group split across
        # batches would break the candidate buffer's superset guarantee
        chunks.extend(_run_frag_batch(cop, frag, snaps, prepared, spans,
                                      builds, mode, overlay=True))
    if not chunks:
        chunks = [_empty_chunk(frag, comb_dicts)]
    emode = "fat" if prepared.get("__hc_fused__") else (
        "group" if prepared.get("__hc_all__") else mode)
    if frag.semis:
        emode = f"{emode}+semi"
    return CopResult(chunks, is_partial_agg=frag.agg is not None,
                     engine=cop._frag_engine(emode))


def _elect_fused_cut(frag, prepared, comb_dicts, n_rows, device) -> None:
    """join+agg+topn fused final cut: every ORDER BY item resolved to a
    group key / SUM / COUNT / AVG, so the program can sort the candidate
    buffer by the EXACT multi-key order (limb-pair digits; dictionary
    ranks for string group keys) and ship only k+1 rows; the +1 row proves
    the cut boundary tie-free at decode time. Sets `__hc_fused__` when
    every item qualifies."""
    for kind, idx, _desc in frag.hc.items:
        if kind == "agg":
            entry = prepared["__hc_sched__"][idx]
            if not TP.digits_fit(entry) or \
                    TP.count_pairs(entry) > TP.MAX_DIGIT_PAIRS:
                return
            d_ = frag.agg.aggs[idx]
            if d_.func == "avg":
                # AVG compares as the host's ROUNDED decimal (arg scale +
                # div_precincrement); the long division is int32-exact
                # only under the count cap
                at_, ot_ = d_.arg.ftype, d_.ftype
                src_sc = at_.scale if at_.is_decimal else 0
                out_sc = ot_.scale if ot_.is_decimal else 0
                if ot_.is_float or out_sc != src_sc + 4 or \
                        n_rows >= TP.AVG_CNT_CAP:
                    return
        else:
            g = frag.agg.group_by[idx]
            if g.ftype.is_string and (not isinstance(g, Col)
                                      or comb_dicts[g.idx] is None):
                return
    prepared["__hc_fused__"] = True
    for kind, idx, _desc in frag.hc.items:
        g = frag.agg.group_by[idx] if kind == "group" else None
        if g is not None and g.ftype.is_string:
            TP.stage_rank_table(prepared, ("hc_rank", idx),
                                comb_dicts[g.idx], g.ftype.is_ci, device)


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


def _perm_array(cop, snap, key_off: int, lo: int, span: int
                ) -> torch.Tensor:
    """key -> epoch row index (device int32, -1 absent), visible rows with
    a valid key only. Built on the host and cached on the device per
    (epoch, key column, lo, span, visibility); the epoch id leads the key
    so that `_evict_stale` frees it with the epoch."""
    key = (snap.epoch.epoch_id, "perm", key_off, lo, span,
           snap.visible_digest)
    with cop._lock:
        hit = cop._col_cache.get(key)
        cacheable = cop._live_epochs.get(snap.table.id) \
            == snap.epoch.epoch_id
    if hit is not None:
        return hit
    keys = snap.epoch.columns[key_off]
    valid = snap.epoch.valids[key_off]
    sel = snap.base_visible.copy()
    if valid is not None:
        sel &= valid
    idx = np.nonzero(sel)[0]
    perm = np.full(span, -1, dtype=np.int32)
    perm[keys[idx].astype(np.int64) - lo] = idx.astype(np.int32)
    dev = cop._place(perm)
    if cacheable:
        with cop._lock:
            cop._col_cache[key] = dev
    return dev


def _semi_build_facts(bcols, dicts, t, key_local: int, keep0: np.ndarray):
    """NULL-aware membership facts of a semi/anti BUILD side, over its
    (data, valid) column pairs and the initial row mask `keep0` (the
    visibility): -> (keep, has_null, key_data, ok) where `keep` marks the
    filter-passing rows (the SET, NULL-keyed members included), `has_null`
    whether the set holds a NULL key, and `ok` the valid-key member rows.
    The build filters run through the host `NumpyEval`, as in the
    reference: never through a device gate or the device's 32-bit
    evaluation, which could change the set."""
    n = len(keep0)
    keep = keep0.copy()
    if t.filters and n:
        ev = NumpyEval([(d, np.ones(n, bool) if v is None else v)
                        for d, v in bcols], dicts, n)
        for c in t.filters:
            fv, fvl = ev.eval(c)
            keep &= _truthy(np.asarray(fv)) & fvl
    kd, kv = bcols[key_local]
    has_null = bool(np.any(keep & ~kv)) if kv is not None else False
    ok = keep if kv is None else (keep & kv)
    return keep, has_null, kd, ok


def _stage_semi_bitmap(cop, sm, snap, lo: int, span: int) -> dict:
    """Device membership bitmap of a semi/anti edge: bool[span], entry
    [key - lo] set iff some visible, filter-passing build row carries that
    key. Built on the host and cached on the device per (epoch, key column,
    span, visibility, filter set); the epoch id leads the key so that
    `_evict_stale` frees it with the epoch. The NULL facts of the
    NULL-aware NOT IN ride along as host constants."""
    t = sm.table
    key_off = t.col_offsets[sm.build_key_local]
    ck = (snap.epoch.epoch_id, "semibm", key_off, lo, span,
          snap.visible_digest, repr(t.filters))
    with cop._lock:
        hit = cop._col_cache.get(ck)
        cacheable = cop._live_epochs.get(t.table.id) == snap.epoch.epoch_id
    if hit is not None:
        return hit
    bcols = [(snap.epoch.columns[off], snap.epoch.valids[off])
             for off in t.col_offsets]
    keep, has_null, kd, ok = _semi_build_facts(
        bcols, [snap.dictionaries[off] for off in t.col_offsets],
        t, sm.build_key_local, snap.base_visible)
    bm = np.zeros(span, dtype=bool)
    idx = np.nonzero(ok)[0]
    if len(idx):
        bm[kd[idx].astype(np.int64) - lo] = True
    entry = {"bm": cop._place_build_array(
        cop._place(bm), key=(snap.epoch.epoch_id, "semibm-rep", key_off, lo,
                             span, snap.visible_digest, repr(t.filters))),
             "has_null": has_null, "empty": not bool(keep.any())}
    _note_transfer(bm.nbytes)
    if cacheable:
        with cop._lock:
            cop._col_cache[ck] = entry
    return entry


def _run_frag_batch(cop, frag, snaps, prepared, spans, builds, mode,
                    overlay: bool) -> list[Chunk]:
    """One probe batch through the fragment's program: the epoch (tiled
    above TILE_ROWS in the agg, rows and topn modes), or the overlay rows
    as one small tile whose joins gather per query."""
    probe = frag.tables[0]
    psnap = snaps[probe.table.id]
    # big epochs stream through tiles exactly like the single-table path;
    # the hc paths stage the whole epoch (a group must not split across
    # tiles; rank metadata and key runs are per epoch)
    if mode in ("agg", "rows", "topn") and not overlay and \
            cop.frag_axis is None and \
            prepared.get("__part_join__") is None and \
            psnap.epoch.num_rows > cop.TILE_ROWS:
        return _run_frag_tiled(cop, frag, snaps, prepared, spans, builds,
                               mode)
    # probe-side staging is scan work, aligned build staging join work
    with obs.operator("scan"), \
            obs.stage("staging", span_name="copr.staging"):
        pcols, pvis, phost, _ = cop._stage_inputs(_facade_dag(probe),
                                                  psnap, overlay=overlay)
    # the first query over an epoch pair pays the gathers; later ones
    # read the cached aligned build columns (membership bitmaps follow)
    kern_builds = builds
    nj = len(frag.joins)
    if not overlay and nj and cop.frag_axis is None and \
            prepared.get("__part_join__") is None:
        with obs.operator("join"), \
                obs.stage("staging", span_name="copr.staging"):
            kern_builds = _stage_aligned(cop, frag, snaps, spans,
                                         builds[:nj], pcols) + builds[nj:]
    aux = None
    if mode == "hc" and prepared.get("__rank_meta__") is not None:
        aux = _stage_rank_aux(cop, psnap, prepared)
    kernel = _frag_program(cop, frag, prepared, spans, mode,
                           pcols[0][0].shape[0] if pcols else 0)
    with obs.operator(_mode_op(frag, mode)):
        with obs.stage("kernel", span_name="device.dispatch"):
            dev = kernel(pcols, pvis, kern_builds) if aux is None \
                else kernel(pcols, pvis, kern_builds, aux)
        with obs.stage("device_get", span_name="device.fetch"):
            out = fetch([dev])[0]
    if mode == "hc":
        # candidate blocks = exchange partitions (1 on a single device)
        prepared["__hc_blocks__"] = cop.hc_exchange_blocks
        chunk = _decode_hc(frag, snaps, prepared, out)
        return [] if chunk is None else [chunk]
    if mode == "agg":
        return _decode_frag_agg(frag, snaps, prepared, out)
    if mode == "topn":
        chunk = _decode_frag_topn(frag, snaps, out)
        return [] if chunk is None else [chunk]
    # row mode: the device returned a packed probe-row bitmask; the host
    # replays the gathers for the passing rows only
    n_rows = phost[0][0].shape[0] if phost else 0
    mask = np.unpackbits(out["bits"])[:n_rows].astype(bool)
    return _host_rows_for(frag, snaps, np.nonzero(mask)[0], overlay)


def _run_frag_tiled(cop, frag, snaps, prepared, spans, builds, mode
                    ) -> list[Chunk]:
    """Stream the probe through shape-bucketed tiles: one program serves
    every tile, aligned join columns are cached per (epoch pair, tile),
    per-tile agg partials merge exactly on the host, per-tile row
    bitmasks become global epoch row indices and per-tile TopN rows stay
    one chunk per tile (the host Sort/Limit above merge them)."""
    probe = frag.tables[0]
    psnap = snaps[probe.table.id]
    with obs.operator("scan"), \
            obs.stage("staging", span_name="copr.staging"):
        tiles = cop._stage_tiles(_facade_dag(probe), psnap)
    kernel = _frag_program(cop, frag, prepared, spans, mode,
                           tiles[0][0][0][0].shape[0] if tiles[0][0] else 0)
    devs = []
    nj = len(frag.joins)
    kop = _mode_op(frag, mode)
    for ti, (cols, vis, _) in enumerate(tiles):
        kb = builds
        if nj:
            with obs.operator("join"), \
                    obs.stage("staging", span_name="copr.staging"):
                kb = _stage_aligned(cop, frag, snaps, spans, builds[:nj],
                                    cols, tag=("tile", ti)) + builds[nj:]
        with obs.operator(kop), \
                obs.stage("kernel", span_name="device.dispatch"):
            devs.append(kernel(cols, vis, kb))
    with obs.operator(kop), \
            obs.stage("device_get", span_name="device.fetch"):
        outs = fetch(devs)
    if mode == "agg":
        with obs.stage("merge"):
            out = _merge_tile_outs(outs, prepared["__agg_sched__"])
        return _decode_frag_agg(frag, snaps, prepared, out)
    if mode == "topn":
        chunks = (_decode_frag_topn(frag, snaps, out) for out in outs)
        return [c for c in chunks if c is not None]
    T = cop.TILE_ROWS
    idx_parts = []
    for ti, (out, (_, _, cnt)) in enumerate(zip(outs, tiles)):
        local = np.nonzero(np.unpackbits(out["bits"])[:cnt])[0]
        if len(local):
            idx_parts.append(local + ti * T)
    idx = np.concatenate(idx_parts) if idx_parts else np.zeros(0, np.int64)
    return _host_rows_for(frag, snaps, idx, overlay=False)


def _frag_program(cop, frag, prepared, spans, mode, bucket):
    """The fragment program of one dispatch, as the client runs it (the
    body itself on one device, a slot program on the mesh)."""
    return cop._kernel(
        "frag", lambda: _frag_key(frag),
        lambda: cop._frag_jit(
            _build_frag_kernel(frag, prepared, spans, mode, cop=cop),
            mode, prepared),
        mode, bucket)


def _frag_key(frag: FragmentDAG) -> str:
    """Structural and full-expression identity of a fragment (filters and
    selections of different queries can share shapes)."""
    parts = [frag.describe()]
    for t in frag.tables:
        parts.append(repr(t.filters))
    for sm in frag.semis:
        parts.append(f"{sm.kind}|{repr(sm.table.filters)}")
    parts.append(repr(frag.selection))
    if frag.agg is not None:
        parts.append(repr(frag.agg.group_by))
        parts.append(repr(frag.agg.aggs))
    if frag.out_map is not None:
        parts.append(repr(frag.out_map))
    if frag.topn is not None:
        parts.append(f"topn{frag.topn.n}|{frag.topn.items!r}")
    if frag.hc is not None:
        parts.append(f"hc{frag.hc.k}|{frag.hc.items!r}")
    return "|".join(parts)


def _mode_op(frag, mode: str) -> str:
    """The fused program's operator label in the attribution plane: one
    program covers the whole tree, so the label names its dominant
    consumers."""
    if mode == "hc":
        if frag.hc is None:  # HAVING-filtered candidate path
            return "join+agg" if frag.joins else "agg"
        return "join+agg+topn" if frag.joins else "agg+topn"
    if mode == "topn":
        return "join+topn" if frag.joins else "topn"
    if mode == "agg":
        return "join+agg" if frag.joins else "agg"
    return "join"


def _stage_aligned(cop, frag, snaps, spans, builds, pcols, tag=None):
    """Build columns ALIGNED to the padded probe rows, cached per epoch.

    The perm lookup and the per-row column gathers are the same for every
    query over an epoch pair; only the filters and aggregates change. So
    the gathers run once per (probe epoch, build epoch, tile) and their
    results (one probe-length column per build column, and a `found` mask)
    stay on the device.

    Returns a per-join list: {'acols': ((data, valid), ...), 'found': m}
    for each join it could align (probe key a plain Col over the probe
    columns or an earlier aligned column), else the builds entry as it is
    (the program gathers that one per query)."""
    probe = frag.tables[0]
    psnap = snaps[probe.table.id]
    pep = psnap.epoch.epoch_id
    bucket = pcols[0][0].shape[0] if pcols else 0
    # combined index -> (data, valid) device pair, or None where the slot
    # belongs to a join the program gathers itself
    combined: list = list(pcols)
    out = []
    for ji, (j, (lo, span), b) in enumerate(zip(frag.joins, spans, builds)):
        t = frag.tables[j.build]
        key_e = j.probe_key
        src = None
        if isinstance(key_e, Col) and key_e.idx < len(combined):
            src = combined[key_e.idx]
        if src is None:
            out.append(b)
            combined.extend([None] * len(t.col_offsets))
            continue
        bsnap = snaps[t.table.id]
        bep = bsnap.epoch.epoch_id
        ckey = (pep, "aligned", bep, t.table.id, ji, key_e.idx, bucket,
                lo, span, tuple(t.col_offsets),
                psnap.visible_digest, bsnap.visible_digest, tag)
        with cop._lock:
            hit = cop._col_cache.get(ckey)
            cacheable = (cop._live_epochs.get(probe.table.id) == pep
                         and cop._live_epochs.get(t.table.id) == bep)
        if hit is None:
            kd, kv = src
            k = kd.to(torch.int32) - lo  # widened first: int8 keys wrap
            ridx = torch.index_select(b["perm"], 0,
                                      torch.clamp(k, 0, span - 1))
            gidx = torch.clamp(ridx, min=0)
            found = (k >= 0) & (k < span) & (ridx >= 0) & kv & \
                torch.index_select(b["vis"], 0, gidx)
            acols = tuple((torch.index_select(d, 0, gidx),
                           torch.index_select(v, 0, gidx) & found)
                          for d, v in b["cols"])
            hit = {"acols": acols, "found": found}
            if cacheable:
                with cop._lock:
                    cop._col_cache[ckey] = hit
        out.append(hit)
        combined.extend(hit["acols"])
    return out


def _decode_frag_agg(frag, snaps, prepared, out) -> list[Chunk]:
    """Fetched dense-agg partials -> partial-layout chunks."""
    if np.any(np.asarray(out.pop("overflow", 0)) > 0):
        raise _Fallback("exchange-overflow")  # join bucket skew
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


def _decode_frag_topn(frag, snaps, out) -> Optional[Chunk]:
    """Fetched top-n candidate rows -> one tree-order chunk; the host
    Sort/Limit above merge the candidate chunks of the tiles exactly.
    String columns come back as dictionary codes."""
    if not out["ints"][1].any():
        return None
    comb_dicts = []
    for t in frag.tables:
        snap = snaps[t.table.id]
        comb_dicts.extend(snap.dictionaries[off] for off in t.col_offsets)
    columns = TP.top_columns(out, frag.output_types,
                             [comb_dicts[comb] for comb in frag.out_map])
    return Chunk(columns) if columns else None


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
    los: list[int] = []
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
        los.append(b[0])

    # ---- segment-key selection (functional dependencies) ----
    # sort only by group keys that DETERMINE the rest: a build table
    # reached through a unique join whose key is determined contributes
    # all its columns (Q3 groups by l_orderkey, o_orderdate,
    # o_shippriority: the orders columns are functions of l_orderkey)
    bases = []
    acc = 0
    for t in frag.tables:
        bases.append((acc, acc + len(t.col_offsets)))
        acc += len(t.col_offsets)

    # a table's PK handle column determines every other column of that
    # table (Q10's c_custkey, c_name, c_acctbal, ... are one segment key)
    pk_comb: dict[int, int] = {}
    for ti, t in enumerate(frag.tables):
        off = getattr(t.table, "pk_handle_offset", None)
        if off is not None and off in t.col_offsets:
            pk_comb[ti] = bases[ti][0] + t.col_offsets.index(off)

    def closure(det: set) -> set:
        det = set(det)
        changed = True
        while changed:
            changed = False
            for j in frag.joins:
                rng = set(range(*bases[j.build]))
                if rng <= det:
                    continue
                if _cols_of(j.probe_key) <= det:
                    det |= rng
                    changed = True
            for ti, pc in pk_comb.items():
                rng = set(range(*bases[ti]))
                if pc in det and not rng <= det:
                    det |= rng
                    changed = True
        return det

    order = sorted(range(len(frag.agg.group_by)),
                   key=lambda gi: -spans_[gi])
    all_needed: set = set()
    for g in frag.agg.group_by:
        all_needed |= _cols_of(g)
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
            need = _cols_of(g)
            if need and not need <= closure(det):
                seg_keys.append(gi)
                # only a PLAIN column key determines its column
                if isinstance(g, Col):
                    det |= need
    if not seg_keys:
        seg_keys = [0]
    segpack = None
    if len(seg_keys) > 2:
        # group-key packing: fold several segment keys into one int32 sort
        # operand when their (span+2) code-space products fit, at most two
        # operands. Packing is a bijection on the key tuples, which is all
        # segment_bounds needs.
        groups: list[list[int]] = []
        cur: list[int] = []
        prod = 1
        for gi in seg_keys:
            card = spans_[gi] + 2
            if card > 2**31 - 2:
                return False
            if prod * card > 2**31 - 2 and cur:
                groups.append(cur)
                cur, prod = [], 1
            cur.append(gi)
            prod *= card
        groups.append(cur)
        if len(groups) > 2:
            return False
        segpack = [[(gi, los[gi], spans_[gi] + 2) for gi in g]
                   for g in groups]
    prepared["__hc_segpack__"] = segpack
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
    prepared["__hc_los__"] = los
    prepared["__hc_sched__"] = sched
    prepared["__hc_segkeys__"] = seg_keys
    # run-order eligibility: every segment key must resolve to a plain
    # PROBE column. A group key that IS the unique build key of a join
    # (o_orderkey) stands for the join's probe key (l_orderkey): equal
    # wherever the inner join matches, and unmatched runs are gated out by
    # their zero row count
    n_probe = len(frag.tables[0].col_offsets)

    def probe_local_of(e) -> Optional[int]:
        if not isinstance(e, Col):
            return None
        if e.idx < n_probe:
            return e.idx
        for j in frag.joins:
            if e.idx == bases[j.build][0] + j.build_key_local and \
                    isinstance(j.probe_key, Col) and \
                    j.probe_key.idx < n_probe:
                return j.probe_key.idx
        return None

    segcols: Optional[list[int]] = []
    segprobe: list[int] = []
    for gi in seg_keys:
        local = probe_local_of(frag.agg.group_by[gi])
        if local is None:
            segcols = None
            break
        segprobe.append(local)
        segcols.append(frag.tables[0].col_offsets[local])
    prepared["__hc_segcols__"] = segcols
    prepared["__hc_segprobe__"] = segprobe if segcols else None
    return True


def _build_frag_kernel(frag, prepared, spans, mode, cop=None):
    """(probe cols, visibility, builds[, rank aux]) -> device outputs:
    agg partials, hc candidates, or {"bits": packed row mask}. On the
    mesh the body runs once per shard slot: the join exchange routes
    probe rows to the slot owning their key of a partitioned build before
    the gathers, the hc exchange routes joined rows by group-key hash
    after them."""
    agg = frag.agg
    if mode == "agg":
        cards = prepared["__dense_cards__"]
        segments = 1
        for c in cards:
            segments *= max(c, 1)
    # group-partition exchange: the distributed client routes joined rows
    # by group-key hash so each slot owns whole groups
    hc_exchange = None
    if mode == "hc" and cop is not None:
        hc_exchange = cop._hc_exchange_fn(frag, prepared)
    # partitioned-join exchange: probe rows route by join key to the slot
    # holding that key of the interleaved build shard
    part_ji = prepared.get("__part_join__")
    join_exchange = None
    if part_ji is not None and cop is not None:
        join_exchange = cop._join_exchange_fn(frag, prepared, spans)
        part_axis = cop.frag_axis
        part_span = spans[part_ji][1]
        part_n_dev = cop.mesh.size
        part_per_dev = -(-part_span // part_n_dev)
    semi_spans = prepared.get("__semi_spans__", ())
    semi_flags = prepared.get("__semi_flags__", ())

    def kernel(pcols, pvis, builds, aux=None):
        cols = widen32(list(pcols))
        mask = pvis
        if frag.tables[0].filters:
            # probe filters (local space == combined prefix) gate rows
            # before any gather
            mask = selection_mask(frag.tables[0].filters, cols, prepared,
                                  mask)
        overflow_j = None
        if join_exchange is not None:
            cols, mask, overflow_j = join_exchange(cols, mask)
        for ji, (j, (lo, span), b) in enumerate(
                zip(frag.joins, spans, builds)):
            t = frag.tables[j.build]
            if "acols" in b:
                # aligned join: the columns already sit in probe-row
                # order; only the query's build filters remain
                found = b["found"]
                acols = widen32(list(b["acols"]))
                if t.filters:
                    found = selection_mask(t.filters, acols, prepared, found)
                for d, v in acols:
                    cols.append((d, v & found))
                mask = mask & found
                continue
            key_v, key_vl = eval_expr(j.probe_key, cols, prepared)
            k = key_v.to(torch.int32) - lo
            if ji == part_ji:
                # rows were routed here by k % n (interleaved build
                # ownership): gather against the LOCAL slice, whose index
                # for key k is k // n
                from ..parallel.dist import axis_index
                slot = axis_index(part_axis)
                local = torch.div(k, part_n_dev, rounding_mode="floor")
                inrange = (k >= 0) & (k < span) & (k % part_n_dev == slot)
                gidx = torch.clamp(local, 0, part_per_dev - 1)
                bmask = b["present"]
                if t.filters:
                    bmask = selection_mask(t.filters, widen32(b["bykey"]),
                                           prepared, bmask)
                found = inrange & key_vl & torch.index_select(bmask, 0, gidx)
                for d, v in widen32(b["bykey"]):
                    cols.append((torch.index_select(d, 0, gidx),
                                 torch.index_select(v, 0, gidx) & found))
                mask = mask & found
                continue
            ridx = torch.index_select(b["perm"], 0,
                                      torch.clamp(k, 0, span - 1))
            found = (k >= 0) & (k < span) & (ridx >= 0) & key_vl
            gidx = torch.clamp(ridx, min=0)
            # build visibility and filters over the FULL build columns,
            # gathered per probe row
            bcols = widen32(list(b["cols"]))
            bmask = b["vis"]
            if t.filters:
                bmask = selection_mask(t.filters, bcols, prepared, bmask)
            found = found & torch.index_select(bmask, 0, gidx)
            for d, v in bcols:
                cols.append((torch.index_select(d, 0, gidx),
                             torch.index_select(v, 0, gidx) & found))
            mask = mask & found
        # semi/anti membership gates: bitmap lookups over the combined
        # columns (after every gather, so keys from build tables work),
        # NULL-aware for the NOT IN (ANTI_NULL) form
        for si, sm in enumerate(frag.semis):
            has_null, empty = semi_flags[si]
            if sm.kind == "ANTI_NULL" and empty:
                continue  # NOT IN (empty set) keeps every row
            if sm.kind == "ANTI_NULL" and has_null:
                # a NULL in the subquery's set: no row qualifies
                mask = torch.zeros_like(mask)
                continue
            lo_s, span_s = semi_spans[si]
            kv_s, kvl_s = eval_expr(sm.probe_key, cols, prepared)
            ks = kv_s.to(torch.int32) - lo_s
            inr = (ks >= 0) & (ks < span_s)
            bm = builds[len(frag.joins) + si]["bm"]
            hit = torch.index_select(bm, 0, torch.clamp(ks, 0, span_s - 1)) \
                & inr & kvl_s
            if sm.kind == "SEMI":
                mask = mask & hit
            elif sm.kind == "ANTI":
                mask = mask & ~hit  # a NULL probe key never matches: kept
            else:  # ANTI_NULL over a NULL-free set: NULL probe key filtered
                mask = mask & kvl_s & ~hit
        if frag.selection:
            mask = selection_mask(frag.selection, cols, prepared, mask)
        if mode == "agg":
            out = agg_partials(agg, prepared, cards, segments, cols, mask)
            if overflow_j is not None:
                out["overflow"] = overflow_j
            return out
        if mode == "hc":
            if hc_exchange is not None:
                cols, mask, overflow = hc_exchange(cols, mask)
                res = _hc_body(frag, prepared, cols, mask)
                res["overflow"] = overflow if overflow_j is None \
                    else overflow + overflow_j
                return res
            res = _hc_body(frag, prepared, cols, mask, aux)
            if overflow_j is not None:
                res["overflow"] = overflow_j
            return res
        if mode == "topn":
            return _topn_rows(frag, prepared, cols, mask)
        return {"bits": packbits(mask)}

    return kernel


def _topn_rows(frag, prepared, cols, mask):
    """Fused multi-key TopN: ONE int32 composite ranks the joined rows and
    the n winners' output columns gather on the device, so the candidate
    rows are the only bytes fetched (topnpack.top_rows)."""
    score = TP.packed_score(prepared["__topn_pack__"], cols, prepared, mask,
                            eval_expr)
    outs = [(*cols[comb], frag.output_types[pos].is_float)
            for pos, comb in enumerate(frag.out_map)]
    return TP.top_rows(score, mask, frag.topn.n, outs)


def _hc_rank_body(frag, prepared, cols, mask, aux):
    """Rank-space hc aggregation over run-ordered input (streamseg).

    `streamseg.rank_sums` turns per-row masked value arrays into exact
    per-GROUP sums indexed by rank (= position among distinct key runs);
    the score and the candidate buffer then work on the rank axis. Group
    keys for candidates are gathered at each rank's first row (r0): within
    a run every group key is constant, so any row serves; fully-masked
    runs are gated by a zero row count."""
    from . import streamseg as SS

    agg = frag.agg
    hc = frag.hc
    nulls = prepared["__hc_nulls__"]
    sched = prepared["__hc_sched__"]
    meta = prepared["__rank_meta__"]
    encs = _group_encs(agg, cols, prepared, nulls)

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
        """(approximate f32 value, count) of aggregate ai per rank."""
        cnt = tot[cnt_ix[ai]]
        if sched[ai]["kind"] == "count":
            return cnt, cnt
        sv = torch.zeros_like(cnt)
        for shift, limb_ids in term_ix[ai]:
            t = torch.zeros_like(cnt)
            for pos, ix in enumerate(limb_ids):
                t = t + tot[ix] * float(1 << (SE.LIMB_BITS * pos))
            sv = sv + t * float(1 << shift)
        return sv, cnt

    if hc is None:
        # HAVING-filtered groups (all-groups mode passes every group)
        pass_m = gate
        for (ai, op, thr) in (frag.having or ()):
            pass_m = pass_m & _having_ok(agg_f32(ai)[0], op, thr)
        score = torch.where(pass_m, 1.0, float("-inf"))
        # exact top-k by score (the reference's approx_max_k at recall
        # 1.0): every passing rank scores 1.0, so whenever fewer than
        # k_cap ranks pass, the candidate set holds all of them
        k_cap = min(FragmentDAG.HAVING_CAP, score.shape[0])
        cand = TP.topk_desc(score, k_cap)
        rows_of = r0[cand]
        res = {"picked": pass_m[cand].to(torch.int32), "score": score[cand]}
        for gi in range(len(agg.group_by)):
            res[f"gk{gi}"] = encs[gi][rows_of]
        _emit_pairs(res, sched, term_ix, cnt_ix, tot, cand)
        return res

    # ---- candidate selection by (approximate) primary sort score ----
    kind, idx = hc.score
    if kind == "group":
        enc_r = encs[idx][r0]
        sv = enc_r.to(torch.float32)
        score_null = enc_r == nulls[idx]
    else:
        d = agg.aggs[idx]
        sv, cnt = agg_f32(idx)
        if sched[idx]["kind"] == "count":
            score_null = torch.zeros_like(gate)
        else:
            if d.func == "avg":
                sv = sv / torch.clamp(cnt, min=1.0)
            score_null = cnt == 0
    score = _topn_score(sv, score_null, gate, hc.desc)
    k_cap = min(hc.cap, score.shape[0])
    cand = TP.topk_desc(score, k_cap)
    rows_of = r0[cand]
    res = {"picked": gate[cand].to(torch.int32), "score": score[cand]}
    for gi in range(len(agg.group_by)):
        res[f"gk{gi}"] = encs[gi][rows_of]
    _emit_pairs(res, sched, term_ix, cnt_ix, tot, cand)
    return _maybe_fused_cut(frag, prepared, res)


def _having_ok(sv, op, thr):
    """A safely WIDENED HAVING predicate over f32 aggregate values (f32
    relative error margin): completeness is what matters; the host
    Selection above re-applies it exactly."""
    eps = torch.abs(sv) * 2.0 ** -18 + 2.0
    thr_f = float(np.float32(thr))  # the threshold as an f32 value
    if op == "gt":
        return sv > thr_f - eps
    if op == "ge":
        return sv >= thr_f - eps
    if op == "lt":
        return sv < thr_f + eps
    return sv <= thr_f + eps


def _topn_score(sv, score_null, gate, desc):
    """Signed f32 candidate score of a TopN consumer. MySQL NULL ordering:
    first in ASC, last in DESC. ASC -> +inf makes a NULL group a sure
    candidate; DESC uses a FINITE floor (below any real sum) so NULL groups
    still outrank non-groups (-inf), which keeps "not every slot picked" a
    proof that every group is a candidate."""
    signed = sv if desc else -sv
    signed = torch.where(score_null, -1e38 if desc else float("inf"),
                         signed)
    return torch.where(gate, signed, float("-inf"))


def _group_encs(agg, cols, prepared, nulls) -> list[torch.Tensor]:
    """int32 group-key codes per row, NULL as the key's code nulls[gi]."""
    encs = []
    for gi, g in enumerate(agg.group_by):
        v, vl = eval_expr(g, cols, prepared)
        encs.append(torch.where(vl, v.to(torch.int32), nulls[gi]))
    return encs


def _hc_body(frag, prepared, cols, mask, aux=None):
    """Sorted-run candidate aggregation (hcagg.py).

    Sorts by the SEGMENT keys only (`_prepare_hc` proved the other group
    keys constant within a segment); a run-ordered epoch outside
    streamseg's gates keeps storage order and takes raw key-change bounds
    instead. Per-row prefix pair sums give every segment's exact sums at
    its start row; the candidate buffer is the top rows by an f32 score
    recombined from them. Run-ordered epochs with rank metadata go to the
    streamseg rank-space body."""
    if aux is not None and prepared.get("__rank_meta__") is not None:
        return _hc_rank_body(frag, prepared, cols, mask, aux)
    agg = frag.agg
    hc = frag.hc
    nulls = prepared["__hc_nulls__"]
    sched = prepared["__hc_sched__"]
    seg_keys = prepared["__hc_segkeys__"]
    runord = bool(prepared.get("__hc_runordered__"))
    n = mask.shape[0]
    encs = _group_encs(agg, cols, prepared, nulls)

    # min/max rides the sort: one extra ascending operand (complement for
    # max) after the segment keys, so each segment's first row holds the
    # aggregate; NULL/dropped rows take the I32_MAX sentinel and sort last
    # within their segment (gated by cnt at decode)
    mm_ai = next((ai for ai, s_ in enumerate(sched)
                  if s_["kind"] in ("min", "max")), None)
    mm_enc = None
    if mm_ai is not None:
        assert not runord  # _device_fragment keeps min/max on the sort
        mv, mvl = eval_expr(agg.aggs[mm_ai].arg, cols, prepared)
        mv32 = mv.to(torch.int32)
        if sched[mm_ai]["kind"] == "max":
            mv32 = -1 - mv32  # order-reversing, wrap-free
        mm_enc = torch.where(mask & mvl, mv32, HC._I32_MAX)
    if runord:
        # storage order already groups the segment keys: boundaries are
        # raw key-change points of the PROBE columns; rows dropped by the
        # mask stay in place and add zero to every sum, and a segment whose
        # rows were ALL dropped is gated out by its row count below
        perm = None
        sk = [cols[i][0].to(torch.int32)
              for i in prepared["__hc_segprobe__"]]
        is_start, end_idx = HC.segment_bounds(
            sk, torch.ones(n, dtype=torch.bool, device=mask.device))
        valid = None
    else:
        segpack = prepared.get("__hc_segpack__")
        if segpack is not None:
            # packed operands: Horner over the NULL-encoded shifted codes,
            # a bijection on the key tuples
            operands = []
            for grp in segpack:
                k = None
                for gi, lo, card in grp:
                    code = encs[gi] - lo
                    k = code if k is None else k * card + code
                operands.append(k)
        else:
            operands = [encs[gi] for gi in seg_keys]
        sort_keys = [torch.where(mask, operands[0], HC._I32_MAX)] + \
            operands[1:]
        n_seg_ops = len(sort_keys)
        if mm_enc is not None:
            sort_keys.append(mm_enc)
        sk, perm = HC.sort_by_keys(sort_keys)
        valid = sk[0] != HC._I32_MAX
        is_start, end_idx = HC.segment_bounds(sk[:n_seg_ops], valid)
    iota = torch.arange(n, dtype=torch.int32, device=mask.device)

    def pair_stack(values_i32, n_limbs):
        """-> int32[n_limbs, 2, n] per-row segment pair sums."""
        v_sorted = values_i32 if perm is None else values_i32[perm]
        outs = []
        for li in SE.limbs_of(v_sorted, n_limbs):
            hi, lo = HC.seg_sum_pairs(li, iota, end_idx)
            outs.append(torch.stack([hi, lo]))
        return torch.stack(outs)

    def pairs_to_f32(pairs):
        """[L, 2, n] pair sums -> approximate per-row f32 value (the
        reference's order of operations)."""
        total = torch.zeros(n, dtype=torch.float32, device=mask.device)
        for li in range(pairs.shape[0]):
            v = pairs[li, 0].to(torch.float32) * 4096.0 + \
                pairs[li, 1].to(torch.float32)
            total = total + v * float(1 << (SE.LIMB_BITS * li))
        return total

    def sum_f32(ai):
        sv = torch.zeros(n, dtype=torch.float32, device=mask.device)
        for ti, (_t, shift, _L) in enumerate(sched[ai]["terms"]):
            sv = sv + pairs_to_f32(out[f"hc_s{ai}_{ti}"]) * float(1 << shift)
        return sv

    out = {"hc_rows": pair_stack(mask.to(torch.int32), 1)}
    for ai, (d, s) in enumerate(zip(agg.aggs, sched)):
        if s["kind"] == "count":
            if d.arg is not None:
                _, vl = eval_expr(d.arg, cols, prepared)
                out[f"hc_cnt{ai}"] = pair_stack((mask & vl).to(torch.int32),
                                                1)
            else:
                out[f"hc_cnt{ai}"] = out["hc_rows"]
            continue
        _, vl = eval_expr(d.arg, cols, prepared)
        contrib = mask & vl
        out[f"hc_cnt{ai}"] = pair_stack(contrib.to(torch.int32), 1)
        if s["kind"] in ("min", "max"):
            continue  # the value is the sorted mm operand below
        for ti, (t, shift, L) in enumerate(s["terms"]):
            tv, _ = eval_expr(t, cols, prepared)
            tv32 = torch.where(contrib, tv.to(torch.int32), 0)
            out[f"hc_s{ai}_{ti}"] = pair_stack(tv32, L)

    # a raw segment whose rows were ALL filtered out is not a group at all
    # (run-ordered only; the sort path moves dropped rows to the end)
    if runord:
        rp = out["hc_rows"]
        seg_rows = rp[0, 0].to(torch.float32) * 4096.0 + \
            rp[0, 1].to(torch.float32)  # exact: counts < 2^24
        gate = is_start & (seg_rows > 0)
    else:
        gate = is_start & valid

    if hc is None:
        # all-groups mode / HAVING: every surviving group is a candidate
        # (score 1.0), HAVING predicates widened; the decode checks the
        # buffer was not exhausted
        pass_m = gate
        for (ai, op, thr) in (frag.having or ()):
            sv_h = pairs_to_f32(out[f"hc_cnt{ai}"]) \
                if sched[ai]["kind"] == "count" else sum_f32(ai)
            pass_m = pass_m & _having_ok(sv_h, op, thr)
        score = torch.where(pass_m, 1.0, float("-inf"))
        k_cap = min(FragmentDAG.HAVING_CAP, n)
    else:
        kind, idx = hc.score
        if kind == "group":
            enc = encs[idx] if perm is None else encs[idx][perm]
            sv = enc.to(torch.float32)
            score_null = enc == nulls[idx]
        elif sched[idx]["kind"] == "count":
            sv = pairs_to_f32(out[f"hc_cnt{idx}"])
            score_null = torch.zeros(n, dtype=torch.bool, device=mask.device)
        else:
            sv = sum_f32(idx)
            cnt = pairs_to_f32(out[f"hc_cnt{idx}"])
            if agg.aggs[idx].func == "avg":
                sv = sv / torch.clamp(cnt, min=1.0)
            score_null = cnt == 0  # SUM/AVG over no valid rows is NULL
        score = _topn_score(sv, score_null, gate, hc.desc)
        k_cap = min(hc.cap, n)

    # exact selection by score, ties to the lower row (the reference's
    # approx_max_k at recall 1.0)
    cand = TP.topk_desc(score, k_cap)
    res = {"picked": (gate if hc is not None else pass_m)[cand].to(
               torch.int32),
           "score": score[cand]}
    rows_of = cand if perm is None else perm[cand]
    for gi in range(len(agg.group_by)):
        res[f"gk{gi}"] = encs[gi][rows_of]
    for ai, s in enumerate(sched):
        res[f"cnt{ai}"] = out[f"hc_cnt{ai}"][:, :, cand]
        for ti in range(len(s.get("terms", ()))):
            res[f"s{ai}_{ti}"] = out[f"hc_s{ai}_{ti}"][:, :, cand]
    if mm_ai is not None:
        res[f"mm{mm_ai}"] = sk[-1][cand]
    return _maybe_fused_cut(frag, prepared, res)


def _maybe_fused_cut(frag, prepared, res):
    """Exact final ordering for the fused join+agg+topn mode: sort the
    candidate buffer by the COMPLETE ORDER BY (exact limb-pair digits for
    SUM/COUNT/AVG items, rank/complement codes for group keys, MySQL NULL
    placement, candidate order as the final tie-break), then cut the heavy
    arrays to k+1 rows. `picked` and `score` stay cap-long in sorted order:
    the decode's soundness check needs the whole buffer."""
    if not prepared.get("__hc_fused__"):
        return res
    sched = prepared["__hc_sched__"]
    nulls = prepared["__hc_nulls__"]
    los = prepared["__hc_los__"]
    cap = res["picked"].shape[0]
    keys = [1 - res["picked"]]  # picked candidates lead
    for kind, idx, desc in frag.hc.items:
        if kind == "group":
            enc = res[f"gk{idx}"]
            isnull = enc == nulls[idx]
            table = prepared.get(("hc_rank", idx))
            val = table[torch.clamp(enc, 0, table.shape[0] - 1)] \
                if table is not None else enc
            # DESC reverses with -1 - val (order-reversing and wrap-free
            # over int32). NULL folds into the value operand when the
            # sentinel cannot collide with a real value (lo > I32_MIN);
            # otherwise a separate flag operand leads
            safe = table is not None or los[idx] > TP.I32_MIN
            if desc:  # NULL last; larger value first
                rev = -1 - val
                if safe:
                    keys.append(torch.where(isnull, TP.I32_MAX, rev))
                else:
                    keys += [isnull.to(torch.int32),
                             torch.where(isnull, 0, rev)]
            else:     # NULL first; smaller value first
                if safe:
                    keys.append(torch.where(isnull, TP.I32_MIN, val))
                else:
                    keys += [(~isnull).to(torch.int32),
                             torch.where(isnull, 0, val)]
            continue
        s_ = sched[idx]
        if s_["kind"] == "count":
            contribs = [(0, res[f"cnt{idx}"])]
            isnull = None  # COUNT is never NULL
        else:
            contribs = [(sh, res[f"s{idx}_{ti}"])
                        for ti, (_t, sh, _L) in enumerate(s_["terms"])]
            cntp = res[f"cnt{idx}"]
            cnt = cntp[0, 0] * 4096 + cntp[0, 1]
            isnull = cnt == 0  # SUM/AVG over no valid rows is NULL
        if s_["kind"] != "count" and frag.agg.aggs[idx].func == "avg":
            keys.extend(TP.avg_sort_keys(TP.pair_digits(contribs), cnt,
                                         isnull, desc))
            continue
        dks = TP.digit_sort_keys(TP.pair_digits(contribs), desc)
        if isnull is not None:
            # the signed head is carry-bounded well inside int32, so the
            # NULL sentinel folds into it (first-ASC / last-DESC)
            sent = TP.I32_MAX if desc else TP.I32_MIN
            dks = [torch.where(isnull, sent, dks[0])] + \
                [torch.where(isnull, 0, dk) for dk in dks[1:]]
        keys.extend(dks)
    perm = HC.lexsort_perm(keys)
    kcut = min(cap, frag.hc.k + 1)
    return {name: v[perm] if name in ("picked", "score")
            else v[..., perm[:kcut]] for name, v in res.items()}


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
    """Candidate partials -> partial-layout chunk: the groups passing the
    widened HAVING, every group in all-groups mode, or the TopN
    candidates (the final k after the fused cut); the host HashAgg(final)
    + Sort + Limit above rank them exactly."""
    if np.any(np.asarray(out.pop("overflow", 0)) > 0):
        raise _Fallback("exchange-overflow")  # adversarial skew
    picked = out["picked"].astype(bool)
    if not picked.any():
        return None
    blocks = max(1, int(prepared.get("__hc_blocks__", 1)))
    if frag.hc is None:
        # sound iff no candidate BLOCK was exhausted (every passing group
        # of that exchange partition fit its buffer); blocks are per
        # slot on the mesh, one on a single device
        kb = len(picked) // blocks
        for b in range(blocks):
            if picked[b * kb:(b + 1) * kb].all():
                raise _Fallback("group-overflow")
        return _decode_hc_rows(frag, snaps, prepared, out, picked)
    # candidate blocks are per exchange partition (disjoint group spaces):
    # each partition's buffer is verified on its own
    if not HC.candidate_blocks_sound(picked, out["score"], frag.hc.k,
                                     blocks):
        raise _Fallback("hc-boundary")
    if prepared.get("__hc_fused__"):
        return _decode_fat(frag, snaps, prepared, out)
    return _decode_hc_rows(frag, snaps, prepared, out, picked)


def _decode_fat(frag, snaps, prepared, out) -> Optional[Chunk]:
    """Fused-cut candidates -> the final k groups per candidate block.

    The program shipped each block's candidates in EXACT final order with
    the heavy arrays cut to k+1 rows; take the first min(picked, k) rows
    of each block and check
    the cut boundary is tie-free on every ORDER BY item (row k-1 must
    differ from row k): an all-key tie is ambiguous against the host's
    stable sort, and the reference concedes it to its host interpreter."""
    k = frag.hc.k
    blocks = max(1, int(prepared.get("__hc_blocks__", 1)))
    picked_full = out["picked"].astype(bool)
    cap = len(picked_full) // blocks
    probe = out.get("gk0")
    if probe is None:
        probe = out.get("cnt0")
    kcut = probe.shape[-1] // blocks

    def row_key(block: int, pos: int) -> tuple:
        p = block * kcut + pos
        vals: list = []
        for kind, idx, _desc in frag.hc.items:
            if kind == "group":
                vals.append(int(out[f"gk{idx}"][p]))
                continue
            s_ = prepared["__hc_sched__"][idx]
            cnt = int(SE.combine_partials(
                out[f"cnt{idx}"][:, :, p:p + 1])[0])
            if s_["kind"] == "count":
                vals.append(cnt)
                continue
            v = 0
            for ti, (_t, sh, _L) in enumerate(s_["terms"]):
                v += int(SE.combine_partials(
                    out[f"s{idx}_{ti}"][:, :, p:p + 1])[0]) << sh
            if frag.agg.aggs[idx].func == "avg":
                # the item compares as the host's rounded decimal: the
                # tie check uses the SAME value
                if cnt == 0:
                    vals.append((True, 0))
                    continue
                at_ = frag.agg.aggs[idx].arg.ftype
                sc = at_.scale if at_.is_decimal else 0
                q = Decimal(v, sc).div(Decimal.from_int(cnt))
                vals.append((False, q.unscaled))
                continue
            vals.append((cnt == 0, v))  # NULL flag + exact value
        return tuple(vals)

    sel = np.zeros(blocks * kcut, dtype=bool)
    for b in range(blocks):
        npicked = int(picked_full[b * cap:(b + 1) * cap].sum())
        take = min(npicked, k, kcut)
        if npicked > k and kcut > k and \
                row_key(b, k - 1) == row_key(b, k):
            raise _Fallback("fat-boundary")
        sel[b * kcut: b * kcut + take] = True
    if not sel.any():
        return None
    heavy = {name: v for name, v in out.items()
             if name not in ("picked", "score")}
    return _decode_hc_rows(frag, snaps, prepared, heavy, sel)


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
        elif s["kind"] in ("min", "max"):
            enc = out[f"mm{ai}"][sel].astype(np.int64)
            val = enc if s["kind"] == "min" else -1 - enc
            val = np.where(cnt > 0, val, 0)  # sentinel-filled when empty
            vcol = Column(val_t, val.astype(val_t.np_dtype),
                          None if (cnt > 0).all() else (cnt > 0))
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


# ==================== row-mode replay and the host interpreter ==========

def _host_rows_for(frag, snaps, probe_idx, overlay: bool) -> list[Chunk]:
    """Joined output rows (`out_map` order) for the given probe rows of
    one batch (the epoch's, or the overlay's)."""
    cols, valids, dicts = _host_join(frag, snaps, probe_idx, overlay)
    if cols is None:
        return []
    return _rows_chunk(frag, cols, valids, dicts)


def _rows_chunk(frag, cols, valids, dicts) -> list[Chunk]:
    columns = []
    for pos, comb in enumerate(frag.out_map):
        ft = frag.output_types[pos]
        v = valids[comb]
        columns.append(Column(ft, cols[comb].astype(ft.np_dtype),
                              None if v.all() else v, dicts[comb]))
    if not columns:
        return []
    return [Chunk(columns)]


def _host_fragment(frag: FragmentDAG, snaps: dict) -> CopResult:
    """The same FragmentDAG interpreted in numpy over every visible row —
    the reference's answer when a snapshot fails a device gate. The same
    chunks as the device path: partial agg layout or `out_map` rows."""
    cols, valids, dicts = _host_join(frag, snaps, None)
    if cols is None:
        return CopResult([], is_partial_agg=frag.agg is not None)
    if frag.agg is None:
        return CopResult(_rows_chunk(frag, cols, valids, dicts),
                         is_partial_agg=False)
    chunk = _host_agg(frag, cols, valids, dicts)
    return CopResult([] if chunk is None else [chunk], is_partial_agg=True)


def _full_host_cols(snap, col_offsets):
    """(data, valid) per column over the visible epoch rows, then the
    overlay rows."""
    vis = snap.base_visible
    n_o = len(snap.overlay_handles)
    out = []
    for off in col_offsets:
        d = snap.epoch.columns[off][vis]
        v = snap.epoch.valids[off]
        v = None if v is None else v[vis]
        if n_o:
            od = snap.overlay_columns[off]
            ov = snap.overlay_valids[off]
            d = np.concatenate([d, od])
            if v is not None or ov is not None:
                va = np.ones(len(d) - n_o, bool) if v is None else v
                vb = np.ones(n_o, bool) if ov is None else ov
                v = np.concatenate([va, vb])
        out.append((d, v))
    return out


def _host_join(frag, snaps, probe_idx, overlay: bool = False):
    """Vectorized host join: -> (cols, valids, dicts) in combined order for
    the surviving rows, or (None, None, None) when none survives.

    With `probe_idx` (the row mode's replay) the rows are those probe rows
    of one batch, the epoch's or the overlay's, with NO further filtering:
    the device already applied every filter and gate. Without it (the host
    interpreter) the probe rows are every visible row, and the filters,
    joins, semi/anti edges and the selection all apply here. Builds are
    their visible rows plus their overlay rows (the device path gates
    build overlays out, so a replay sees the epoch's visible rows)."""
    probe = frag.tables[0]
    psnap = snaps[probe.table.id]
    filtered = probe_idx is None
    if filtered:
        base = _full_host_cols(psnap, probe.col_offsets)
    else:
        base = []
        for off in probe.col_offsets:
            if overlay:
                d, v = psnap.overlay_columns[off], psnap.overlay_valids[off]
            else:
                d, v = psnap.epoch.columns[off], psnap.epoch.valids[off]
            base.append((d[probe_idx], None if v is None else v[probe_idx]))
    cols = [d for d, _ in base]
    valids = [np.ones(len(d), bool) if v is None else v.copy()
              for d, v in base]
    dicts = [psnap.dictionaries[off] for off in probe.col_offsets]
    nrows = len(cols[0]) if cols else 0
    keep = np.ones(nrows, bool)

    if filtered and probe.filters:
        ev = NumpyEval(list(zip(cols, valids)), dicts, nrows)
        for c in probe.filters:
            fv, fvl = ev.eval(c)
            keep &= _truthy(np.asarray(fv)) & fvl

    for j in frag.joins:
        t = frag.tables[j.build]
        snap = snaps[t.table.id]
        bcols = _full_host_cols(snap, t.col_offsets)
        bn = len(bcols[0][0]) if bcols else 0
        bkeep = np.ones(bn, bool)
        bdicts = [snap.dictionaries[off] for off in t.col_offsets]
        if filtered and t.filters:
            bev = NumpyEval([(d, np.ones(bn, bool) if v is None else v)
                             for d, v in bcols], bdicts, bn)
            for c in t.filters:
                fv, fvl = bev.eval(c)
                bkeep &= _truthy(np.asarray(fv)) & fvl
        # unique-key mapping via sorted search
        kd, kv = bcols[j.build_key_local]
        ok = bkeep if kv is None else bkeep & kv
        bidx = np.nonzero(ok)[0]
        bkeys = kd[bidx].astype(np.int64)
        order = np.argsort(bkeys, kind="stable")
        skeys = bkeys[order]
        srows = bidx[order]

        pk, pkv = NumpyEval(list(zip(cols, valids)), dicts,
                            nrows).eval(j.probe_key)
        pk = np.asarray(pk).astype(np.int64)
        pos = np.searchsorted(skeys, pk)
        pos_safe = np.clip(pos, 0, max(len(skeys) - 1, 0))
        found = np.zeros(nrows, bool) if len(skeys) == 0 else (
            (pos < len(skeys)) & (skeys[pos_safe] == pk))
        found &= np.asarray(pkv)
        rows = srows[pos_safe] if len(skeys) else np.zeros(nrows, np.int64)
        keep &= found
        safe_rows = np.where(found, rows, 0)
        for d, v in bcols:
            cols.append(d[safe_rows])
            valids.append((np.ones(nrows, bool) if v is None
                           else v[safe_rows]) & found)
        dicts.extend(bdicts)

    if filtered and nrows:
        # semi/anti membership edges (the device twin: the bitmap lookups
        # of _build_frag_kernel)
        for sm in frag.semis:
            snap = snaps[sm.table.table.id]
            bcols = _full_host_cols(snap, sm.table.col_offsets)
            bn = len(bcols[0][0]) if bcols else 0
            bkeep, has_null, kd, ok = _semi_build_facts(
                bcols, [snap.dictionaries[off]
                        for off in sm.table.col_offsets],
                sm.table, sm.build_key_local, np.ones(bn, bool))
            skeys = np.unique(kd[ok].astype(np.int64))
            pk, pkv = NumpyEval(list(zip(cols, valids)), dicts,
                                nrows).eval(sm.probe_key)
            pkv = np.asarray(pkv)
            found = np.isin(np.asarray(pk).astype(np.int64), skeys) & pkv
            if sm.kind == "SEMI":
                keep &= found
            elif sm.kind == "ANTI":
                keep &= ~found
            elif bkeep.any():  # ANTI_NULL: NULL-aware NOT IN
                # a NULL in the set keeps no row; NOT IN (empty set)
                # keeps every row
                keep &= False if has_null else (pkv & ~found)

    if filtered and frag.selection and nrows:
        ev = NumpyEval(list(zip(cols, valids)), dicts, nrows)
        for c in frag.selection:
            fv, fvl = ev.eval(c)
            keep &= _truthy(np.asarray(fv)) & fvl

    if filtered:
        idx = np.nonzero(keep)[0]
        if len(idx) == 0:
            return None, None, None
        cols = [c[idx] for c in cols]
        valids = [v[idx] for v in valids]
    elif nrows == 0:
        return None, None, None
    return cols, valids, dicts


def _host_agg(frag, cols, valids, dicts) -> Optional[Chunk]:
    """Partial-layout aggregation over joined host rows (numpy)."""
    agg = frag.agg
    n = len(cols[0]) if cols else 0
    if n == 0:
        return None
    ev = NumpyEval(list(zip(cols, valids)), dicts, n)
    keys = []
    for g in agg.group_by:
        gv, gvl = ev.eval(g)
        gv = np.asarray(gv)
        enc = gv.astype(np.float64).view(np.int64) \
            if np.issubdtype(gv.dtype, np.floating) else gv.astype(np.int64)
        keys.append((np.where(gvl, enc, np.int64(-(2**62))), gv, gvl))
    if keys:
        stacked = np.stack([k[0] for k in keys], axis=1)
        _, first, inv = np.unique(stacked, axis=0, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)
    else:
        first = np.zeros(1, np.int64)
        inv = np.zeros(n, np.int64)
    n_seg = len(first)

    columns: list[Column] = []
    for gi, g in enumerate(agg.group_by):
        _, gv, gvl = keys[gi]
        vl = gvl[first]
        dictionary = dicts[g.idx] \
            if g.ftype.is_string and isinstance(g, Col) else None
        columns.append(Column(g.ftype, gv[first].astype(g.ftype.np_dtype),
                              None if vl.all() else vl, dictionary))
    for ai, d in enumerate(agg.aggs):
        val_t = frag.output_types[len(agg.group_by) + 2 * ai]
        if d.arg is None:
            cnt = np.bincount(inv, minlength=n_seg).astype(np.int64)
            vcol = Column(val_t, cnt)
        else:
            av, avl = ev.eval(d.arg)
            av = np.asarray(av)
            avl = np.asarray(avl)
            cnt = np.bincount(inv, weights=avl.astype(np.float64),
                              minlength=n_seg).astype(np.int64)
            if d.func == "count":
                vcol = Column(val_t, cnt)
            elif d.func in ("sum", "avg"):
                if np.issubdtype(av.dtype, np.floating):
                    s = np.bincount(inv, weights=np.where(avl, av, 0.0),
                                    minlength=n_seg)
                else:
                    s = np.zeros(n_seg, np.int64)
                    np.add.at(s, inv, np.where(avl, av.astype(np.int64), 0))
                vcol = Column(val_t, s.astype(val_t.np_dtype),
                              None if (cnt > 0).all() else (cnt > 0))
            elif d.func in ("min", "max"):
                if np.issubdtype(av.dtype, np.floating):
                    sent = np.inf if d.func == "min" else -np.inf
                    vv = np.where(avl, av, sent)
                else:
                    sent = np.int64(2**62) if d.func == "min" \
                        else np.int64(-(2**62))
                    vv = np.where(avl, av.astype(np.int64), sent)
                s = np.full(n_seg, sent, dtype=vv.dtype)
                red = np.minimum if d.func == "min" else np.maximum
                red.at(s, inv, vv)
                s = np.where(cnt > 0, s, 0)
                vcol = Column(val_t, s.astype(val_t.np_dtype),
                              None if (cnt > 0).all() else (cnt > 0))
            else:
                raise CompileError(f"host fragment agg {d.func}")
        columns.append(vcol)
        columns.append(Column(FieldType(TypeKind.BIGINT, nullable=False),
                              cnt.astype(np.int64)))
    return Chunk(columns)


def _cols_of(e) -> set:
    """Combined column indices an expression reads."""
    out = set()

    def walk(x):
        if isinstance(x, Col):
            out.add(x.idx)
        elif hasattr(x, "args"):
            for a in x.args:
                walk(a)
    walk(e)
    return out


def _empty_chunk(frag: FragmentDAG, comb_dicts) -> Chunk:
    columns = []
    if frag.agg is None:
        for pos, comb in enumerate(frag.out_map):
            ft = frag.output_types[pos]
            columns.append(Column(ft, np.empty(0, ft.np_dtype), None,
                                  comb_dicts[comb]))
        return Chunk(columns)
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
