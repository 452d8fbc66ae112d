"""CopClient: the coprocessor — executes CopDAG requests as PyTorch programs.

Port of the single-table paths of `tidb_tpu/copr/client.py` (aggregation;
rows: scan, selection, projection, limit; TopN), and of the staging the
fragment executor (`copr/fragment.py`) uses for its build tables
(`_stage_build_table`, `_place_build_array`, one device).
What stays as in the reference:

* the host-side resolution (`_prepare`): string constants to dictionary
  codes, LIKE/IN code tables, interval bounds, the dense-segment strategy
  (masked loop for <= 64 segments, one-hot product up to 8192), the term
  decomposition and limb counts. Every gate decides as the reference
  decides, because the bounds, staging widths and limb counts are the same;
* 32-bit staging: int64 host columns stage as int32 (int8/int16 where the
  epoch statistics allow, upcast at kernel entry), float64 as float32;
* tiling: epochs above TILE_ROWS stream as tiles padded to one shape
  bucket, and per-tile partials merge exactly on the host;
* the partial layout [group cols..., (val, cnt) per agg] returned to the
  final merge;
* the row path: a selection runs on the device and ships one packed
  bitmask per tile, and the host projects the selected rows (`NumpyEval`);
  a bare scan runs no device program at all;
* the TopN path: each tile returns its top n rows, output columns gathered
  on the device (one int32 score, or the packed multi-key composite of
  topnpack.py; ties to the lower row).

* overlay rows (committed or buffered after the epoch) run as a second
  batch through the same prepared program, one small tile; the gates
  decide over the epoch and the overlay together (`_scan_bounds`);
* where a gate rejects the device, `host_exec.execute_host` answers on the
  host, tagged `host(<reason>)`; index-ranged scans go to
  `host_exec.execute_ranged`, tagged `ranged`; APPROX_COUNT_DISTINCT
  ships per-group HLL registers (`analyze.py`), merged across tiles by
  max.

Every `execute` first notes its scan on the keyspace heatmap (`heat`, the
storage's `RangeHeatRecorder`, attached by the session; rows and the
epoch columns' host bytes, as the reference counts them) when the plane
is on, before any engine is chosen.

Dispatch stages and spans sit at the reference's sites (`obs.stage`,
`obs.span`; the stages' meanings on the port are in `obs.py`): `ranged`,
`prepare`, `host_fallback`, `staging` with `transfer` inside it, `kernel`
(the asynchronous launches), `device_get` (the synchronizing copy to the
host) and `merge`; spans `copr.execute(t<id>)`, `copr.fragment`,
`device.batch(base|overlay)`, `device.dispatch` and `device.fetch`.

What differs: the programs run eagerly on `self.device` (no jit cache),
and staged columns are cached per epoch as device tensors. The host tier
is the reference's own answer for those requests, not a fallback from a
device error: no torch or CUDA error is caught.
"""

from __future__ import annotations

import threading
import weakref
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from .. import obs
from ..chunk.chunk import Chunk
from ..chunk.column import Column, Dictionary
from ..device import resolve_device
from ..plan.dag import (HLL_WORDS, CopDAG, agg_partial_starts,
                        agg_partial_width)
from ..plan.expr import Call, Col, Const, PlanExpr
from ..plan.fragment import FragmentDAG
from ..store.table_store import TableSnapshot
from ..types.field_type import FieldType, TypeKind
from . import analyze as AN
from . import host_exec
from . import sumexact as SE
from . import topnpack as TP
from .bounds import (
    Bound,
    decompose_terms,
    expr_bounds,
    expr_device_safe,
    fits_int32,
    limbs_for,
)
from .eval import CompileError, eval_expr, selection_mask
from .npeval import NumpyEval

_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31) + 1

# dense segment space caps per reduction strategy
MAX_LOOP_SEGMENTS = 64
# dense-vs-sort group strategy gate (_prepare_agg): an einsum over a
# segment space at least this wide whose estimated occupancy is under the
# per-slot floor prefers the sorted-run "group" mode
DENSE_SPARSE_MIN_SEGMENTS = 1024
DENSE_MIN_ROWS_PER_SEGMENT = 128
MAX_DENSE_SEGMENTS = 1 << 13

_FLOAT_BLOCKS = 32  # per-segment f32 block partials (host sums in f64)


def _bucket(n: int) -> int:
    """Static shape bucket: smallest of {2^k, 1.5*2^k} >= max(n, 256)."""
    b = 256
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b *= 2
    return b


# ---- device telemetry -------------------------------------------------------
# live clients, so one process-wide probe can sum the staged bytes across
# sessions without per-dispatch accounting
_LIVE_CLIENTS: "weakref.WeakSet" = weakref.WeakSet()


def _cached_tensors(vals):
    """The tensors nested in staging-cache values (tuples, lists and the
    semi-join bitmap entries' dicts)."""
    if isinstance(vals, torch.Tensor):
        yield vals
    elif isinstance(vals, (tuple, list)):
        for v in vals:
            yield from _cached_tensors(v)
    elif isinstance(vals, dict):
        for v in vals.values():
            yield from _cached_tensors(v)


def _device_telemetry_probe() -> None:
    """Set `tidb_device_buffer_bytes` to the unique bytes the live
    clients' column and mask caches hold, each storage counted once (a
    view and its base, or one tensor cached under two keys, share one
    storage), and `tidb_jit_cache_entries` to the CUDA libraries
    loaded."""
    from . import _kernels
    seen: set = set()
    buf = 0
    for c in list(_LIVE_CLIENTS):
        with c._lock:
            vals = list(c._col_cache.values()) + \
                list(c._mask_cache.values())
        for t in _cached_tensors(vals):
            st = t.untyped_storage()
            ptr = (t.device, st.data_ptr())
            if ptr in seen:
                continue
            seen.add(ptr)
            buf += st.nbytes()
    obs.DEVICE_BUFFER_BYTES.set(buf)
    obs.JIT_CACHE_ENTRIES.set(_kernels.loaded_count())


obs.register_gauge_probe(_device_telemetry_probe)


@dataclass
class CopResult:
    """Coprocessor answer: one or more partial chunks in the layout
    [group cols..., (val, cnt) per agg], merged by the final stage."""

    chunks: list[Chunk]
    is_partial_agg: bool
    # which engine served it: "device", "device[<mode>]", "host(<reason>)"
    # or "ranged"
    engine: str = "device"


def _obj_nbytes(o) -> int:
    if isinstance(o, (tuple, list)):
        return sum(_obj_nbytes(x) for x in o)
    return int(getattr(o, "nbytes", 0) or 0)


def _note_transfer(nbytes: int) -> None:
    """Host-to-device staging accounting: the process gauge and the
    statement's active operator (Top SQL, the slow log)."""
    obs.DEVICE_TRANSFER_BYTES.inc(nbytes)
    obs.note_op_bytes(nbytes)


class CopClient:
    # rows per device tile: epochs larger than this stream through the
    # programs as fixed-shape tiles whose partials merge host-side
    TILE_ROWS = 1 << 22

    def __init__(self, device: Optional[Union[str, torch.device]] = None
                 ) -> None:
        self.device = resolve_device(device)
        # (epoch_id, offset, bucket) and ("tile", ...) -> (data, valid)
        self._col_cache: dict = {}
        # (epoch_id, bucket, digest) and ("tile", ...) -> visibility mask
        self._mask_cache: dict = {}
        # table_id -> last seen epoch_id, for cache eviction
        self._live_epochs: dict[int, int] = {}
        # (epoch_id, offset) -> integer (lo, hi) or None; also run-order
        # and rank-metadata facts keyed by (epoch_id, tag, offsets)
        self._stats: dict = {}
        self._lock = threading.RLock()
        # keyspace heat recorder (obs_heat.RangeHeatRecorder), attached
        # by the session from the owning storage: every coprocessor
        # scan accounts its table's record span on the heatmap. None on
        # bare clients; one gated attribute test per execute() when off
        self.heat = None
        _LIVE_CLIENTS.add(self)

    def _evict_stale(self, table_id: int, epoch_id: int) -> None:
        """Free device tensors cached for a table's superseded epoch."""
        with self._lock:
            old = self._live_epochs.get(table_id)
            if old is not None and epoch_id <= old:
                return
            self._live_epochs[table_id] = epoch_id
            if old is not None:
                self._drop_epoch(old)

    def forget_table(self, table_id: int) -> None:
        """Free the device tensors cached for a physical table whose data
        is gone (DROP or TRUNCATE of a table or a partition): a dropped
        id never stages a newer epoch, so `_evict_stale` would never
        free them."""
        with self._lock:
            old = self._live_epochs.pop(table_id, None)
            if old is not None:
                self._drop_epoch(old)

    def _drop_epoch(self, old: int) -> None:
        def stale(k) -> bool:  # plain or "tile"-prefixed cache keys
            if len(k) > 2 and k[1] == "aligned" and k[2] == old:
                return True  # build-side epoch of an aligned join
            return k[0] == old or (k[0] == "tile" and k[1] == old)

        for cache in (self._col_cache, self._mask_cache):
            for k in [k for k in cache if stale(k)]:
                del cache[k]
        for k in [k for k in self._stats if k[0] == old]:
            del self._stats[k]

    # ---- placement hooks of the executor (one device: no-ops) -----------
    def placement_scope(self, snap):
        """Context the executor opens around each dispatch; the
        reference's mesh client pins a shard placement here, one device
        has nothing to pin."""
        return nullcontext()

    def take_mesh_note(self):
        """Per-shard dispatch accounting of the reference's mesh client;
        None on one device."""
        return None

    # ==================== public entry ====================
    def execute(self, dag: CopDAG, snap: TableSnapshot) -> CopResult:
        with obs.span(f"copr.execute(t{dag.scan.table_id})") as sp:
            heat = self.heat
            if heat is not None and heat.enabled:
                # one scan note per coprocessor dispatch, split across
                # the ranges overlapping the table's record span —
                # regardless of which engine ends up serving it
                heat.note_scan(
                    dag.scan.table_id,
                    rows=snap.epoch.num_rows + len(snap.overlay_handles),
                    nbytes=_obj_nbytes(snap.epoch.columns))
            return self._execute(dag, snap, sp)

    def _execute(self, dag: CopDAG, snap: TableSnapshot, sp) -> CopResult:
        if dag.scan.ranges is not None:
            # index-ranged scan: the index permutation resolves a (small)
            # handle set, and the DAG runs on the host over those rows
            obs.COPR_REQUESTS.inc(engine="ranged")
            with obs.stage("ranged", span_name="copr.ranged"):
                r = host_exec.execute_ranged(dag, snap)
            r.engine = "ranged"
            if sp:
                sp.note = "ranged"
            return r
        self._evict_stale(dag.scan.table_id, snap.epoch.epoch_id)
        with obs.stage("prepare", span_name="copr.prepare"):
            prepared, fallback = self._prepare(dag, snap)
        if fallback is not None:
            r = self._try_group_fragment(dag, snap, fallback)
            if r is not None:
                if sp:
                    sp.note = r.engine
                return r
            if fallback.startswith("sparse segment space"):
                # the sort-grouped preference could not be honored: the
                # dense einsum is still correct and still a device path
                with obs.stage("prepare", span_name="copr.prepare"):
                    prepared, fallback = self._prepare(dag, snap,
                                                       sparse_gate=False)
        if fallback is not None:
            obs.COPR_REQUESTS.inc(engine="host")
            with obs.stage("host_fallback",
                           span_name="copr.host_fallback") as hsp:
                if hsp:
                    hsp.note = fallback
                r = host_exec.execute_host(dag, snap, fallback)
            r.engine = f"host({fallback})"
            return r
        obs.COPR_REQUESTS.inc(engine="device")
        if sp:
            sp.note = "device"
        chunks: list[Chunk] = []
        if snap.epoch.num_rows > 0:
            with obs.span("device.batch(base)"):
                chunks.extend(self._run_batch(dag, snap, prepared,
                                              overlay=False))
        if len(snap.overlay_handles) > 0:
            with obs.span("device.batch(overlay)"):
                chunks.extend(self._run_batch(dag, snap, prepared,
                                              overlay=True))
        if not chunks:
            chunks = [self._empty_chunk(dag, snap)]
        return CopResult(chunks, is_partial_agg=dag.agg is not None,
                         engine="device")

    def _run_batch(self, dag: CopDAG, snap: TableSnapshot,
                   prepared: dict[Any, Any], overlay: bool) -> list[Chunk]:
        """One batch through the request's path (aggregation, TopN or
        rows): the base epoch in tiles, or the overlay rows as one small
        tile. A bare row scan of the base epoch stages nothing: no device
        program reads it."""
        bare = dag.agg is None and dag.topn is None and dag.selection is None
        with obs.stage("staging", span_name="copr.staging"):
            if overlay:
                cols, vis, host_cols, host_mask = self._stage_inputs(
                    dag, snap, overlay=True)
                tiles = [(cols, vis, len(snap.overlay_handles))]
            else:
                tiles = None if bare else self._stage_tiles(dag, snap)
        if not overlay:
            host_cols, host_mask = self._host_view(dag, snap)
        if dag.agg is not None:
            return self._run_agg(dag, snap, prepared, tiles)
        if dag.topn is not None:
            return self._run_topn(dag, snap, prepared, tiles)
        return self._run_rows(dag, snap, prepared, tiles, host_cols,
                              host_mask)

    def _host_view(self, dag: CopDAG, snap: TableSnapshot):
        """Host numpy views of the epoch's scan columns (the row path's
        projection input); validity stays None where a column has no NULLs,
        so big epochs allocate no ones-masks per request."""
        epoch = snap.epoch
        host_cols = [(epoch.columns[off], epoch.valids[off])
                     for off in dag.scan.col_offsets]
        return host_cols, snap.base_visible

    def _try_group_fragment(self, dag: CopDAG, snap: TableSnapshot,
                            reason: str) -> Optional[CopResult]:
        """Single-table GROUP BY rejected by the dense-segment gate: retry
        as a degenerate one-table fragment (copr/fragment.py) before
        conceding. Returns None when the shape is ineligible or the
        fragment path gates out."""
        if dag.agg is None or dag.topn is not None or dag.limit is not None:
            return None
        if not (reason.startswith("group keys not dense-encodable")
                or reason.startswith("sparse segment space")
                or "min/max or float aggregates" in reason):
            return None
        if any(agg_partial_width(d) != 2 for d in dag.agg.aggs):
            return None  # hll sketches don't flow through fragments
        from . import fragment as FR
        frag = FR.lift_group_dag(dag, snap)
        if frag is None:
            return None
        try:
            with obs.span("copr.fragment") as fsp:
                if fsp:
                    fsp.note = "group-lift"
                r = FR._device_fragment(
                    self, frag, {frag.tables[0].table.id: snap})
            obs.COPR_REQUESTS.inc(engine="device-fragment")
            return r
        except (FR._Fallback, CompileError):
            return None

    # ==================== preparation (host-side resolution) ================
    def _col_stats(self, snap: TableSnapshot, off: int) -> Bound:
        """Integer (lo, hi) over valid epoch values, cached per epoch."""
        key = (snap.epoch.epoch_id, off)
        with self._lock:
            if key in self._stats:
                return self._stats[key]
        data = snap.epoch.columns[off]
        valid = snap.epoch.valids[off]
        b: Bound = None
        if data.dtype.kind in "iub" and len(data):
            vals = data if valid is None else data[valid]
            b = (int(vals.min()), int(vals.max())) if len(vals) else (0, 0)
        elif data.dtype.kind in "iub":
            b = (0, 0)
        with self._lock:
            self._stats[key] = b
        return b

    def _runs_ordered(self, snap: TableSnapshot, offsets) -> bool:
        """True when the epoch columns at `offsets` are lexicographically
        non-decreasing in storage order with no NULLs, so every group-key
        value occupies one contiguous run. Cached per epoch."""
        key = (snap.epoch.epoch_id, "runord", tuple(offsets))
        with self._lock:
            hit = self._stats.get(key)
        if hit is None:
            hit = _lex_runs_ordered(snap, offsets)
            with self._lock:
                self._stats[key] = hit
        return bool(hit)

    def _rank_meta(self, snap: TableSnapshot, offsets):
        """Host rank metadata for the streamseg kernel over the epoch
        columns at `offsets` (already run-ordered). Cached per epoch;
        None when a kernel gate fails."""
        key = (snap.epoch.epoch_id, "rankmeta", tuple(offsets))
        with self._lock:
            hit = self._stats.get(key)
        if hit is None:
            from . import streamseg as SS
            hit = SS.rank_meta([snap.epoch.columns[off] for off in offsets])
            with self._lock:
                self._stats[key] = hit if hit is not None else False
        return hit or None

    def _scan_bounds(self, dag: CopDAG, snap: TableSnapshot) -> list[Bound]:
        """Per scan-column [lo, hi] covering epoch AND overlay values."""
        out: list[Bound] = []
        for off in dag.scan.col_offsets:
            b = self._col_stats(snap, off)
            if len(snap.overlay_handles):
                od = snap.overlay_columns[off]
                ov = snap.overlay_valids[off]
                if od.dtype.kind in "iub" and len(od):
                    vals = od if ov is None else od[ov]
                    if len(vals):
                        ob = (int(vals.min()), int(vals.max()))
                        b = None if b is None else (
                            min(b[0], ob[0]), max(b[1], ob[1]))
                else:
                    b = None if od.dtype.kind not in "iub" else b
            out.append(b)
        return out

    def _prepare(
        self, dag: CopDAG, snap: TableSnapshot, sparse_gate: bool = True
    ) -> tuple[Optional[dict[Any, Any]], Optional[str]]:
        """Resolve string constants/predicates against column dictionaries,
        pick the aggregation strategy, bound value ranges, and build the
        aggregate schedule. Returns (prepared, None) for the device path or
        (None, reason) where the reference leaves the device."""
        prepared: dict[Any, Any] = {}
        dicts = self._scan_dicts(dag, snap)
        col_bounds = self._scan_bounds(dag, snap)
        prepared["__col_bounds__"] = col_bounds

        # int64 host columns must fit int32 to stage (staging is 32-bit-only)
        for ci, off in enumerate(dag.scan.col_offsets):
            if snap.epoch.columns[off].dtype == np.int64 and \
                    not fits_int32(col_bounds[ci]):
                return None, (
                    f"column offset {off} too wide for int32 device staging")

        try:
            exprs: list[PlanExpr] = []
            if dag.selection:
                exprs.extend(dag.selection.conditions)
            if dag.agg:
                exprs.extend(dag.agg.group_by)
                for d in dag.agg.aggs:
                    if d.arg is not None:
                        exprs.append(d.arg)
            if dag.topn:
                exprs.extend(e for e, _ in dag.topn.items)
                if dag.projections:
                    exprs.extend(dag.projections)
            for e in exprs:
                self._prepare_expr(e, dicts, prepared)
        except CompileError as ce:
            return None, str(ce)

        if dag.selection:
            for c in dag.selection.conditions:
                if not expr_device_safe(c, col_bounds):
                    return None, "filter condition too wide for int32 device"

        if dag.agg is not None:
            err = self._prepare_agg(
                dag, dicts, col_bounds, prepared,
                snap.epoch.num_rows + len(snap.overlay_handles),
                sparse_gate=sparse_gate)
            if err is not None:
                return None, err
        if dag.topn is not None:
            err = self._prepare_topn(dag, col_bounds, prepared)
            if err is not None:
                return None, err
        return prepared, None

    def _prepare_topn(self, dag, col_bounds, prepared) -> Optional[str]:
        # the program gathers the projection outputs of the k winners
        if dag.projections:
            for x in dag.projections:
                if x.ftype.is_string:
                    continue
                if not x.ftype.is_float and \
                        not expr_device_safe(x, col_bounds):
                    return "TopN expression too wide for int32 device"
        items = dag.topn.items
        if len(items) == 1:
            e = items[0][0]
            if e.ftype.is_string:
                return "string TopN key is host-side"
            # the sort key reads the projection's output schema: substitute
            # so that the bounds analysis sees scan-column indices
            key = _subst_proj_cols(e, dag.projections) \
                if dag.projections else e
            if not e.ftype.is_float:
                if not expr_device_safe(key, col_bounds):
                    return "TopN expression too wide for int32 device"
                b = expr_bounds(key, col_bounds)
                # the negated scores of ASC must fit too
                if b is None or not fits_int32(b) or \
                        not fits_int32((-b[1], -b[0])):
                    return "TopN key too wide for int32 device"
            return None
        # multi-key: the bounded mixed-direction keys pack into ONE int32
        # lexicographic composite (topnpack.py); ties resolve by row order
        keys = [(_subst_proj_cols(e, dag.projections)
                 if dag.projections else e, desc)
                for e, desc in items]
        specs, reason = TP.plan_pack(keys, col_bounds)
        if specs is None:
            return reason
        TP.stage_rank_tables(specs, prepared, self.device)
        prepared["__topn_pack__"] = specs
        return None

    def _prepare_agg(self, dag, dicts, col_bounds, prepared,
                     n_rows: int, sparse_gate: bool = True
                     ) -> Optional[str]:
        cards, offsets = self._dense_cards(dag, dicts, col_bounds)
        if cards is None:
            return "group keys not dense-encodable on device"
        for g in dag.agg.group_by:
            if not expr_device_safe(g, col_bounds):
                return "group key too wide for int32 device"
        prepared["__dense_cards__"] = cards
        prepared["__key_offsets__"] = offsets
        segments = 1
        for c in cards:
            segments *= max(c, 1)

        sched: list[dict[str, Any]] = []
        needs_loop = False
        for d in dag.agg.aggs:
            if d.arg is None or d.func == "count":
                sched.append({"kind": "count"})
                continue
            is_f = d.arg.ftype.is_float
            if d.func in ("sum", "avg"):
                if is_f:
                    sched.append({"kind": "fsum"})
                    needs_loop = True
                else:
                    terms = decompose_terms(d.arg, col_bounds)
                    if terms is None:
                        return (f"agg arg {d.arg!r} not int32-decomposable")
                    # the TRUE total must fit int64 for the host Horner
                    # recombination (sumexact.combine_partials)
                    b = expr_bounds(d.arg, col_bounds)
                    if b is None:
                        return "agg arg unbounded"
                    mag = max(abs(b[0]), abs(b[1]))
                    if mag * max(n_rows, 1) >= 2**62:
                        return "sum magnitude exceeds int64 accumulator"
                    sched.append({
                        "kind": "isum",
                        "terms": [
                            (t, s, limbs_for(expr_bounds(t, col_bounds),
                                             SE.LIMB_BITS))
                            for t, s in terms
                        ],
                    })
            elif d.func in ("min", "max"):
                if not is_f and not expr_device_safe(d.arg, col_bounds):
                    return "min/max arg too wide for int32 device"
                sched.append({"kind": d.func, "float": is_f})
                needs_loop = True
            elif d.func == "approx_count_distinct":
                # hashes the exact int32 value; the planner already kept
                # floats/strings host-side
                if is_f or not expr_device_safe(d.arg, col_bounds):
                    return "approx_count_distinct arg not int32-hashable"
                sched.append({"kind": "hll"})
            else:
                return f"agg {d.func} not on device"

        if segments <= MAX_LOOP_SEGMENTS:
            strategy = "loop"
        elif needs_loop:
            return (f"{segments} segments with min/max or float aggregates "
                    "is host-side")
        else:
            strategy = "einsum"
        if strategy == "einsum" and sparse_gate and \
                segments >= DENSE_SPARSE_MIN_SEGMENTS and \
                n_rows < segments * DENSE_MIN_ROWS_PER_SEGMENT:
            # a wide space with thin estimated occupancy prefers the
            # sorted-run "group" mode; only spaces the candidate buffer
            # can provably hold reroute
            if segments <= FragmentDAG.HAVING_CAP:
                return (f"sparse segment space: {segments} slots over "
                        f"{n_rows} rows (sort-grouped path preferred)")
        prepared["__strategy__"] = strategy
        prepared["__agg_sched__"] = sched
        return None

    def _scan_dicts(self, dag: CopDAG, snap: TableSnapshot
                    ) -> list[Optional[Dictionary]]:
        return [snap.dictionaries[off] for off in dag.scan.col_offsets]

    def _prepare_expr(
        self,
        e: PlanExpr,
        dicts: list[Optional[Dictionary]],
        prepared: dict[Any, Any],
    ) -> None:
        """Resolve string consts to codes and LIKE/IN to code tables."""
        if isinstance(e, Call):
            str_col = self._plain_string_col(e.args[0]) if e.args else None
            if e.op in ("eq", "ne", "lt", "le", "gt", "ge") and \
                    len(e.args) == 2:
                a, b = e.args
                ca = self._plain_string_col(a)
                cb = self._plain_string_col(b)
                if ca is not None and isinstance(b, Const) and \
                        b.ftype.is_string:
                    self._prepare_string_cmp(e, ca, b, dicts, prepared)
                    return
                if cb is not None and isinstance(a, Const) and \
                        a.ftype.is_string:
                    self._prepare_string_cmp(e, cb, a, dicts, prepared)
                    return
                if (ca is not None) and (cb is not None):
                    if dicts[ca.idx] is not dicts[cb.idx]:
                        raise CompileError(
                            "string compare across dictionaries is "
                            "host-side")
                    if e.op not in ("eq", "ne"):
                        raise CompileError(
                            "string ordering compare is host-side for now")
                    return
                if (a.ftype.is_string or b.ftype.is_string) and e.op not in (
                    "eq", "ne"
                ):
                    raise CompileError("string compare form not supported")
            if e.op == "in_values" and str_col is not None:
                d = dicts[str_col.idx]
                codes = [d.lookup(str(v)) for v in e.extra]
                prepared[id(e)] = [c for c in codes if c >= 0] or [-1]
                for a in e.args:
                    self._prepare_expr(a, dicts, prepared)
                return
            if e.op == "like":
                if str_col is None:
                    raise CompileError(
                        "LIKE over computed strings is host-side")
                import re as _re
                d = dicts[str_col.idx]
                rx = _re.compile(_like_to_regex(str(e.extra)), _re.DOTALL)
                table = np.fromiter(
                    (rx.fullmatch(v) is not None for v in d.values),
                    dtype=bool, count=len(d),
                )
                if not len(table):
                    table = np.zeros(1, dtype=bool)
                prepared[id(e)] = torch.as_tensor(table, device=self.device)
                return
            for a in e.args:
                self._prepare_expr(a, dicts, prepared)
        elif isinstance(e, Const) and e.ftype.is_string:
            raise CompileError("free-standing string constant on device")

    def _prepare_string_cmp(self, e: Call, col: Col, const: Const,
                            dicts: list[Optional[Dictionary]],
                            prepared: dict[Any, Any]) -> None:
        if e.op in ("eq", "ne"):
            prepared[id(const)] = dicts[col.idx].lookup(str(const.value))
            return
        raise CompileError("string ordering compare is host-side for now")

    @staticmethod
    def _plain_string_col(e: PlanExpr) -> Optional[Col]:
        if isinstance(e, Col) and e.ftype.is_string:
            return e
        return None

    def _dense_cards(
        self, dag: CopDAG, dicts: list[Optional[Dictionary]],
        col_bounds: list[Bound],
    ) -> tuple[Optional[list[int]], Optional[list[int]]]:
        """Per-group-key (cardinality+1 for NULL, value offset). String
        keys use dictionary codes; integer/date/decimal keys use epoch
        min/max stats — card = hi-lo+2, key = value-lo."""
        cards: list[int] = []
        offsets: list[int] = []
        for g in dag.agg.group_by:
            if isinstance(g, Col) and g.ftype.is_string:
                cards.append(len(dicts[g.idx]) + 1)
                offsets.append(0)
            elif g.ftype.is_string:
                return None, None
            elif isinstance(g, Col) and g.ftype.kind == TypeKind.BOOLEAN:
                cards.append(3)
                offsets.append(0)
            elif g.ftype.is_float:
                return None, None
            else:
                b = expr_bounds(g, col_bounds)
                if b is None:
                    return None, None
                lo, hi = b
                card = hi - lo + 2
                if card > MAX_DENSE_SEGMENTS:
                    return None, None
                cards.append(card)
                offsets.append(lo)
        prod = 1
        for c in cards:
            prod *= max(c, 1)
        if prod > MAX_DENSE_SEGMENTS:
            return None, None
        return cards, offsets

    # ==================== staging ====================
    def _place(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _upload(self, arrs, note: bool = True):
        """Place staged scan arrays as the `transfer` stage; `note`
        attributes their bytes to the statement's active operator."""
        with obs.stage("transfer"):
            out = tuple(self._place(a) for a in arrs)
        if note:
            _note_transfer(sum(a.nbytes for a in arrs))
        return out

    def _stage_tiles(self, dag: CopDAG, snap: TableSnapshot):
        """Device tiles covering the base epoch: [(dev_cols, vis, n_rows)].

        Epochs at or below TILE_ROWS stage as the single cached tile of
        _stage_inputs; larger epochs split into TILE_ROWS slices all
        padded to ONE shape bucket."""
        epoch = snap.epoch
        n = epoch.num_rows
        if n <= self.TILE_ROWS:
            cols, vis, _, _ = self._stage_inputs(dag, snap, overlay=False)
            return [(cols, vis, n)]
        T = self.TILE_ROWS
        b = _bucket(T)
        with self._lock:
            cacheable = self._live_epochs.get(dag.scan.table_id) \
                == epoch.epoch_id
        tiles = []
        vis_digest = snap.visible_digest
        with self._lock:
            # one live visibility digest per (epoch, bucket)
            for k in [k for k in self._mask_cache
                      if k[0] == "tile" and k[1] == epoch.epoch_id
                      and k[2] == b and k[3] != vis_digest]:
                del self._mask_cache[k]
        for ti in range(-(-n // T)):
            lo = ti * T
            cnt = min(lo + T, n) - lo
            dev_cols = []
            for off in dag.scan.col_offsets:
                key = ("tile", epoch.epoch_id, off, b, ti)
                with self._lock:
                    cached = self._col_cache.get(key)
                if cached is None:
                    obs.COL_CACHE.inc(result="miss")
                    data = epoch.columns[off][lo:lo + cnt]
                    valid = epoch.valids[off]
                    vslice = np.ones(cnt, bool) if valid is None \
                        else valid[lo:lo + cnt]
                    cached = self._upload((
                        _pad(_narrow_stats(data, self._col_stats(snap, off)),
                             b),
                        _pad_bool(vslice, b)))
                    if cacheable:
                        with self._lock:
                            self._col_cache[key] = cached
                else:
                    obs.COL_CACHE.inc(result="hit")
                dev_cols.append(cached)
            vkey = ("tile", epoch.epoch_id, b, vis_digest, ti)
            with self._lock:
                vis = self._mask_cache.get(vkey)
            if vis is None:
                vis, = self._upload(
                    (_pad_bool(snap.base_visible[lo:lo + cnt], b),))
                if cacheable:
                    with self._lock:
                        self._mask_cache[vkey] = vis
            tiles.append((dev_cols, vis, cnt))
        return tiles

    def _stage_inputs(self, dag: CopDAG, snap: TableSnapshot,
                      overlay: bool):
        """Pad + upload scan columns as 32-bit (or narrower) device
        tensors: the whole epoch (cached), or the overlay rows (staged per
        request, padded to their own bucket). Returns the device (data,
        valid) pairs, the device row mask, the host (data, valid) views
        and the host row mask."""
        if overlay:
            n = len(snap.overlay_handles)
            b = _bucket(n)
            host_cols, dev_cols = [], []
            for off in dag.scan.col_offsets:
                data = snap.overlay_columns[off]
                valid = snap.overlay_valids[off]
                vfull = np.ones(n, bool) if valid is None else valid
                host_cols.append((data, vfull))
                dev_cols.append(self._upload(
                    (_pad(_narrow(data), b), _pad_bool(vfull, b))))
            mask = np.zeros(b, bool)
            mask[:n] = True
            dev_mask, = self._upload((mask,), note=False)
            return dev_cols, dev_mask, host_cols, mask[:n]
        epoch = snap.epoch
        n = epoch.num_rows
        b = _bucket(n)
        with self._lock:
            cacheable = self._live_epochs.get(dag.scan.table_id) \
                == epoch.epoch_id
        dev_cols = []
        host_cols = []
        for off in dag.scan.col_offsets:
            key = (epoch.epoch_id, off, b)
            valid = epoch.valids[off]
            vfull = np.ones(n, bool) if valid is None else valid
            with self._lock:
                cached = self._col_cache.get(key)
            if cached is None:
                obs.COL_CACHE.inc(result="miss")
                cached = self._upload((
                    _pad(_narrow_stats(epoch.columns[off],
                                       self._col_stats(snap, off)), b),
                    _pad_bool(vfull, b)))
                if cacheable:
                    with self._lock:
                        self._col_cache[key] = cached
            else:
                obs.COL_CACHE.inc(result="hit")
            dev_cols.append(cached)
            host_cols.append((epoch.columns[off], vfull))
        vis_digest = snap.visible_digest
        vis_key = (epoch.epoch_id, b, vis_digest)
        with self._lock:
            vis = self._mask_cache.get(vis_key)
        if vis is None:
            vis, = self._upload((_pad_bool(snap.base_visible, b),))
            if cacheable:
                with self._lock:
                    for k in [k for k in self._mask_cache
                              if k[:2] == (epoch.epoch_id, b)
                              and k[2] != vis_digest]:
                        del self._mask_cache[k]
                    self._mask_cache[vis_key] = vis
        return dev_cols, vis, host_cols, snap.base_visible

    # ---- fragment placement hooks: a single device stages every build
    # table whole and places its arrays as they are ----
    def _stage_build_table(self, facade: CopDAG, snap: TableSnapshot):
        return self._stage_inputs(facade, snap, overlay=False)

    def _place_build_array(self, arr: torch.Tensor) -> torch.Tensor:
        return arr

    def _frag_engine(self, mode: str) -> str:
        return f"device[{mode}]"

    # ---- aggregation path ---------------------------------------------------
    def _run_agg(self, dag, snap, prepared, tiles) -> list[Chunk]:
        agg = dag.agg
        cards: list[int] = prepared["__dense_cards__"]
        segments = 1
        for c in cards:
            segments *= max(c, 1)
        body = self._agg_kernel_body(dag, prepared, cards, segments)
        # launches are asynchronous; ONE fetch brings every tile's
        # partials to the host
        with obs.stage("kernel", span_name="device.dispatch") as sp:
            if sp:
                sp.note = f"{len(tiles)} tile(s)"
            devs = [body(cols, vis) for cols, vis, _ in tiles]
        with obs.stage("device_get", span_name="device.fetch"):
            outs = fetch(devs)
        with obs.stage("merge"):
            out = _merge_tile_outs(outs, prepared["__agg_sched__"])
        group_dicts = [
            snap.dictionaries[dag.scan.col_offsets[g.idx]]
            if g.ftype.is_string and isinstance(g, Col) else None
            for g in agg.group_by
        ]
        chunk = decode_agg_partials(
            agg, prepared, cards, out, group_dicts,
            dag.output_types[len(agg.group_by):])
        return [] if chunk is None else [chunk]

    def _agg_kernel_body(self, dag, prepared, cards, segments):
        """(cols, row_mask) -> {partials}. All leaves are int32 (exact limb
        partials, sentinel min/max) or f32 (block float sums)."""
        agg = dag.agg
        sel = dag.selection

        def kernel(cols, row_mask):
            cols = widen32(cols)
            mask = row_mask
            if sel is not None:
                mask = selection_mask(sel.conditions, cols, prepared, mask)
            return agg_partials(agg, prepared, cards, segments, cols, mask)

        return kernel

    # ---- row path (scan/selection/projection/limit) -------------------------
    def _run_rows(self, dag, snap, prepared, tiles, host_cols,
                  host_mask) -> list[Chunk]:
        """The device evaluates the selection and returns ONLY a packed
        bitmask, one small buffer per tile; the host projects the selected
        rows (numpy over the batch's host columns). A bare scan's rows are
        the visible ones: no device program runs."""
        if dag.selection is None:
            idx = np.nonzero(host_mask)[0]
        else:
            body = self._rowmask_body(dag, prepared)
            with obs.stage("kernel", span_name="device.dispatch"):
                devs = [body(cols, vis) for cols, vis, _ in tiles]
            with obs.stage("device_get", span_name="device.fetch"):
                packs = [p.cpu().numpy() for p in devs]
            parts = [np.unpackbits(p)[:cnt].astype(bool)
                     for p, (_, _, cnt) in zip(packs, tiles)]
            idx = np.nonzero(np.concatenate(parts))[0]
        if dag.limit is not None and len(idx) > dag.limit.n:
            idx = idx[: dag.limit.n]
        return self._host_rows(dag, snap, host_cols, idx)

    def _rowmask_body(self, dag, prepared):
        sel = dag.selection

        def kernel(cols, row_mask):
            cols = widen32(cols)
            return packbits(selection_mask(sel.conditions, cols, prepared,
                                           row_mask))

        return kernel

    def _host_rows(self, dag, snap, host_cols, idx) -> list[Chunk]:
        """Project the selected rows on the host (numpy)."""
        columns = []
        k = len(idx)
        if dag.projections is not None:
            sub = [(d[idx], np.ones(k, bool) if v is None else v[idx])
                   for d, v in host_cols]
            ev = NumpyEval(sub, self._scan_dicts(dag, snap), k)
            for pi, e in enumerate(dag.projections):
                v, vl = ev.eval(e)
                ft = dag.output_types[pi]
                dictionary = None
                if ft.is_string and isinstance(e, Col):
                    dictionary = snap.dictionaries[dag.scan.col_offsets[e.idx]]
                columns.append(Column(
                    ft, np.asarray(v).astype(ft.np_dtype),
                    None if vl.all() else np.asarray(vl), dictionary))
        else:
            for ci, off in enumerate(dag.scan.col_offsets):
                data, vfull = host_cols[ci]
                v = None if vfull is None else vfull[idx]
                columns.append(Column(
                    dag.output_types[ci], data[idx],
                    None if v is None or v.all() else v,
                    snap.dictionaries[off]))
        if not columns:
            return []
        return [Chunk(columns)]

    # ---- TopN path ----------------------------------------------------------
    def _run_topn(self, dag, snap, prepared, tiles) -> list[Chunk]:
        """Per-tile top-n candidates; the host Sort/Limit above merge the
        tiles' chunks exactly."""
        body = self._topn_body(dag, prepared)
        with obs.stage("kernel", span_name="device.dispatch"):
            devs = [body(cols, vis) for cols, vis, _ in tiles]
        with obs.stage("device_get", span_name="device.fetch"):
            outs = fetch(devs)
        chunks = (self._topn_decode(dag, snap, out) for out in outs)
        return [c for c in chunks if c is not None]

    def _out_exprs(self, dag) -> list[PlanExpr]:
        if dag.projections is not None:
            return dag.projections
        return [Col(ci, ft) for ci, ft in enumerate(dag.output_types)]

    def _topn_decode(self, dag, snap, out) -> Optional[Chunk]:
        dicts = [snap.dictionaries[dag.scan.col_offsets[e.idx]]
                 if ft.is_string and isinstance(e, Col) else None
                 for e, ft in zip(self._out_exprs(dag), dag.output_types)]
        columns = TP.top_columns(out, dag.output_types, dicts)
        return Chunk(columns) if columns else None

    def _topn_body(self, dag, prepared):
        sel = dag.selection
        expr, desc = dag.topn.items[0]
        if dag.projections is not None:
            # sort items were resolved against the projection's output
            # schema; substitute so the key computes over projected values
            expr = _subst_proj_cols(expr, dag.projections)
        exprs = self._out_exprs(dag)
        out_types = dag.output_types
        pack = prepared.get("__topn_pack__")

        def kernel(cols, row_mask):
            cols = widen32(cols)
            mask = row_mask
            if sel is not None:
                mask = selection_mask(sel.conditions, cols, prepared, mask)
            if pack is not None:
                score = TP.packed_score(pack, cols, prepared, mask, eval_expr)
            else:
                v, vl = eval_expr(expr, cols, prepared)
                # dropped rows score strictly below NULL-key rows (DESC
                # sorts NULLs last, but they still belong in the result)
                if v.is_floating_point():
                    null_score = float("inf") if not desc else \
                        -torch.finfo(torch.float32).max
                    score = torch.where(vl, v if desc else -v, null_score)
                    score = torch.where(mask, score, float("-inf"))
                else:
                    v32 = v.to(torch.int32)
                    null_score = _I32_MAX if not desc else _I32_MIN
                    score = torch.where(vl, v32 if desc else -v32,
                                        null_score)
                    score = torch.where(mask, score, TP.I32_MIN)
            outs = []
            for e, ft in zip(exprs, out_types):
                pv, pvl = eval_expr(e, cols, prepared)
                outs.append((pv, pvl, ft.is_float))
            return TP.top_rows(score, mask, dag.topn.n, outs)

        return kernel

    def _empty_chunk(self, dag: CopDAG, snap: TableSnapshot) -> Chunk:
        columns = []
        if dag.agg is not None:
            for g in dag.agg.group_by:
                dictionary = None
                if isinstance(g, Col) and g.ftype.is_string:
                    dictionary = snap.dictionaries[
                        dag.scan.col_offsets[g.idx]]
                columns.append(Column(
                    g.ftype, np.empty(0, g.ftype.np_dtype), None, dictionary))
            starts = agg_partial_starts(dag.agg.aggs, len(dag.agg.group_by))
            for ai, d in enumerate(dag.agg.aggs):
                for j in range(agg_partial_width(d)):
                    vt = dag.output_types[starts[ai] + j]
                    columns.append(Column(vt, np.empty(0, vt.np_dtype)))
            return Chunk(columns)
        for i, ft in enumerate(dag.output_types):
            dictionary = None
            if ft.is_string:
                src = None
                if dag.projections is not None:
                    e = dag.projections[i]
                    if isinstance(e, Col):
                        src = dag.scan.col_offsets[e.idx]
                else:
                    src = dag.scan.col_offsets[i]
                dictionary = snap.dictionaries[src] if src is not None \
                    else None
            columns.append(Column(ft, np.empty(0, ft.np_dtype), None,
                                  dictionary))
        return Chunk(columns)


def fetch(outs: list[dict]) -> list[dict]:
    """Device partials -> host numpy, one dict per tile."""
    return [{k: v.cpu().numpy() for k, v in o.items()} for o in outs]


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n / 8)], 8 rows a byte with the first in the
    most significant bit (zero-padded), as `np.packbits` packs and
    `np.unpackbits` reads."""
    pad = -mask.shape[0] % 8
    if pad:
        mask = torch.cat([mask, mask.new_zeros(pad)])
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=mask.device)
    return (mask.view(-1, 8).to(torch.int32) * w).sum(dim=1).to(torch.uint8)


def _merge_tile_outs(outs: list[dict], sched) -> dict:
    """Merge per-tile agg partials host-side. Int limb partials are
    additive (summed in int64); float block partials concatenate along the
    block axis; min/max merge elementwise against their sentinels, and HLL
    registers by elementwise max (the sketches' union)."""
    if len(outs) == 1:
        return outs[0]
    minmax = {f"m{ai}": s["kind"] for ai, s in enumerate(sched)
              if s["kind"] in ("min", "max")}
    hll_keys = {f"h{ai}" for ai, s in enumerate(sched) if s["kind"] == "hll"}
    merged: dict[str, np.ndarray] = {}
    for k in outs[0]:
        vals = [np.asarray(o[k]) for o in outs]
        kind = minmax.get(k)
        if kind == "min":
            merged[k] = np.minimum.reduce(vals)
        elif kind == "max" or k in hll_keys:
            merged[k] = np.maximum.reduce(vals)
        elif k.startswith("f"):
            merged[k] = np.concatenate(vals, axis=0)
        else:
            merged[k] = SE.merge_additive(vals)
    return merged


# ==================== shared aggregation machinery ====================
# module-level so the fragment executor (copr/fragment.py) builds the same
# partial-producing programs

def segment_ids(agg, cards, offsets, cols, prepared, mask):
    """Mixed-radix dense segment id; NULL key -> card-1 slot."""
    seg = torch.zeros(mask.shape[0], dtype=torch.int32, device=mask.device)
    for g, card, off in zip(agg.group_by, cards, offsets):
        v, vl = eval_expr(g, cols, prepared)
        if v.dtype == torch.bool:
            v = v.to(torch.int32)  # boolean keys: 0/1 codes
        shifted = (v - off).to(torch.int32)
        k = torch.where(vl, shifted, card - 1)
        k = torch.clamp(k, 0, card - 1)
        seg = seg * card + k
    return torch.where(mask, seg, -1)


def agg_partials(agg, prepared, cards, segments, cols, mask):
    """(cols, row mask) -> {exact limb partials} per the agg schedule.
    All leaves int32 (additive) or f32 (block float sums)."""
    offsets = prepared["__key_offsets__"]
    sched = prepared["__agg_sched__"]
    strategy = prepared["__strategy__"]
    seg = segment_ids(agg, cards, offsets, cols, prepared, mask)
    ones = mask.to(torch.int32)
    out = {"rows": SE.seg_sum_partials(ones, seg, segments, 1, strategy)}
    for ai, (d, s) in enumerate(zip(agg.aggs, sched)):
        if s["kind"] == "count":
            if d.arg is not None:
                _, vl = eval_expr(d.arg, cols, prepared)
                out[f"cnt{ai}"] = SE.seg_sum_partials(
                    ones, torch.where(vl, seg, -1), segments, 1, strategy)
            continue
        if s["kind"] == "isum":
            _, vl = eval_expr(d.arg, cols, prepared)
            vseg = torch.where(vl, seg, -1)
            out[f"cnt{ai}"] = SE.seg_sum_partials(
                ones, vseg, segments, 1, strategy)
            for ti, (t, shift, L) in enumerate(s["terms"]):
                tv, _ = eval_expr(t, cols, prepared)
                out[f"s{ai}_{ti}"] = SE.seg_sum_partials(
                    tv.to(torch.int32), vseg, segments, L, strategy)
            continue
        v, vl = eval_expr(d.arg, cols, prepared)
        vseg = torch.where(vl, seg, -1)
        if s["kind"] == "hll":
            out[f"cnt{ai}"] = SE.seg_sum_partials(
                ones, vseg, segments, 1, strategy)
            v32 = v.to(torch.int32) if v.dtype == torch.bool else v
            out[f"h{ai}"] = AN.hll_group_registers(v32, vseg, segments)
            continue
        out[f"cnt{ai}"] = SE.seg_sum_partials(ones, vseg, segments, 1)
        if s["kind"] == "fsum":
            out[f"f{ai}"] = SE.float_seg_sums(
                v, vseg, segments, _FLOAT_BLOCKS)
        else:  # min / max with sentinels (kept for the tile merge)
            if v.is_floating_point():
                sent = float("inf") if s["kind"] == "min" else float("-inf")
            else:
                sent = _I32_MAX if s["kind"] == "min" else _I32_MIN
                v = v.to(torch.int32)
            vv = torch.where(vseg >= 0, v, sent)
            red = torch.min if s["kind"] == "min" else torch.max
            out[f"m{ai}"] = torch.stack([
                red(torch.where(vseg == k, vv, sent))
                for k in range(segments)])
    return out


def decode_agg_partials(agg, prepared, cards, out, group_dicts,
                        val_types) -> Optional[Chunk]:
    """Fetched partials -> one partial-layout chunk
    [group cols..., (val, cnt) per agg] (int64 host columns), or None when
    no group matched. val_types: per-agg output types in (val, cnt) pair
    order as laid out by the planner's partial schema."""
    offsets = prepared["__key_offsets__"]
    sched = prepared["__agg_sched__"]
    segments = 1
    for c in cards:
        segments *= max(c, 1)
    rows_per_seg = SE.combine_partials(out["rows"])
    seg_idx = np.nonzero(rows_per_seg > 0)[0]
    if len(seg_idx) == 0:
        return None

    columns: list[Column] = []
    codes = seg_idx.copy()
    parts: list[np.ndarray] = []
    for c in reversed(cards):
        parts.append(codes % c)
        codes = codes // c
    parts.reverse()
    for gi, g in enumerate(agg.group_by):
        card = cards[gi]
        code = parts[gi]
        ft = g.ftype
        is_null = code == (card - 1)
        data = (code + offsets[gi]).astype(ft.np_dtype)
        columns.append(Column(
            ft, data, None if not is_null.any() else ~is_null,
            group_dicts[gi]))

    starts = agg_partial_starts(agg.aggs, 0)  # offsets into val_types
    for ai, (d, s) in enumerate(zip(agg.aggs, sched)):
        cnt = SE.combine_partials(out[f"cnt{ai}"])[seg_idx] \
            if f"cnt{ai}" in out else rows_per_seg[seg_idx]
        val_t = val_types[starts[ai]]
        if s["kind"] == "hll":
            # HLL_WORDS byte-packed register words, then cnt: the final
            # merge unpacks and maxes them, so overlay batches and
            # host-tier partials union correctly
            words = AN.hll_pack_words(np.asarray(out[f"h{ai}"])[seg_idx])
            for w in range(HLL_WORDS):
                columns.append(Column(
                    FieldType(TypeKind.BIGINT, nullable=False),
                    words[:, w].copy()))
            columns.append(Column(
                FieldType(TypeKind.BIGINT, nullable=False),
                cnt.astype(np.int64)))
            continue
        if s["kind"] == "count":
            vcol = Column(val_t, cnt.astype(np.int64))
        elif s["kind"] == "isum":
            total = np.zeros(segments, dtype=np.int64)
            for ti, (_, shift, _) in enumerate(s["terms"]):
                total += SE.combine_partials(out[f"s{ai}_{ti}"]) << shift
            val = total[seg_idx]
            vcol = Column(val_t, val.astype(val_t.np_dtype),
                          None if (cnt > 0).all() else (cnt > 0))
        elif s["kind"] == "fsum":
            val = SE.combine_float(out[f"f{ai}"])[seg_idx]
            vcol = Column(val_t, val.astype(val_t.np_dtype),
                          None if (cnt > 0).all() else (cnt > 0))
        else:  # min / max — sentinel-filled where empty; cnt gates
            val = np.asarray(out[f"m{ai}"])[seg_idx]
            val = np.where(cnt > 0, val, 0)
            vcol = Column(val_t, val.astype(val_t.np_dtype),
                          None if (cnt > 0).all() else (cnt > 0))
        columns.append(vcol)
        columns.append(Column(
            FieldType(TypeKind.BIGINT, nullable=False),
            cnt.astype(np.int64)))
    return Chunk(columns)


# ==================== helpers ====================


def _narrow_stats(a: np.ndarray, bound) -> np.ndarray:
    """Stats-driven staging width: columns whose value bounds fit
    int8/int16 stage at that width; programs upcast to int32 at entry
    (`widen32`), so compute semantics are unchanged."""
    if a.dtype.kind in "iu" and bound is not None:
        lo, hi = bound
        if -128 <= lo and hi <= 127:
            return a.astype(np.int8)
        if -32768 <= lo and hi <= 32767:
            return a.astype(np.int16)
    return _narrow(a)


def widen32(cols):
    """Upcast narrow staged columns to int32 for compute."""
    out = []
    for d, v in cols:
        if d.dtype in (torch.int8, torch.int16):
            d = d.to(torch.int32)
        out.append((d, v))
    return out


def _narrow(a: np.ndarray) -> np.ndarray:
    """64-bit host columns -> 32-bit device staging."""
    if a.dtype == np.int64:
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def _pad(a: np.ndarray, b: int) -> np.ndarray:
    if len(a) == b:
        return a
    out = np.zeros(b, dtype=a.dtype)
    out[: len(a)] = a
    return out


def _pad_bool(a: np.ndarray, b: int) -> np.ndarray:
    out = np.zeros(b, dtype=bool)
    out[: len(a)] = a
    return out


def _lex_runs_ordered(snap, offsets) -> bool:
    """Lexicographic non-decreasing check over epoch columns (NULL-free):
    proves every distinct key tuple forms one contiguous storage run."""
    tie = None
    for off in offsets:
        v = snap.epoch.valids[off]
        if v is not None and not v.all():
            return False  # NULL codes sort above every value: order breaks
        d = snap.epoch.columns[off]
        if d.dtype.kind not in "iub":
            return False
        if len(d) < 2:
            continue
        a, b = d[:-1], d[1:]
        if tie is None:
            if np.any(a > b):
                return False
            tie = a == b
        else:
            if np.any(tie & (a > b)):
                return False
            tie = tie & (a == b)
    return True


def _subst_proj_cols(e: PlanExpr, projections: list[PlanExpr]) -> PlanExpr:
    """Rewrite Col refs (projection-output indices) to the projected exprs."""
    if isinstance(e, Col):
        return projections[e.idx]
    if isinstance(e, Call):
        return Call(e.op, [_subst_proj_cols(a, projections) for a in e.args],
                    e.ftype, e.extra)
    return e


def _like_to_regex(pattern: str) -> str:
    import re
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)
