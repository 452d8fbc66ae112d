"""Host execution engine: runs the root side of physical plans.

Counterpart of the reference's executor package (reference:
executor/executor.go Volcano Open/Next/Close; builder.go:99 dispatch) with a
TPU-first simplification: operators are chunk-at-a-time materialized rather
than pipelined iterators — the heavy lifting happened on the device; what
reaches the host is either partial-agg rows (small) or filtered row sets.
A streaming/spilling volcano loop comes with the memory-quota work.

Final aggregation merges device partials (reference P2: HashAggExec final
stage, executor/aggregate.go:146); joins/sorts are vectorized numpy
(reference: join.go/sort.go worker pools — replaced by array ops).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from .. import obs
from ..chunk.chunk import Chunk
from ..chunk.column import Column, Dictionary
from ..copr.client import CopClient
from ..copr.npeval import NumpyEval, _truthy
from ..plan.expr import AggDesc, Call, Col, Const, PlanExpr, ScalarSubq
from ..plan.physical import (
    PhysHashAgg,
    PhysHashJoin,
    PhysIndexJoin,
    PhysMergeJoin,
    PhysLimit,
    PhysIndexMerge,
    PhysPointGet,
    PhysProjection,
    PhysSelection,
    PhysSort,
    PhysUnion,
    PhysWindow,
    PhysTableRead,
    PhysicalPlan,
)
from ..store.storage import Transaction
from ..types.field_type import FieldType, TypeKind
from ..types.value import Decimal
from ..util import interrupt
from ..util.memory import MemTracker, QueryMemExceeded, SpillDir

_NULL_KEY = np.iinfo(np.int64).min


@dataclass
class ExecContext:
    txn: Transaction
    cop: CopClient
    stats: Optional[object] = None  # obs.RuntimeStatsColl for EXPLAIN ANALYZE
    mem: Optional[MemTracker] = None  # per-query quota tracker
    # statement-end hook (session uses it to unregister the tracker
    # root from the server-wide memory governor); runs exactly once
    on_close: Optional[object] = None

    def __post_init__(self) -> None:
        self._subq_cache: dict[int, Const] = {}
        if self.mem is None:
            self.mem = MemTracker()
        self._spill: Optional[SpillDir] = None

    @property
    def spill(self) -> SpillDir:
        if self._spill is None:
            self._spill = SpillDir()
        return self._spill

    def close(self) -> None:
        if self._spill is not None:
            self._spill.close()
            self._spill = None
        cb, self.on_close = self.on_close, None
        if cb is not None:
            cb()


def _overflow(ctx: ExecContext, est: int, label: str) -> bool:
    """True when `est` bytes don't fit the query quota and the operator
    should switch to its partitioned on-disk strategy; raises when the
    configured action is CANCEL (reference: util/memory/action.go:28 —
    spill actions vs PanicOnExceed)."""
    if not ctx.mem.over_budget(est):
        # admitted in memory: record the working set on the statement's
        # materialization ledger so the server-wide governor can rank
        # statements by weight (and MEM_MAX explains kills afterwards);
        # deliberately NOT consume() — quota/spill decisions unchanged
        ctx.mem.account(est)
        return False
    ctx.mem.check(est, label)  # raises under CANCEL
    ctx.mem.note_spill()
    if ctx.stats is not None and hasattr(ctx.stats, "note_spill"):
        ctx.stats.note_spill(label)
    return True


def _subst_subq(e: PlanExpr, ctx: ExecContext) -> PlanExpr:
    """Replace uncorrelated ScalarSubq nodes with materialized Consts.

    The subquery plan runs once per statement (reference evaluates
    uncorrelated scalar subqueries eagerly at rewrite time,
    planner/core/expression_rewriter.go)."""
    if isinstance(e, ScalarSubq):
        cached = ctx._subq_cache.get(id(e))
        if cached is not None:
            return cached
        chunk = run_physical(e.phys, ctx)
        if chunk.num_rows == 0 or not chunk.columns:
            const = Const(None, e.ftype)
        else:
            if chunk.num_rows > 1:
                raise ValueError("scalar subquery returned more than one row")
            col = chunk.columns[0]
            if not col.validity[0]:
                const = Const(None, e.ftype)
            elif col.dictionary is not None:
                const = Const(col.dictionary.decode(int(col.data[0])),
                              e.ftype)
            else:
                v = col.data[0]
                const = Const(float(v) if col.ftype.is_float else int(v),
                              e.ftype)
        ctx._subq_cache[id(e)] = const
        return const
    if isinstance(e, Call):
        new_args = [_subst_subq(a, ctx) for a in e.args]
        if all(n is o for n, o in zip(new_args, e.args)):
            return e
        return Call(e.op, new_args, e.ftype, e.extra)
    return e


# plan-node class -> the operator label the resource-attribution plane
# aggregates under (obs.StageRecorder op_wall / TopSQL / slow log);
# PhysTableRead refines by its pushed-down DAG tail, PhysFragmentRead's
# internals open their own finer-grained frames (copr/fragment.py)
_OP_LABELS = {
    "PhysFragmentRead": "fragment",
    "PhysPointGet": "point_get",
    "PhysIndexMerge": "index_merge",
    "PhysSelection": "filter",
    "PhysProjection": "project",
    "PhysHashAgg": "agg",
    "PhysSort": "sort",
    "PhysLimit": "limit",
    "PhysHashJoin": "join",
    "PhysMergeJoin": "join",
    "PhysIndexJoin": "join",
    "PhysUnion": "union",
    "PhysWindow": "window",
}


def _op_label(plan: PhysicalPlan) -> str:
    if isinstance(plan, PhysTableRead):
        dag = plan.dag
        if dag.agg is not None:
            return "scan+agg"
        if dag.topn is not None:
            return "scan+topn"
        return "scan"
    return _OP_LABELS.get(type(plan).__name__, "other")


def run_physical(plan: PhysicalPlan, ctx: ExecContext) -> Chunk:
    from .. import obs

    # always-on per-operator attribution: when a statement recorder is
    # installed (every session statement), each node runs under an
    # operator frame recording its EXCLUSIVE wall time + tagging the
    # dispatch stages/transfer bytes opened inside — the continuous
    # feed for Top SQL and the slow log's operator column. Cost is two
    # perf_counter reads and a dict update per plan node.
    rec = obs.active_stage_recorder()
    if ctx.stats is not None:
        import time as _time

        # attribute dispatch-stage time (staging/compile/transfer/
        # kernel/device_get/host_fallback) to this node, INCLUSIVE of
        # children — same convention as the node wall time
        before = rec.snapshot() if rec is not None else None
        t0 = _time.perf_counter()
        engine_tag = [None]
        with obs.operator(_op_label(plan)):
            chunk = _run_node(plan, ctx, engine_tag)
        stages = rec.delta_since(before) if rec is not None else None
        # mesh flight recorder: collect this node's per-shard dispatch
        # accounting (a no-op None on the single-device CopClient) —
        # feeds the EXPLAIN ANALYZE `mesh` column and the skew detector
        ctx.stats.record(plan, _time.perf_counter() - t0, chunk.num_rows,
                         engine_tag[0], stages=stages,
                         mesh=ctx.cop.take_mesh_note())
        return chunk
    if rec is not None:
        with obs.operator(_op_label(plan)):
            chunk = _run_node(plan, ctx, None)
        ctx.cop.take_mesh_note()
        return chunk
    chunk = _run_node(plan, ctx, None)
    ctx.cop.take_mesh_note()
    return chunk


def _run_node(plan: PhysicalPlan, ctx: ExecContext,
              engine_tag: Optional[list]) -> Chunk:
    interrupt.check()  # KILL QUERY checkpoint between plan nodes
    if isinstance(plan, PhysTableRead):
        if plan.dag.scan.table_id < 0:
            return Chunk([])  # dual pseudo-table: one conceptual row, no cols
        snap = ctx.txn.snapshot(plan.dag.scan.table_id)
        # placement-aware dispatch: the engine pins the mesh placement
        # (shard the epoch over the device mesh vs single-device) for
        # this node from the snapshot it just took, so every staging/
        # kernel decision below sees one consistent answer
        with ctx.cop.placement_scope(snap):
            result = ctx.cop.execute(plan.dag, snap)
        obs.note_engine(result.engine)
        if engine_tag is not None:
            engine_tag[0] = result.engine
        out = Chunk.concat(result.chunks) if result.chunks else \
            _empty_like(plan)
        if plan.dag.agg is None and plan.dag.topn is None and \
                plan.dag.limit is None and plan.dag.selection is not None:
            # scan-count feedback: the observed row count corrects the
            # histogram estimate for this exact conjunct set (reference:
            # statistics/feedback.go + handle/update.go:551)
            from ..plan.physical import conds_digest
            stats = ctx.txn.storage.stats
            stats.record_feedback(
                plan.dag.scan.table_id,
                conds_digest(plan.dag.selection.conditions), out.num_rows)
            # column-attributable predicates also correct the histogram
            # buckets / point estimates themselves
            stats.record_condition_feedback(
                plan.dag.scan.table_id, plan.dag.scan.col_offsets,
                plan.dag.selection.conditions, out.num_rows)
        return out
    from ..plan.fragment import PhysFragmentRead
    if isinstance(plan, PhysFragmentRead):
        from ..copr.fragment import execute_fragment
        snaps = {t.table.id: ctx.txn.snapshot(t.table.id)
                 for t in plan.frag.tables}
        for sm in plan.frag.semis:  # membership builds need snapshots too
            tid = sm.table.table.id
            if tid not in snaps:
                snaps[tid] = ctx.txn.snapshot(tid)
        result = execute_fragment(ctx.cop, plan.frag, snaps)
        obs.note_engine(result.engine)
        if engine_tag is not None:
            engine_tag[0] = result.engine
        if not result.chunks:
            return _empty_like(plan)
        return Chunk.concat(result.chunks)
    if isinstance(plan, PhysPointGet):
        return _run_point_get(plan, ctx)
    if isinstance(plan, PhysIndexMerge):
        return _run_index_merge(plan, ctx)
    if isinstance(plan, PhysUnion):
        return _run_union(plan, ctx)
    if isinstance(plan, PhysWindow):
        return _run_window(plan, ctx)
    if isinstance(plan, PhysSelection):
        child = run_physical(plan.children[0], ctx)
        ev = _evaluator(child)
        mask = np.ones(child.num_rows, dtype=bool)
        for c in plan.conditions:
            v, vl = ev.eval(_subst_subq(c, ctx))
            mask &= _truthy(np.asarray(v)) & vl
        return child.take(np.nonzero(mask)[0])
    if isinstance(plan, PhysProjection):
        child = run_physical(plan.children[0], ctx)
        ev = _evaluator(child)
        if not child.columns:
            ev.n = 1  # dual: constants evaluate to a single row
        cols = []
        for e, f in zip(plan.exprs, plan.schema.fields):
            e = _subst_subq(e, ctx)
            if f.ftype.is_string and not isinstance(e, Col):
                # computed strings cross dictionary domains: evaluate in the
                # string domain, re-encode into a fresh dictionary
                sv, svl = ev.eval_str(e)
                d = Dictionary()
                data = np.fromiter(
                    (d.encode(s) if ok else 0 for s, ok in zip(sv, svl)),
                    dtype=np.int32, count=ev.n)
                cols.append(Column(f.ftype, data,
                                   None if svl.all() else svl, d))
                continue
            v, vl = ev.eval(e)
            v = np.asarray(v)
            vl = np.asarray(vl)
            dictionary = None
            if f.ftype.is_string and isinstance(e, Col):
                dictionary = child.columns[e.idx].dictionary
            cols.append(Column(f.ftype, v.astype(f.ftype.np_dtype),
                               None if vl.all() else vl, dictionary))
        if not cols:
            # zero-column projection over pseudo table: one row
            return Chunk([])
        return Chunk(cols)
    if isinstance(plan, PhysHashAgg):
        return _run_agg(plan, ctx)
    if isinstance(plan, PhysSort):
        child = run_physical(plan.children[0], ctx)
        items = [(_subst_subq(e, ctx), d) for e, d in plan.items]
        est = child.nbytes + child.num_rows * 8 * max(1, len(items))
        if items and child.num_rows and _overflow(ctx, est, "Sort"):
            return _spill_sort(child, items, ctx)
        order = _sort_order(child, items)
        return child.take(order)
    if isinstance(plan, PhysLimit):
        child = run_physical(plan.children[0], ctx)
        start = min(plan.offset, child.num_rows)
        stop = min(plan.offset + plan.limit, child.num_rows)
        return child.slice(start, stop)
    if isinstance(plan, (PhysHashJoin, PhysMergeJoin)):
        # the merge join reuses the join driver: its single-key match is
        # the sort-free searchsorted alignment (_equi_match fast path)
        return _run_join(plan, ctx)
    if isinstance(plan, PhysIndexJoin):
        return _run_index_join(plan, ctx)
    raise TypeError(f"run_physical: unknown node {type(plan).__name__}")


def _gathered_chunk(snap, gathered, col_offsets, schema, conditions,
                    ctx: ExecContext) -> Chunk:
    """Shared fetch tail of the point-get and index-merge readers:
    assemble gathered columns into a chunk and apply the residual
    filter engine-side."""
    columns = []
    for (data, valid), off, f in zip(gathered, col_offsets,
                                     schema.fields):
        columns.append(Column(f.ftype, data,
                              None if valid.all() else valid,
                              snap.dictionaries[off]))
    chunk = Chunk(columns)
    if conditions and chunk.num_rows:
        ev = _evaluator(chunk)
        mask = np.ones(chunk.num_rows, dtype=bool)
        for c in conditions:
            v, vl = ev.eval(_subst_subq(c, ctx))
            mask &= _truthy(np.asarray(v)) & vl
        chunk = chunk.take(np.nonzero(mask)[0])
    return chunk


def _run_point_get(plan: PhysPointGet, ctx: ExecContext) -> Chunk:
    """Fetch rows by handle / unique key, then apply the residual filter
    (reference: executor/point_get.go Next; batch_point_get.go)."""
    from ..store.index import probe_and_gather

    snap = ctx.txn.snapshot(plan.table.id)
    if plan.handles is not None:
        handles = np.array(
            sorted({h for h in plan.handles if snap.has_handle(h)}),
            dtype=np.int64)
        gathered = snap.gather(handles, plan.col_offsets)
    else:
        handles, gathered = probe_and_gather(snap, plan.ranges,
                                             plan.col_offsets)
    return _gathered_chunk(snap, gathered, plan.col_offsets, plan.schema,
                           plan.conditions, ctx)


def _run_index_merge(plan: "PhysIndexMerge", ctx: ExecContext) -> Chunk:
    """Union every branch's handle set, gather once, re-check the full
    filter (reference: executor/index_merge_reader.go — the partial
    workers' union then table fetch, collapsed to vector ops). A branch
    with index=None carries literal pk-handle points."""
    from ..store.index import IndexSearcher

    snap = ctx.txn.snapshot(plan.table.id)
    found: list[np.ndarray] = []
    for r in plan.branches:
        if r.index is None:
            hs = np.array([h for (h,) in r.points if snap.has_handle(h)],
                          dtype=np.int64)
            found.append(hs)
            continue
        searcher = IndexSearcher(snap.store, snap, r.index)
        if r.interval is not None:
            lo, hi, li, hi_i = r.interval
            found.append(searcher.range(lo, hi, li, hi_i))
        else:
            found.extend(searcher.eq(p) for p in r.points)
    handles = (np.unique(np.concatenate(found)) if found
               else np.empty(0, dtype=np.int64))
    gathered = snap.gather(handles, plan.col_offsets)
    return _gathered_chunk(snap, gathered, plan.col_offsets, plan.schema,
                           plan.conditions, ctx)


def _empty_like(plan: PhysicalPlan) -> Chunk:
    return Chunk([
        Column(f.ftype, np.empty(0, f.ftype.np_dtype))
        for f in plan.schema.fields
    ])


def _evaluator(chunk: Chunk) -> NumpyEval:
    cols = [(c.data, c.validity) for c in chunk.columns]
    dicts = [c.dictionary for c in chunk.columns]
    return NumpyEval(cols, dicts, chunk.num_rows)


# ==================== union ====================

def _run_union(plan: "PhysUnion", ctx: ExecContext) -> Chunk:
    """UNION ALL: normalize each child chunk to the unified schema and
    concatenate (reference: executor union over children; DISTINCT is the
    aggregation the planner placed above)."""
    from ..chunk.column import Dictionary

    out_fields = plan.schema.fields
    shared_dicts = [Dictionary() if f.ftype.is_string else None
                    for f in out_fields]
    pieces: list[Chunk] = []
    for child in plan.children:
        chunk = run_physical(child, ctx)
        cols = []
        for i, f in enumerate(out_fields):
            src = chunk.columns[i] if i < len(chunk.columns) else None
            cols.append(_normalize_union_col(src, f.ftype, shared_dicts[i]))
        pieces.append(Chunk(cols))
    return Chunk.concat(pieces)


def _normalize_union_col(src, ft, shared_dict):
    """Convert a child column to the union's result type: decimal rescale,
    integer/float widening, dictionary re-encode into the shared dict."""
    if src is None:
        return Column(ft, np.empty(0, ft.np_dtype), None, shared_dict)
    data = src.data
    valid = src.validity
    if ft.is_string:
        # re-encode through the shared dictionary so codes unify
        if src.dictionary is not None:
            remap = np.fromiter(
                (shared_dict.encode(v) for v in src.dictionary.values),
                dtype=np.int32, count=len(src.dictionary))
            codes = remap[data] if len(remap) else np.zeros(len(data),
                                                           np.int32)
        else:
            codes = data.astype(np.int32)
        return Column(ft, codes, None if valid.all() else valid,
                      shared_dict)
    if ft.is_decimal:
        sscale = src.ftype.scale if src.ftype.is_decimal else 0
        d = data.astype(np.int64)
        if sscale < ft.scale:
            d = d * (10 ** (ft.scale - sscale))
        return Column(ft, d, None if valid.all() else valid)
    if ft.is_float:
        d = data.astype(np.float64)
        if src.ftype.is_decimal:
            d = d / (10 ** src.ftype.scale)
        return Column(ft, d, None if valid.all() else valid)
    return Column(ft, data.astype(ft.np_dtype),
                  None if valid.all() else valid)


# ==================== window functions ====================

def _run_window(plan: PhysWindow, ctx: ExecContext) -> Chunk:
    """Window computation over the child chunk (reference:
    executor/window.go): per item, sort by (partition, order keys),
    compute vectorized running/whole-partition values, scatter back to the
    original row order. Default frame semantics: with ORDER BY the value
    is cumulative with peers sharing results (RANGE UNBOUNDED
    PRECEDING..CURRENT ROW); without, the whole partition."""
    child = run_physical(plan.children[0], ctx)
    n = child.num_rows
    ev = _evaluator(child)
    out_cols = list(child.columns)
    for item, f in zip(plan.items,
                       plan.schema.fields[len(child.columns):]):
        data, valid = _window_values(item, f.ftype, child, ev, n, ctx)
        dictionary = None
        if f.ftype.is_string:
            # value-propagating funcs over a string column carry its
            # dictionary (builder gates out other string-typed windows)
            arg0 = item.args[0] if item.args else None
            if isinstance(arg0, Col):
                dictionary = child.columns[arg0.idx].dictionary
        out_cols.append(Column(f.ftype, data,
                               None if valid is None or valid.all()
                               else valid, dictionary))
    return Chunk(out_cols)


def _window_sort_keys(item, child, ev, n):
    """lexsort keys: order keys (last = primary is partition)."""
    keys = []
    for e, desc in reversed(item.order):
        v, vl = ev.eval(e)
        v = np.asarray(v)
        vl = np.asarray(vl)
        if e.ftype.is_string and isinstance(e, Col):
            d = child.columns[e.idx].dictionary
            if d is not None and len(d):
                ranks = d.sort_ranks(ci=e.ftype.is_ci)
                v = ranks[np.clip(v, 0, len(d) - 1)].astype(np.int64)
        if np.issubdtype(v.dtype, np.floating):
            key = np.where(vl, v.astype(np.float64), -np.inf)
        else:
            key = np.where(vl, v.astype(np.int64), _NULL_KEY + 1)
        keys.append(-key if desc else key)
    return keys


def _window_values(item, out_t, child, ev, n, ctx):
    # partition ids
    if item.partition:
        pcols = []
        for e in item.partition:
            v, vl = ev.eval(e)
            pcols.append((np.asarray(v), np.asarray(vl)))
        pid, _ = _group_ids(pcols, n)
    else:
        pid = np.zeros(n, np.int64)
    okeys = _window_sort_keys(item, child, ev, n)
    order = np.lexsort(tuple(okeys) + (pid,)) if (okeys or n) else         np.arange(n)
    pid_s = pid[order]
    iota = np.arange(n, dtype=np.int64)
    starts = np.r_[True, pid_s[1:] != pid_s[:-1]] if n else         np.zeros(0, bool)
    pstart = np.maximum.accumulate(np.where(starts, iota, 0)) if n else iota

    # peer groups: same partition AND same order-key values
    if item.order and n:
        peer_start = starts.copy()
        for k in okeys:
            ks = k[order]
            peer_start |= np.r_[True, ks[1:] != ks[:-1]]
    else:
        peer_start = starts.copy() if n else starts

    def last_of_peer():
        """index of the last row of each row's peer group (sorted order);
        without ORDER BY, the last row of the partition."""
        if n == 0:
            return iota
        boundary = peer_start if item.order else starts
        nxt = np.where(boundary, iota, n)
        nxt = np.r_[nxt[1:], n]
        nxt = np.minimum.accumulate(nxt[::-1])[::-1]
        return np.minimum(nxt - 1, n - 1)

    # per-row partition end + size (frame clipping, ntile, cume_dist)
    bnds = np.nonzero(starts)[0] if n else np.zeros(0, np.int64)
    pend = (np.r_[bnds[1:], n] - 1)[np.cumsum(starts) - 1] if n else iota
    psize = pend - pstart + 1 if n else iota

    name = item.func
    valid_out = None
    frame = getattr(item, "frame", None)
    if frame is not None and n and name in (
            "SUM", "COUNT", "AVG", "MIN", "MAX",
            "FIRST_VALUE", "LAST_VALUE", "NTH_VALUE"):
        fs, fe = _frame_bounds(frame, item, iota, pstart, pend,
                               peer_start, last_of_peer, okeys, order, n)
        vals, valid_out = _frame_agg(name, item, out_t, ev, order,
                                     fs, fe, n)
    elif name == "ROW_NUMBER":
        vals = (iota - pstart + 1).astype(np.int64)
    elif name == "RANK":
        first_peer = np.maximum.accumulate(
            np.where(peer_start, iota, 0)) if n else iota
        vals = (first_peer - pstart + 1).astype(np.int64)
    elif name == "DENSE_RANK":
        cp = np.cumsum(peer_start) if n else iota
        cp_at_start = cp[pstart] if n else cp
        vals = (cp - cp_at_start + 1).astype(np.int64)
    elif name in ("LEAD", "LAG"):
        av, avl = ev.eval(item.args[0])
        av = np.asarray(av)[order]
        avl = np.asarray(avl)[order]
        off = 1
        if len(item.args) > 1:
            off = int(_const_of(item.args[1]))
            if off < 0:
                raise ValueError(f"{name} offset must be non-negative")
        src = iota + (off if name == "LEAD" else -off)
        ok = (src >= 0) & (src < n)
        src_c = np.clip(src, 0, max(n - 1, 0))
        ok &= pid_s[src_c] == pid_s  # stay inside the partition
        vals = np.where(ok, av[src_c], 0)
        valid_s = np.where(ok, avl[src_c], False)
        if len(item.args) > 2:  # explicit default
            dv = _const_of(item.args[2])
            if dv is not None:
                if isinstance(dv, str):
                    arg0 = item.args[0]
                    d = child.columns[arg0.idx].dictionary \
                        if isinstance(arg0, Col) else None
                    if d is not None:
                        dv = d.encode(dv)
                    else:
                        # numeric column: coerce MySQL-style or reject
                        try:
                            dv = float(dv) if "." in dv else int(dv)
                        except ValueError:
                            raise ValueError(
                                f"{name} default {dv!r} does not coerce "
                                "to the column type") from None
                vals = np.where(ok, vals, dv)
                valid_s = valid_s | ~ok
        vals, valid_out = vals, valid_s
    elif name in ("FIRST_VALUE", "LAST_VALUE", "NTH_VALUE"):
        av, avl = ev.eval(item.args[0])
        av = np.asarray(av)[order]
        avl = np.asarray(avl)[order]
        if name == "NTH_VALUE":
            nth = int(_const_of(item.args[1]))
            if nth < 1:
                raise ValueError("NTH_VALUE position must be >= 1")
            idx = pstart + nth - 1
            # default frame end: peers with ORDER BY, else partition end
            end = last_of_peer() if item.order else pend
            ok = idx <= end
            idx = np.minimum(idx, np.maximum(end, pstart))
            vals = np.where(ok, av[idx], 0)
            valid_out = np.where(ok, avl[idx], False)
        else:
            idx = pstart if name == "FIRST_VALUE" else last_of_peer()
            vals = av[idx]
            valid_out = avl[idx]
    elif name == "NTILE":
        k = int(_const_of(item.args[0]))
        if k < 1:
            raise ValueError("NTILE argument must be >= 1")
        r = iota - pstart
        small = psize // k
        big = psize % k
        cut = big * (small + 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            in_big = r < cut
            vals = np.where(
                in_big,
                r // np.maximum(small + 1, 1),
                big + np.where(small > 0, (r - cut) // np.maximum(small, 1),
                               0)) + 1
        vals = vals.astype(np.int64)
    elif name == "PERCENT_RANK":
        first_peer = np.maximum.accumulate(
            np.where(peer_start, iota, 0)) if n else iota
        rank = first_peer - pstart
        denom = np.maximum(psize - 1, 1)
        vals = np.where(psize > 1, rank / denom, 0.0)
    elif name == "CUME_DIST":
        vals = (last_of_peer() - pstart + 1) / np.maximum(psize, 1)
    else:  # SUM / COUNT / AVG / MIN / MAX
        func = name.lower()
        if item.args:
            av, avl = ev.eval(item.args[0])
            av = np.asarray(av)[order]
            avl = np.asarray(avl)[order]
        else:  # COUNT(*)
            av = np.ones(n, np.int64)
            avl = np.ones(n, bool)
        running = bool(item.order)
        cnts = _seg_cum(avl.astype(np.int64), starts, pstart, running)
        if func == "count":
            vals = cnts[last_of_peer()] if running and n else cnts
        elif func in ("sum", "avg"):
            if np.issubdtype(av.dtype, np.floating):
                masked = np.where(avl, av, 0.0)
            else:
                masked = np.where(avl, av.astype(np.int64), 0)
            sums = _seg_cum(masked, starts, pstart, running)
            if running and n:
                lp = last_of_peer()
                sums = sums[lp]
                cnts = cnts[lp]
            if func == "sum":
                vals = sums
                valid_out = cnts > 0
            else:
                col = _avg_column(
                    AggDesc("avg", item.args[0], out_t, False, ""),
                    out_t, sums, cnts)
                vals = col.data
                valid_out = col.validity
        else:  # min / max — running needs a segmented scan
            red = np.minimum if func == "min" else np.maximum
            if np.issubdtype(av.dtype, np.floating):
                sent = np.inf if func == "min" else -np.inf
                masked = np.where(avl, av, sent)
            else:
                sent = np.iinfo(np.int64).max if func == "min" else                     np.iinfo(np.int64).min
                masked = np.where(avl, av.astype(np.int64), sent)
            if running and n:
                vals = masked.copy()
                # segmented running reduce per partition slice
                bounds = np.nonzero(starts)[0]
                for b, e in zip(bounds, np.r_[bounds[1:], n]):
                    vals[b:e] = red.accumulate(masked[b:e])
                vals = vals[last_of_peer()]
            else:
                bounds = np.nonzero(starts)[0] if n else                     np.zeros(0, np.int64)
                totals = red.reduceat(masked, bounds) if n else masked
                seg = np.cumsum(starts) - 1 if n else iota
                vals = totals[seg] if n else masked
            valid_out = cnts[last_of_peer()] > 0 if running and n                 else (cnts > 0)
            vals = np.where(valid_out, vals, 0)

    out = np.zeros(n, dtype=out_t.np_dtype)
    out[order] = vals.astype(out_t.np_dtype)
    if valid_out is None:
        return out, None
    vo = np.zeros(n, bool)
    vo[order] = valid_out
    return out, vo


def _frame_bounds(frame, item, iota, pstart, pend, peer_start,
                  last_of_peer, okeys, order, n):
    """Inclusive frame [fs, fe] per row in sorted order (reference:
    executor/window.go frame builders rowFrameWindowProcessor /
    rangeFrameWindowProcessor). ROWS bounds are index arithmetic; RANGE
    bounds are key-offset searches within each partition's sorted run.
    Empty frames surface as fs > fe."""
    if frame.unit == "ROWS":
        def rows_bound(btype, val, is_start):
            if btype == "unbounded":
                return pstart
            if btype == "unbounded_following":
                return pend
            if btype == "current":
                return iota
            off = val if btype == "following" else -val
            return iota + off
        fs = rows_bound(frame.start_type, frame.start_value, True)
        fe = rows_bound(frame.end_type, frame.end_value, False)
        return np.maximum(fs, pstart), np.minimum(fe, pend)

    # RANGE: offsets move along the primary ORDER BY key; direction is
    # already folded into the encoded key (desc keys are negated), so
    # PRECEDING is always key - off in encoded space
    key = okeys[-1] if okeys else None  # primary key, pre-sort order
    key_s = key[order] if key is not None else None
    scale = 1
    if item.order and getattr(item.order[0][0].ftype, "is_decimal", False):
        scale = 10 ** item.order[0][0].ftype.scale

    def range_bound(btype, val, is_start):
        if btype == "unbounded":
            return pstart
        if btype == "unbounded_following":
            return pend
        if btype == "current":
            if is_start:  # first peer
                return np.maximum.accumulate(np.where(peer_start, iota, 0))
            return last_of_peer()
        off = val * scale * (1 if btype == "following" else -1)
        out = np.empty(n, np.int64)
        bnds = np.nonzero(np.r_[True, pstart[1:] != pstart[:-1]])[0]
        for b, e in zip(bnds, np.r_[bnds[1:], n]):
            seg = key_s[b:e]
            target = key_s[b:e] + off
            if is_start:
                out[b:e] = b + np.searchsorted(seg, target, side="left")
            else:
                out[b:e] = b + np.searchsorted(seg, target,
                                               side="right") - 1
        return out

    fs = range_bound(frame.start_type, frame.start_value, True)
    fe = range_bound(frame.end_type, frame.end_value, False)
    return np.maximum(fs, pstart), np.minimum(fe, pend)


def _sparse_minmax(vals, fs, fe, fn, empty):
    """Vectorized range min/max over inclusive [fs, fe] via a sparse
    table (O(n log n) build, O(1) per query)."""
    n = len(vals)
    table = [vals]
    k = 1
    while (1 << k) <= n:
        prev = table[-1]
        half = 1 << (k - 1)
        m = n - (1 << k) + 1
        table.append(fn(prev[:m], prev[half:half + m]))
        k += 1
    length = np.maximum(fe - fs + 1, 1)
    kq = np.floor(np.log2(length)).astype(np.int64)
    out = np.full(n, empty, dtype=vals.dtype)
    for kk in range(len(table)):
        mask = kq == kk
        if not mask.any():
            continue
        s = fs[mask]
        e = fe[mask]
        out[mask] = fn(table[kk][s], table[kk][e - (1 << kk) + 1])
    return out


def _frame_agg(name, item, out_t, ev, order, fs, fe, n):
    """Apply an aggregate/value function over per-row frames [fs, fe]
    (sorted order); returns (vals, valid) in sorted order."""
    nonempty = fs <= fe
    fs_c = np.minimum(fs, n - 1)
    fe_c = np.clip(fe, 0, n - 1)
    if item.args:
        av, avl = ev.eval(item.args[0])
        av = np.asarray(av)[order]
        avl = np.asarray(avl)[order]
    else:  # COUNT(*)
        av = np.ones(n, np.int64)
        avl = np.ones(n, bool)

    if name == "FIRST_VALUE":
        return (np.where(nonempty, av[fs_c], 0),
                np.where(nonempty, avl[fs_c], False))
    if name == "LAST_VALUE":
        return (np.where(nonempty, av[fe_c], 0),
                np.where(nonempty, avl[fe_c], False))
    if name == "NTH_VALUE":
        nth = int(_const_of(item.args[1]))
        if nth < 1:
            raise ValueError("NTH_VALUE position must be >= 1")
        idx = fs + nth - 1
        ok = nonempty & (idx <= fe)
        idx = np.clip(idx, 0, n - 1)
        return np.where(ok, av[idx], 0), np.where(ok, avl[idx], False)

    cnt_ps = np.r_[0, np.cumsum(avl.astype(np.int64))]
    cnts = np.where(nonempty, cnt_ps[fe_c + 1] - cnt_ps[fs_c], 0)
    if name == "COUNT":
        return cnts.astype(np.int64), None
    if name in ("SUM", "AVG"):
        if np.issubdtype(av.dtype, np.floating):
            masked = np.where(avl, av, 0.0)
        else:
            masked = np.where(avl, av.astype(np.int64), 0)
        ps = np.r_[masked.dtype.type(0), np.cumsum(masked)]
        sums = np.where(nonempty, ps[fe_c + 1] - ps[fs_c], 0)
        if name == "SUM":
            valid = cnts > 0
            return sums, valid
        col = _avg_column(AggDesc("avg", item.args[0], out_t, False, ""),
                          out_t, sums, cnts)
        return col.data, (col.validity if col.valid is not None
                          else cnts > 0)
    # MIN / MAX
    red = np.minimum if name == "MIN" else np.maximum
    if np.issubdtype(av.dtype, np.floating):
        sent = np.inf if name == "MIN" else -np.inf
        masked = np.where(avl, av, sent)
    else:
        sent = np.iinfo(np.int64).max if name == "MIN" else \
            np.iinfo(np.int64).min
        masked = np.where(avl, av.astype(np.int64), sent)
    vals = _sparse_minmax(masked, fs_c, fe_c, red, sent)
    valid = cnts > 0
    return np.where(valid, vals, 0), valid


def _seg_cum(vals, starts, pstart, running):
    """Per-partition cumulative (running) or total (not) sums."""
    n = len(vals)
    if n == 0:
        return vals
    cum = np.cumsum(vals)
    run = cum - cum[pstart] + vals[pstart]
    if running:
        return run
    # whole-partition totals: value of the run at the partition's last row
    bounds = np.nonzero(starts)[0]
    last = np.r_[bounds[1:], n] - 1
    seg = np.cumsum(starts) - 1
    return run[last][seg]


def _const_of(e):
    if isinstance(e, Const):
        return e.value
    raise ValueError("LEAD/LAG offset and default must be literals")


# ==================== aggregation ====================

def _run_agg(plan: PhysHashAgg, ctx: ExecContext) -> Chunk:
    child = run_physical(plan.children[0], ctx)
    if plan.mode == "final":
        return _merge_partials(plan, child)
    plan = PhysHashAgg(
        plan.mode,
        [_subst_subq(g, ctx) for g in plan.group_by],
        [AggDesc(d.func, None if d.arg is None else _subst_subq(d.arg, ctx),
                 d.ftype, d.distinct, d.name, d.params)
         for d in plan.aggs],
        plan.schema, plan.children)
    # group-id working set: sort order + unique + inverse over all rows
    if plan.group_by and child.num_rows and \
            _overflow(ctx, child.nbytes * 2, "HashAgg"):
        return _spill_agg(plan, child, ctx)
    return _complete_agg(plan, child)


def _spill_agg(plan: PhysHashAgg, child: Chunk, ctx: ExecContext) -> Chunk:
    """Hash-partitioned aggregation: rows split by group-key hash into
    on-disk partitions, each aggregated independently, results
    concatenated — group keys are disjoint across partitions, so the
    union of per-partition groups IS the global answer (the same
    disjointness the mesh hc-agg exchange relies on; reference:
    executor/aggregate.go spill + parallel partial workers)."""
    ev = _evaluator(child)
    n = child.num_rows
    enc = []
    for g in plan.group_by:
        if g.ftype.is_string and not isinstance(g, Col):
            sv, svl = ev.eval_str(g)
            e = np.fromiter(
                (hash(s) if ok else _NULL_KEY for s, ok in zip(sv, svl)),
                np.int64, count=n)
        else:
            v, vl = ev.eval(g)
            v = np.asarray(v)
            if g.ftype.is_string and isinstance(g, Col) and g.ftype.is_ci:
                d = child.columns[g.idx].dictionary
                if d is not None and len(d):
                    v = d.ci_canonical()[np.clip(v, 0, len(d) - 1)]
            if np.issubdtype(v.dtype, np.floating):
                e = v.astype(np.float64).view(np.int64)
            else:
                e = v.astype(np.int64)
            e = np.where(np.asarray(vl), e, _NULL_KEY)
        enc.append(e)
    stack = np.stack(enc, axis=1)
    need = child.nbytes * 2
    parts = int(min(64, max(2, -(-need * 2 // max(ctx.mem.available(), 1)))))
    pid = (_key_hash(stack) % np.uint64(parts)).astype(np.int64)
    del stack, enc, ev
    files = []
    for p in range(parts):
        idx = np.nonzero(pid == p)[0]
        if len(idx):
            files.append(ctx.spill.spill(child.take(idx)))
    del child, pid
    outs = []
    for f in files:
        part = f.read()
        ctx.mem.consume(part.nbytes)
        outs.append(_complete_agg(plan, part))
        ctx.mem.release(part.nbytes)
    if not outs:
        return _complete_agg(plan, Chunk([]))
    return Chunk.concat(outs)


def _group_ids(key_cols: list[tuple[np.ndarray, np.ndarray]], n: int):
    """(inverse ids, unique-first row indices); NULLs group together."""
    if not key_cols:
        return np.zeros(n, np.int64), np.zeros(1 if n else 0, np.int64)
    enc = []
    for v, vl in key_cols:
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            e = v.astype(np.float64).view(np.int64)
        else:
            e = v.astype(np.int64)
        enc.append(np.where(vl, e, _NULL_KEY))
    stacked = np.stack(enc, axis=1)
    _, first, inv = np.unique(stacked, axis=0, return_index=True,
                              return_inverse=True)
    return inv.reshape(-1), first


def _merge_partials(plan: PhysHashAgg, child: Chunk) -> Chunk:
    """Merge device/host partials: [gk..., (val,cnt)...] -> final schema."""
    ngroups = len(plan.group_by)
    n = child.num_rows
    key_cols = [(child.columns[i].data, child.columns[i].validity)
                for i in range(ngroups)]
    inv, first = _group_ids(key_cols, n)
    n_seg = len(first)
    if n == 0:
        n_seg = 0
    order = np.argsort(inv[:n], kind="stable") if n else np.empty(0, np.int64)
    sorted_inv = inv[order]
    bounds = np.nonzero(np.r_[True, sorted_inv[1:] != sorted_inv[:-1]])[0] \
        if n else np.empty(0, np.int64)

    out_cols: list[Column] = []
    for gi in range(ngroups):
        src = child.columns[gi]
        f = plan.schema.fields[gi]
        gidx = order[bounds] if n else np.empty(0, np.int64)
        data = src.data[gidx]
        valid = src.validity[gidx]
        out_cols.append(Column(f.ftype, data.astype(f.ftype.np_dtype),
                               None if valid.all() else valid,
                               src.dictionary))

    from ..plan.dag import HLL_WORDS, agg_partial_starts
    starts = agg_partial_starts(plan.aggs, ngroups)
    for ai, d in enumerate(plan.aggs):
        out_t = plan.schema.fields[ngroups + ai].ftype
        if d.func == "approx_count_distinct":
            from ..copr.analyze import hll_ndv, hll_unpack_words
            words = np.stack(
                [child.columns[starts[ai] + w].data.astype(np.int64)
                 for w in range(HLL_WORDS)], axis=1)
            ccol = child.columns[starts[ai] + HLL_WORDS]
            cnts = _seg_reduce(np.add, ccol.data.astype(np.int64),
                               order, bounds)
            regs = hll_unpack_words(words)
            merged = _seg_reduce(np.maximum, regs, order, bounds) \
                if n else np.zeros((0, regs.shape[1]), np.int32)
            vals = np.array(
                [hll_ndv(merged[i], cnts[i]) if cnts[i] else 0
                 for i in range(len(cnts))], np.int64)
            out_cols.append(Column(out_t, vals))
            continue
        vcol = child.columns[starts[ai]]
        ccol = child.columns[starts[ai] + 1]
        cnts = _seg_reduce(np.add, ccol.data.astype(np.int64), order, bounds)
        if d.func == "count":
            out_cols.append(Column(out_t, cnts))
            continue
        vdata = vcol.data
        vvalid = vcol.validity
        if d.func in ("sum", "avg"):
            if np.issubdtype(vdata.dtype, np.floating):
                masked = np.where(vvalid, vdata, 0.0)
            else:
                masked = np.where(vvalid, vdata.astype(np.int64), 0)
            sums = _seg_reduce(np.add, masked, order, bounds)
            if d.func == "sum":
                valid = cnts > 0
                out_cols.append(Column(out_t, sums.astype(out_t.np_dtype),
                                       None if valid.all() else valid))
            else:
                out_cols.append(_avg_column(d, out_t, sums, cnts))
        elif d.func in ("min", "max"):
            if np.issubdtype(vdata.dtype, np.floating):
                sentinel = np.inf if d.func == "min" else -np.inf
                masked = np.where(vvalid, vdata, sentinel)
            else:
                sentinel = np.iinfo(np.int64).max if d.func == "min" else \
                    np.iinfo(np.int64).min
                masked = np.where(vvalid, vdata.astype(np.int64), sentinel)
            fn = np.minimum if d.func == "min" else np.maximum
            vals = _seg_reduce(fn, masked, order, bounds)
            valid = cnts > 0
            vals = np.where(valid, vals, 0)
            out_cols.append(Column(out_t, vals.astype(out_t.np_dtype),
                                   None if valid.all() else valid))
        else:
            raise NotImplementedError(d.func)
    if not out_cols:
        return Chunk([])
    if ngroups == 0 and (n == 0 or out_cols[0].data.shape[0] == 0):
        # scalar aggregate over empty input: one row (count=0, sums NULL)
        return _scalar_agg_empty_row(plan)
    return Chunk(out_cols)


class _RawDec(str):
    """Marker for an exact decimal literal inside a JSON aggregate: the
    value dumps as a tagged string, then _raw_dumps strips the quotes so
    the EXACT number lands in the document (json floats cap at ~17
    significant digits)."""


def _raw_dumps(o) -> str:
    import json as _json
    import re as _re
    s = _json.dumps(o, sort_keys=True, separators=(", ", ": "))
    return _re.sub(r'"\\u0000RAWD:(-?[0-9.]+)"', r"\1", s)


def _gc_render(v, ft) -> str:
    """GROUP_CONCAT element rendering (MySQL text form of the value)."""
    from ..types.value import decode_date
    if ft.is_decimal:
        s = ft.scale
        u = int(v)
        if s <= 0:
            return str(u)
        sign = "-" if u < 0 else ""
        u = abs(u)
        return f"{sign}{u // 10 ** s}.{u % 10 ** s:0{s}d}"
    if ft.kind == TypeKind.DATE:
        return decode_date(int(v)).isoformat()
    if ft.is_float:
        return repr(float(v))
    return str(int(v))


def _seg_reduce(ufunc, values: np.ndarray, order: np.ndarray,
                bounds: np.ndarray) -> np.ndarray:
    if len(order) == 0:
        return np.empty(0, dtype=values.dtype if values.dtype != bool
                        else np.int64)
    return ufunc.reduceat(values[order], bounds)


def _avg_column(d: AggDesc, out_t: FieldType, sums: np.ndarray,
                cnts: np.ndarray) -> Column:
    assert d.arg is not None
    at = d.arg.ftype
    valid = cnts > 0
    if out_t.is_float:
        vals = np.where(valid, sums / np.maximum(cnts, 1), 0.0)
        return Column(out_t, vals, None if valid.all() else valid)
    # exact decimal average via host bignum per group (group count is small)
    src_scale = at.scale if at.is_decimal else 0
    out = np.zeros(len(sums), dtype=np.int64)
    for i in range(len(sums)):
        if not valid[i]:
            continue
        q = Decimal(int(sums[i]), src_scale).div(
            Decimal.from_int(int(cnts[i])))
        out[i] = q.rescale(out_t.scale).unscaled
    return Column(out_t, out, None if valid.all() else valid)


def _scalar_agg_empty_row(plan: PhysHashAgg) -> Chunk:
    cols = []
    for ai, d in enumerate(plan.aggs):
        f = plan.schema.fields[len(plan.group_by) + ai]
        if d.func in ("count", "approx_count_distinct"):
            cols.append(Column(f.ftype, np.array([0], np.int64)))
        else:
            cols.append(Column(f.ftype, np.zeros(1, f.ftype.np_dtype),
                               np.array([False])))
    return Chunk(cols)


def _complete_agg(plan: PhysHashAgg, child: Chunk) -> Chunk:
    """Host-only aggregation over an operator output chunk."""
    ev = _evaluator(child)
    n = child.num_rows
    key_vv = []
    key_dicts: list[Optional[Dictionary]] = []
    for g in plan.group_by:
        if g.ftype.is_string and not isinstance(g, Col):
            # computed string key (e.g. substring): group on fresh codes
            sv, svl = ev.eval_str(g)
            d = Dictionary()
            codes = np.fromiter(
                (d.encode(s) if ok else 0 for s, ok in zip(sv, svl)),
                np.int64, count=n)
            key_vv.append((codes, np.asarray(svl)))
            key_dicts.append(d)
        else:
            v, vl = ev.eval(g)
            v = np.asarray(v)
            d = child.columns[g.idx].dictionary \
                if g.ftype.is_string and isinstance(g, Col) else None
            if d is not None and len(d) and g.ftype.is_ci:
                # ci collation: group on canonical codes so case
                # variants merge; output shows the first-seen spelling
                v = d.ci_canonical()[np.clip(v, 0, len(d) - 1)]
            key_vv.append((v, np.asarray(vl)))
            key_dicts.append(d)
    inv, first = _group_ids(key_vv, n)
    n_seg = len(first) if n else 0
    order = np.argsort(inv[:n], kind="stable") if n else np.empty(0, np.int64)
    sorted_inv = inv[order]
    bounds = np.nonzero(np.r_[True, sorted_inv[1:] != sorted_inv[:-1]])[0] \
        if n else np.empty(0, np.int64)

    out_cols: list[Column] = []
    ngroups = len(plan.group_by)
    for gi, g in enumerate(plan.group_by):
        v, vl = key_vv[gi]
        f = plan.schema.fields[gi]
        gidx = order[bounds] if n else np.empty(0, np.int64)
        dictionary = key_dicts[gi]
        data = v[gidx]
        valid = vl[gidx]
        out_cols.append(Column(f.ftype, data.astype(f.ftype.np_dtype),
                               None if valid.all() else valid, dictionary))

    for ai, d in enumerate(plan.aggs):
        out_t = plan.schema.fields[ngroups + ai].ftype
        if d.arg is None:  # count(*)
            ones = np.ones(n, np.int64)
            cnts = _seg_reduce(np.add, ones, order, bounds)
            out_cols.append(Column(out_t, cnts))
            continue
        if d.func in ("json_arrayagg", "json_objectagg"):
            import json as _json
            from ..chunk.column import Dictionary as _Dct

            def jvals(e):
                """Per-row python JSON values for one expression."""
                if e.ftype.kind == TypeKind.JSON or e.ftype.is_string:
                    sv, svl = ev.eval_str(e)
                    if e.ftype.kind == TypeKind.JSON:
                        return [
                            _json.loads(s) if ok else None
                            for s, ok in zip(sv, svl)], np.asarray(svl)
                    return [s if ok else None
                            for s, ok in zip(sv, svl)], np.asarray(svl)
                vv, vl = ev.eval(e)
                vv = np.asarray(vv)
                out = []
                for i2 in range(n):
                    if not vl[i2]:
                        out.append(None)
                    elif e.ftype.is_decimal:
                        # exact: a float division would round >15
                        # significant digits; _RawDec embeds the exact
                        # literal at dump time
                        out.append(_RawDec(
                            "\x00RAWD:" + _gc_render(int(vv[i2]),
                                                     e.ftype)))
                    elif e.ftype.kind == TypeKind.DATE:
                        from ..types.value import decode_date
                        out.append(decode_date(int(vv[i2])).isoformat())
                    elif e.ftype.kind in (TypeKind.DATETIME,
                                          TypeKind.TIMESTAMP):
                        from ..types.value import decode_datetime
                        out.append(decode_datetime(int(vv[i2])).isoformat(
                            sep=" "))
                    elif e.ftype.is_float:
                        out.append(float(vv[i2]))
                    else:
                        out.append(int(vv[i2]))
                return out, np.asarray(vl)

            if d.func == "json_arrayagg":
                vals_py, _vl = jvals(d.arg)
                groups: list[list] = [[] for _ in range(n_seg)]
                for i2 in range(n):
                    # SQL NULLs become JSON nulls (MySQL semantics,
                    # func_json_arrayagg.go)
                    groups[inv[i2]].append(vals_py[i2])
                docs = [_raw_dumps(g2) for g2 in groups]
            else:
                keys_py, kvl = jvals(d.arg.args[0])
                vals_py, _vl = jvals(d.arg.args[1])
                objs: list[dict] = [{} for _ in range(n_seg)]
                for i2 in range(n):
                    if not kvl[i2]:
                        from ..session.session import SQLError
                        raise SQLError(
                            "JSON documents may not contain NULL member "
                            "names", errno=3158)
                    objs[inv[i2]][str(keys_py[i2])] = vals_py[i2]
                docs = [_raw_dumps(o) for o in objs]
            dct = _Dct()
            data = np.fromiter((dct.encode(s) for s in docs),
                               np.int64, count=n_seg)
            out_cols.append(Column(out_t, data, None, dct))
            continue
        av, avl = ev.eval(d.arg)
        av = np.asarray(av)
        avl = np.asarray(avl)
        if d.distinct:
            vals = _distinct_agg(d, av, avl, inv, n_seg, out_t)
            out_cols.append(vals)
            continue
        cnts = _seg_reduce(np.add, avl.astype(np.int64), order, bounds)
        if d.func == "count":
            out_cols.append(Column(out_t, cnts))
            continue
        if d.func == "approx_count_distinct":
            from ..copr.analyze import hll_group_registers_host, hll_ndv
            hsrc = _hll_hash_src(d, av, child)
            regs = hll_group_registers_host(hsrc, avl, inv, n_seg)
            vals = np.array(
                [hll_ndv(regs[i], cnts[i]) if cnts[i] else 0
                 for i in range(n_seg)], np.int64)
            out_cols.append(Column(out_t, vals))
            continue
        if d.func == "approx_percentile":
            # per-group percentile: the value at ceil(p% * n) in sort
            # order (reference: executor/aggfuncs/func_percentile.go
            # picks an element, not an interpolation)
            pct = float(d.params[0]) if d.params else 50.0
            vals = np.zeros(n_seg, av.dtype if not np.issubdtype(
                av.dtype, np.bool_) else np.int64)
            valid = np.zeros(n_seg, bool)
            srt_v = av[order]
            srt_l = avl[order]
            # rows are grouped contiguously along `order`; per-segment
            # slices keep this O(n log n) overall
            for gi2 in range(n_seg):
                lo = bounds[gi2]
                hi = bounds[gi2 + 1] if gi2 + 1 < n_seg else n
                g = np.sort(srt_v[lo:hi][srt_l[lo:hi]])
                if len(g):
                    k = max(int(np.ceil(pct / 100.0 * len(g))) - 1, 0)
                    vals[gi2] = g[k]
                    valid[gi2] = True
            out_cols.append(Column(out_t, vals.astype(out_t.np_dtype),
                                   None if valid.all() else valid))
            continue
        if d.func in ("sum", "avg"):
            if np.issubdtype(av.dtype, np.floating):
                masked = np.where(avl, av, 0.0)
            else:
                masked = np.where(avl, av.astype(np.int64), 0)
            sums = _seg_reduce(np.add, masked, order, bounds)
            if d.func == "sum":
                valid = cnts > 0
                out_cols.append(Column(out_t, sums.astype(out_t.np_dtype),
                                       None if valid.all() else valid))
            else:
                out_cols.append(_avg_column(d, out_t, sums, cnts))
            continue
        if d.func in ("min", "max"):
            is_f = np.issubdtype(av.dtype, np.floating)
            if d.func == "min":
                sentinel = np.inf if is_f else np.iinfo(np.int64).max
                fn = np.minimum
            else:
                sentinel = -np.inf if is_f else np.iinfo(np.int64).min
                fn = np.maximum
            masked = np.where(avl, av if is_f else av.astype(np.int64),
                              sentinel)
            vals = _seg_reduce(fn, masked, order, bounds)
            valid = cnts > 0
            vals = np.where(valid, vals, 0)
            dictionary = None
            if out_t.is_string and isinstance(d.arg, Col):
                dictionary = child.columns[d.arg.idx].dictionary
                if dictionary is not None and len(dictionary):
                    # min/max over dict codes is order-wrong; use ranks
                    ranks = dictionary.sort_ranks(ci=d.arg.ftype.is_ci)
                    rank_of = ranks[np.clip(av, 0, len(dictionary) - 1)]
                    masked_r = np.where(avl, rank_of.astype(np.int64),
                                        sentinel)
                    best_rank = _seg_reduce(fn, masked_r, order, bounds)
                    inv_rank = np.argsort(ranks)
                    vals = inv_rank[np.clip(best_rank, 0,
                                            len(dictionary) - 1)]
                    vals = np.where(valid, vals, 0)
            out_cols.append(Column(out_t, vals.astype(out_t.np_dtype),
                                   None if valid.all() else valid,
                                   dictionary))
            continue
        if d.func in ("std", "stddev", "stddev_pop", "stddev_samp",
                      "variance", "var_pop", "var_samp"):
            # population/sample moments (reference:
            # executor/aggfuncs/func_varpop.go): sum + sum of squares
            scale = 10.0 ** d.arg.ftype.scale if d.arg.ftype.is_decimal \
                else 1.0
            fv = np.where(avl, av.astype(np.float64) / scale, 0.0)
            sums = _seg_reduce(np.add, fv, order, bounds)
            sqs = _seg_reduce(np.add, fv * fv, order, bounds)
            mean = sums / np.maximum(cnts, 1)
            var = sqs / np.maximum(cnts, 1) - mean * mean
            var = np.maximum(var, 0.0)
            samp = d.func in ("stddev_samp", "var_samp")
            if samp:
                var = np.where(cnts > 1,
                               var * cnts / np.maximum(cnts - 1, 1), 0.0)
            if d.func in ("std", "stddev", "stddev_pop", "stddev_samp"):
                var = np.sqrt(var)
            valid = cnts > (1 if samp else 0)
            out_cols.append(Column(out_t, var,
                                   None if valid.all() else valid))
            continue
        if d.func in ("bit_and", "bit_or", "bit_xor"):
            # never NULL; empty-group identities match MySQL (reference:
            # executor/aggfuncs/func_bitfuncs.go)
            ident = -1 if d.func == "bit_and" else 0
            fn = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
                  "bit_xor": np.bitwise_xor}[d.func]
            masked = np.where(avl, av.astype(np.int64), ident)
            vals = _seg_reduce(fn, masked, order, bounds)
            out_cols.append(Column(out_t, vals.astype(np.int64)))
            continue
        if d.func == "any_value":
            gidx = order[bounds] if n else np.empty(0, np.int64)
            dictionary = child.columns[d.arg.idx].dictionary \
                if out_t.is_string and isinstance(d.arg, Col) else None
            vals = av[gidx]
            valid = avl[gidx]
            out_cols.append(Column(out_t, vals.astype(out_t.np_dtype),
                                   None if valid.all() else valid,
                                   dictionary))
            continue
        if d.func == "group_concat":
            if d.arg.ftype.is_string:
                sv, svl = ev.eval_str(d.arg)
            else:
                sv, svl = [_gc_render(x, d.arg.ftype) for x in av], avl
            dct = Dictionary()
            data = np.zeros(n_seg, np.int64)
            valid = np.zeros(n_seg, bool)
            parts: list[list[str]] = [[] for _ in range(n_seg)]
            for i in range(n):
                if svl[i]:
                    parts[inv[i]].append(str(sv[i]))
            for gi2 in range(n_seg):
                if parts[gi2]:
                    data[gi2] = dct.encode(",".join(parts[gi2]))
                    valid[gi2] = True
            out_cols.append(Column(out_t, data,
                                   None if valid.all() else valid, dct))
            continue
        raise NotImplementedError(d.func)
    if not out_cols:
        return Chunk([])
    if ngroups == 0 and (n == 0):
        return _scalar_agg_empty_row(plan)
    return Chunk(out_cols)


def _hll_hash_src(d: AggDesc, av: np.ndarray, child: Chunk) -> np.ndarray:
    """uint32 hash input per row for host-side APPROX_COUNT_DISTINCT.

    Integers in int32 range use their low 32 bits — bit-identical to the
    device sketch (copr/client.agg_partials), so the two paths agree.
    Wider ints and floats fold high bits in (plain truncation would
    collide every integral-valued double); dictionary strings hash the
    string bytes, stable across partition dictionaries."""
    import zlib
    if d.arg.ftype.is_string and isinstance(d.arg, Col):
        dct = child.columns[d.arg.idx].dictionary
        if dct is not None and len(dct):
            entry = np.array(
                [zlib.crc32(s.encode("utf-8")) for s in dct.values],
                np.uint32)
            return entry[np.clip(av.astype(np.int64), 0, len(dct) - 1)]
        return av.astype(np.int64).astype(np.uint32)
    from ..copr.analyze import float_bits_key, hll_hash_src_int
    if np.issubdtype(av.dtype, np.floating):
        bits = float_bits_key(av).view(np.uint64)
        return ((bits ^ (bits >> np.uint64(32))) &
                np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hll_hash_src_int(av)


def _distinct_agg(d: AggDesc, av, avl, inv, n_seg, out_t: FieldType) -> Column:
    is_float = np.issubdtype(av.dtype, np.floating)
    if is_float:
        # dedup on exact bit patterns (copr/analyze.float_bits_key
        # normalizes -0.0 so it equals 0.0)
        from ..copr.analyze import float_bits_key
        enc = float_bits_key(av)
    else:
        enc = av.astype(np.int64)
    enc = np.where(avl, enc, _NULL_KEY)
    pairs = np.stack([inv, enc], axis=1)[avl]
    if out_t.is_float:
        out = np.zeros(n_seg, np.float64)
    else:
        out = np.zeros(n_seg, np.int64)
    if len(pairs):
        upairs = np.unique(pairs, axis=0)
        if d.func == "count":
            segs, c = np.unique(upairs[:, 0], return_counts=True)
            out[segs] = c
        elif d.func == "sum":
            order2 = np.argsort(upairs[:, 0], kind="stable")
            sp = upairs[order2]
            b2 = np.nonzero(np.r_[True, sp[1:, 0] != sp[:-1, 0]])[0]
            vals = sp[:, 1].copy().view(np.float64) if is_float else sp[:, 1]
            sums = np.add.reduceat(vals, b2)
            out[sp[b2, 0]] = sums
        else:
            raise NotImplementedError(f"distinct {d.func}")
    return Column(out_t, out.astype(out_t.np_dtype))


# ==================== sort ====================

def _sort_key(chunk: Chunk, e: PlanExpr, desc: bool,
              ev: Optional[NumpyEval] = None) -> np.ndarray:
    """One encoded sort key: larger-encodes-later, desc folded in, NULLs
    first (MySQL NULL ordering)."""
    if ev is None:
        ev = _evaluator(chunk)
    v, vl = ev.eval(e)
    v = np.asarray(v)
    vl = np.asarray(vl)
    if e.ftype.is_string and isinstance(e, Col):
        d = chunk.columns[e.idx].dictionary
        if d is not None and len(d):
            ranks = d.sort_ranks(ci=e.ftype.is_ci)
            v = ranks[np.clip(v, 0, len(d) - 1)].astype(np.int64)
    if np.issubdtype(v.dtype, np.floating):
        key = np.where(vl, v.astype(np.float64), -np.inf)
    else:
        key = np.where(vl, v.astype(np.int64), _NULL_KEY + 1)
    return -key if desc else key


def _sort_order(chunk: Chunk, items: list[tuple[PlanExpr, bool]]) -> np.ndarray:
    ev = _evaluator(chunk)
    keys = [_sort_key(chunk, e, desc, ev)
            for e, desc in reversed(items)]  # lexsort: last key is primary
    if not keys:
        return np.arange(chunk.num_rows)
    return np.lexsort(keys)


def _spill_sort(child: Chunk, items: list[tuple[PlanExpr, bool]],
                ctx: ExecContext) -> Chunk:
    """External sample sort: range-partition on the primary key into
    on-disk buckets, sort each bucket in memory, emit in bucket order.

    Counterpart of the reference's sort spill (executor/sort.go:176 +
    row_container.go:493 SortAndSpillDiskAction) re-shaped for the
    vectorized engine: sorted runs + k-way merge become quantile
    buckets + per-bucket lexsort — same bounded working set, and the
    output equals the in-memory path bit-for-bit (equal primary keys
    land in one bucket, lexsort stability does the rest).
    """
    n = child.num_rows
    key0 = _sort_key(child, items[0][0], items[0][1])
    need = child.nbytes + n * 8 * max(1, len(items))
    parts = int(min(64, max(2, -(-need * 2 // max(ctx.mem.available(), 1)))))
    sample = key0[:: max(1, n // 4096)]
    qs = np.quantile(sample, np.linspace(0, 1, parts + 1)[1:-1])
    bucket = np.searchsorted(qs, key0, side="right")
    files = []
    for b in range(parts):
        idx = np.nonzero(bucket == b)[0]
        if len(idx):
            files.append(ctx.spill.spill(child.take(idx)))
    del child, key0, bucket
    pieces = []
    for f in files:
        part = f.read()
        ctx.mem.consume(part.nbytes)
        order = _sort_order(part, items)
        pieces.append(part.take(order))
        ctx.mem.release(part.nbytes)
    return Chunk.concat(pieces)


# ==================== join ====================

def _run_index_join(plan, ctx: ExecContext) -> Chunk:
    """Outer-driven index probe (reference: executor/index_lookup_join.go
    innerWorker buildTask): evaluate the outer child, look the keys up in
    the inner table's sorted-permutation epoch index (one vectorized
    searchsorted pass) plus the overlay, gather only matching inner rows,
    then apply the inner scan's pushed-down filters and residual ON
    conditions."""
    from ..store.index import epoch_column_order, epoch_index_order

    outer = run_physical(plan.children[0], ctx)
    inner_tr = plan.children[1]
    snap = ctx.txn.snapshot(inner_tr.table.id)
    oi, ii = plan.eq_conditions[0]
    okey = outer.columns[oi]
    keys = okey.data.astype(np.int64)
    kvalid = okey.validity

    epoch = snap.epoch
    off = plan.inner_offset
    # epoch side: the table's LAZY sorted-permutation — built once per
    # (epoch, column) and cached on the store (store/index.py), so
    # repeated probes pay only the searchsorted. NULL rows sort first;
    # the search runs over the non-NULL suffix only.
    store = ctx.txn.storage.tables[inner_tr.table.id]
    index = next((ix for ix in inner_tr.table.indices
                  if ix.visible and ix.col_offsets == [off]), None)
    li_parts = []
    pos_parts = []
    if epoch.num_rows:
        data = epoch.columns[off]
        valid = epoch.valids[off]
        if index is not None:
            order = epoch_index_order(store, epoch, index)
            start = 0 if valid is None else int(
                np.searchsorted(valid[order], True, "left"))
        else:  # PK-handle column (no named index object)
            order, start = epoch_column_order(store, epoch, off)
        order = order[start:]
        sorted_vals = data[order]
        lo = np.searchsorted(sorted_vals, keys, side="left")
        hi = np.searchsorted(sorted_vals, keys, side="right")
        counts = np.where(kvalid, hi - lo, 0)
        total = int(counts.sum())
        li = np.repeat(np.arange(outer.num_rows), counts)
        starts = np.repeat(lo, counts)
        offs = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts)
        pos = order[starts + offs]
        keep = snap.base_visible[pos]
        li_parts.append(li[keep])
        pos_parts.append(pos[keep])
    # overlay side (uncommitted / unfolded rows): small — match by scan
    n_over = len(snap.overlay_handles)
    ov_li = ov_rows = None
    if n_over:
        od = snap.overlay_columns[off].astype(np.int64)
        ovl = snap.overlay_valids[off]
        om = np.ones(n_over, bool) if ovl is None else ovl
        oorder = np.argsort(od, kind="stable")
        osorted = od[oorder]
        lo = np.searchsorted(osorted, keys, side="left")
        hi = np.searchsorted(osorted, keys, side="right")
        counts = np.where(kvalid, hi - lo, 0)
        total = int(counts.sum())
        ov_li = np.repeat(np.arange(outer.num_rows), counts)
        starts = np.repeat(lo, counts)
        offs = np.arange(total) - np.repeat(
            np.cumsum(counts) - counts, counts)
        orows = oorder[starts + offs]
        keep = om[orows]
        ov_li, ov_rows = ov_li[keep], orows[keep]

    # inner chunk in the scan's column order
    col_offsets = inner_tr.dag.scan.col_offsets
    cols = []
    for ci, coff in enumerate(col_offsets):
        parts_d, parts_v = [], []
        if pos_parts:
            d = epoch.columns[coff][pos_parts[0]]
            v = epoch.valids[coff]
            parts_d.append(d)
            parts_v.append(np.ones(len(d), bool) if v is None
                           else v[pos_parts[0]])
        if ov_rows is not None and len(ov_rows):
            d = snap.overlay_columns[coff][ov_rows]
            v = snap.overlay_valids[coff]
            parts_d.append(d)
            parts_v.append(np.ones(len(d), bool) if v is None
                           else v[ov_rows])
        ft = inner_tr.dag.output_types[ci]
        if parts_d:
            data = np.concatenate(parts_d)
            vv = np.concatenate(parts_v)
        else:
            data = np.empty(0, ft.np_dtype)
            vv = np.empty(0, bool)
        cols.append(Column(ft, data.astype(ft.np_dtype),
                           None if vv.all() else vv,
                           snap.dictionaries[coff]))
    inner = Chunk(cols)
    li = np.concatenate(li_parts + ([ov_li] if ov_li is not None
                                    and len(ov_li) else []))         if (li_parts or ov_li is not None) else np.empty(0, np.int64)
    ri = np.arange(inner.num_rows)

    # inner pushed-down filters (the scan's dag.selection)
    if inner_tr.dag.selection is not None and inner.num_rows:
        ev = _evaluator(inner)
        mask = np.ones(inner.num_rows, bool)
        for c in inner_tr.dag.selection.conditions:
            v, vl = ev.eval(_subst_subq(c, ctx))
            mask &= _truthy(np.asarray(v)) & vl
        sel = np.nonzero(mask)[0]
        inner = inner.take(sel)
        keepm = mask[ri[: len(li)]] if len(li) else mask[:0]
        li = li[keepm]
        ri = np.arange(inner.num_rows)

    if plan.other_conditions:
        joined = _merge_chunks(outer.take(li), inner)
        ev = _evaluator(joined)
        mask = np.ones(len(li), dtype=bool)
        for c in plan.other_conditions:
            v, vl = ev.eval(_subst_subq(c, ctx))
            mask &= _truthy(np.asarray(v)) & vl
        li = li[mask]
        inner = inner.take(np.nonzero(mask)[0])

    if plan.kind == "SEMI":
        return outer.take(np.unique(li))
    return _merge_chunks(outer.take(li), inner)


def _run_join(plan, ctx: ExecContext) -> Chunk:
    left = run_physical(plan.children[0], ctx)
    right = run_physical(plan.children[1], ctx)
    nleft = len(left.columns)

    if plan.kind == "ANTI_NULL":
        # null-aware NOT IN semantics (reference: planner NAAJ):
        # any NULL in the subquery side means no outer row qualifies;
        # outer rows with a NULL key never qualify.
        ri_idx = plan.eq_conditions[0][1]
        if right.num_rows and not right.columns[ri_idx].validity.all():
            return left.take(np.empty(0, np.int64))

    if not plan.eq_conditions:
        li = np.repeat(np.arange(left.num_rows), right.num_rows)
        ri = np.tile(np.arange(right.num_rows), left.num_rows)
    else:
        # key-unify working set: ~4 int64 copies per key column per row
        # (stack, concat, unique, inverse) on both sides
        est = (left.num_rows + right.num_rows) * \
            (len(plan.eq_conditions) * 8 * 4 + 16)
        if _overflow(ctx, est, "HashJoin"):
            return _grace_join(plan, left, right, ctx)
        li, ri = _equi_match(plan, left, right)

    # residual ON conditions filter matched pairs
    if plan.other_conditions:
        joined = _merge_chunks(left.take(li), right.take(ri))
        ev = _evaluator(joined)
        mask = np.ones(len(li), dtype=bool)
        for c in plan.other_conditions:
            v, vl = ev.eval(_subst_subq(c, ctx))
            mask &= _truthy(np.asarray(v)) & vl
        li, ri = li[mask], ri[mask]

    if plan.kind == "SEMI":
        return left.take(np.unique(li))
    if plan.kind in ("ANTI", "ANTI_NULL"):
        keep = np.ones(left.num_rows, dtype=bool)
        keep[li] = False
        if plan.kind == "ANTI_NULL" and right.num_rows:
            # NULL lhs vs a non-empty set is UNKNOWN -> filtered;
            # NOT IN (empty set) is TRUE even for a NULL lhs
            li_idx = plan.eq_conditions[0][0]
            keep &= left.columns[li_idx].validity
        return left.take(np.nonzero(keep)[0])
    if plan.kind == "LEFT":
        matched = np.zeros(left.num_rows, dtype=bool)
        matched[li] = True
        extra = np.nonzero(~matched)[0]
        return _merge_chunks(
            left.take(np.concatenate([li, extra])),
            _append_nulls(right.take(ri), len(extra)),
        )
    if plan.kind == "RIGHT":
        matched = np.zeros(right.num_rows, dtype=bool)
        matched[ri] = True
        extra = np.nonzero(~matched)[0]
        return _merge_chunks(
            _append_nulls(left.take(li), len(extra)),
            right.take(np.concatenate([ri, extra])),
        )
    return _merge_chunks(left.take(li), right.take(ri))


def _encode_join_keys(plan: PhysHashJoin, left: Chunk, right: Chunk):
    """Per-side comparable int64 key stacks [n, nkeys] + validity masks.

    Encodings unify the key domains across sides (dictionary remap,
    decimal rescale, float bit patterns) so equal SQL values encode to
    equal int64s; both the in-memory unify and the grace partitioner
    hash these."""
    lkeys = []
    rkeys = []
    lvalid = np.ones(left.num_rows, dtype=bool)
    rvalid = np.ones(right.num_rows, dtype=bool)
    for li_idx, ri_idx in plan.eq_conditions:
        lc = left.columns[li_idx]
        rc = right.columns[ri_idx]
        lv = lc.data
        rv = rc.data
        if lc.ftype.is_string and lc.dictionary is not None and \
                rc.dictionary is not None:
            ci = lc.ftype.is_ci or rc.ftype.is_ci
            ld = lc.dictionary
            # dictionary columns across different dicts: remap right into
            # left's (ci: casefold-equal values unify)
            if rc.dictionary is not ld:
                lookup = ld.lookup_ci if ci else ld.lookup
                remap = np.fromiter(
                    (lookup(s) for s in rc.dictionary.values),
                    dtype=np.int64, count=len(rc.dictionary))
                rv = remap[rc.data] if len(rc.dictionary) else rc.data
            if ci and len(ld):
                canon = ld.ci_canonical()
                lv = canon[np.clip(lv, 0, len(ld) - 1)]
                rv = np.where(np.asarray(rv) >= 0,
                              canon[np.clip(rv, 0, len(ld) - 1)],
                              np.asarray(rv))
        # unify key domains: if either side is float, compare both as
        # float64 bit patterns (with -0.0 normalized); otherwise align
        # decimal scales and compare as int64
        l_float = np.issubdtype(lv.dtype, np.floating)
        r_float = np.issubdtype(rv.dtype, np.floating)
        if l_float or r_float:
            def to_f(v, ft):
                f = v.astype(np.float64)
                if ft.is_decimal:
                    f = f / 10 ** ft.scale
                return np.where(f == 0, 0.0, f).view(np.int64)
            lv = to_f(lv, lc.ftype)
            rv = to_f(rv, rc.ftype)
        else:
            ls = lc.ftype.scale if lc.ftype.is_decimal else 0
            rs = rc.ftype.scale if rc.ftype.is_decimal else 0
            lv = lv.astype(np.int64)
            rv = rv.astype(np.int64)
            if ls < rs:
                lv = lv * 10 ** (rs - ls)
            elif rs < ls:
                rv = rv * 10 ** (ls - rs)
        lkeys.append(lv)
        rkeys.append(rv)
        lvalid &= lc.validity
        rvalid &= rc.validity
    return (np.stack(lkeys, axis=1), np.stack(rkeys, axis=1),
            lvalid, rvalid)


def _equi_match(plan, left: Chunk, right: Chunk):
    """Vectorized equi-join: sort-merge expand over unified key ids.

    Single-column keys skip the np.unique id-unification entirely (the
    encoded int64 values are directly comparable — this is the sort-merge
    join inner loop, reference: executor/merge_join.go); multi-column
    keys unify via unique-row ids first."""
    lstack, rstack, lvalid, rvalid = _encode_join_keys(plan, left, right)
    if lstack.shape[1] == 1:
        # NULL rows are excluded from the domains outright — no sentinel
        # values that a real key could collide with
        lids = lstack[:, 0]
        rvalid_idx = np.nonzero(rvalid)[0]
        rvals = rstack[rvalid_idx, 0]
        ro = np.argsort(rvals, kind="stable")
        rorder = rvalid_idx[ro]
        rsorted = rvals[ro]
        null_gate = lvalid
    else:
        all_keys = np.concatenate([lstack, rstack], axis=0)
        _, inv = np.unique(all_keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        lids = np.where(lvalid, inv[: left.num_rows], -1)
        rids = np.where(rvalid, inv[left.num_rows:], -2)
        null_gate = lids >= 0
        rorder = np.argsort(rids, kind="stable")
        rsorted = rids[rorder]
    lo = np.searchsorted(rsorted, lids, side="left")
    hi = np.searchsorted(rsorted, lids, side="right")
    counts = np.where(null_gate, hi - lo, 0)
    total = int(counts.sum())
    li = np.repeat(np.arange(left.num_rows), counts)
    starts = np.repeat(lo, counts)
    offsets = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    ri = rorder[starts + offsets]
    return li, ri


def _key_hash(stack: np.ndarray) -> np.ndarray:
    """FNV-1a-style mix of an [n, k] int64 key stack to uint64."""
    h = np.full(stack.shape[0], 14695981039346656037, np.uint64)
    for j in range(stack.shape[1]):
        h = (h ^ stack[:, j].astype(np.uint64)) * np.uint64(1099511628211)
    return h


def _grace_join(plan: PhysHashJoin, left: Chunk, right: Chunk,
                ctx: ExecContext) -> Chunk:
    """Partitioned (grace) hash join: hash both sides by join key into
    on-disk partitions, free the inputs, join partition pairs one at a
    time, then restore the in-memory path's row order from the global
    row indices carried with each partition.

    Counterpart of the reference's spilling hash join
    (executor/join.go + util/chunk/row_container.go:63); partition
    co-location is sound because matching pairs encode to equal int64
    keys (see _encode_join_keys) and therefore equal hashes.
    """
    lstack, rstack, lvalid, rvalid = _encode_join_keys(plan, left, right)
    need = (lstack.nbytes + rstack.nbytes) * 4
    parts = int(min(64, max(2, -(-need * 2 // max(ctx.mem.available(), 1)))))
    lh = (_key_hash(lstack) % np.uint64(parts)).astype(np.int64)
    rh = (_key_hash(rstack) % np.uint64(parts)).astype(np.int64)
    del lstack, rstack, lvalid, rvalid
    part_files = []
    for p in range(parts):
        lidx = np.nonzero(lh == p)[0]
        ridx = np.nonzero(rh == p)[0]
        if not len(lidx) and not len(ridx):
            continue  # nothing to join or null-fill from this partition
        part_files.append((lidx, ctx.spill.spill(left.take(lidx)),
                           ridx, ctx.spill.spill(right.take(ridx))))
    n_right_total = right.num_rows
    del left, right, lh, rh

    matched: list[tuple[np.ndarray, np.ndarray, Chunk]] = []
    extras: list[tuple[np.ndarray, Chunk]] = []  # LEFT/RIGHT outer fill
    plains: list[tuple[np.ndarray, Chunk]] = []  # SEMI/ANTI left rows
    for lidx, lf, ridx, rf in part_files:
        lpart = lf.read()
        rpart = rf.read()
        ctx.mem.consume(lpart.nbytes + rpart.nbytes)
        li, ri = _equi_match(plan, lpart, rpart)
        if plan.other_conditions:
            joined = _merge_chunks(lpart.take(li), rpart.take(ri))
            ev = _evaluator(joined)
            mask = np.ones(len(li), dtype=bool)
            for c in plan.other_conditions:
                v, vl = ev.eval(_subst_subq(c, ctx))
                mask &= _truthy(np.asarray(v)) & vl
            li, ri = li[mask], ri[mask]
        if plan.kind == "SEMI":
            ul = np.unique(li)
            plains.append((lidx[ul], lpart.take(ul)))
        elif plan.kind in ("ANTI", "ANTI_NULL"):
            keep = np.ones(lpart.num_rows, dtype=bool)
            keep[li] = False
            if plan.kind == "ANTI_NULL" and n_right_total:
                keep &= lpart.columns[plan.eq_conditions[0][0]].validity
            kidx = np.nonzero(keep)[0]
            plains.append((lidx[kidx], lpart.take(kidx)))
        elif plan.kind == "LEFT":
            matched.append((lidx[li], ridx[ri],
                            _merge_chunks(lpart.take(li), rpart.take(ri))))
            um = np.zeros(lpart.num_rows, dtype=bool)
            um[li] = True
            extra = np.nonzero(~um)[0]
            extras.append((lidx[extra], _merge_chunks(
                lpart.take(extra),
                _append_nulls(rpart.take(np.empty(0, np.int64)),
                              len(extra)))))
        elif plan.kind == "RIGHT":
            matched.append((lidx[li], ridx[ri],
                            _merge_chunks(lpart.take(li), rpart.take(ri))))
            um = np.zeros(rpart.num_rows, dtype=bool)
            um[ri] = True
            extra = np.nonzero(~um)[0]
            extras.append((ridx[extra], _merge_chunks(
                _append_nulls(lpart.take(np.empty(0, np.int64)),
                              len(extra)),
                rpart.take(extra))))
        else:  # INNER
            matched.append((lidx[li], ridx[ri],
                            _merge_chunks(lpart.take(li), rpart.take(ri))))
        ctx.mem.release(lpart.nbytes + rpart.nbytes)

    if plan.kind in ("SEMI", "ANTI", "ANTI_NULL"):
        gli = np.concatenate([g for g, _ in plains])
        out = Chunk.concat([c for _, c in plains])
        return out.take(np.argsort(gli, kind="stable"))
    gli = np.concatenate([g for g, _, _ in matched])
    gri = np.concatenate([r for _, r, _ in matched])
    out = Chunk.concat([c for _, _, c in matched])
    out = out.take(np.lexsort((gri, gli)))
    if plan.kind in ("LEFT", "RIGHT"):
        gex = np.concatenate([g for g, _ in extras])
        ex = Chunk.concat([c for _, c in extras])
        ex = ex.take(np.argsort(gex, kind="stable"))
        return Chunk.concat([out, ex])
    return out


def _merge_chunks(a: Chunk, b: Chunk) -> Chunk:
    return Chunk(a.columns + b.columns)


def _append_nulls(side: Chunk, n_null: int) -> Chunk:
    """side's rows followed by n_null NULL-extended rows (outer join fill)."""
    cols = []
    for c in side.columns:
        data = np.concatenate([c.data, np.zeros(n_null, c.data.dtype)])
        valid = np.concatenate([c.validity, np.zeros(n_null, bool)])
        cols.append(Column(c.ftype, data, valid, c.dictionary))
    return Chunk(cols)


__all__ = ["ExecContext", "run_physical"]
