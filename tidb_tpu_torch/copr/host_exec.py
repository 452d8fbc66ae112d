"""Host (numpy) execution of CopDAGs — the coprocessor's host tier.

Port of `tidb_tpu/copr/host_exec.py`. The reference serves a request here
when a device gate rejects it (`host(<reason>)`: high-cardinality group
keys, string ordering compares, wide sums, multi-key TopN outside the
packable set) and for index-ranged scans (`ranged`), whose gathered
subset is small. Both are host work in the reference by design, so a
CUDA client runs them on the host too, and the engine tag says so.

Produces the device path's layouts (partial-agg layout or row layout), so
the executor above never knows which tier answered.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..chunk.chunk import Chunk
from ..chunk.column import Column, Dictionary
from ..plan.dag import CopDAG, agg_partial_starts
from ..plan.expr import Col, PlanExpr
from ..store.table_store import TableSnapshot
from ..types.field_type import FieldType, TypeKind
from .npeval import VV, NumpyEval, _truthy


def execute_host(dag: CopDAG, snap: TableSnapshot, reason: str):
    """The whole visible table (base rows, then overlay rows) through the
    DAG on the host. `reason` is the device gate's; the caller tags the
    result with it."""
    from .client import CopResult

    return CopResult(_HostEval(dag, snap).run(),
                     is_partial_agg=dag.agg is not None)


def execute_ranged(dag: CopDAG, snap: TableSnapshot):
    """Index-ranged scan: resolve handles via the index permutation, gather
    only the matching rows, run the DAG over the subset."""
    from ..store.index import probe_and_gather
    from .client import CopResult

    handles, cols = probe_and_gather(snap, dag.scan.ranges,
                                     dag.scan.col_offsets)
    ev = _HostEval(dag, snap, cols=cols, n=len(handles))
    return CopResult(ev.run(), is_partial_agg=dag.agg is not None)


def _hll_partial_columns(av: np.ndarray, avl: np.ndarray,
                         inv: np.ndarray, n_seg: int) -> list[Column]:
    """HLL_WORDS byte-packed register word columns for one
    approx_count_distinct aggregate (plan/dag.agg_partial_width layout),
    hash-identical to the device sketch for int32-range values; wider
    int64 values fold their high bits (the device gate rejects those)."""
    from .analyze import (hll_group_registers_host, hll_hash_src_int,
                          hll_pack_words)
    regs = hll_group_registers_host(hll_hash_src_int(av), avl, inv, n_seg)
    words = hll_pack_words(regs)
    return [Column(FieldType(TypeKind.BIGINT, nullable=False),
                   words[:, w].copy())
            for w in range(words.shape[1])]


class _HostEval(NumpyEval):
    def __init__(self, dag: CopDAG, snap: TableSnapshot,
                 cols: Optional[list[VV]] = None,
                 n: Optional[int] = None) -> None:
        self.dag = dag
        self.snap = snap
        dicts: list[Optional[Dictionary]] = [
            snap.dictionaries[off] for off in dag.scan.col_offsets
        ]
        if cols is None:
            cols = []
            for off in dag.scan.col_offsets:
                col = snap.column(off)
                cols.append((col.data, col.validity))
        if n is None:
            n = cols[0][0].shape[0] if cols else snap.num_visible_rows
        super().__init__(cols, dicts, n)

    # ---- entry -------------------------------------------------------------
    def run(self) -> list[Chunk]:
        mask = np.ones(self.n, dtype=bool)
        if self.dag.selection is not None:
            for c in self.dag.selection.conditions:
                v, vl = self.eval(c)
                mask &= _truthy(v) & vl
        if self.dag.agg is not None:
            return self._agg(mask)
        if self.dag.topn is not None:
            return self._topn(mask)
        idx = np.nonzero(mask)[0]
        if self.dag.limit is not None:
            idx = idx[: self.dag.limit.n]
        return self._rows(idx)

    # ---- row output --------------------------------------------------------
    def _rows(self, idx: np.ndarray) -> list[Chunk]:
        columns = []
        if self.dag.projections is not None:
            for pi, e in enumerate(self.dag.projections):
                v, vl = self.eval(e)
                ft = self.dag.output_types[pi]
                columns.append(Column(
                    ft, np.asarray(v)[idx].astype(ft.np_dtype),
                    None if vl[idx].all() else vl[idx], self._proj_dict(e)))
        else:
            for ci, off in enumerate(self.dag.scan.col_offsets):
                data, vl = self.cols[ci]
                ft = self.dag.output_types[ci]
                columns.append(Column(
                    ft, data[idx], None if vl[idx].all() else vl[idx],
                    self.snap.dictionaries[off]))
        if not columns:
            return []
        return [Chunk(columns)]

    def _proj_dict(self, e: PlanExpr) -> Optional[Dictionary]:
        if isinstance(e, Col) and e.ftype.is_string:
            return self.dicts[e.idx]
        return None

    # ---- TopN --------------------------------------------------------------
    def _topn(self, mask: np.ndarray) -> list[Chunk]:
        from .client import _subst_proj_cols

        keys = []
        for e, desc in reversed(self.dag.topn.items):  # lexsort: last primary
            if self.dag.projections is not None:
                # sort items index the projection's output schema
                e = _subst_proj_cols(e, self.dag.projections)
            v, vl = self.eval(e)
            if e.ftype.is_string:
                d = self.dicts[e.idx] if isinstance(e, Col) else None
                if d is not None and len(d):
                    ranks = d.sort_ranks()
                    v = ranks[np.clip(v, 0, len(d) - 1)].astype(np.int64)
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                key = np.where(vl, v, -np.inf)  # NULLs first (asc)
            else:
                key = np.where(vl, v.astype(np.int64),
                               np.iinfo(np.int64).min + 1)
            if desc:
                key = -key
            keys.append(key)
        order = np.lexsort(keys) if keys else np.arange(self.n)
        order = order[mask[order]]
        return self._rows(order[: self.dag.topn.n])

    # ---- aggregation (partial layout) --------------------------------------
    def _agg(self, mask: np.ndarray) -> list[Chunk]:
        agg = self.dag.agg
        idx = np.nonzero(mask)[0]
        ngroups_cols = len(agg.group_by)
        key_vals: list[VV] = []
        if ngroups_cols == 0:
            inv = np.zeros(len(idx), dtype=np.int64)
            n_seg = 1
        else:
            key_cols = []
            for g in agg.group_by:
                v, vl = self.eval(g)
                v = np.asarray(v)[idx]
                vl = np.asarray(vl)[idx]
                key_vals.append((v, vl))
                if np.issubdtype(v.dtype, np.floating):
                    enc = v.view(np.int64)
                else:
                    enc = v.astype(np.int64)
                key_cols.append(np.where(vl, enc, np.iinfo(np.int64).min))
            inv, n_seg = _group_ids(key_cols)
        if len(idx) == 0:
            return []

        # a stable sort of few groups' ids sorts them narrow (radix sort)
        narrow = inv.astype(np.int16) if n_seg <= 2**15 else inv
        order = np.argsort(narrow, kind="stable")
        sorted_inv = inv[order]
        boundaries = np.nonzero(
            np.r_[True, sorted_inv[1:] != sorted_inv[:-1]])[0]

        def seg_sum(values: np.ndarray) -> np.ndarray:
            return np.add.reduceat(values[order], boundaries)

        def seg_min(values: np.ndarray) -> np.ndarray:
            return np.minimum.reduceat(values[order], boundaries)

        def seg_max(values: np.ndarray) -> np.ndarray:
            return np.maximum.reduceat(values[order], boundaries)

        columns: list[Column] = []
        for gi, g in enumerate(agg.group_by):
            v, vl = key_vals[gi]
            gfirst = v[order][boundaries]
            gvalid = vl[order][boundaries]
            columns.append(Column(
                g.ftype, gfirst.astype(g.ftype.np_dtype),
                None if gvalid.all() else gvalid, self._proj_dict(g)))
        rows_per_seg = seg_sum(np.ones(len(idx), np.int64))
        starts = agg_partial_starts(agg.aggs, ngroups_cols)
        for ai, d in enumerate(agg.aggs):
            val_t = self.dag.output_types[starts[ai]]
            if d.func == "approx_count_distinct":
                av, avl = self.eval(d.arg)
                av = np.asarray(av)[idx]
                avl = np.asarray(avl)[idx]
                cnt = seg_sum(avl.astype(np.int64))
                columns.extend(_hll_partial_columns(av, avl, inv, n_seg))
                columns.append(Column(
                    FieldType(TypeKind.BIGINT, nullable=False), cnt))
                continue
            if d.arg is None:
                cnt = rows_per_seg
                columns.append(Column(val_t, cnt.astype(val_t.np_dtype)))
                columns.append(Column(
                    FieldType(TypeKind.BIGINT, nullable=False), cnt))
                continue
            av, avl = self.eval(d.arg)
            av = np.asarray(av)[idx]
            avl = np.asarray(avl)[idx]
            cnt = seg_sum(avl.astype(np.int64))
            is_f = np.issubdtype(av.dtype, np.floating)
            if d.func in ("sum", "avg", "count"):
                vv = np.where(avl, av, 0.0) if is_f else \
                    np.where(avl, av.astype(np.int64), 0)
                val = cnt if d.func == "count" else seg_sum(vv)
            elif d.func == "min":
                big = np.inf if is_f else np.iinfo(np.int64).max
                val = seg_min(np.where(
                    avl, av if is_f else av.astype(np.int64), big))
                val = np.where(cnt > 0, val, 0)
            elif d.func == "max":
                small = -np.inf if is_f else np.iinfo(np.int64).min
                val = seg_max(np.where(
                    avl, av if is_f else av.astype(np.int64), small))
                val = np.where(cnt > 0, val, 0)
            else:
                raise NotImplementedError(d.func)
            columns.append(Column(val_t, val.astype(val_t.np_dtype),
                                  None if (cnt > 0).all() else cnt > 0))
            columns.append(Column(
                FieldType(TypeKind.BIGINT, nullable=False), cnt))
        return [Chunk(columns)]


def _group_ids(key_cols: list[np.ndarray]) -> tuple[np.ndarray, int]:
    """Group id per row of the int64 key columns: ids number the distinct
    key tuples in lexicographic order, as `np.unique(axis=0,
    return_inverse=True)` numbers them (and as the reference does). Each
    column is ranked on its own, and the ranks fold into one int64 code
    while their product fits; the codes' order is the tuples' order, so
    ranking the codes gives the same ids as the row-wise unique, without
    its sort of structured rows."""
    code = None
    span = 1
    for kc in key_cols:
        rank, card = _dense_rank(kc)
        if code is None:
            code, span = rank, card
            continue
        if span * card >= 2**62:
            # the next column would overflow the code: renumber the tuples
            # so far densely, then fold on
            code, span = _dense_rank(code)
        code, span = code * card + rank, span * card
    return _dense_rank(code)


def _dense_rank(v: np.ndarray) -> tuple[np.ndarray, int]:
    """`np.unique(v, return_inverse=True)`'s inverse (the rank of each value
    among the distinct values) and the number of distinct values. A narrow
    value range ranks through a lookup table in one pass."""
    if len(v) == 0:
        return np.zeros(0, np.int64), 0
    lo, hi = int(v.min()), int(v.max())
    if hi - lo < 4 * len(v) + 1024:
        present = np.zeros(hi - lo + 1, dtype=bool)
        present[v - lo] = True
        table = np.cumsum(present) - 1
        return table[v - lo], int(table[-1]) + 1
    uniq, inv = np.unique(v, return_inverse=True)
    return inv.reshape(-1).astype(np.int64), len(uniq)
