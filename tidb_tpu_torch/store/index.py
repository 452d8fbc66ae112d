"""Secondary-index runtime over columnar epochs.

Port of `tidb_tpu/store/index.py`. An index is a *sorted permutation* of
the immutable column epoch: computed lazily per (epoch, index) with
np.lexsort, cached on the TableStore, and binary-searched with
np.searchsorted for point lookups. Snapshot overlay rows are searched
linearly — they are small by construction (compaction folds them into the
epoch).

String key columns are dictionary-encoded and codes are NOT
collation-ordered, so string index columns support equality points only.
NULL semantics follow MySQL: NULLs sort first inside the permutation (so
the valid region is a suffix), equality points and intervals never match
NULL.

What differs: the first index column in sorted order (and its validity)
is cached beside the permutation, so a request of many points (or an
interval) binary-searches it instead of gathering the whole column
through the permutation once per point. The handles found are the same.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..catalog.schema import IndexInfo
from .table_store import TableSnapshot, TableStore

_CACHE_CAP = 32


def _cache_put(store: TableStore, key, value) -> None:
    """Bounded: drop entries for epochs other than the live one (old
    entries belong to snapshots that will release soon)."""
    cache = store._index_orders
    if len(cache) >= _CACHE_CAP:
        live = store.epoch.epoch_id
        for k in list(cache):
            if k[0] != live and k != key:
                del cache[k]
    cache[key] = value


def epoch_index_order(store: TableStore, epoch, index: IndexInfo
                      ) -> np.ndarray:
    """Sorted permutation of `epoch` (the one a snapshot pinned — not
    necessarily the store's live epoch) for `index`.

    Sort key: (valid0, data0, valid1, data1, ...) with NULLs (valid=False)
    first within each column level. Cached per (epoch_id, index_id).
    """
    key = (epoch.epoch_id, index.id)
    order = store._index_orders.get(key)
    if order is not None:
        return order
    # np.lexsort: LAST key is the primary sort key
    keys: list[np.ndarray] = []
    for off in reversed(index.col_offsets):
        keys.append(epoch.columns[off])
        valid = epoch.valids[off]
        if valid is not None:
            keys.append(valid)
    order = np.lexsort(keys) if keys else np.arange(epoch.num_rows)
    _cache_put(store, key, order)
    return order


def _sorted_first(store: TableStore, epoch, index: IndexInfo,
                  order: np.ndarray):
    """(data, valid or None) of the first index column in index order,
    cached beside the permutation."""
    key = (epoch.epoch_id, index.id, "first")
    hit = store._index_orders.get(key)
    if hit is None:
        off = index.col_offsets[0]
        valid = epoch.valids[off]
        hit = (epoch.columns[off][order],
               None if valid is None else valid[order])
        _cache_put(store, key, hit)
    return hit


def epoch_column_order(store: TableStore, epoch, off: int
                       ) -> tuple[np.ndarray, int]:
    """(sorted permutation, start) for a single column: NULL rows sort
    first, `start` is the index of the first non-NULL position, so
    data[order[start:]] is monotone. Cached per (epoch, column) beside
    the index orders (same eviction policy)."""
    key = (epoch.epoch_id, ("col", off))
    hit = store._index_orders.get(key)
    if hit is not None:
        return hit
    data = epoch.columns[off]
    valid = epoch.valids[off]
    if valid is None:
        order = np.argsort(data, kind="stable")
        start = 0
    else:
        order = np.lexsort((data, valid))
        start = int(np.searchsorted(valid[order], True, "left"))
    _cache_put(store, key, (order, start))
    return order, start


def probe_and_gather(snap: TableSnapshot, ranges, col_offsets: list[int]):
    """Resolve a ScanRanges' point set (or interval) to visible handles and
    gather those rows' columns — the core of the coprocessor's ranged path.
    Returns (handles, [(data, valid), ...])."""
    searcher = IndexSearcher(snap.store, snap, ranges.index)
    if ranges.interval is not None:
        lo, hi, li, hi_i = ranges.interval
        handles = np.unique(searcher.range(lo, hi, li, hi_i))
    else:
        found = [searcher.eq(p) for p in ranges.points]
        handles = (np.unique(np.concatenate(found)) if found
                   else np.empty(0, dtype=np.int64))
    return handles, snap.gather(handles, col_offsets)


class IndexSearcher:
    """Point/prefix lookups for one index over one snapshot."""

    def __init__(self, store: TableStore, snap: TableSnapshot,
                 index: IndexInfo) -> None:
        self.store = store
        self.snap = snap
        self.index = index
        self._order: Optional[np.ndarray] = None

    def _sorted(self):
        """(order, first column's data, its validity) in index order."""
        epoch = self.snap.epoch
        if self._order is None:
            self._order = epoch_index_order(self.store, epoch, self.index)
        data, valid = _sorted_first(self.store, epoch, self.index,
                                    self._order)
        return self._order, data, valid

    def _encode_key(self, values: tuple) -> Optional[list]:
        """Cast host key values into the physical column domain; None if the
        key can never match (absent dictionary string)."""
        out = []
        for v, off in zip(values, self.index.col_offsets):
            ft = self.snap.table.columns[off].ftype
            if ft.is_string:
                d = self.snap.dictionaries[off]
                code = d.lookup(v) if isinstance(v, str) else int(v)
                if code < 0:
                    return None
                out.append(code)
            else:
                out.append(v)
        return out

    def eq(self, values: tuple) -> np.ndarray:
        """Handles of visible rows whose index prefix equals `values`.

        Any None in values returns empty (SQL equality with NULL is never
        true). len(values) may be a prefix of the index columns.
        """
        if any(v is None for v in values):
            return np.empty(0, dtype=np.int64)
        key = self._encode_key(values)
        epoch = self.snap.epoch
        base = np.empty(0, dtype=np.int64)
        if key is not None and epoch.num_rows:
            order, first, first_valid = self._sorted()
            lo, hi = 0, len(order)
            for level, (v, off) in enumerate(zip(key,
                                                 self.index.col_offsets)):
                # this level's data and validity over positions lo..hi
                if level == 0:
                    sub = first[lo:hi]
                    sub_v = None if first_valid is None \
                        else first_valid[lo:hi]
                else:
                    rows = order[lo:hi]
                    valid = epoch.valids[off]
                    sub = epoch.columns[off][rows]
                    sub_v = None if valid is None else valid[rows]
                if sub_v is not None:
                    # valid region is the True-suffix at this level
                    skip = int(np.searchsorted(sub_v, True, "left"))
                    lo += skip
                    sub = sub[skip:]
                l = lo + int(np.searchsorted(sub, v, "left"))
                r = lo + int(np.searchsorted(sub, v, "right"))
                lo, hi = l, r
                if lo >= hi:
                    break
            if lo < hi:
                pos = order[lo:hi]
                pos = pos[self.snap.base_visible[pos]]
                base = epoch.handles[pos]
        return np.concatenate([base, self._overlay_eq(values)])

    def range(self, lo, hi, lo_incl: bool, hi_incl: bool) -> np.ndarray:
        """Handles of visible rows whose FIRST index column lies in the
        interval (numeric/temporal only — dictionary codes are unordered).
        None bounds are unbounded; NULLs never match (MySQL comparison)."""
        epoch = self.snap.epoch
        off = self.index.col_offsets[0]
        base = np.empty(0, dtype=np.int64)
        if epoch.num_rows:
            order, first, first_valid = self._sorted()
            lo_pos = 0
            if first_valid is not None:
                lo_pos = int(np.searchsorted(first_valid, True, "left"))
            sub = first[lo_pos:]
            l, r = 0, len(sub)
            if lo is not None:
                l = int(np.searchsorted(sub, lo,
                                        "left" if lo_incl else "right"))
            if hi is not None:
                r = int(np.searchsorted(sub, hi,
                                        "right" if hi_incl else "left"))
            if l < r:
                pos = order[lo_pos + l:lo_pos + r]
                pos = pos[self.snap.base_visible[pos]]
                base = epoch.handles[pos]
        snap = self.snap
        m = len(snap.overlay_handles)
        if m == 0:
            return base
        data = snap.overlay_columns[off]
        mask = np.ones(m, dtype=bool)
        ovv = snap.overlay_valids[off]
        if ovv is not None:
            mask &= ovv
        if lo is not None:
            mask &= (data >= lo) if lo_incl else (data > lo)
        if hi is not None:
            mask &= (data <= hi) if hi_incl else (data < hi)
        return np.concatenate([base, snap.overlay_handles[mask]])

    def _overlay_eq(self, values: tuple) -> np.ndarray:
        snap = self.snap
        m = len(snap.overlay_handles)
        if m == 0:
            return np.empty(0, dtype=np.int64)
        key = self._encode_key(values)
        if key is None:
            return np.empty(0, dtype=np.int64)
        mask = np.ones(m, dtype=bool)
        for v, off in zip(key, self.index.col_offsets):
            data = snap.overlay_columns[off]
            valid = snap.overlay_valids[off]
            mask &= data == data.dtype.type(v)
            if valid is not None:
                mask &= valid
        return snap.overlay_handles[mask]
