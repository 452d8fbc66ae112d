"""Columnar table storage: one immutable base epoch per table.

The read side of the reference's MVCC store (`tidb_tpu/store/table_store.py`):
a `ColumnEpoch` of flat column arrays, and a `TableSnapshot` over it with a
visibility mask and an overlay of rows committed (or buffered) after the
epoch, which the coprocessor runs as a second batch. Deltas, compaction and
the KV layer are a later slice: `TableStore.snapshot` gives every base row
and no overlay, and a snapshot with overlay rows is built by its caller
(one converted from the reference, or `bench/tpch_requests.py`'s
`overlay_snapshot`). The store keeps the index sort orders
(`store/index.py`) of its epochs.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..catalog.schema import TableInfo
from ..chunk.column import Column, Dictionary, EnumDictionary
from ..types.field_type import TypeKind

_epoch_ids = itertools.count(1)


def _column_dictionary(ftype) -> Optional[Dictionary]:
    """Dictionary for string-physical columns; ENUM gets the fixed
    definition-ordered validating dictionary."""
    if ftype.kind == TypeKind.ENUM:
        return EnumDictionary(ftype.elems)
    return Dictionary() if ftype.is_string else None


class HandleIndex:
    """handle -> row-position map over an epoch's handle array, built at
    the first lookup: contiguous handles (the bulk-load shape) answer with
    arithmetic, anything else argsorts once and binary-searches."""

    __slots__ = ("_handles", "_mode", "_base", "_sorted", "_order")

    def __init__(self, handles: np.ndarray) -> None:
        self._handles = handles
        self._mode: Optional[str] = None

    def _resolve(self) -> None:
        h = self._handles
        n = len(h)
        if n == 0:
            self._mode = "empty"
            return
        base = int(h[0])
        if int(h[-1]) - base == n - 1 and bool(
                (h == np.arange(base, base + n, dtype=np.int64)).all()):
            self._base = base
            self._mode = "contig"
            return
        self._order = np.argsort(h, kind="stable")
        self._sorted = h[self._order]
        self._mode = "sorted"

    def get(self, handle: int, default=None):
        """Row position of one handle, or `default`."""
        if self._mode is None:
            self._resolve()
        if self._mode == "empty":
            return default
        if self._mode == "contig":
            i = handle - self._base
            return int(i) if 0 <= i < len(self._handles) else default
        j = int(np.searchsorted(self._sorted, handle))
        if j < len(self._sorted) and int(self._sorted[j]) == handle:
            return int(self._order[j])
        return default

    def positions(self, handles: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
        """-> (row position per handle, found): positions where not found
        are 0."""
        if self._mode is None:
            self._resolve()
        handles = np.asarray(handles, dtype=np.int64)
        if self._mode == "empty":
            return (np.zeros(len(handles), np.int64),
                    np.zeros(len(handles), bool))
        if self._mode == "contig":
            pos = handles - self._base
            found = (pos >= 0) & (pos < len(self._handles))
        else:
            j = np.searchsorted(self._sorted, handles)
            jc = np.minimum(j, len(self._sorted) - 1)
            found = self._sorted[jc] == handles
            pos = self._order[jc]
        return np.where(found, pos, 0), found


@dataclass
class ColumnEpoch:
    """Immutable columnar snapshot of all rows folded up to fold_ts."""

    epoch_id: int
    fold_ts: int
    handles: np.ndarray  # int64[n]
    columns: list[np.ndarray]  # physical data per table column
    valids: list[Optional[np.ndarray]]  # None = all valid
    # handle -> row position; built lazily from handles
    handle_pos: Optional[HandleIndex] = None

    def __post_init__(self) -> None:
        if not isinstance(self.handle_pos, HandleIndex):
            self.handle_pos = HandleIndex(self.handles)

    @property
    def num_rows(self) -> int:
        return len(self.handles)


@dataclass
class TableSnapshot:
    """A point-in-time readable view: device-friendly base + host overlay."""

    table: TableInfo
    dictionaries: list[Optional[Dictionary]]
    epoch: ColumnEpoch
    # False where a base row is overridden/deleted at this snapshot's ts
    base_visible: np.ndarray  # bool[epoch.num_rows]
    overlay_handles: np.ndarray  # int64[m] rows added/updated after fold_ts
    overlay_columns: list[np.ndarray]
    overlay_valids: list[Optional[np.ndarray]]
    # backref for index lookups (the epoch sort-order cache lives on the
    # store)
    store: Any = field(default=None, repr=False)

    @property
    def num_visible_rows(self) -> int:
        return int(self.base_visible.sum()) + len(self.overlay_handles)

    def has_handle(self, handle: int) -> bool:
        """True if a live row with this handle is visible at the snapshot
        (the point-get path's membership test)."""
        if len(self.overlay_handles) and bool(
                (self.overlay_handles == handle).any()):
            return True
        pos = self.epoch.handle_pos.get(handle)
        return pos is not None and bool(self.base_visible[pos])

    def gather(self, handles: np.ndarray, offsets: list[int]):
        """Rows for the given (visible) handles as per-offset (data, valid)
        arrays, in handle-argument order; an overlay row shadows its base
        row. The index-lookup read path: O(k), never materializes the
        table."""
        handles = np.asarray(handles, dtype=np.int64)
        k = len(handles)
        oh = self.overlay_handles
        from_overlay = np.zeros(k, dtype=bool)
        ov_rows = np.zeros(k, dtype=np.int64)
        if len(oh) and k:
            order = np.argsort(oh, kind="stable")
            j = np.minimum(np.searchsorted(oh[order], handles), len(oh) - 1)
            from_overlay = oh[order][j] == handles
            ov_rows = np.where(from_overlay, order[j], 0)
        base_rows, found = self.epoch.handle_pos.positions(handles)
        base_rows = np.where(from_overlay, 0, base_rows)
        bad = ~from_overlay & ~(found & self.base_visible[base_rows]
                                if self.epoch.num_rows else found)
        if bad.any():
            raise ValueError(
                f"gather of non-visible handle {int(handles[bad][0])}")
        out = []
        for off in offsets:
            dt = self.table.columns[off].ftype.np_dtype
            if self.epoch.num_rows:
                data = self.epoch.columns[off][base_rows].astype(dt, copy=True)
            else:
                data = np.zeros(k, dtype=dt)
            valid = np.ones(k, dtype=bool)
            bv = self.epoch.valids[off]
            if bv is not None and self.epoch.num_rows:
                valid &= bv[base_rows] | from_overlay
            if from_overlay.any():
                data[from_overlay] = self.overlay_columns[off][
                    ov_rows[from_overlay]]
                ovv = self.overlay_valids[off]
                if ovv is not None:
                    valid[from_overlay] = ovv[ov_rows[from_overlay]]
            out.append((data, valid))
        return out

    def column(self, offset: int) -> Column:
        """One full visible column: the visible base rows, then the
        overlay rows (the host interpreter's input). Where every base row
        is visible and there is no overlay, the epoch's own (immutable)
        arrays."""
        ft = self.table.columns[offset].ftype
        if self.visible_digest == "all" and not len(self.overlay_handles):
            return Column(ft, self.epoch.columns[offset],
                          self.epoch.valids[offset],
                          self.dictionaries[offset])
        base_data = self.epoch.columns[offset][self.base_visible]
        base_valid = self.epoch.valids[offset]
        if base_valid is not None:
            base_valid = base_valid[self.base_visible]
        data = np.concatenate([base_data, self.overlay_columns[offset]])
        ov_valid = self.overlay_valids[offset]
        if base_valid is None and ov_valid is None:
            valid = None
        else:
            bv = base_valid if base_valid is not None \
                else np.ones(len(base_data), bool)
            ov = ov_valid if ov_valid is not None else np.ones(
                len(self.overlay_columns[offset]), bool)
            valid = np.concatenate([bv, ov])
        return Column(ft, data, valid, self.dictionaries[offset])

    @functools.cached_property
    def visible_digest(self) -> str:
        """Digest of base_visible ("all" when every row is visible), the
        visibility part of the coprocessor's device cache keys. Computed
        once per snapshot: a join query asks for it once per tile and
        table, and each ask would otherwise scan the whole mask."""
        m = self.base_visible
        if m.all():
            return "all"
        return hashlib.md5(np.packbits(m).tobytes()).hexdigest()[:16]


class TableStore:
    """Storage for one table: a single base epoch filled by `bulk_load`."""

    def __init__(self, table: TableInfo) -> None:
        self.table = table
        # rows touched since creation: the auto-analyze delta feed
        # (stats/handle.py)
        self.modify_count = 0
        self._snapshot: Optional[TableSnapshot] = None
        # (epoch_id, index id or ("col", offset)) -> sort order; see
        # store/index.py
        self._index_orders: dict = {}
        self.dictionaries: list[Optional[Dictionary]] = [
            _column_dictionary(c.ftype) for c in table.columns
        ]
        self.epoch = ColumnEpoch(
            epoch_id=next(_epoch_ids), fold_ts=0,
            handles=np.empty(0, dtype=np.int64),
            columns=[np.empty(0, dtype=c.ftype.np_dtype)
                     for c in table.columns],
            valids=[None] * len(table.columns))

    def bulk_load(self, columns: list[np.ndarray],
                  valids: Optional[list[Optional[np.ndarray]]] = None
                  ) -> None:
        """Install pre-encoded column arrays as the base epoch.

        Physical encodings must match the table's column types (dictionary
        codes for strings, scaled ints for decimals, day numbers for
        dates). The caller's arrays are adopted without copying; epoch
        columns are treated as immutable everywhere."""
        if self.epoch.num_rows:
            raise ValueError("bulk_load: the base epoch is already loaded")
        if len(columns) != self.table.num_columns:
            raise ValueError(
                f"bulk_load: {len(columns)} columns for "
                f"{self.table.num_columns}-column table")
        n = len(columns[0]) if columns else 0
        for ci, c in enumerate(columns):
            if len(c) != n:
                raise ValueError(
                    f"bulk_load: column {ci} has {len(c)} rows, expected {n}")
        valids = list(valids) if valids is not None \
            else [None] * len(columns)
        for ci, v in enumerate(valids):
            if v is not None and len(v) != n:
                raise ValueError(
                    f"bulk_load: valids[{ci}] has {len(v)} rows, "
                    f"expected {n}")
        self.modify_count += n
        self.epoch = ColumnEpoch(
            epoch_id=next(_epoch_ids), fold_ts=0,
            handles=np.arange(1, n + 1, dtype=np.int64),
            columns=[c.astype(col.ftype.np_dtype, copy=False)
                     for c, col in zip(columns, self.table.columns)],
            valids=valids)

    def snapshot(self) -> TableSnapshot:
        """Every base row visible, no overlay rows. One snapshot object
        per epoch: it is immutable, and its visibility digest is then
        computed once, not once per statement."""
        snap = self._snapshot
        if snap is not None and snap.epoch is self.epoch:
            return snap
        ncols = self.table.num_columns
        self._snapshot = TableSnapshot(
            table=self.table,
            dictionaries=self.dictionaries,
            epoch=self.epoch,
            base_visible=np.ones(self.epoch.num_rows, dtype=bool),
            overlay_handles=np.empty(0, dtype=np.int64),
            overlay_columns=[np.empty(0, dtype=c.ftype.np_dtype)
                             for c in self.table.columns],
            overlay_valids=[None] * ncols,
            store=self)
        return self._snapshot
