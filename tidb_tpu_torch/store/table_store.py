"""Per-table MVCC columnar storage: immutable base epochs + row deltas.

Port of `tidb_tpu/store/table_store.py`:

* The **base epoch** is an immutable set of flat column arrays. It is what
  the coprocessor stages on the device and what kernels scan.
* **Deltas** are committed row mutations `(commit_ts, handle, row|TOMBSTONE)`
  kept host-side in commit order. A snapshot read at `snap_ts` sees the base
  epoch minus overridden handles, plus the latest visible delta per handle —
  merged into a small "overlay" chunk the device treats as one more tile.
* **Compaction** folds deltas at or below the GC-safe ts into a new epoch.

Handles are int64 row ids, auto-allocated or taken from an integer primary
key. The store keeps the index sort orders (`store/index.py`) of its
epochs, and fires its durable-epoch hook (`on_epoch`) at every new epoch.
The DDL reorganisations `apply_schema` and `cast_column` swap a new
`TableInfo` and a new epoch (a new `epoch_id`) in one step under the store
lock. Left out with the plane it serves: the mesh plane's eviction hooks.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..catalog.schema import TableInfo
from ..chunk.column import Column, Dictionary, EnumDictionary, _encode_scalar
from ..kv.memdb import TOMBSTONE
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

    def handles(self) -> np.ndarray:
        return np.concatenate(
            [self.epoch.handles[self.base_visible], self.overlay_handles])

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


def _empty_epoch(table: TableInfo) -> ColumnEpoch:
    return ColumnEpoch(
        epoch_id=next(_epoch_ids),
        fold_ts=0,
        handles=np.empty(0, dtype=np.int64),
        columns=[np.empty(0, dtype=c.ftype.np_dtype) for c in table.columns],
        valids=[None] * len(table.columns),
    )


class TableStore:
    """MVCC store for one table."""

    # fold deltas into a fresh epoch once this many are visible to everyone
    COMPACT_THRESHOLD = 8192

    def __init__(self, table: TableInfo) -> None:
        self.table = table
        self.dictionaries: list[Optional[Dictionary]] = [
            _column_dictionary(c.ftype) for c in table.columns
        ]
        self.epoch = _empty_epoch(table)
        # committed mutations after epoch.fold_ts, in commit-ts order
        self.deltas: list[tuple[int, int, Any]] = []  # (commit_ts, handle, row)
        self._next_handle = 1
        self._lock = threading.RLock()
        # (epoch_id, index id or ("col", offset)) -> sort order; see
        # store/index.py
        self._index_orders: dict = {}
        # rows touched since creation — the auto-analyze delta feed
        # (reference: stats delta in handle/update.go)
        self.modify_count = 0
        # bumped by every DDL that changes this table's schema; txns that
        # buffered writes under an older token must abort at commit
        # (reference: schema validator fencing, domain/schema_validator.go)
        self.schema_token = 0
        # the newest snapshot with no delta visible, per epoch: immutable,
        # so its visibility digest is computed once, not per statement
        self._snapshot: Optional[TableSnapshot] = None
        # durable-storage hook: fired after every base-epoch replacement
        # (bulk_load / compact / apply_schema / cast_column) so the owner
        # can persist the columnar snapshot (Storage._on_epoch_changed).
        # `required=False` (compaction) only marks the epoch dirty: the
        # folded deltas are still recoverable from the KV truth, so the
        # snapshot write can defer to checkpoint() instead of stalling the
        # committing session on an O(table) file write
        self.on_epoch = None
        self.epoch_dirty = False
        # eager-eviction hooks: fired on every base-epoch replacement so
        # device-resident caches (the mesh plane's sharded epochs) free
        # the superseded epoch's tensors now, not on the next dispatch
        # (Storage.add_epoch_listener attaches)
        self.evict_hooks: list = []

    def _epoch_changed(self, required: bool = True) -> None:
        if self.on_epoch is not None:
            self.on_epoch(self, required)
        for fn in list(self.evict_hooks):
            fn(self)

    def restore_epoch(self, epoch: ColumnEpoch,
                      dictionaries: list[Optional[Dictionary]],
                      next_handle: int) -> None:
        """Install a recovered columnar snapshot (restart recovery path)."""
        with self._lock:
            self.epoch = epoch
            self.dictionaries = dictionaries
            self._next_handle = max(self._next_handle, next_handle)

    # ---- write path --------------------------------------------------------
    def alloc_handle(self) -> int:
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            return h

    def note_handle(self, handle: int) -> None:
        """Keep auto-alloc above explicitly-written pk-is-handle values."""
        with self._lock:
            if handle >= self._next_handle:
                self._next_handle = handle + 1

    def encode_row(self, values: list[Any]) -> tuple:
        """Host scalars -> physical tuple (dictionary side effects included)."""
        assert len(values) == self.table.num_columns
        out = []
        for v, col, d in zip(values, self.table.columns, self.dictionaries):
            if v is None:
                out.append(None)
            else:
                out.append(_encode_scalar(col.ftype, v, d))
        return tuple(out)

    def apply_commit(self, commit_ts: int, handle: int, row: Any) -> None:
        """Record one committed mutation (row tuple or TOMBSTONE)."""
        with self._lock:
            self.deltas.append((commit_ts, handle, row))
            self.modify_count += 1

    def latest_commit_ts(self, handle: int) -> int:
        """Newest commit touching handle (0 if only in base/absent) —
        the write-conflict check input."""
        with self._lock:
            for commit_ts, h, _ in reversed(self.deltas):
                if h == handle:
                    return commit_ts
        return 0

    # ---- read path ---------------------------------------------------------
    def snapshot(
        self,
        snap_ts: int,
        txn_overlay: Optional[dict[int, Any]] = None,
    ) -> TableSnapshot:
        """Build the visible view at snap_ts, optionally unioned with an
        uncommitted txn buffer (read-your-writes; reference analog:
        executor/union_scan.go over kv/union_iter.go). A view with no
        delta and no buffered row is the epoch's one all-visible
        snapshot."""
        with self._lock:
            epoch = self.epoch
            # latest visible version per handle among deltas
            visible: dict[int, Any] = {}
            for commit_ts, handle, row in self.deltas:
                if commit_ts <= snap_ts:
                    visible[handle] = row
            if txn_overlay:
                visible.update(txn_overlay)
            if not visible:
                snap = self._snapshot
                if snap is None or snap.epoch is not epoch:
                    snap = self._snapshot = self._base_snapshot(epoch)
                return snap

        base_visible = np.ones(epoch.num_rows, dtype=bool)
        ov_handles: list[int] = []
        ov_rows: list[tuple] = []
        for handle, row in visible.items():
            pos = epoch.handle_pos.get(handle)
            if pos is not None:
                base_visible[pos] = False
            if row is not TOMBSTONE:
                ov_handles.append(handle)
                ov_rows.append(row)

        ncols = self.table.num_columns
        ov_columns: list[np.ndarray] = []
        ov_valids: list[Optional[np.ndarray]] = []
        for ci in range(ncols):
            dt = self.table.columns[ci].ftype.np_dtype
            data = np.zeros(len(ov_rows), dtype=dt)
            valid = np.ones(len(ov_rows), dtype=bool)
            for ri, row in enumerate(ov_rows):
                v = row[ci]
                if v is None:
                    valid[ri] = False
                else:
                    data[ri] = v
            ov_columns.append(data)
            ov_valids.append(None if valid.all() else valid)

        return TableSnapshot(
            table=self.table,
            dictionaries=self.dictionaries,
            epoch=epoch,
            base_visible=base_visible,
            overlay_handles=np.array(ov_handles, dtype=np.int64),
            overlay_columns=ov_columns,
            overlay_valids=ov_valids,
            store=self,
        )

    def _base_snapshot(self, epoch: ColumnEpoch) -> TableSnapshot:
        return TableSnapshot(
            table=self.table,
            dictionaries=self.dictionaries,
            epoch=epoch,
            base_visible=np.ones(epoch.num_rows, dtype=bool),
            overlay_handles=np.empty(0, dtype=np.int64),
            overlay_columns=[np.empty(0, dtype=c.ftype.np_dtype)
                             for c in self.table.columns],
            overlay_valids=[None] * self.table.num_columns,
            store=self)

    # ---- bulk load ----------------------------------------------------------
    def bulk_load(
        self,
        columns: list[np.ndarray],
        valids: Optional[list[Optional[np.ndarray]]] = None,
        commit_ts: int = 0,
    ) -> None:
        """Append pre-encoded column arrays directly into a new base epoch.

        The loader path of cmd/importer (reference: cmd/importer) — bypasses
        the transaction layer; intended for benchmarks and dataset loads.
        Physical encodings must match the table's column types (dictionary
        codes for strings, scaled ints for decimals, day numbers for dates).
        """
        if len(columns) != self.table.num_columns:
            raise ValueError(
                f"bulk_load: {len(columns)} columns for "
                f"{self.table.num_columns}-column table")
        n = len(columns[0]) if columns else 0
        for ci, c in enumerate(columns):
            if len(c) != n:
                raise ValueError(
                    f"bulk_load: column {ci} has {len(c)} rows, expected {n}")
        if valids is not None:
            for ci, v in enumerate(valids):
                if v is not None and len(v) != n:
                    raise ValueError(
                        f"bulk_load: valids[{ci}] has {len(v)} rows, "
                        f"expected {n}")
        with self._lock:
            epoch = self.epoch
            self.modify_count += n
            handles = np.arange(self._next_handle, self._next_handle + n,
                                dtype=np.int64)
            self._next_handle += n
            new_cols = []
            new_valids: list[Optional[np.ndarray]] = []
            for ci in range(self.table.num_columns):
                dt = self.table.columns[ci].ftype.np_dtype
                if epoch.num_rows == 0:
                    # adopt the caller's arrays without copying: a SF100
                    # load is ~60GB of columns and a concatenate would
                    # double the peak footprint. Epoch columns are
                    # treated as immutable everywhere.
                    new_cols.append(columns[ci].astype(dt, copy=False))
                else:
                    new_cols.append(np.concatenate(
                        [epoch.columns[ci], columns[ci].astype(dt)]))
                add_v = valids[ci] if valids is not None else None
                old_v = epoch.valids[ci]
                if old_v is None and add_v is None:
                    new_valids.append(None)
                else:
                    ov = old_v if old_v is not None else np.ones(
                        epoch.num_rows, bool)
                    av = add_v if add_v is not None else np.ones(n, bool)
                    new_valids.append(np.concatenate([ov, av]))
            all_handles = np.concatenate([epoch.handles, handles])
            self.epoch = ColumnEpoch(
                epoch_id=next(_epoch_ids),
                fold_ts=max(epoch.fold_ts, commit_ts),
                handles=all_handles,
                columns=new_cols,
                valids=new_valids,
            )
        self._epoch_changed()

    # ---- schema change (DDL reorg primitives) ------------------------------
    def apply_schema(self, new_info: TableInfo,
                     column_map: list, fills: dict) -> None:
        """Swap to a new TableInfo, rewriting stored data to its layout.

        column_map[i] = old offset backing new column i, or None for a new
        column (filled from fills[i] = (phys_default, valid)). Old snapshots
        stay consistent: they hold the previous TableInfo object and epoch
        (immutable); only new snapshots see the new layout. This is the
        storage half of the DDL state machine (reference: delete-only/
        write-only states guard TiKV row format changes, ddl/column.go —
        here the epoch swap is atomic under the store lock)."""
        with self._lock:
            epoch = self.epoch
            n = epoch.num_rows
            cols: list[np.ndarray] = []
            valids: list[Optional[np.ndarray]] = []
            dicts: list[Optional[Dictionary]] = []
            for i, c in enumerate(new_info.columns):
                src = column_map[i]
                if src is None:
                    dv, dvalid = fills[i]
                    dt = c.ftype.np_dtype
                    d = _column_dictionary(c.ftype)
                    if dvalid and isinstance(dv, str):
                        dv = d.encode(dv)  # string default -> fresh code
                    cols.append(np.full(n, dv if dvalid else 0, dtype=dt))
                    valids.append(None if dvalid else np.zeros(n, bool))
                    dicts.append(d)
                    fills[i] = (dv, dvalid)  # deltas reuse the encoded value
                else:
                    data = epoch.columns[src]
                    if data.dtype != c.ftype.np_dtype:
                        data = data.astype(c.ftype.np_dtype)
                    cols.append(data)
                    valids.append(epoch.valids[src])
                    dicts.append(self.dictionaries[src])
            new_deltas = []
            for commit_ts, handle, row in self.deltas:
                if row is not TOMBSTONE:
                    row = tuple(
                        (row[column_map[i]] if column_map[i] is not None
                         else (fills[i][0] if fills[i][1] else None))
                        for i in range(len(new_info.columns)))
                new_deltas.append((commit_ts, handle, row))
            self.table = new_info
            self.dictionaries = dicts
            self.deltas = new_deltas
            self.epoch = ColumnEpoch(
                epoch_id=next(_epoch_ids),
                fold_ts=epoch.fold_ts,
                handles=epoch.handles,
                columns=cols,
                valids=valids,
                handle_pos=epoch.handle_pos,
            )
            self._index_orders.clear()
            self.schema_token += 1
        self._epoch_changed()

    def cast_column(self, offset: int, cast_fn,
                    new_info: Optional[TableInfo] = None) -> Optional[str]:
        """Rewrite one column's physical values (MODIFY COLUMN reorg).
        cast_fn(data, valid) -> (new_data, new_valid) or raises ValueError;
        returns an error string on failure (job rolls back).

        new_info, when given, is swapped in atomically with the rewritten
        epoch: a snapshot must never pair new physical values with the old
        FieldType (e.g. a DECIMAL(10,2)->INT rescale read back at scale 2)
        — mirror of apply_schema's atomic table+epoch swap."""
        with self._lock:
            epoch = self.epoch
            try:
                data, valid = cast_fn(
                    epoch.columns[offset],
                    epoch.valids[offset] if epoch.valids[offset] is not None
                    else np.ones(epoch.num_rows, bool))
                new_deltas = []
                for commit_ts, handle, row in self.deltas:
                    if row is not TOMBSTONE and row[offset] is not None:
                        v, ok = cast_fn(np.array([row[offset]]),
                                        np.ones(1, bool))
                        if not ok[0]:
                            raise ValueError(f"cannot convert {row[offset]}")
                        row = row[:offset] + (v[0].item(),) + row[offset + 1:]
                    new_deltas.append((commit_ts, handle, row))
            except (ValueError, OverflowError) as e:
                return str(e)
            cols = list(epoch.columns)
            valids = list(epoch.valids)
            cols[offset] = data
            valids[offset] = None if valid.all() else valid
            self.deltas = new_deltas
            self.epoch = ColumnEpoch(
                epoch_id=next(_epoch_ids),
                fold_ts=epoch.fold_ts,
                handles=epoch.handles,
                columns=cols,
                valids=valids,
                handle_pos=epoch.handle_pos,
            )
            if new_info is not None:
                self.table = new_info
            self._index_orders.clear()
            self.schema_token += 1
        self._epoch_changed()
        return None

    # ---- compaction --------------------------------------------------------
    def maybe_compact(self, safe_ts: int) -> None:
        if len(self.deltas) >= self.COMPACT_THRESHOLD:
            self.compact(safe_ts)

    def compact(self, safe_ts: int) -> None:
        """Fold deltas with commit_ts <= safe_ts into a new immutable epoch.

        safe_ts must not exceed the oldest active snapshot ts (the Storage
        layer enforces this — GC-safepoint analog, store/tikv/gcworker).
        """
        with self._lock:
            epoch = self.epoch
            folding: dict[int, Any] = {}
            remaining: list[tuple[int, int, Any]] = []
            for commit_ts, handle, row in self.deltas:
                if commit_ts <= safe_ts:
                    folding[handle] = row
                else:
                    remaining.append((commit_ts, handle, row))
            if not folding:
                return

            keep = np.ones(epoch.num_rows, dtype=bool)
            for handle in folding:
                pos = epoch.handle_pos.get(handle)
                if pos is not None:
                    keep[pos] = False
            new_rows = [(h, r) for h, r in folding.items() if r is not TOMBSTONE]
            new_rows.sort(key=lambda x: x[0])  # handle order keeps scans stable

            ncols = self.table.num_columns
            handles = np.concatenate(
                [epoch.handles[keep], np.array([h for h, _ in new_rows], np.int64)]
            )
            columns: list[np.ndarray] = []
            valids: list[Optional[np.ndarray]] = []
            for ci in range(ncols):
                dt = self.table.columns[ci].ftype.np_dtype
                add = np.zeros(len(new_rows), dtype=dt)
                addv = np.ones(len(new_rows), dtype=bool)
                for ri, (_, row) in enumerate(new_rows):
                    v = row[ci]
                    if v is None:
                        addv[ri] = False
                    else:
                        add[ri] = v
                columns.append(np.concatenate([epoch.columns[ci][keep], add]))
                oldv = epoch.valids[ci]
                if oldv is None and addv.all():
                    valids.append(None)
                else:
                    ov = oldv[keep] if oldv is not None else np.ones(int(keep.sum()), bool)
                    valids.append(np.concatenate([ov, addv]))

            new_epoch = ColumnEpoch(
                epoch_id=next(_epoch_ids),
                fold_ts=safe_ts,
                handles=handles,
                columns=columns,
                valids=valids,
            )
            self.epoch = new_epoch
            self.deltas = remaining
        self._epoch_changed(required=False)
