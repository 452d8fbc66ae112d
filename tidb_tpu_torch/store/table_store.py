"""Columnar table storage: one immutable base epoch per table.

The read side of the reference's MVCC store (`tidb_tpu/store/table_store.py`):
a `ColumnEpoch` of flat column arrays, and a `TableSnapshot` over it with a
visibility mask and an (empty) overlay of rows committed after the epoch.
Deltas, compaction and the KV layer are a later slice; a snapshot handed to
the coprocessor may still carry overlay rows (one converted from the
reference does), and the coprocessor raises `NotInSlice` for them.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..catalog.schema import TableInfo
from ..chunk.column import Dictionary, EnumDictionary
from ..types.field_type import TypeKind

_epoch_ids = itertools.count(1)


def _column_dictionary(ftype) -> Optional[Dictionary]:
    """Dictionary for string-physical columns; ENUM gets the fixed
    definition-ordered validating dictionary."""
    if ftype.kind == TypeKind.ENUM:
        return EnumDictionary(ftype.elems)
    return Dictionary() if ftype.is_string else None


@dataclass
class ColumnEpoch:
    """Immutable columnar snapshot of all rows folded up to fold_ts."""

    epoch_id: int
    fold_ts: int
    handles: np.ndarray  # int64[n]
    columns: list[np.ndarray]  # physical data per table column
    valids: list[Optional[np.ndarray]]  # None = all valid

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
        self.epoch = ColumnEpoch(
            epoch_id=next(_epoch_ids), fold_ts=0,
            handles=np.arange(1, n + 1, dtype=np.int64),
            columns=[c.astype(col.ftype.np_dtype, copy=False)
                     for c, col in zip(columns, self.table.columns)],
            valids=valids)

    def snapshot(self) -> TableSnapshot:
        """Every base row visible, no overlay rows."""
        ncols = self.table.num_columns
        return TableSnapshot(
            table=self.table,
            dictionaries=self.dictionaries,
            epoch=self.epoch,
            base_visible=np.ones(self.epoch.num_rows, dtype=bool),
            overlay_handles=np.empty(0, dtype=np.int64),
            overlay_columns=[np.empty(0, dtype=c.ftype.np_dtype)
                             for c in self.table.columns],
            overlay_valids=[None] * ncols)
