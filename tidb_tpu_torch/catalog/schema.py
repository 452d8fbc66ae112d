"""Table and column metadata read by the coprocessor.

The subset of the reference catalog (`tidb_tpu/catalog/schema.py`) that
requests and snapshots carry: `TableInfo`, `ColumnInfo` and `IndexInfo`
(index-ranged scans read the index's columns). Partitions, foreign keys
and the catalog itself belong to the SQL tier.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..types.field_type import FieldType


@dataclass
class ColumnInfo:
    id: int
    name: str
    ftype: FieldType
    offset: int = 0  # position in the table
    default: Any = None
    is_primary: bool = False
    auto_increment: bool = False

    @property
    def nullable(self) -> bool:
        return self.ftype.nullable and not self.is_primary


@dataclass
class IndexInfo:
    id: int
    name: str
    col_offsets: list[int]
    unique: bool = False
    primary: bool = False
    # False while the index is being built online: the planner must not
    # read it yet
    visible: bool = True


@dataclass
class TableInfo:
    id: int
    name: str
    columns: list[ColumnInfo]
    indices: list[IndexInfo] = field(default_factory=list)
    # offset of an integer PRIMARY KEY column used directly as the row
    # handle; None means rows get auto-allocated handles
    pk_handle_offset: Optional[int] = None

    def column_by_name(self, name: str) -> Optional[ColumnInfo]:
        lname = name.lower()
        for c in self.columns:
            if c.name.lower() == lname:
                return c
        return None

    @property
    def num_columns(self) -> int:
        return len(self.columns)
