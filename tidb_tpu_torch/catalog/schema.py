"""Catalog: schema metadata and name resolution.

Counterpart of the reference's `infoschema.InfoSchema` + `model.TableInfo`
(reference: infoschema/infoschema.go:39; model types from the external
parser module). The catalog is an immutable-ish snapshot consumed by the
planner; DDL produces new versions (schema_version bumps mirror the
reference's meta schema-version, meta/meta.go:264).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..errno import (
    ER_BAD_DB,
    ER_DB_CREATE_EXISTS,
    ER_NO_SUCH_TABLE,
    ER_TABLE_EXISTS,
    CodedError,
)
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
    # False while the index is being built online (delete-only/write-only/
    # write-reorg states, reference ddl/index.go): writes maintain it, the
    # planner must not read it yet
    visible: bool = True


@dataclass
class FKInfo:
    """Foreign-key metadata (reference: model.FKInfo; the v5.0 reference
    PARSES and stores FK constraints but does not enforce them —
    ddl/foreign_key.go builds metadata only, foreign_key_checks defaults
    off. Same here: catalog + information_schema surface, no runtime
    enforcement)."""

    name: str
    col_offsets: list[int]
    ref_db: str
    ref_table: str
    ref_cols: list[str]
    on_delete: str = "RESTRICT"  # RESTRICT|CASCADE|SET NULL|NO ACTION
    on_update: str = "RESTRICT"


@dataclass
class SequenceInfo:
    """CREATE SEQUENCE state (reference: model.SequenceInfo +
    ddl/sequence.go; TiDB's MariaDB-compatible sequences)."""

    id: int
    name: str
    start: int = 1
    increment: int = 1
    min_value: int = 1
    max_value: int = (1 << 63) - 1
    cycle: bool = False
    next_value: int = 1


@dataclass
class PartitionDef:
    """One partition: own table id = own physical TableStore + KV range
    (reference: model.PartitionDefinition — each partition is a physical
    table, table/tables/partition.go)."""

    name: str
    id: int
    # RANGE: exclusive upper bound; None = MAXVALUE. HASH: unused.
    less_than: Optional[int] = None


@dataclass
class PartitionInfo:
    """PARTITION BY metadata (reference: model.PartitionInfo;
    ddl/partition.go builds it, planner prunes on it)."""

    kind: str  # 'hash' | 'range'
    col_offset: int
    defs: list[PartitionDef] = field(default_factory=list)

    def route(self, value) -> PartitionDef:
        """Partition for a column value (reference: partitionedTable
        locatePartition, table/tables/partition.go)."""
        if value is None:
            if self.kind == "hash":
                return self.defs[0]  # MySQL: NULL hashes to partition 0
            # RANGE: NULL sorts below every bound -> first partition
            return self.defs[0]
        v = int(value)
        if self.kind == "hash":
            return self.defs[v % len(self.defs)]
        for d in self.defs:
            if d.less_than is None or v < d.less_than:
                return d
        raise ValueError(
            f"Table has no partition for value {v}")

    def by_name(self, name: str) -> Optional[PartitionDef]:
        lname = name.lower()
        for d in self.defs:
            if d.name.lower() == lname:
                return d
        return None


@dataclass
class TableInfo:
    id: int
    name: str
    columns: list[ColumnInfo]
    indices: list[IndexInfo] = field(default_factory=list)
    # offset of an integer PRIMARY KEY column used directly as the row
    # handle (reference: pk-is-handle tables, table/tables.go); None means
    # rows get auto-allocated internal handles.
    pk_handle_offset: Optional[int] = None
    # PARTITION BY metadata; None = unpartitioned. Access via
    # getattr(info, 'partition', None) where old pickled catalogs may
    # lack the field.
    partition: Optional[PartitionInfo] = None
    # foreign-key constraints (metadata only; see FKInfo)
    foreign_keys: list = field(default_factory=list)

    def column_by_name(self, name: str) -> Optional[ColumnInfo]:
        lname = name.lower()
        for c in self.columns:
            if c.name.lower() == lname:
                return c
        return None

    @property
    def num_columns(self) -> int:
        return len(self.columns)


class CatalogError(CodedError, KeyError):
    """Schema lookup/namespace error. Subclasses KeyError so existing
    `except KeyError` callers keep working; __str__ stays Exception's
    (KeyError would repr-quote the message)."""

    def __str__(self) -> str:  # noqa: D105
        return Exception.__str__(self)


@dataclass
class SchemaInfo:
    name: str
    tables: dict[str, TableInfo] = field(default_factory=dict)  # lower-name keyed
    sequences: dict[str, SequenceInfo] = field(default_factory=dict)
    views: dict[str, "ViewInfo"] = field(default_factory=dict)


@dataclass
class ViewInfo:
    """A named stored SELECT, expanded at plan-build time (reference:
    ddl/ddl_api.go CreateView; planner/core/logical_plan_builder.go
    BuildDataSourceFromView re-parses the stored SELECT). Column aliases
    (when given) rename the underlying SELECT's output columns."""

    name: str
    sql: str            # the SELECT text
    columns: tuple = ()  # optional explicit column-name list
    definer: str = "root@%"


class Catalog:
    """All schemas + id allocation + versioning. Single-node, in-memory.

    Name lookups are case-insensitive (MySQL default on most platforms).
    """

    def __init__(self) -> None:
        self.schemas: dict[str, SchemaInfo] = {}
        self.version = 0
        self._next_id = 1
        # durable storage installs a persistence hook here; fired on every
        # version bump (the schema-version write of meta/meta.go:264)
        self.on_change = None
        self.create_schema("test")  # convenience default, like test setups

    # ---- id / version ------------------------------------------------------
    def alloc_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def bump_version(self) -> int:
        self.version += 1
        if self.on_change is not None:
            self.on_change()
        return self.version

    # ---- schema ops --------------------------------------------------------
    def create_schema(self, name: str, if_not_exists: bool = False) -> SchemaInfo:
        key = name.lower()
        if key in self.schemas:
            if if_not_exists:
                return self.schemas[key]
            raise CatalogError(f"database exists: {name}", errno=ER_DB_CREATE_EXISTS)
        info = SchemaInfo(name)
        self.schemas[key] = info
        self.bump_version()
        return info

    def drop_schema(self, name: str, if_exists: bool = False) -> list[TableInfo]:
        key = name.lower()
        if key not in self.schemas:
            if if_exists:
                return []
            raise CatalogError(f"unknown database: {name}", errno=ER_BAD_DB)
        dropped = list(self.schemas.pop(key).tables.values())
        self.bump_version()
        return dropped

    def schema(self, name: str) -> SchemaInfo:
        key = name.lower()
        if key not in self.schemas:
            raise CatalogError(f"unknown database: {name}", errno=ER_BAD_DB)
        return self.schemas[key]

    # ---- table ops ---------------------------------------------------------
    def add_table(self, db: str, tbl: TableInfo, if_not_exists: bool = False) -> bool:
        schema = self.schema(db)
        key = tbl.name.lower()
        if key in schema.tables:
            if if_not_exists:
                return False
            raise CatalogError(f"table exists: {db}.{tbl.name}", errno=ER_TABLE_EXISTS)
        schema.tables[key] = tbl
        self.bump_version()
        return True

    def drop_table(self, db: str, name: str, if_exists: bool = False) -> Optional[TableInfo]:
        schema = self.schema(db)
        key = name.lower()
        if key not in schema.tables:
            if if_exists:
                return None
            raise CatalogError(f"unknown table: {db}.{name}", errno=ER_NO_SUCH_TABLE)
        info = schema.tables.pop(key)
        self.bump_version()
        return info

    def table(self, db: str, name: str) -> TableInfo:
        schema = self.schema(db)
        key = name.lower()
        if key not in schema.tables:
            raise CatalogError(f"unknown table: {db}.{name}", errno=ER_NO_SUCH_TABLE)
        return schema.tables[key]

    def try_table(self, db: str, name: str) -> Optional[TableInfo]:
        try:
            return self.table(db, name)
        except KeyError:
            return None

    def replace_table(self, db: str, old_name: str, info: TableInfo) -> None:
        """Swap in a new TableInfo object (DDL publishes new schema versions
        as fresh immutable-ish objects so in-flight snapshots keep the old
        one — the schema-version delta apply of infoschema/builder.go)."""
        schema = self.schema(db)
        schema.tables.pop(old_name.lower(), None)
        schema.tables[info.name.lower()] = info
        self.bump_version()
