"""Carry requests and snapshots of the JAX reference over to the port.

`tidb_tpu` objects are read by attribute access alone; nothing of the
reference is imported. Two parts:

* `snapshot_from_reference(snap)`: a reference `TableSnapshot` -> a port
  `TableSnapshot` over the same numpy arrays (epoch columns, validity,
  handles, visibility, overlay), with the dictionaries copied value for
  value so that codes stay the same, and a port `TableStore` behind it
  that holds the table (its indexes too) and the snapshot's epoch;
* `request_from_reference(obj)`: a reference `CopDAG` or `FragmentDAG`
  tree (and everything inside it: `DAGScan`, `Col`, `Const`, `Call`,
  `AggDesc`, `FieldType`, `TypeKind`, `TableInfo`, `IndexInfo`,
  `ScanRanges`, ...) -> the port's classes, matched by class name and
  dataclass field.
"""

from __future__ import annotations

import dataclasses
import enum

from .catalog import schema
from .chunk.column import Dictionary, EnumDictionary
from .plan import dag, expr, fragment, ranger
from .store.table_store import ColumnEpoch, TableSnapshot, TableStore
from .types import field_type

_CLASSES = {
    cls.__name__: cls for cls in (
        dag.CopDAG, dag.DAGScan, dag.DAGSelection, dag.DAGAggregation,
        dag.DAGTopN, dag.DAGLimit,
        fragment.FragmentDAG, fragment.FragTable, fragment.FragJoin,
        fragment.FragSemi, fragment.HCTopN,
        expr.Col, expr.Const, expr.Call, expr.AggDesc,
        field_type.FieldType, schema.TableInfo, schema.ColumnInfo,
        schema.IndexInfo, schema.PartitionInfo, schema.PartitionDef,
        schema.FKInfo, ranger.ScanRanges,
    )
}
_ENUMS = {"TypeKind": field_type.TypeKind}


def request_from_reference(obj):
    """Reference request tree -> the port's classes (recursively)."""
    name = type(obj).__name__
    if isinstance(obj, enum.Enum):
        return _ENUMS[name][obj.name]
    if name in _CLASSES:
        cls = _CLASSES[name]
        kwargs = {f.name: request_from_reference(getattr(obj, f.name))
                  for f in dataclasses.fields(cls) if f.init}
        return cls(**kwargs)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        raise TypeError(f"no port class for reference {name}")
    if isinstance(obj, list):
        return [request_from_reference(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(request_from_reference(x) for x in obj)
    return obj  # ints, floats, strings, None, numpy scalars


def _dictionary(d, memo: dict):
    """Copy of a reference dictionary; one copy per reference object, so
    columns that share a dictionary still share it."""
    if d is None:
        return None
    if id(d) not in memo:
        cls = EnumDictionary if type(d).__name__ == "EnumDictionary" \
            else Dictionary
        memo[id(d)] = cls(list(d.values))
    return memo[id(d)]


def snapshot_from_reference(snap) -> TableSnapshot:
    """Reference TableSnapshot -> port TableSnapshot over the same arrays."""
    ep = snap.epoch
    memo: dict = {}
    epoch = ColumnEpoch(epoch_id=ep.epoch_id, fold_ts=ep.fold_ts,
                        handles=ep.handles, columns=list(ep.columns),
                        valids=list(ep.valids))
    table = request_from_reference(snap.table)
    store = TableStore(table)
    store.epoch = epoch
    store.dictionaries = [_dictionary(d, memo) for d in snap.dictionaries]
    return TableSnapshot(
        table=table,
        dictionaries=store.dictionaries,
        epoch=epoch,
        base_visible=snap.base_visible,
        overlay_handles=snap.overlay_handles,
        overlay_columns=list(snap.overlay_columns),
        overlay_valids=list(snap.overlay_valids),
        store=store)
