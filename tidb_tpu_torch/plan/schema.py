"""Plan output schemas: named, typed column lists for name resolution.

Counterpart of the reference's `expression.Schema` + output names
(reference: expression/schema.go) — every plan node exposes one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.field_type import FieldType


@dataclass
class ResultField:
    name: str  # column name (lowered)
    ftype: FieldType
    table_alias: str = ""  # qualifier (table alias or name, lowered)
    # for scans: offset of the column in the stored table row
    source_offset: int = -1


@dataclass
class PlanSchema:
    fields: list[ResultField] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.fields)

    def resolve(self, name: str, table: Optional[str] = None) -> Optional[int]:
        """Index of the column matching [table.]name; None if absent.
        Raises on ambiguity."""
        lname = name.lower()
        ltable = table.lower() if table else None
        hits = [
            i
            for i, f in enumerate(self.fields)
            if f.name == lname and (ltable is None or f.table_alias == ltable)
        ]
        if not hits:
            return None
        if len(hits) > 1:
            raise KeyError(f"ambiguous column: {name}")
        return hits[0]
