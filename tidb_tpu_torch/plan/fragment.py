"""Fragment requests: multi-table pushdown units for the coprocessor.

The dataclasses of the reference's `tidb_tpu/plan/fragment.py`. Recognising
fragments in a physical plan is planner work and belongs to the SQL tier;
the coprocessor only reads these structures.

tables[0] is the probe; joins place tables[1..] in order. The combined
column space is concat(tables[i] columns) in table order; selection, agg
and out_map all reference it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.field_type import FieldType
from .dag import DAGAggregation, DAGTopN
from .expr import PlanExpr


@dataclass
class FragTable:
    """One table of the fragment. col_offsets are store offsets in local
    column order; filters are this table's pushed-down conjuncts in LOCAL
    index space (Col.idx -> position in col_offsets)."""

    table: object  # TableInfo
    col_offsets: list[int]
    filters: list[PlanExpr] = field(default_factory=list)
    col_types: list[FieldType] = field(default_factory=list)


@dataclass
class FragJoin:
    """Gather-join of tables[build] onto the probe row stream (unique
    build key: idx = perm[key - lo]; found = idx >= 0)."""

    build: int
    probe_key: PlanExpr
    build_key_local: int


@dataclass
class FragSemi:
    """Membership-gate edge (EXISTS / IN / NOT IN). kind: "SEMI" |
    "ANTI" | "ANTI_NULL"."""

    table: FragTable
    probe_key: PlanExpr
    build_key_local: int
    kind: str


@dataclass
class HCTopN:
    """High-cardinality group-by hint: the aggregation's consumer is
    ORDER BY <score> LIMIT k. score: ("group", j) or ("agg", ai); items,
    when set, is the complete resolved ORDER BY list."""

    score: tuple[str, int]
    desc: bool
    k: int
    items: Optional[list] = None

    @property
    def cap(self) -> int:
        # candidate buffer absorbing f32 score ties near the k-th value
        return max(4 * self.k, self.k + 64)


@dataclass
class FragmentDAG:
    tables: list[FragTable]
    joins: list[FragJoin]
    selection: list[PlanExpr] = field(default_factory=list)
    agg: Optional[DAGAggregation] = None
    # row mode: combined idx per output position (tree schema order)
    out_map: Optional[list[int]] = None
    output_types: list[FieldType] = field(default_factory=list)
    # row mode with a TopN consumer
    topn: Optional[DAGTopN] = None
    # set when the agg's consumer is a TopN
    hc: Optional[HCTopN] = None
    # set when the agg's consumer filters on an aggregate value (HAVING
    # sum(x) > c): [(agg_index, op, const)] with op in lt/le/gt/ge and
    # const scaled to the aggregate's integer representation. The device
    # may return only groups passing a safely widened version; the host
    # Selection above re-applies them exactly.
    having: Optional[list] = None
    # semi/anti membership gates applied after the joins (no columns)
    semis: list[FragSemi] = field(default_factory=list)
    HAVING_CAP = 65536  # candidate buffer for having/all-groups modes

    def combined_types(self) -> list[FieldType]:
        out: list[FieldType] = []
        for t in self.tables:
            out.extend(t.col_types)
        return out

    def describe(self) -> str:
        parts = [f"probe(t{self.tables[0].table.id} "
                 f"cols={self.tables[0].col_offsets})"]
        for j in self.joins:
            t = self.tables[j.build]
            parts.append(f"gather(t{t.table.id} key={j.probe_key!r})")
        for sm in self.semis:
            parts.append(f"{sm.kind.lower()}(t{sm.table.table.id} "
                         f"key={sm.probe_key!r})")
        if self.selection:
            parts.append(f"sel({len(self.selection)})")
        if self.agg is not None:
            parts.append(f"agg(groups={len(self.agg.group_by)}, "
                         f"aggs={self.agg.aggs})")
        if self.topn is not None:
            parts.append(f"topn({self.topn.n})")
        return " -> ".join(parts)
