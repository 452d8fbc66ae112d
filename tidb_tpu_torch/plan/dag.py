"""CopDAG: the pushdown plan IR shipped to the TiTPU coprocessor.

Counterpart of the reference's `tipb.DAGRequest` executor list (reference:
planner/core/plan_to_pb.go:39-326 builds TableScan -> Selection ->
Aggregation/TopN/Limit chains; the storage side interprets or compiles them,
store/mockstore/unistore/cophandler/closure_exec.go). Here the DAG is a
typed Python structure the kernel compiler lowers to one fused JAX program;
a protobuf wire form comes with the C++/multi-host tier.

Expression trees inside the DAG reference the scan's output columns by
index (Col.idx is an offset into `DAGScan.col_offsets`' output order).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.field_type import FieldType
from .expr import AggDesc, PlanExpr


@dataclass
class DAGScan:
    table_id: int
    # offsets into the stored table's columns, in output order
    col_offsets: list[int]
    # index access ranges (plan/ranger.ScanRanges); None = full scan.
    # With ranges the coprocessor gathers matching rows via the index
    # permutation and runs the rest of the DAG host-side over the (small)
    # subset (reference: IndexLookUp double read, executor/distsql.go:353)
    ranges: Optional[object] = None


@dataclass
class DAGSelection:
    # conjunctive conditions over the scan output
    conditions: list[PlanExpr]


@dataclass
class DAGAggregation:
    group_by: list[PlanExpr]
    aggs: list[AggDesc]


# ---- partial-aggregate column layout ---------------------------------------
# Most aggregates ship (val, cnt) column pairs from the coprocessor to the
# final merge. APPROX_COUNT_DISTINCT ships its HLL sketch instead:
# byte-packed max-rank registers in HLL_WORDS int64 words, then cnt — the
# only representation that merges correctly across partial producers
# (overlay batches, partitions, shards); a scalar estimate would not
# (reference: executor/aggfuncs/func_hybrid_count_distinct.go keeps the
# sketch through partial merge for the same reason).

HLL_WORDS = 32  # 256 registers / 8 per int64 word (one byte per register)


def agg_partial_width(d: AggDesc) -> int:
    """Number of partial columns the aggregate contributes (incl. cnt)."""
    return (HLL_WORDS + 1) if d.func == "approx_count_distinct" else 2


def agg_partial_starts(aggs: list[AggDesc], ngroups: int) -> list[int]:
    """Per-agg first partial-column index in the partial chunk layout
    [group cols..., per-agg partial cols...]."""
    starts = []
    o = ngroups
    for d in aggs:
        starts.append(o)
        o += agg_partial_width(d)
    return starts


@dataclass
class DAGTopN:
    # (expr, desc) sort items over scan output, then keep n
    items: list[tuple[PlanExpr, bool]]
    n: int


@dataclass
class DAGLimit:
    n: int


@dataclass
class CopDAG:
    """scan -> [selection] -> [agg | topn | limit] -> [projection exprs]."""

    scan: DAGScan
    selection: Optional[DAGSelection] = None
    agg: Optional[DAGAggregation] = None
    topn: Optional[DAGTopN] = None
    limit: Optional[DAGLimit] = None
    # post-ops projection evaluated device-side when no agg (scan output ->
    # projected exprs); with agg, projection happens host-side over agg output
    projections: Optional[list[PlanExpr]] = None
    output_types: list[FieldType] = field(default_factory=list)

    def describe(self) -> str:
        rng = f" {self.scan.ranges.describe()}" if self.scan.ranges else ""
        parts = [f"scan(t{self.scan.table_id} cols={self.scan.col_offsets}{rng})"]
        if self.selection:
            parts.append(f"sel({len(self.selection.conditions)} conds)")
        if self.agg:
            parts.append(
                f"agg(groups={len(self.agg.group_by)}, aggs={self.agg.aggs})"
            )
        if self.topn:
            parts.append(f"topn({self.topn.n})")
        if self.limit:
            parts.append(f"limit({self.limit.n})")
        if self.projections:
            parts.append(f"proj({len(self.projections)})")
        return " -> ".join(parts)
