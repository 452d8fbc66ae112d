"""Index access ranges of a scan.

The part of the reference's `tidb_tpu/plan/ranger.py` that a request
carries: `ScanRanges`, the ranges on one index that `DAGScan.ranges`
holds. Deriving them from predicates (`extract_points`,
`extract_interval`) is planner work and waits for the SQL tier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..catalog.schema import IndexInfo


@dataclass
class ScanRanges:
    """Access ranges on one index. Two forms:

    * points mode: every tuple is a full value list for the first
      len(tuple) index columns (physical domain, strings raw — encoded by
      the searcher)
    * interval mode: one (lo, hi, lo_incl, hi_incl) interval on the FIRST
      index column (numeric/temporal only; None bound = unbounded on that
      side)
    """

    index: IndexInfo
    points: list[tuple]
    interval: Optional[tuple] = None  # (lo, hi, lo_incl, hi_incl)

    def describe(self) -> str:
        if self.interval is not None:
            lo, hi, li, hi_i = self.interval
            lb = ("[" if li else "(") + (str(lo) if lo is not None else "-inf")
            ub = (str(hi) if hi is not None else "+inf") + ("]" if hi_i else ")")
            return f"index:{self.index.name} range {lb},{ub}"
        return (f"index:{self.index.name}"
                f"({len(self.points)} point{'s' if len(self.points) != 1 else ''})")
