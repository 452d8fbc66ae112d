"""Statistics subsystem: sketches, histograms, stats handle, selectivity.

Counterpart of the reference's statistics/ package (SURVEY.md §2:
histograms, CMSketch, FMSketch, selectivity, delta-driven auto-analyze).
"""

from .handle import (  # noqa: F401
    ColumnStats,
    PSEUDO_EQ_RATE,
    PSEUDO_RANGE_RATE,
    StatsHandle,
    TableStats,
)
from .histogram import Histogram  # noqa: F401
from .sketch import CMSketch, FMSketch  # noqa: F401
