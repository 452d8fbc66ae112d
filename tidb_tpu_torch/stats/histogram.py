"""Equal-depth histograms for range selectivity.

Counterpart of the reference's statistics/histogram.go: buckets hold
(lower, upper, cumulative count, repeats-of-upper); estimation walks
buckets with linear interpolation inside the boundary buckets. Built from
a (possibly sampled) sorted column in one vectorized pass.

Only numeric/temporal physical domains get histograms — string dictionary
codes are not value-ordered (chunk/column.py Dictionary), so string range
predicates are estimated with the pseudo rate, as the reference does for
columns lacking stats (statistics/selectivity.go pseudo paths).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

DEFAULT_BUCKETS = 256


class Histogram:
    def __init__(self, lowers: np.ndarray, uppers: np.ndarray,
                 counts: np.ndarray, repeats: np.ndarray,
                 total: float) -> None:
        self.lowers = lowers      # per-bucket lower bound (inclusive)
        self.uppers = uppers      # per-bucket upper bound (inclusive)
        self.counts = counts      # per-bucket row count (float, scaled)
        self.cum = np.cumsum(counts)  # cumulative
        self.repeats = repeats    # rows equal to upper bound
        self.total = total        # total rows covered (scaled)

    @classmethod
    def build(cls, values: np.ndarray, scale: float = 1.0,
              n_buckets: int = DEFAULT_BUCKETS) -> Optional["Histogram"]:
        """values: non-null numeric array (unsorted ok)."""
        n = len(values)
        if n == 0:
            return None
        v = np.sort(values.astype(np.float64))
        n_buckets = min(n_buckets, n)
        # equal-depth boundaries; snap to value edges so `repeats` is exact
        edges = np.linspace(0, n, n_buckets + 1).astype(np.int64)[1:]
        edges = np.clip(edges, 1, n)
        uppers = v[edges - 1]
        # extend each bucket to cover all duplicates of its upper bound
        ends = np.searchsorted(v, uppers, side="right")
        ends = np.unique(ends)  # strictly increasing bucket end offsets
        starts = np.concatenate([[0], ends[:-1]])
        lowers = v[starts]
        uppers = v[ends - 1]
        counts = (ends - starts).astype(np.float64) * scale
        rep_start = np.searchsorted(v, uppers, side="left")
        repeats = (ends - rep_start).astype(np.float64) * scale
        return cls(lowers, uppers, counts, repeats, float(n) * scale)

    # ---- estimation -------------------------------------------------------
    def _less_count(self, x: float, inclusive: bool) -> float:
        """Rows with value < x (or <= x when inclusive)."""
        side = "right" if inclusive else "left"
        b = int(np.searchsorted(self.uppers, x, side=side))
        if b >= len(self.uppers):
            return self.total
        before = float(self.cum[b - 1]) if b > 0 else 0.0
        lo, up = float(self.lowers[b]), float(self.uppers[b])
        cnt = float(self.counts[b])
        if x < lo or up == lo:
            inside = float(inclusive and x == lo) * cnt
        elif x == up:
            # bucket boundary: strict-less excludes the repeats mass
            inside = cnt if inclusive else cnt - float(self.repeats[b])
        else:
            frac = (x - lo) / (up - lo)
            inside = cnt * min(max(frac, 0.0), 1.0)
        return before + inside

    def range_count(self, lo, hi, lo_incl: bool, hi_incl: bool) -> float:
        """Estimated rows in the interval; None bounds are unbounded."""
        hi_c = self._less_count(float(hi), hi_incl) if hi is not None \
            else self.total
        lo_c = self._less_count(float(lo), not lo_incl) if lo is not None \
            else 0.0
        return max(hi_c - lo_c, 0.0)

    def apply_range_feedback(self, lo, hi, lo_incl: bool, hi_incl: bool,
                             actual: float) -> None:
        """Scale the buckets overlapping [lo, hi] so the interval's
        estimate matches the observed row count (reference:
        statistics/feedback.go merging actual scan counts back into
        histogram buckets). The correction factor is clamped so one
        noisy observation can't destroy the histogram."""
        est = self.range_count(lo, hi, lo_incl, hi_incl)
        if est <= 0 or actual < 0:
            return
        factor = max(0.1, min(actual / est, 10.0))
        if abs(factor - 1.0) < 0.05:
            return
        lo_f = -np.inf if lo is None else float(lo)
        hi_f = np.inf if hi is None else float(hi)
        # per-bucket overlap fraction (same linear interpolation the
        # estimator uses): only the in-interval mass gets corrected, so
        # a narrow observation can't inflate a whole wide bucket
        width = np.maximum(self.uppers - self.lowers, 0.0)
        cover_lo = np.maximum(self.lowers, lo_f)
        cover_hi = np.minimum(self.uppers, hi_f)
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = np.where(
                width > 0,
                np.clip((cover_hi - cover_lo) / np.where(width > 0, width,
                                                         1.0), 0.0, 1.0),
                ((self.lowers >= lo_f) & (self.uppers <= hi_f))
                .astype(np.float64))
        frac = np.where(cover_hi < cover_lo, 0.0, frac)
        if not (frac > 0).any():
            return
        delta = self.counts * frac * (factor - 1.0)
        self.counts = np.maximum(self.counts + delta, 0.0)
        self.repeats = np.minimum(self.repeats, self.counts)
        self.cum = np.cumsum(self.counts)
        self.total = float(self.counts.sum())

    def eq_count(self, x: float) -> float:
        b = int(np.searchsorted(self.uppers, x, side="left"))
        if b >= len(self.uppers):
            return 0.0
        if x == float(self.uppers[b]):
            return float(self.repeats[b])
        if x < float(self.lowers[b]):
            return 0.0
        # inside the bucket: assume uniform over its distinct values
        return float(self.counts[b]) / max(float(self.counts[b]) ** 0.5, 1.0)
