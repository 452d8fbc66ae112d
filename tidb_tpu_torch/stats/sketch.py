"""Count-Min and Flajolet-Martin sketches, built vectorized.

Counterparts of the reference's statistics/cmsketch.go (CM sketch with an
exact TopN carve-out) and statistics/fmsketch.go (FM sketch for NDV). The
reference builds these row-at-a-time while scanning samples; here the whole
column is already a flat array, so builds are numpy reductions (np.unique /
np.add.at) — the same shape a jnp/segment_sum device build would take, and
trivially portable there when ANALYZE pushdown moves on-device (SURVEY.md
§2.3 P13).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# splitmix64 constants — cheap vectorized 64-bit mixing
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_SHIFT = np.uint64(30)
_SHIFT2 = np.uint64(27)
_SHIFT3 = np.uint64(31)


def hash64(values: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over an int64/uint64 array."""
    with np.errstate(over="ignore"):
        x = values.astype(np.uint64, copy=True)
        x ^= x >> _SHIFT
        x *= _M1
        x ^= x >> _SHIFT2
        x *= _M2
        x ^= x >> _SHIFT3
    return x


def hash_any(values: np.ndarray) -> np.ndarray:
    """Hash a column's physical values to uint64 (floats via bit pattern)."""
    if np.issubdtype(values.dtype, np.floating):
        v = values.astype(np.float64).view(np.uint64)
    else:
        v = values.astype(np.int64).view(np.uint64)
    return hash64(v)


class CMSketch:
    """Count-Min sketch with exact TopN (reference: statistics/cmsketch.go).

    Point-frequency estimation for equality predicates. The TopN (most
    frequent values) is stored exactly and subtracted from the sketch,
    which keeps heavy hitters from inflating everything else's estimate.
    """

    DEPTH = 5
    WIDTH = 2048
    TOPN = 20

    def __init__(self) -> None:
        self.table = np.zeros((self.DEPTH, self.WIDTH), dtype=np.int64)
        self.topn: dict[int, int] = {}  # raw value -> exact count
        self.default = 0  # estimate for values never seen

    @classmethod
    def build(cls, values: np.ndarray, scale: float = 1.0) -> "CMSketch":
        """values: non-null physical column (ints/floats). scale: inverse
        sampling rate to extrapolate counts."""
        sk = cls()
        if len(values) == 0:
            return sk
        uniq, counts = np.unique(values, return_counts=True)
        if len(uniq) > cls.TOPN:
            kth = np.argpartition(counts, -cls.TOPN)[-cls.TOPN:]
            # only counts clearly above average qualify as heavy hitters
            avg = len(values) / len(uniq)
            top_idx = kth[counts[kth] > 2 * avg]
        else:
            top_idx = np.arange(len(uniq))
        top_mask = np.zeros(len(uniq), dtype=bool)
        top_mask[top_idx] = True
        for i in top_idx:
            # .item(): exact python int/float key (floats must NOT be
            # truncated — distinct heavy hitters would collide)
            sk.topn[uniq[i].item()] = int(round(counts[i] * scale))
        rest_u, rest_c = uniq[~top_mask], counts[~top_mask]
        if len(rest_u):
            h = hash_any(rest_u)
            scaled = np.round(rest_c * scale).astype(np.int64)
            for d in range(cls.DEPTH):
                idx = ((h >> np.uint64((d + 1) * 12)) ^ h) % np.uint64(cls.WIDTH)
                np.add.at(sk.table[d], idx.astype(np.int64), scaled)
            sk.default = max(1, int(round(float(rest_c.mean()) * scale / 2)))
        return sk

    def query(self, value) -> int:
        if hasattr(value, "item"):
            value = value.item()  # numpy scalar -> python
        if value in self.topn:
            return self.topn[value]
        arr = np.array([value])
        h = hash_any(arr)
        est = None
        for d in range(self.DEPTH):
            idx = int(((h >> np.uint64((d + 1) * 12)) ^ h)[0]
                      % np.uint64(self.WIDTH))
            c = int(self.table[d][idx])
            est = c if est is None else min(est, c)
        return est if est and est > 0 else self.default


class FMSketch:
    """Flajolet-Martin NDV sketch (reference: statistics/fmsketch.go).

    The reference keeps a bounded hash set with a doubling mask; the
    vectorized equivalent: find the smallest k such that the count of
    distinct hashes divisible by 2^k fits the bound, then NDV ~= count<<k.
    """

    MAX_SIZE = 10000

    def __init__(self, ndv: int) -> None:
        self.ndv = ndv

    @classmethod
    def build(cls, values: np.ndarray) -> "FMSketch":
        """NDV of the given values (sample extrapolation is the caller's
        job — see StatsHandle.build_table's GEE-style scale-up)."""
        if len(values) == 0:
            return cls(0)
        h = np.unique(hash_any(np.unique(values)))
        k = 0
        while len(h) > cls.MAX_SIZE:
            k += 1
            h = h[(h & np.uint64((1 << k) - 1)) == 0]
        return cls(int(len(h) << k))
