"""HLL sketches and ANALYZE's full-column statistics on the device.

Port of `tidb_tpu/copr/analyze.py`. One reduction per column and tile over
the same shape-bucketed tiles the query path stages (cached device columns
are reused) gives

  * the non-null row count,
  * min / max,
  * 256 HLL registers from a 32-bit splitmix hash (the device programs are
    64-bit-free in the reference) — the NDV estimator that replaces a host
    np.unique over the full column.

The same hash, bucket and rank serve APPROX_COUNT_DISTINCT's per-group
registers (`client.agg_partials`), and the host twins here
(`hash32_host`, `hll_bucket_rank_host`, `hll_group_registers_host`) give
the host interpreter bit-identical registers, so sketches from either side
merge.

What differs: the reference hashes in uint32 lanes. PyTorch's uint32 ops
are thin on CUDA, so the device hash works in int64 lanes holding the
uint32 value, multiplies by each constant's 16-bit halves (no product
leaves 2^49), and keeps the low 32 bits; the rank is an integer count of
trailing zeros where the reference takes an f32 log2 of the isolated low
bit (a power of two, so both are exact).
"""

from __future__ import annotations

import numpy as np
import torch

N_REG = 256         # HLL registers (2^8: ~6.5% standard error)
_REG_BITS = 8

# splitmix32-style avalanche (device-side; uint32 lanes)
_M1 = np.uint32(0x85EBCA6B)
_M2 = np.uint32(0xC2B2AE35)
_U32 = 0xFFFFFFFF
# (mask, weight) pairs of a power of two's bit index: bit k set in the
# index iff the power lies under the mask
_TZ_MASKS = ((0xAAAAAAAA, 1), (0xCCCCCCCC, 2), (0xF0F0F0F0, 4),
             (0xFF00FF00, 8), (0xFFFF0000, 16))


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 lanes holding uint32 values."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 of int32 lanes (their uint32 bit patterns) -> int64
    lanes holding the uint32 hash."""
    h = x.to(torch.int64) & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, int(_M1))
    h = h ^ (h >> 13)
    h = _mul32(h, int(_M2))
    return h ^ (h >> 16)


def hash32_host(x: np.ndarray) -> np.ndarray:
    """Host twin of the device hash (sketches built on either side must
    agree)."""
    with np.errstate(over="ignore"):
        h = x.astype(np.uint32)
        h ^= h >> 16
        h *= _M1
        h ^= h >> 13
        h *= _M2
        h ^= h >> 16
    return h


def hll_bucket_rank(v32: torch.Tensor):
    """Device (bucket, rank) per lane for HLL register updates: bucket =
    low 8 hash bits, rank = 1 + trailing zeros of the remaining bits.
    Shared by ANALYZE NDV and the APPROX_COUNT_DISTINCT aggregate so their
    sketches merge. -> (int64 bucket, int32 rank)."""
    h = _hash32(v32)
    bucket = h & (N_REG - 1)
    rest = (h >> _REG_BITS) | (1 << (32 - _REG_BITS))
    low = rest & -rest  # the lowest set bit, a power of two <= 2^24
    tz = torch.zeros_like(low)
    for mask, weight in _TZ_MASKS:
        tz = tz + ((low & mask) != 0).to(torch.int64) * weight
    return bucket, (tz + 1).to(torch.int32)


def hll_bucket_rank_host(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of hll_bucket_rank (bit-identical registers)."""
    h = hash32_host(x)
    bucket = (h & np.uint32(N_REG - 1)).astype(np.int32)
    rest = (h >> np.uint32(_REG_BITS)) | np.uint32(1 << (32 - _REG_BITS))
    low = rest & (~rest + np.uint32(1))
    rank = np.log2(low.astype(np.float64)).astype(np.int32) + 1
    return bucket, rank


def hll_group_registers(v32: torch.Tensor, seg: torch.Tensor,
                        segments: int) -> torch.Tensor:
    """Per-segment max-rank registers on the device: int32[segments,
    N_REG]. seg -1 marks rows that update nothing: their slot clamps to 0
    and their rank to 0, a no-op against the zero start (no negative index
    reaches the scatter)."""
    bucket, rank = hll_bucket_rank(v32)
    live = seg >= 0
    cell = torch.clamp(seg, min=0).to(torch.int64) * N_REG + bucket
    regs = torch.zeros(segments * N_REG, dtype=torch.int32,
                       device=v32.device)
    regs.scatter_reduce_(0, cell, torch.where(live, rank, 0), "amax")
    return regs.view(segments, N_REG)


def hll_hash_src_int(v: np.ndarray) -> np.ndarray:
    """uint32 hash input for integer values. The choice is PER ELEMENT:
    int32-range values use their low 32 bits (bit-identical to the device
    sketch), wider values fold their high 32 bits in (plain truncation
    would collide every pair differing only above bit 31). A per-batch
    choice would hash the same in-range value differently across partial
    producers (partitions/overlay), double-counting it in the register
    merge."""
    v = np.asarray(v).astype(np.int64)
    u = v.view(np.uint64)
    low = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    in_range = (v >= -(2 ** 31)) & (v < 2 ** 31)
    if in_range.all():
        return low
    folded = ((u ^ (u >> np.uint64(32))) &
              np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.where(in_range, low, folded)


def float_bits_key(x: np.ndarray) -> np.ndarray:
    """Canonical int64 bit-key for float64 values: -0.0 normalizes to
    0.0 so the two zero encodings compare equal."""
    norm = np.where(x == 0, 0.0, np.asarray(x, np.float64))
    return norm.view(np.int64)


def hll_group_registers_host(av: np.ndarray, avl: np.ndarray,
                             inv: np.ndarray, n_seg: int) -> np.ndarray:
    """Per-group HLL registers host-side: (n_seg, N_REG) int32 max-rank,
    bit-identical to the device scatter (`hll_group_registers`) so
    host-tier partials merge with device partials."""
    regs = np.zeros((n_seg, N_REG), np.int32)
    rows = np.nonzero(avl)[0]
    if len(rows):
        bucket, rank = hll_bucket_rank_host(av[rows])
        np.maximum.at(regs, (inv[rows], bucket), rank)
    return regs


def hll_pack_words(regs: np.ndarray) -> np.ndarray:
    """(n, N_REG) int32 registers -> (n, N_REG // 8) int64 byte-packed."""
    regs = regs.astype(np.int64)
    words = np.zeros((regs.shape[0], N_REG // 8), np.int64)
    for w in range(N_REG // 8):
        for b in range(8):
            words[:, w] |= regs[:, w * 8 + b] << (8 * b)
    return words


def hll_unpack_words(words: np.ndarray) -> np.ndarray:
    """(n, N_REG // 8) int64 byte-packed -> (n, N_REG) int32 registers."""
    out = np.zeros((words.shape[0], N_REG), np.int32)
    for w in range(words.shape[1]):
        for b in range(8):
            out[:, w * 8 + b] = (words[:, w] >> (8 * b)) & 0xFF
    return out


def _column_partials(data: torch.Tensor, valid: torch.Tensor) -> dict:
    """Reduction body for one staged column (int32/f32 after widening, or
    bool) and its row mask: count, min, max and the 256 registers."""
    v32 = data.to(torch.int32) if data.dtype == torch.bool else data
    cnt = valid.sum(dtype=torch.int32)
    if v32.is_floating_point():
        mn = torch.where(valid, v32, float("inf")).min()
        mx = torch.where(valid, v32, float("-inf")).max()
        hsrc = v32.view(torch.int32)  # the f32 bit pattern
    else:
        mn = torch.where(valid, v32, 2**31 - 1).min()
        mx = torch.where(valid, v32, -(2**31)).max()
        hsrc = v32
    regs = hll_group_registers(hsrc, torch.where(valid, 0, -1), 1)[0]
    return {"cnt": cnt, "mn": mn, "mx": mx, "regs": regs}


def _merge(parts: list[dict]) -> dict:
    out = dict(parts[0])
    for p in parts[1:]:
        out["cnt"] = out["cnt"] + p["cnt"]
        out["mn"] = np.minimum(out["mn"], p["mn"])
        out["mx"] = np.maximum(out["mx"], p["mx"])
        out["regs"] = np.maximum(out["regs"], p["regs"])
    return out


def hll_ndv(regs: np.ndarray, nonnull: float) -> int:
    """Standard HLL estimate with small-range correction."""
    m = float(N_REG)
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(
        N_REG, 0.7213 / (1 + 1.079 / m))
    regs = np.asarray(regs, dtype=np.float64)
    est = alpha * m * m / np.sum(np.exp2(-regs))
    zeros = float((regs == 0).sum())
    if est <= 2.5 * m and zeros > 0:
        est = m * np.log(m / zeros)
    return max(1, min(int(round(est)), int(nonnull)))


def device_column_stats(cop, snap, offsets: list[int]) -> dict:
    """off -> (nonnull_count, min, max, ndv) via one reduction per column
    and tile, reusing the query path's cached tile staging. Columns whose
    staged width cannot represent the values (host int64 beyond int32) are
    skipped — the caller keeps host stats for those."""
    from ..plan.dag import CopDAG, DAGScan
    from .client import fetch, widen32

    usable = []
    for off in offsets:
        if snap.epoch.columns[off].dtype == np.int64:
            b = cop._col_stats(snap, off)
            if b is None or b[0] < -(2**31) or b[1] >= 2**31:
                continue
        usable.append(off)
    if not usable:
        return {}
    tiles = cop._stage_tiles(CopDAG(scan=DAGScan(snap.store.table.id,
                                                 usable)), snap)
    outs = []
    for ci in range(len(usable)):
        devs = []
        for cols, vis, _ in tiles:
            (d, v), = widen32([cols[ci]])
            devs.append(_column_partials(d, v & vis))
        outs.append(fetch(devs))
    result = {}
    for ci, off in enumerate(usable):
        p = _merge(outs[ci])
        nonnull = float(p["cnt"])
        result[off] = (nonnull, p["mn"], p["mx"],
                       hll_ndv(p["regs"], nonnull) if nonnull else 0)
    return result
