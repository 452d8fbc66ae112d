"""Run-ordered segmented sums: `rank_sums` and its host metadata.

Port of `tidb_tpu/copr/streamseg.py`. When storage order already groups
the GROUP BY key (fact tables clustered by their key), every group is one
contiguous run and the aggregation is a rank-space reduction:

    rank(row)   = number of key changes up to the row   (host-precomputed)
    out[k, r]   = sum of vals[k, row] over rows with rank(row) == r

`rank_meta` computes the change flags once per epoch on the host (a copy
of the reference, including the fields only the TPU kernel used, so that
the two dicts compare equal and gate identically). `rank_sums` launches
the hand-written CUDA kernel (`csrc/streamseg.cu`, bound in
`_kernels.py`) for a CUDA tensor and runs `rank_sums_plain`, the plain
PyTorch version of the same function, for a CPU tensor.

Exactness: the values are integers (12-bit limbs, 0/1 masks) and, under
the MAX_ROWS_PER_KEY gate, every per-rank partial and total is below
2^24, so f32 sums are exact in any order and the kernel equals the plain
version bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

BLK = 1024     # rows per inner block of the TPU kernel (one-hot extent)
B = 16         # inner blocks per TPU grid step
MAX_ROWS_PER_KEY = 4096   # f32 exactness: rows_per_key * (2^12-1) < 2^24
MAX_ARRAYS = 8  # K cap


def _r128(x: int) -> int:
    return (-(-x // 128)) * 128


def rank_meta(key_cols: list[np.ndarray]):
    """Host-side per-epoch metadata from the raw (lexicographically
    run-ordered) key column(s). Pad rows added by staging keep the last
    rank; their values are query-masked to zero.

    Returns None when a gate fails (too many rows in one key)."""
    n0 = len(key_cols[0])
    if n0 == 0:
        return None
    chg = np.zeros(n0, dtype=bool)
    for k in key_cols:
        chg[1:] |= k[1:] != k[:-1]
    r0 = np.flatnonzero(np.concatenate([[True], chg[1:n0]])).astype(
        np.int32)
    nd = len(r0)
    seg_rows = np.diff(np.concatenate([r0, [n0]]))
    if len(seg_rows) and seg_rows.max() > MAX_ROWS_PER_KEY:
        return None
    f = np.zeros(n0, dtype=np.int32)
    f[1:] = chg[1:]
    # widest per-inner-block rank count (drove the TPU kernel's one-hot
    # width; kept so the metadata and its cache signature match)
    nblk0 = -(-n0 // BLK)
    fb = np.zeros(nblk0 * BLK, dtype=np.int64)
    fb[:n0] = f
    maxd = int(fb.reshape(nblk0, BLK).sum(axis=1).max()) + 1
    ohw = _r128(maxd + 2) + 128
    F = _r128(B * maxd + 2)
    wstep = 2 * F + ohw + 256
    nd_pad = max(_r128(nd), 128)
    out_pad = nd_pad + wstep + F
    r0_pad = np.zeros(nd_pad, dtype=np.int32)
    r0_pad[:nd] = r0
    return {
        "n0": n0, "nd": nd,
        "nd_pad": nd_pad, "out_pad": out_pad, "maxd": maxd, "ohw": ohw,
        "flush": F, "wstep": wstep, "f": f, "r0": r0_pad,
        "identity": nd == n0,
    }


def rank_sums_plain(vals: torch.Tensor, f: torch.Tensor, nd: int,
                    nd_pad: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: cumsum of the change flags,
    then one index_add_ into zeros. vals f32[K, n]; f int32[len <= or >
    n] (missing flags are 0). -> f32[K, nd_pad], ranks >= nd zeroed."""
    n = vals.shape[1]
    if f.shape[0] < n:
        f = torch.cat([f, f.new_zeros(n - f.shape[0])])
    rank = torch.cumsum(f[:n], dim=0)
    keep = (rank >= 0) & (rank < nd)
    out = torch.zeros(vals.shape[0], nd_pad, dtype=torch.float32,
                      device=vals.device)
    out.index_add_(1, rank[keep], vals[:, keep])
    return out


def rank_sums(vals: torch.Tensor, f_dev: torch.Tensor, meta) -> torch.Tensor:
    """vals: f32[K, n_pad] query-masked integer-valued arrays.
    -> f32[K, nd_pad] per-rank sums (exact integers; entries at ranks
    >= nd are zeroed).

    CUDA tensors launch the streamseg kernel; CPU tensors take
    `rank_sums_plain`. The identity case (one row per rank) is a slice
    on either device, as in the reference."""
    nd, nd_pad = meta["nd"], meta["nd_pad"]
    if meta["identity"]:
        flat = vals[:, :nd_pad]
        if flat.shape[1] < nd_pad:
            flat = torch.cat([flat, flat.new_zeros(
                (flat.shape[0], nd_pad - flat.shape[1]))], dim=1)
        live = torch.arange(nd_pad, device=vals.device) < nd
        return torch.where(live[None, :], flat, 0.0)
    if vals.is_cuda:
        return _kernels.streamseg_rank_sums(vals, f_dev, nd, nd_pad)
    if vals.device.type != "cpu":
        raise ValueError(f"rank_sums: no kernel for device {vals.device}")
    return rank_sums_plain(vals, f_dev, nd, nd_pad)
