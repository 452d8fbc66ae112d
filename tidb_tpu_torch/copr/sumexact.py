"""Exact integer segment sums without 64-bit device arithmetic.

Port of `tidb_tpu/copr/sumexact.py`. The device programs stay 64-bit-free,
as in the reference, so that bounds, limb counts and therefore every gate
decide exactly as the reference decides:

    per-row int32 values -> int32[limbs, 2, segments] partials
    (every partial is exactly representable; the host recombines to int64)

* the value is split into signed 12-bit limbs (the arithmetic shift of the
  top limb keeps the sign; torch's `>>` on int32 is arithmetic, and every
  tensor here stays int32 so no promotion changes the split);
* each limb is summed per segment in float32 over blocks of <= 4096 rows,
  so every block partial is an integer < 2^24, exact in f32 whatever the
  summation order;
* block partials convert to int32, split at 2^12, and the halves sum in
  int32 over the block axis.

The host combines with int64 Horner: p = hi*4096 + lo per limb, then
value = sum_i p_i << (12*i).
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 12
_LIMB_MASK = (1 << LIMB_BITS) - 1
_L2 = 1 << LIMB_BITS  # second-level split base
BLOCK = 4096  # rows per exact f32 block: 4096 * (2^12-1) < 2^24
EINSUM_BLOCK = 2048  # rows per block of the einsum strategy


def _pad1(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    """Right-pad a 1-D tensor with `pad` copies of `value`."""
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), value, dtype=x.dtype,
                                    device=x.device)])


def limbs_of(v: torch.Tensor, n_limbs: int) -> list[torch.Tensor]:
    """Signed 12-bit limb decomposition of an int32 tensor.

    v == sum_i limbs[i] << (12*i); limbs 0..n-2 in [0, 4096), the top limb
    signed (arithmetic shift). All int32 ops.
    """
    out = []
    x = v
    for i in range(n_limbs):
        if i < n_limbs - 1:
            out.append(x & _LIMB_MASK)
            x = x >> LIMB_BITS
        else:
            out.append(x)
    return out


def _two_level(part: torch.Tensor) -> torch.Tensor:
    """f32[blocks, segments] exact-int partials -> int32[2, segments]."""
    p = part.to(torch.int32)
    return torch.stack([(p >> LIMB_BITS).sum(dim=0, dtype=torch.int32),
                        (p & _LIMB_MASK).sum(dim=0, dtype=torch.int32)])


def seg_sum_partials(
    v: torch.Tensor,
    seg: torch.Tensor,
    segments: int,
    n_limbs: int,
    strategy: str = "loop",
) -> torch.Tensor:
    """Exact per-segment sums of int32 v -> int32[n_limbs, 2, segments].

    seg: int32 segment id per row, -1 = excluded (masked/padded rows).
    "loop" takes one masked block reduction per segment; "einsum" (the
    reference's one-hot product, up to 8192 segments) scatter-adds each
    limb into f32[blocks of EINSUM_BLOCK rows, segments]. Both give the
    reference's partials: every block cell is an integer sum of at most
    4096 twelve-bit limbs, below 2^24, so f32 adds it exactly in any order,
    and the einsum form's memory is blocks x segments, not rows x segments.
    """
    n = v.shape[0]
    limbs = limbs_of(v, n_limbs)
    outs = []
    if strategy == "loop":
        # per-segment masked block sums
        nblk = -(-n // BLOCK)
        pad = nblk * BLOCK - n
        seg_b = _pad1(seg, pad, -1).reshape(nblk, BLOCK)
        for li in limbs:
            lb = _pad1(li.to(torch.float32), pad).reshape(nblk, BLOCK)
            per_seg = []
            for k in range(segments):
                # f32[nblk], exact: every block partial is below 2^24
                part = torch.where(seg_b == k, lb, 0.0).sum(dim=1)
                per_seg.append(_two_level(part[:, None])[:, 0])
            outs.append(torch.stack(per_seg, dim=-1))  # [2, segments]
    else:
        # excluded rows add 0 to cell 0: no negative index reaches the
        # scatter (a CUDA scatter with one kills the context)
        nblk = -(-n // EINSUM_BLOCK)
        live = seg >= 0
        blk = torch.arange(n, dtype=torch.int64, device=seg.device) \
            // EINSUM_BLOCK
        cell = torch.where(live, blk * segments + seg, 0)
        for li in limbs:
            part = torch.zeros(nblk * segments, dtype=torch.float32,
                               device=v.device)
            part.index_add_(0, cell, torch.where(live, li.to(torch.float32),
                                                 0.0))
            outs.append(_two_level(part.view(nblk, segments)))
    return torch.stack(outs)  # int32[n_limbs, 2, segments]


def merge_additive(vals) -> np.ndarray:
    """Sum per-tile additive partials host-side in int64 (hi/lo sums can
    exceed int32 once many tiles merge)."""
    return np.sum(np.stack([np.asarray(v).astype(np.int64) for v in vals]),
                  axis=0)


def combine_partials(p: np.ndarray) -> np.ndarray:
    """int32[n_limbs, 2, segments] -> int64[segments], exact.

    Horner over limbs of (hi*4096 + lo); intermediates stay within int64
    because the true total does.
    """
    p = np.asarray(p, dtype=np.int64)
    n_limbs = p.shape[0]
    total = np.zeros(p.shape[2], dtype=np.int64)
    for i in range(n_limbs - 1, -1, -1):
        total = total * (1 << LIMB_BITS) + (p[i, 0] * _L2 + p[i, 1])
    return total


def float_seg_sums(
    v: torch.Tensor,
    seg: torch.Tensor,
    segments: int,
    n_blocks: int = 32,
) -> torch.Tensor:
    """Blocked f32 per-segment sums -> f32[n_blocks, segments].

    The host sums the block partials in float64, so rounding error is
    confined within blocks of n/n_blocks rows.
    """
    n = v.shape[0]
    per = -(-n // n_blocks)
    pad = per * n_blocks - n
    vb = _pad1(v.to(torch.float32), pad).reshape(n_blocks, per)
    sb = _pad1(seg, pad, -1).reshape(n_blocks, per)
    outs = []
    for k in range(segments):
        outs.append(torch.where(sb == k, vb, 0.0).sum(dim=1))
    return torch.stack(outs, dim=1)  # [n_blocks, segments]


def combine_float(p: np.ndarray) -> np.ndarray:
    """f32[n_blocks, segments] -> f64[segments] (host f64 accumulate)."""
    return np.asarray(p, dtype=np.float64).sum(axis=0)
