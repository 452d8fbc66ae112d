"""High-cardinality group-by on the device: sorted runs + candidate buffer.

Port of `tidb_tpu/copr/hcagg.py`. The dense-segment aggregation caps at
8192 segments; this module serves GROUP BY over millions of groups when
the consumer keeps few of them (a TopN, a HAVING) or when the group count
fits the candidate buffer (all-groups mode):

1. rows sort lexicographically by the segment keys (`sort_by_keys`);
2. segment starts are key-change positions; each start's segment END is
   recovered with a suffix minimum over start indices (`segment_bounds`);
3. per-aggregate sums use the 12-bit-limb exactness scheme of sumexact.py
   as PREFIX sums: per limb an exact f32 in-block inclusive cumsum
   (< 2^24) plus int32 hi/lo cumsums of block totals; a segment's limb sum
   is the prefix difference between its end and start-1, an int32 pair
   (hi <= n/4096, lo < 2^25, value = hi*4096 + lo) that the host combines
   exactly into int64 (`seg_sum_pairs`);
4. the decode checks the candidate buffer (`candidate_blocks_sound`).

All device tensors stay int32 (torch.cumsum of int32 is given its dtype;
it would return int64 otherwise).
"""

from __future__ import annotations

import numpy as np
import torch

from . import sumexact as SE

_I32_MAX = 2**31 - 1

PREFIX_BLOCK = 4096  # in-block f32 cumsum stays < 2^24 for 12-bit limbs


def _blocked_prefix(limb: torch.Tensor):
    """Exact global inclusive prefix of a 12-bit-limb int32 tensor as
    (hi int32, lo_plus_inblock int32) with prefix = hi * 4096 + lo.
    hi <= n/4096, lo < 2^25."""
    n = limb.shape[0]
    nblk = -(-n // PREFIX_BLOCK)
    pad = nblk * PREFIX_BLOCK - n
    lb = SE._pad1(limb, pad).reshape(nblk, PREFIX_BLOCK)
    inblk = torch.cumsum(lb.to(torch.float32), dim=1)  # exact (< 2^24)
    totals = inblk[:, -1].to(torch.int32)
    # exclusive block prefixes, split at 2^12 to stay int32-exact
    t_hi = totals >> SE.LIMB_BITS
    t_lo = totals & ((1 << SE.LIMB_BITS) - 1)
    ex_hi = torch.cumsum(t_hi, 0, dtype=torch.int32) - t_hi
    ex_lo = torch.cumsum(t_lo, 0, dtype=torch.int32) - t_lo
    hi = ex_hi[:, None].expand(nblk, PREFIX_BLOCK).reshape(-1)[:n]
    lo = (ex_lo[:, None] + inblk.to(torch.int32)).reshape(-1)[:n]
    return hi, lo


def _prefix_at(hi, lo, idx):
    """Gather prefix pairs; idx == -1 means 'before row 0' -> (0, 0)."""
    safe = torch.clamp(idx, min=0)
    zero = idx < 0
    return (torch.where(zero, 0, hi[safe]), torch.where(zero, 0, lo[safe]))


def seg_sum_pairs(limb_sorted: torch.Tensor, starts: torch.Tensor,
                  ends: torch.Tensor):
    """Per-candidate exact limb sums over sorted segments as int32 pairs.

    starts/ends: candidate segment boundaries (row indices into the sorted
    order). Returns (hi_diff, lo_diff); value = hi*4096 + lo, exact."""
    hi, lo = _blocked_prefix(limb_sorted)
    ehi, elo = _prefix_at(hi, lo, ends)
    shi, slo = _prefix_at(hi, lo, starts - 1)
    return ehi - shi, elo - slo


def lexsort_perm(keys: list[torch.Tensor]) -> torch.Tensor:
    """Ascending lexicographic order over `keys` (most significant first),
    the position itself breaking full ties: a total order, as
    `lax.sort(keys + (iota,), num_keys=len(keys) + 1)`. Chained stable
    sorts from the least significant key up (torch has no multi-key
    sort)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def sort_by_keys(keys: list[torch.Tensor]):
    """Lexicographic sort of int32 keys; returns (sorted key tensors,
    permutation int64). Rows with equal keys keep their order, which the
    reference's sort does not promise and no result depends on: segment
    sums are order-free and every other group key is constant within a
    segment."""
    perm = lexsort_perm(keys)
    return [k[perm] for k in keys], perm


def _suffix_min(s: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix minimum via log-doubling shifts (the reference's
    form): 26 shifted elementwise minimums at 67M rows, where
    `torch.cummin` over the flipped tensor (a scan that also tracks
    indices) took 176 ms on an H100 (chip_smoke.py part c, PERF.md)."""
    d = 1
    n = s.shape[0]
    while d < n:
        s = torch.minimum(s, torch.cat([s[d:], s.new_full((d,), _I32_MAX)]))
        d *= 2
    return s


def candidate_blocks_sound(picked: np.ndarray, score: np.ndarray,
                           k: int, blocks: int) -> bool:
    """Soundness check for fetched candidate buffers, per candidate block
    (one block on a single device).

    A block whose buffer is NOT exhausted proves every group is a
    candidate. An exhausted block is sound only if the k-th best score
    strictly beats the buffer's worst: f32 scores order-embed the exact
    primary values, so a strict gap proves no non-candidate can reach the
    top-k; a tie at the boundary is ambiguous."""
    blocks = max(1, int(blocks))
    kb = len(picked) // blocks
    for b in range(blocks):
        pb = picked[b * kb:(b + 1) * kb]
        if not pb.all():
            continue
        sb = score[b * kb:(b + 1) * kb]
        if k >= kb or not (sb[k - 1] > sb[-1]):
            return False
    return True


def segment_bounds(sorted_keys: list[torch.Tensor], valid_row: torch.Tensor):
    """(is_start, end_idx int32) for the sorted order. valid_row marks rows
    that belong to some group (dropped rows sorted to the end are False)."""
    n = sorted_keys[0].shape[0]
    changed = torch.zeros(n, dtype=torch.bool, device=valid_row.device)
    changed[0] = True
    for k in sorted_keys:
        changed[1:] |= k[1:] != k[:-1]
    is_start = changed & valid_row
    iota = torch.arange(n, dtype=torch.int32, device=valid_row.device)
    # end of segment starting at i = (next start after i) - 1, where a
    # dropped row also terminates the last real segment
    boundary = is_start | ~valid_row
    s_idx = torch.where(boundary, iota, n)
    shifted = torch.cat([s_idx[1:], s_idx.new_full((1,), n)])
    nxt = _suffix_min(shifted)
    end_idx = torch.clamp(nxt - 1, max=n - 1)
    return is_start, end_idx
