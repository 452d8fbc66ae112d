"""Hash/range-partition exchange over the mesh: the all_to_all data plane.

Port of `tidb_tpu/parallel/exchange.py`. The reference's MPP tier has two
exchange modes, broadcast and hash partition (reference:
planner/core/fragment.go:45 ExchangeSender types, store/tikv/mpp.go:372
dispatch). Each shard slot buckets its rows by destination, lays them out
as an [n_dev, capacity] send buffer, and one `all_to_all` (the slot
runner's collective, `parallel/dist.py`) transposes the slot/bucket axes.
Shapes are fixed per dispatch: skew beyond the capacity sets an overflow
flag (psum'd to every slot) that the host turns into the reference's
typed route to its host tier, never a silent truncation.

Used by parallel/dist.py for:
* high-cardinality GROUP BY: route rows by group-key hash so every group
  lands wholly on one slot, then run the sorted-run candidate aggregation
  (copr/hcagg.py) on disjoint group partitions;
* partitioned (non-broadcast) joins: route probe rows by join key to the
  slot owning that key of the interleaved build shard.
"""

from __future__ import annotations

import torch

from .dist import all_to_all, note_routed, psum

_I32_SPAN = 1 << 32
_I32_HALF = 1 << 31


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its int32 two's-complement value (still int64)."""
    return ((x + _I32_HALF) & (_I32_SPAN - 1)) - _I32_HALF


def mix_hash(keys: list[torch.Tensor]) -> torch.Tensor:
    """Deterministic int32 mix of one or more int32 key arrays (same key
    tuple -> same value on every slot), with the reference's wrapping
    int32 arithmetic carried out exactly in int64."""
    h = torch.zeros_like(keys[0], dtype=torch.int64)
    for k in keys:
        h = _wrap32(h * -1640531527 + k.to(torch.int64))  # 0x9E3779B9
        h = h ^ (h >> 15)
    h = _wrap32(h * -2048144789)  # 0x85EBCA6B murmur mix
    h = h ^ (h >> 13)
    return h.to(torch.int32)


def abs32(h: torch.Tensor) -> torch.Tensor:
    """int32 absolute value with the reference's wrap (|INT32_MIN| is
    INT32_MIN), as int64."""
    return _wrap32(h.to(torch.int64).abs())


def capacity_for(m: int, n_dev: int, slack: float = 2.0) -> int:
    """Per-(slot, dest) send capacity: expected m/n_dev rows with slack.
    Overflow under adversarial skew is detected, not truncated."""
    c = int(m * slack) // n_dev + 1
    return max(64, min(c, m))


def route_cols(dest, cols, mask, axis: str, n_dev: int, capacity: int):
    """route_rows over a fragment column list: packs [(data, valid), ...]
    plus the row mask, routes, and unpacks. Shared by the group-partition
    (hc) and join-partition exchanges."""
    payload: list = [mask]
    for d, v in cols:
        payload.append(d)
        payload.append(v)
    recv, recv_valid, overflow = route_rows(dest, payload, axis, n_dev,
                                            capacity)
    new_mask = recv[0] & recv_valid
    new_cols = [(recv[1 + 2 * i], recv[2 + 2 * i]) for i in range(len(cols))]
    return new_cols, new_mask, overflow


def route_rows(dest: torch.Tensor, payload: list[torch.Tensor], axis: str,
               n_dev: int, capacity: int):
    """Send row i of every payload array to slot dest[i].

    Per-slot view (inside a slot program): dest int32[m] in [0, n_dev);
    payload arrays shaped [m]. Returns (recv_payload, recv_valid,
    overflow) where recv arrays are [n_dev * capacity] (concatenated by
    source slot), recv_valid marks real rows against padding, and
    overflow is a replicated int32 > 0 if ANY slot overflowed a bucket.

    The layout pass is gather-only: a stable sort by destination,
    `searchsorted` for each bucket's start, and indexing."""
    m = dest.shape[0]
    dev = dest.device
    # the routed-bytes account: the payload's m rows this slot sends
    note_routed(sum(x.numel() * x.element_size() for x in payload), axis)
    # stable sort by destination; perm brings payloads into dest order
    sd, perm = torch.sort(dest, stable=True)
    start = torch.searchsorted(
        sd, torch.arange(n_dev, dtype=dest.dtype, device=dev), side="left")
    ends = torch.cat([start[1:], start.new_full((1,), m)])
    counts = ends - start
    overflow = (counts > capacity).any()

    slots = torch.arange(n_dev * capacity, device=dev)
    d_idx = slots // capacity
    c_idx = slots % capacity
    src = torch.clamp(start[d_idx] + c_idx, 0, max(m - 1, 0))
    slot_valid = c_idx < counts[d_idx]
    order = perm[src]  # row space -> slot space in one gather index

    # row space -> slot space -> one all_to_all of every array; slot_valid
    # is ALREADY slot-space: no row-permutation gather
    sends = [x[order] for x in payload] + [slot_valid]
    recvs = all_to_all(
        [x.reshape((n_dev, capacity) + tuple(x.shape[1:])) for x in sends],
        axis)
    recvs = [r.reshape((n_dev * capacity,) + tuple(r.shape[2:]))
             for r in recvs]
    total_overflow = psum(overflow.to(torch.int32), axis)
    return recvs[:-1], recvs[-1], total_overflow


__all__ = ["abs32", "capacity_for", "mix_hash", "route_cols", "route_rows"]
