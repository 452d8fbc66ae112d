"""Region model: key-range shards with epochs, splits, and a region cache.

Counterpart of the reference's region plumbing (reference:
store/tikv/region_cache.go:274 — LocateKey :538, epoch invalidation;
store/mockstore/mocktikv/cluster.go — Split, the in-process region
topology used by every multi-region test). Regions shard one shared MVCC
store in-process; RegionError surfaces stale routing exactly like TiKV's
epoch-not-match so client retry paths are exercised for real.

Port of `tidb_tpu/kv/region.py`, whole.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass
from typing import Optional

from .mvcc import MVCCStore, Mutation


class RegionError(Exception):
    """Stale region routing (epoch mismatch / key out of range) — the
    client must refresh its cache and retry (reference:
    region_request.go:599 onRegionError)."""


@dataclass
class Region:
    id: int
    start_key: bytes
    end_key: bytes  # b"" = +inf
    epoch: int = 1

    def contains(self, key: bytes) -> bool:
        return self.start_key <= key and (not self.end_key
                                          or key < self.end_key)


class RegionManager:
    """Authoritative region table (PD analog) + the per-region request
    gate. All regions serve the same underlying MVCCStore; the gate checks
    routing freshness, which is what distributes correctness."""

    def __init__(self, store: Optional[MVCCStore] = None) -> None:
        self.store = store if store is not None else MVCCStore()
        self._mu = threading.RLock()
        self._next_id = 2
        self._regions: dict[int, Region] = {1: Region(1, b"", b"")}
        # parallel sorted arrays: region start keys + their ids
        self._starts: list[bytes] = [b""]
        self._ids: list[int] = [1]

    # ---- PD-side API -------------------------------------------------------
    def locate(self, key: bytes) -> Region:
        with self._mu:
            i = bisect.bisect_right(self._starts, key) - 1
            r = self._regions[self._ids[i]]
            assert r.contains(key), (key, r)
            return Region(r.id, r.start_key, r.end_key, r.epoch)

    def split(self, split_key: bytes) -> tuple[Region, Region]:
        """Split the region containing split_key (reference:
        cluster.go Split; tikv split_region.go)."""
        with self._mu:
            old = self._region_for(split_key)
            if old.start_key == split_key:
                right = self._regions[old.id]
                return Region(right.id, right.start_key, right.end_key,
                              right.epoch), \
                    Region(right.id, right.start_key, right.end_key,
                           right.epoch)
            new_id = self._next_id
            self._next_id += 1
            right = Region(new_id, split_key, old.end_key)
            old.end_key = split_key
            old.epoch += 1
            self._regions[new_id] = right
            i = bisect.bisect_left(self._starts, split_key)
            self._starts.insert(i, split_key)
            self._ids.insert(i, new_id)
            return (Region(old.id, old.start_key, old.end_key, old.epoch),
                    Region(right.id, right.start_key, right.end_key,
                           right.epoch))

    def regions(self) -> list[Region]:
        with self._mu:
            return [Region(r.id, r.start_key, r.end_key, r.epoch)
                    for rid in self._ids
                    for r in (self._regions[rid],)]

    def _region_for(self, key: bytes) -> Region:
        i = bisect.bisect_right(self._starts, key) - 1
        return self._regions[self._ids[i]]

    # ---- store-side request gate ------------------------------------------
    def check_context(self, region_id: int, epoch: int,
                      keys: list[bytes]) -> None:
        with self._mu:
            r = self._regions.get(region_id)
            if r is None or r.epoch != epoch:
                raise RegionError(f"epoch not match for region {region_id}")
            for k in keys:
                if not r.contains(k):
                    raise RegionError(
                        f"key {k!r} not in region {region_id}")

    # ---- region-checked MVCC ops (the kv.Client surface) ------------------
    def prewrite(self, region: Region, mutations: list[Mutation],
                 primary: bytes, start_ts: int, ttl: int = 3000) -> None:
        self.check_context(region.id, region.epoch,
                           [m.key for m in mutations])
        self.store.prewrite(mutations, primary, start_ts, ttl)

    def commit(self, region: Region, keys: list[bytes], start_ts: int,
               commit_ts: int) -> None:
        self.check_context(region.id, region.epoch, keys)
        self.store.commit(keys, start_ts, commit_ts)

    def rollback(self, region: Region, keys: list[bytes],
                 start_ts: int) -> None:
        self.check_context(region.id, region.epoch, keys)
        self.store.rollback(keys, start_ts)

    def get(self, region: Region, key: bytes, read_ts: int):
        self.check_context(region.id, region.epoch, [key])
        return self.store.get(key, read_ts)

    # ---- resolver/read surface (no region gate: these route BY key) -------
    # The committer and LockResolver call these on whatever rm they were
    # built over; kv/rangeclient.py's RangeRouter implements the same
    # three names over cross-process RPC, which is what lets ONE
    # committer run against either tier.
    def check_txn_status(self, primary: bytes, lock_ts: int,
                         current_ts: int) -> tuple[int, bool]:
        return self.store.check_txn_status(primary, lock_ts, current_ts)

    def resolve_lock(self, key: bytes, start_ts: int,
                     commit_ts: int) -> None:
        self.store.resolve_lock(key, start_ts, commit_ts)

    def scan(self, start: bytes, end: bytes, read_ts: int,
             limit: int = -1) -> list[tuple[bytes, bytes]]:
        return self.store.scan(start, end, read_ts, limit)


def group_by_region(rm: RegionManager,
                    keys: list[bytes]) -> dict[int, tuple[Region, list]]:
    """Split keys into per-region groups (reference: 2pc.go:616
    groupMutations / coprocessor.go:248 buildCopTasks)."""
    groups: dict[int, tuple[Region, list]] = {}
    for k in keys:
        r = rm.locate(k)
        if r.id not in groups:
            groups[r.id] = (r, [])
        groups[r.id][1].append(k)
    return groups
