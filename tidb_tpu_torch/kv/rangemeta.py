"""Range descriptors: the keyspace split into leader-sharded ranges.

A RangeSpec is the unit of write leadership: a half-open key interval
[start_key, end_key) with a routing-table epoch. The range TABLE (the
ordered list of specs) is the cluster's authoritative metadata — the
PD region-table analog (reference: store/tikv/region_cache.go:274
keeps the client copy; pd owns the truth). rpc/ranged.py persists it
as `ranges/meta.json` under the shared durable root and bumps a
range's epoch whenever its metadata or leadership generation changes;
clients carrying an older epoch are answered with EpochNotMatchError
and reload.

Key routing is plain byte comparison on the encoded KV keys — the same
keys kv/region.py routes in-process — so one committer can run against
either tier.

Port of `tidb_tpu/kv/rangemeta.py`, whole.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass


@dataclass
class RangeSpec:
    id: int
    start_key: bytes
    end_key: bytes  # b"" = +inf
    epoch: int = 1

    def contains(self, key: bytes) -> bool:
        return self.start_key <= key and (not self.end_key
                                          or key < self.end_key)

    def to_wire(self) -> dict:
        return {"id": int(self.id), "start": self.start_key,
                "end": self.end_key, "epoch": int(self.epoch)}

    @staticmethod
    def from_wire(d: dict) -> "RangeSpec":
        return RangeSpec(int(d["id"]), bytes(d["start"]),
                         bytes(d["end"]), int(d.get("epoch", 1)))


def split_keyspace(count: int = 1,
                   split_points: list = ()) -> list[RangeSpec]:
    """The initial range table from the [ranges] knobs. Explicit split
    points (strings, encoded utf-8, or bytes) win; otherwise `count`
    ranges split the single-byte prefix space evenly — coarse on
    purpose: table-prefixed keys (catalog/codec) hash across prefixes,
    and real split points come from the knob when a workload needs
    them. Always covers the whole keyspace ([b'', +inf))."""
    points: list[bytes] = []
    for p in split_points:
        b = p.encode("utf-8") if isinstance(p, str) else bytes(p)
        if b:
            points.append(b)
    if not points and count > 1:
        count = min(int(count), 256)
        step = 256 // count
        points = [bytes([min(i * step, 255)])
                  for i in range(1, count)]
    points = sorted(set(points))
    bounds = [b""] + points + [b""]
    return [RangeSpec(i + 1, bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)]


def locate_spec(specs: list[RangeSpec], key: bytes) -> RangeSpec:
    """The spec containing key — specs must be the full sorted table
    (split_keyspace output order)."""
    starts = [s.start_key for s in specs]
    i = bisect.bisect_right(starts, key) - 1
    s = specs[i]
    assert s.contains(key), (key, s)
    return s


def split_spec(parent: RangeSpec, split_key: bytes,
               child_id: int) -> tuple[RangeSpec, RangeSpec]:
    """One online split's table delta: the parent keeps its id as the
    LEFT child [start, split_key) (so its metric/heat series never
    turns into a phantom id), a fresh id takes [split_key, end), and
    BOTH carry epoch parent+1 — any request stamped with the parent's
    pre-split epoch is answered EpochNotMatchError and re-routes
    (reference: the region-split epoch bump, region_cache.go:274)."""
    if not (parent.start_key < split_key
            and (not parent.end_key or split_key < parent.end_key)):
        raise ValueError(
            f"split key {split_key!r} not strictly inside "
            f"[{parent.start_key!r}, {parent.end_key!r})")
    if int(child_id) == int(parent.id):
        raise ValueError("child id must differ from the parent's")
    epoch = int(parent.epoch) + 1
    left = RangeSpec(parent.id, parent.start_key, split_key, epoch)
    right = RangeSpec(int(child_id), split_key, parent.end_key, epoch)
    return left, right


def table_gaps(specs: list[RangeSpec]) -> list[str]:
    """Coverage defects in a (sorted) range table: gaps, overlaps, a
    missing -inf/+inf edge, duplicate ids. Empty list = the table
    covers the whole keyspace exactly once — the invariant every
    split must preserve and the chaos suite asserts after a kill."""
    out: list[str] = []
    if not specs:
        return ["empty table"]
    specs = sorted(specs, key=lambda s: s.start_key)
    ids = [s.id for s in specs]
    if len(set(ids)) != len(ids):
        out.append(f"duplicate range ids: {sorted(ids)}")
    if specs[0].start_key != b"":
        out.append(f"keyspace starts at "
                   f"{specs[0].start_key!r}, not -inf")
    if specs[-1].end_key != b"":
        out.append(f"keyspace ends at {specs[-1].end_key!r}, not +inf")
    for a, b in zip(specs, specs[1:]):
        if not a.end_key or a.end_key > b.start_key:
            out.append(f"r{a.id}/r{b.id} overlap at "
                       f"{b.start_key!r}")
        elif a.end_key < b.start_key:
            out.append(f"gap between r{a.id} and r{b.id}: "
                       f"[{a.end_key!r}, {b.start_key!r})")
    return out


__all__ = ["RangeSpec", "split_keyspace", "locate_spec", "split_spec",
           "table_gaps"]
