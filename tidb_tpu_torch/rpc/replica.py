"""The follower read tier's per-storage settings.

Of `tidb_tpu/rpc/replica.py`, only `ReplicaReadState` is ported, with the
two fields the apply engine (`rpc/apply.py`) reads: a socket follower
runs it by default. Routing (`try_route`, the candidate choice, the row
codec), serving (`serve_replica_read`) and their settings
(`max_staleness_ms`, `prefer_follower`, `range_aware`) come with item 5b
of ROADMAP queue 1; until then `Config.seed_replica_read` raises
`NotInSlice` for those knobs away from their defaults, and so does a
session whose `tidb_replica_read` or `tidb_read_staleness` leaves the
leader default.
"""

from __future__ import annotations


class ReplicaReadState:
    """Per-storage replica-read settings. Field names/defaults MIRROR
    config.ReplicaReadConfig (the TOML owner; Config.seed_replica_read
    copies the knobs in) — mirrored rather than imported so an embedded
    Storage never parses config."""

    # master switch of the follower apply engine
    enabled: bool = True
    # follower apply-engine cadence (closed-ts fetch + columnar fold)
    apply_interval_ms: int = 200


__all__ = ["ReplicaReadState"]
