"""Timestamp oracle: hybrid physical/logical timestamps.

Equivalent of PD's TSO service (reference: oracle/oracles/local.go for the
single-node oracle). Timestamps use PD's layout — physical milliseconds
<< 18 | logical counter — because the MVCC tier derives lock TTL expiry
from `now_ts - lock_ts > ttl << 18` (reference: oracle.ExtractPhysical).
start_ts/commit_ts ordering is the basis of snapshot-isolation visibility
in the MVCC store.

Port of the in-process `TimestampOracle` of `tidb_tpu/kv/tso.py`. The
reference's `RemoteTSO` (RPC followers) and `SharedTSO` (several processes
over one directory) belong to the multi-process planes: not ported.
"""

from __future__ import annotations

import threading
import time

_LOGICAL_BITS = 18


class TimestampOracle:
    def __init__(self, floor: int = 0) -> None:
        """`floor`: restart lower bound — every issued ts is > floor
        (recovery passes the persisted lease so timestamps never repeat
        across restarts even under clock skew; reference analog: PD's
        persisted TSO window, oracle/oracles/pd.go). Multi-process
        deployments use `SharedTSO` instead (one allocator, strict SI)."""
        self._lock = threading.Lock()
        self._physical = floor >> _LOGICAL_BITS
        self._logical = floor & ((1 << _LOGICAL_BITS) - 1)

    def next_ts(self) -> int:
        with self._lock:
            physical = int(time.time() * 1000)
            if physical <= self._physical:
                self._logical += 1
                if self._logical >= (1 << _LOGICAL_BITS):
                    # logical space exhausted within one millisecond:
                    # borrow the next physical tick
                    self._physical += 1
                    self._logical = 0
            else:
                self._physical = physical
                self._logical = 0
            return (self._physical << _LOGICAL_BITS) | self._logical

    def observe(self, ts: int) -> None:
        """Advance past an externally observed timestamp so every
        timestamp we issue afterwards is strictly greater — required for
        observed commits to be VISIBLE to our snapshots
        (commit_ts <= read_ts)."""
        with self._lock:
            phys = ts >> _LOGICAL_BITS
            logi = ts & ((1 << _LOGICAL_BITS) - 1)
            if phys < self._physical:
                return
            if phys > self._physical:
                self._physical = phys
                self._logical = 0
            if logi > self._logical:
                self._logical = logi

    # the 2PC committer's oracle interface (kv/twopc.py TSO protocol)
    def ts(self) -> int:
        return self.next_ts()

    def current(self) -> int:
        with self._lock:
            return (self._physical << _LOGICAL_BITS) | self._logical
