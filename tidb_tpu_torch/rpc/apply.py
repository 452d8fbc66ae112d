"""Follower apply engine: continuous WAL apply + closed timestamps.

Port of `tidb_tpu/rpc/apply.py`. A socket follower runs it by default
(`ReplicaReadState.enabled`); the read routing that consumes its closed
timestamp is `rpc/replica.py` (`try_route`, `serve_replica_read`). One
difference, kept on purpose: the loop
survives only `errors.survivable()` — a leader hiccup, a fenced or
conflicting fold. Any other error in a tick (the fold runs the
storage's columnar apply, a torch or CUDA error among the possible
ones) ends the loop and is kept as `error`; `close()` re-raises it.

The serving half of the follower-read tier (reference: TiFlash learner
replicas applying the raft log continuously + the closed-timestamp /
resolved-ts protocol that makes follower snapshot reads safe,
store/tikv follower read via ReadIndex). A follower mirrors the
leader's (snapshot, WAL) byte stream; its statements fold it into the
columnar epochs lazily, with a leader round-trip on the statement path.
This engine runs the SAME fold continuously in the background and —
crucially — tracks the highest timestamp the local replica is COMPLETE
at:

  * Each tick asks the leader for `closed_info`: a (wal_size, closed_ts)
    pair with the invariant that every commit whose commit_ts is at or
    below closed_ts has its WAL records inside the first wal_size
    bytes. The leader computes the pair under its commit lock, capping
    closed_ts below any remote commit timestamp that is still
    unpublished (the pending-commit ledger in rpc/server.py).
  * The tick then tails/folds the mirror to at least wal_size and
    adopts closed_ts as this replica's `applied_ts` — the fence the
    read router checks before sending a snapshot read here.
  * A read whose read_ts is above applied_ts WAITS (wait_for, the
    ReadIndex analog: kick a tick, block on the advance condition) up
    to a small bound instead of failing — a healthy replica closes a
    fresh leader timestamp within one round-trip.

Every heartbeat ping advertises (applied_ts, apply_lag_ms, serving,
load, term) so the leader's membership registry — and through it the
read router, information_schema.cluster_info and /status — always
knows which replicas can serve and how far behind they are.

Failpoint `replica/apply-stall` freezes the advance (the tick still
refreshes lag/heartbeat state) so tests can pin the staleness fence:
a stalled replica must cause a typed leader fallback, never a stale
answer.

Mirroring is never blocked: the fold path is the same refresh the
statement path already uses (MVCCStore serializes them), and a fold
failure only delays the NEXT advance — the byte mirror (the promotion
substrate) keeps its own cadence inside RemoteKV.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..kv.tso import _LOGICAL_BITS
from ..util import failpoint
from .errors import survivable


def ts_physical_ms(ts: int) -> int:
    """Physical milliseconds of a hybrid timestamp (the PD layout
    kv/tso.py owns; this module and rpc/replica.py convert through
    these two helpers only)."""
    return int(ts) >> _LOGICAL_BITS


def ts_at_physical_ms(ms: int) -> int:
    """The smallest hybrid timestamp at physical time `ms` (inverse of
    ts_physical_ms; the bounded-staleness read point)."""
    return max(0, int(ms)) << _LOGICAL_BITS


class ApplyEngine:
    """Background fold + closed-timestamp tracker for ONE follower
    Storage. Thread-light: one daemon thread, woken early by kick()
    (a replica read waiting for coverage) and joined by close()."""

    def __init__(self, storage, interval_ms: int = 200) -> None:
        self.storage = storage
        self.interval_ms = max(10, int(interval_ms))
        self._cv = threading.Condition()
        self.applied_ts = 0          # highest CLOSED ts fully applied
        self.applied_wal = 0         # WAL bytes folded at that ts
        self.last_advance = time.monotonic()
        self.ticks = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        # a non-survivable error that ended the loop (close re-raises)
        self.error: Optional[BaseException] = None
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="titpu-replica-apply", daemon=True)
        self._thread.start()

    # ---- the loop ----------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except survivable() as e:
                # a leader hiccup: the next tick retries
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {str(e)[:200]}"
            except Exception as e:
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {str(e)[:200]}"
                self.error = e
                return
            self._kick.wait(self.interval_ms / 1000.0)
            self._kick.clear()

    def tick(self) -> bool:
        """One apply round: fetch the leader's closed point, fold the
        mirror past it, adopt the closed ts. Returns True when the
        applied_ts advanced. Heartbeat/lag state refreshes either way,
        so a stalled replica reports its growing lag instead of its
        last healthy numbers."""
        storage = self.storage
        if not storage.remote or self._stop.is_set():
            return False
        advanced = False
        stalled = bool(failpoint.inject("replica/apply-stall"))
        try:
            if not stalled:
                client = storage._rpc_client
                r = client.call(
                    "closed_info",
                    _budget_ms=min(client.options.backoff_budget_ms,
                                   1000))
                target = int(r.get("wal_size", 0))
                closed = int(r.get("closed_ts", 0))
                # the same fold the statement path runs (kv.refresh +
                # columnar drain); MVCCStore serializes concurrent
                # callers
                storage.kv.refresh()
                storage._drain_refresh()
                eng = storage.kv.kv
                eng.sync_mirror()
                off = int(getattr(eng, "_applied_off", 0))
                if off >= target and closed > self.applied_ts:
                    with self._cv:
                        self.applied_ts = closed
                        self.applied_wal = off
                        self.last_advance = time.monotonic()
                        self._cv.notify_all()
                    advanced = True
        finally:
            # publish EVEN when the leader call raised: a replica whose
            # ticks keep failing must advertise its growing lag, not
            # its last healthy numbers — the router's freshness check
            # and the follower-apply-lag rule both read this
            self.ticks += 1
            self._publish()
        return advanced

    def _publish(self) -> None:
        """Refresh the gauge + the heartbeat's replica advertisement."""
        storage = self.storage
        lag_s = self.lag_ms() / 1000.0
        storage.obs.apply_lag.set(lag_s)
        client = storage._rpc_client
        if client is None:
            return
        gate = getattr(storage, "admission", None)
        load = 0
        if gate is not None:
            st = gate.stats()
            load = int(st.get("running", 0)) + int(st.get("queue_depth", 0))
        # REPLACE the dict (atomic assignment): the heartbeat thread
        # unpacks ping_params concurrently, and an in-place update that
        # adds keys could resize it mid-iteration
        client.ping_params = {
            **client.ping_params,
            "applied_ts": int(self.applied_ts),
            "apply_lag_ms": round(self.lag_ms(), 1),
            # serving is withheld until the FIRST successful sync: a
            # just-started replica's lag reads near zero (it is the
            # engine's age), and advertising it would draw routed
            # reads that can only burn the serve-side wait
            "serving": bool(storage.replica_read.enabled
                            and self.applied_ts > 0),
            "load": load,
            "term": int(client.term),
        }

    # ---- read-side fences --------------------------------------------------
    def lag_ms(self) -> float:
        """How far behind leader time the applied prefix is. Before the
        first successful tick this is merely the engine's age — which
        is why _publish withholds the serving flag until applied_ts
        moves (an un-synced replica must never look fresh to the
        router)."""
        if self.applied_ts <= 0:
            return (time.monotonic() - self.last_advance) * 1000.0
        return max(0.0, time.time() * 1000.0
                   - ts_physical_ms(self.applied_ts))

    def info(self) -> dict:
        """Snapshot for /debug/replicas and transport health."""
        return {
            "applied_ts": int(self.applied_ts),
            "applied_wal": int(self.applied_wal),
            "apply_lag_ms": round(self.lag_ms(), 1),
            "interval_ms": self.interval_ms,
            "ticks": self.ticks,
            "errors": self.errors,
            "last_error": self.last_error,
        }

    def wait_for(self, read_ts: int, timeout_s: float) -> bool:
        """Block until applied_ts covers read_ts (the ReadIndex analog:
        kick an immediate tick, then wait on the advance condition).
        Returns False when the bound expires — the caller answers with
        a typed staleness rejection and the router falls back."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self.applied_ts < read_ts:
                remain = deadline - time.monotonic()
                if remain <= 0 or self._stop.is_set():
                    return False
                self._kick.set()
                self._cv.wait(min(remain, 0.05))
        return True

    def close(self) -> None:
        self._stop.set()
        self._kick.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join()
        err, self.error = self.error, None
        if err is not None:
            raise err


__all__ = ["ApplyEngine", "ts_physical_ms", "ts_at_physical_ms"]
