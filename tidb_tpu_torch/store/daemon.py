"""Background maintenance: GC, lock-TTL resolution, auto-analyze, checkpoints.

Port of `tidb_tpu/store/daemon.py`. Counterpart of the reference's
background loops: the GC worker (reference: store/tikv/gcworker/
gc_worker.go:95 leader-elected tick, :241 resolve-locks-then-GC
ordering), lock TTL expiry via the resolver (store/tikv/lock_resolver.go),
auto-analyze (statistics/handle/update.go:860), and periodic engine
checkpointing.

The worker is tick-driven so tests call `tick()` deterministically;
`start()` wraps it in a daemon thread for servers. The GC safepoint is
`min(now - gc_life, oldest active snapshot)` — active snapshots are
registered on Storage (storage.py safe_ts), which is exactly the
safepoint-vs-active-txn protection the reference gets from PD's
safepoint service + the MinStartTS reports.

One difference from the reference, kept on purpose: the reference's loop
swallows every exception of a tick. Here the loop goes on only past the
port's own KV and transaction errors (`WOUNDED`: a lock owner racing the
resolver, a conflict with a live writer), which are the wounded pass the
reference means. Any other exception, a torch or CUDA error among them,
ends the loop and is kept on the worker; `stop()` re-raises it, so a
server's shutdown fails with it instead of hiding it.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Optional

from ..kv.backoff import BackoffExhausted
from ..kv.mvcc import KVError
from ..kv.region import RegionError
from ..kv.twopc import CommitError
from ..util import failpoint

# the errors of a wounded maintenance pass: the next tick sweeps again
WOUNDED = (KVError, RegionError, CommitError, BackoffExhausted)


def parse_duration(s: str, default_s: float = 600.0) -> float:
    """'10m', '1h30m', '45s', '500ms' -> seconds (Go duration subset,
    the format tidb_gc_life_time uses)."""
    if not s:
        return default_s
    s = str(s).strip()
    try:
        return float(s)  # bare number = seconds
    except ValueError:
        pass
    total = 0.0
    found = False
    for num, unit in re.findall(r"([0-9.]+)(ms|s|m|h|d)", s):
        total += float(num) * {"ms": 1e-3, "s": 1, "m": 60, "h": 3600,
                               "d": 86400}[unit]
        found = True
    return total if found else default_s


class MaintenanceWorker:
    """One tick = resolve expired locks -> GC at the safepoint ->
    compact + checkpoint -> auto-analyze. Owned by a Storage."""

    def __init__(self, storage, catalog=None) -> None:
        self.storage = storage
        self.catalog = catalog
        self.last_safepoint = 0
        self.gc_removed_total = 0
        self.locks_resolved_total = 0
        self.auto_analyzed: list[str] = []
        # auto-analyze cadence floor (performance.stats-lease seeds
        # it; 0 = analyze on every tick, the embedded/test default)
        self.stats_lease_s = 0.0
        self._last_analyze = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # what ended the loop, re-raised by stop()
        self._error: Optional[BaseException] = None

    # ---- components (also individually test-callable) -----------------
    def resolve_expired_locks(self) -> int:
        """Roll expired orphan locks forward/back from the primary's fate
        (reference: gc_worker.go:241 resolveLocks phase before DoGC —
        GC must not run under locks older than the safepoint)."""
        from ..kv.twopc import LockResolver

        resolver = LockResolver(self.storage.rm, self.storage.tso)
        n = 0
        now = self.storage.tso.next_ts()
        for lock in self.storage.kv.all_locks():
            expired = now - lock.start_ts > (lock.ttl << 18)
            if not expired:
                continue
            try:
                if resolver.resolve(lock):
                    n += 1
            except WOUNDED:
                continue  # lock owner raced us; next tick sweeps again
        self.locks_resolved_total += n
        return n

    def _duration_var(self, name: str, default: str) -> float:
        v = self.storage.sysvars.get_global(name)
        return parse_duration(default if v is None else str(v))

    def gc_safepoint(self) -> int:
        """min(now - tidb_gc_life_time, oldest active snapshot)."""
        life_s = self._duration_var("tidb_gc_life_time", "10m")
        horizon = self.storage.tso.current() - (int(life_s * 1000) << 18)
        return max(0, min(horizon, self.storage.safe_ts()))

    def run_gc(self) -> int:
        """MVCC version GC + columnar compaction at the safepoint
        (reference: gc_worker.go DoGC). Never moves backwards."""
        sp = self.gc_safepoint()
        if sp <= self.last_safepoint:
            return 0
        failpoint.inject("daemon/before-gc")
        removed = self.storage.kv.gc(sp)
        for store in list(self.storage.tables.values()):  # DDL may race
            store.maybe_compact(sp)
        self.last_safepoint = sp
        self.gc_removed_total += removed
        return removed

    def run_auto_analyze(self) -> list[str]:
        if self.catalog is None:
            return []
        if self.stats_lease_s > 0:
            now = time.monotonic()
            if now - self._last_analyze < self.stats_lease_s:
                return []
            self._last_analyze = now
        names = self.storage.stats.auto_analyze(self.storage, self.catalog)
        self.auto_analyzed.extend(names)
        return names

    def run_checkpoint(self) -> None:
        """Persist dirty epochs + fold the KV WAL (durable stores only).
        The WAL folds unconditionally: meta-plane writes (sysvars, stats,
        DDL jobs) dirty no epoch but still grow it, and crash recovery
        replays whatever is left unfolded."""
        self.storage.checkpoint(dirty_only=True)

    def tick(self) -> dict:
        # GC runs on the elected owner only (reference: the GC worker is
        # leader-elected, gc_worker.go:95); lock resolution,
        # auto-analyze and checkpointing of THIS process's dirty state
        # are per-process work and never skip
        owner = getattr(self.storage, "gc_owner", None)
        locks = self.resolve_expired_locks()
        removed = 0
        if owner is None or owner.try_campaign():
            try:
                removed = self.run_gc()
            finally:
                if owner is not None:
                    owner.resign()
        analyzed = self.run_auto_analyze()
        self.run_checkpoint()
        return {"locks_resolved": locks, "gc_removed": removed,
                "auto_analyzed": analyzed}

    # ---- thread lifecycle ----------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        """interval_s=None re-reads tidb_gc_run_interval every cycle, so
        SET GLOBAL takes effect without a restart (reference: gc_worker
        re-reads its interval each tick)."""
        if self._thread is not None:
            return

        def interval() -> float:
            if interval_s is not None:
                return interval_s
            return max(1.0, self._duration_var("tidb_gc_run_interval",
                                               "10m"))

        def loop() -> None:
            while not self._stop.wait(interval()):
                try:
                    self.tick()
                except WOUNDED:
                    # a wounded maintenance pass must not kill the loop
                    # (reference: gc_worker logs and continues)
                    continue
                except BaseException as e:  # noqa: BLE001 — kept for stop()
                    self._error = e
                    return

        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(target=loop, name="titpu-maint",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop and join the loop, waiting out a tick in progress however
        long it takes (the store closes only after it); re-raise what
        ended the loop, if anything but a wounded pass did."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err


__all__ = ["MaintenanceWorker", "WOUNDED", "parse_duration"]
