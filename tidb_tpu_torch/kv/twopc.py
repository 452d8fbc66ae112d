"""Two-phase percolator commit + lock resolver + TSO-driven snapshots.

Counterpart of the reference's twoPhaseCommitter (reference:
store/tikv/2pc.go:78 — execute :1050, region-grouped batches :616,670,
primary-first commit :730-761) and LockResolver (reference:
store/tikv/lock_resolver.go — check primary txn status, roll
forward/backward). In-process regions replace gRPC; the retry loop against
RegionError and KeyIsLocked is the same control flow the reference runs
against real TiKV.

Port of `tidb_tpu/kv/twopc.py` over the in-process region tier, with the
reference's four failpoint sites (`twopc/before-prewrite`,
`twopc/after-prewrite`, `twopc/before-commit-primary`,
`twopc/after-primary-commit`), its TRACE spans (`twopc.prewrite`,
`twopc.commit`, `twopc.commit_primary`, `twopc.commit_secondary`), its
typed waits (`prewrite`, `tso_wait`, `commit_primary`,
`commit_secondary`, `resolve_lock`, `backoff.txnLock`) and the
`orphan_resolved` event. The keyspace heatmap and the range tier's
cross-range commit fan-out have no port yet: their hooks are left out,
and the control flow between them is the reference's.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import obs
from ..util import failpoint
from .mvcc import OP_LOCK, KeyIsLockedError, KVError, Mutation
from .region import Region, RegionError, RegionManager


class TSO:
    """Monotonic timestamp oracle (reference: oracle/oracles/pd.go —
    physical<<18 | logical layout; local twin oracle/oracles/local.go)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._last_physical = 0
        self._logical = 0

    def ts(self) -> int:
        with self._mu:
            physical = int(time.time() * 1000)
            if physical <= self._last_physical:
                physical = self._last_physical
                self._logical += 1
            else:
                self._last_physical = physical
                self._logical = 0
            return (physical << 18) | self._logical


class CommitError(Exception):
    errno = 9007  # ER_WRITE_CONFLICT (tidb_tpu/errno.py)
    sqlstate = "HY000"


class LockResolver:
    """Resolves locks left by crashed/slow transactions (reference:
    store/tikv/lock_resolver.go ResolveLocks)."""

    def __init__(self, rm: RegionManager, tso: TSO,
                 events=None) -> None:
        self.rm = rm
        self.tso = tso
        # optional structured EventLog sink: every orphan actually
        # rolled forward or back is recorded there
        self.events = events

    def resolve(self, lock) -> bool:
        """True if the lock was cleared (caller may retry immediately).

        Goes through the rm-level resolver surface, not rm.store: over
        the range tier (kv/rangeclient.py) the primary's status lives on
        ANOTHER range's leader, so the status check and the resolve are
        two routed calls — exactly how a peer rolls a crashed
        coordinator's orphans forward/backward."""
        with obs.wait("resolve_lock"):
            commit_ts, done = self.rm.check_txn_status(
                lock.primary, lock.start_ts, self.tso.ts())
            if not done:
                return False  # lock holder still alive; caller backs off
            self.rm.resolve_lock(lock.key, lock.start_ts, commit_ts)
        if self.events is not None:
            action = "roll-forward" if commit_ts else "roll-back"
            self.events.record(
                "orphan_resolved",
                detail=f"{action} key={lock.key!r} "
                       f"primary={lock.primary!r} "
                       f"start_ts={lock.start_ts} commit_ts={commit_ts} "
                       "trace_id=")
        return True


@dataclass
class TwoPhaseCommitter:
    rm: RegionManager
    tso: TSO
    lock_ttl: int = 3000
    max_retries: int = 12
    # how long a commit waits on someone else's (live) lock before giving
    # up — pessimistic txns hold locks for arbitrary user-paced durations,
    # so this is time-based, unlike the count-based region retries
    # (reference: backoff.go txnLockFastBackoff with a total budget)
    lock_wait_timeout_s: float = 50.0
    # structured EventLog sink for orphan resolutions (the storage
    # passes its obs.events; bare committers audit nothing)
    events: Optional[object] = None

    def commit(self, mutations: list[Mutation], start_ts: int) -> int:
        """Run 2PC; returns commit_ts (reference: 2pc.go execute :1050)."""
        if not mutations:
            return start_ts
        state = self.prewrite_phase(mutations, start_ts)
        return self.commit_phase(state, start_ts)

    def prewrite_phase(self, mutations: list[Mutation], start_ts: int):
        """Phase 1 only. This is where commit blocks on other txns' locks
        (possibly for the whole lock-wait timeout), so callers must NOT
        hold serializing locks across it — the storage runs it outside
        its commit lock (the reference has no such global lock; its fold
        equivalent is TiFlash's async raft apply)."""
        with obs.wait("prewrite"), obs.span("twopc.prewrite") as sp:
            if sp:
                sp.note = f"{len(mutations)} keys"
            return self._prewrite_phase(mutations, start_ts)

    def _prewrite_phase(self, mutations: list[Mutation], start_ts: int):
        resolver = LockResolver(self.rm, self.tso, events=self.events)
        mutations = sorted(mutations, key=lambda m: m.key)
        # the primary must leave a write record: a lock-only (OP_LOCK)
        # primary would give crash recovery nothing to roll forward from
        # (reference: 2pc.go primary selection skips lock-only keys)
        primary = next((m.key for m in mutations if m.op != OP_LOCK),
                       mutations[0].key)

        # prewrite grouped by region, primary's batch first
        # (reference: 2pc.go:730 prewrite primary first for async recovery)
        failpoint.inject("twopc/before-prewrite")
        self._run_batches(
            mutations, primary, resolver,
            lambda region, batch: self.rm.prewrite(
                region, batch, primary, start_ts, self.lock_ttl))
        # crash here = fully-prewritten, uncommitted txn: every lock is
        # orphaned and must roll BACK (reference failpoint site: 2pc.go:704)
        failpoint.inject("twopc/after-prewrite")
        return mutations, primary, resolver

    def commit_phase(self, state, start_ts: int) -> int:
        """Phase 2: never waits on foreign locks (we hold every key),
        so it is safe inside the storage commit lock."""
        with obs.span("twopc.commit"):
            return self._commit_phase(state, start_ts)

    def _commit_phase(self, state, start_ts: int) -> int:
        mutations, primary, resolver = state
        with obs.wait("tso_wait"):
            commit_ts = self.tso.ts()
        # commit the primary synchronously — the txn is durable
        # once this lands (reference: 2pc.go:741)
        failpoint.inject("twopc/before-commit-primary")
        with obs.wait("commit_primary",
                      span_name="twopc.commit_primary"):
            self._retry_region(
                primary, resolver,
                lambda region: self.rm.commit(region, [primary], start_ts,
                                              commit_ts))
        # crash here = committed txn with secondary locks left behind:
        # the resolver must roll them FORWARD from the primary's write
        # record (reference failpoint site: 2pc.go:1027)
        failpoint.inject("twopc/after-primary-commit")
        # secondaries may commit lazily; do them inline (the reference
        # fires a goroutine — same semantics, resolver covers crashes).
        # IMPORTANT: the txn is already durable — a secondary failure must
        # NOT surface as a commit failure (the lock resolver rolls the
        # stragglers forward from the committed primary)
        rest = [m.key for m in mutations if m.key != primary]
        if rest:
            with obs.wait("commit_secondary",
                          span_name="twopc.commit_secondary"):
                for key in rest:
                    try:
                        self._retry_region(
                            key, resolver,
                            lambda region, k=key: self.rm.commit(
                                region, [k], start_ts, commit_ts))
                    except (CommitError, KVError):
                        # resolver recovers from the primary's record
                        pass
        return commit_ts

    def rollback(self, mutations: list[Mutation], start_ts: int) -> None:
        resolver = LockResolver(self.rm, self.tso, events=self.events)
        for m in mutations:
            self._retry_region(
                m.key, resolver,
                lambda region, k=m.key: self.rm.rollback(
                    region, [k], start_ts))

    # ---- helpers -----------------------------------------------------------
    def _run_batches(self, mutations, primary, resolver, fn) -> None:
        """Group by region, primary's batch first — re-locating and
        re-grouping on EVERY attempt: an online split moves keys to a
        fresh region/epoch mid-flight, and retrying with the handle
        that just answered EpochNotMatch would exhaust the budget
        without ever seeing the reloaded table. Re-sending an already-
        applied batch is safe — prewrite/commit/rollback are all
        idempotent per (key, start_ts) (see mvcc._prewrite_check)."""
        def attempt():
            groups: dict[int, tuple[Region, list[Mutation]]] = {}
            for m in mutations:
                r = self.rm.locate(m.key)
                groups.setdefault(r.id, (r, []))[1].append(m)
            ordered = sorted(
                groups.values(),
                key=lambda g: 0 if any(m.key == primary
                                       for m in g[1]) else 1)
            for region, batch in ordered:
                fn(region, batch)

        self._retry(attempt, [m.key for m in mutations], resolver)

    def _retry_region(self, key: bytes, resolver, fn) -> None:
        self._retry(lambda: fn(self.rm.locate(key)), [key], resolver)

    def _retry(self, fn, keys, resolver) -> None:
        backoff = 0.001
        region_errs = 0
        deadline = time.monotonic() + self.lock_wait_timeout_s
        while True:
            try:
                fn()
                return
            except RegionError:
                region_errs += 1  # refreshed routing on next call
                if region_errs >= self.max_retries:
                    raise CommitError(
                        f"region retries exhausted for keys {keys[:2]}...")
            except KeyIsLockedError as e:
                if resolver.resolve(e.lock):
                    continue
                if time.monotonic() >= deadline:
                    err = CommitError(
                        "Lock wait timeout exceeded; try restarting "
                        "transaction")
                    err.errno = 1205  # ER_LOCK_WAIT_TIMEOUT
                    raise err from None
                time.sleep(backoff)
                _note_lock_backoff(backoff)
                backoff = min(backoff * 2, 0.05)


def _note_lock_backoff(seconds: float) -> None:
    """Type a foreign-lock wait sleep: the backoff families plus the
    active statement's wait ledger."""
    obs.BACKOFF_SECONDS.observe(seconds, kind="txnLock")
    obs.BACKOFF_EVENTS.inc(kind="txnLock")
    obs.note_wait("backoff.txnLock", seconds)


class Snapshot:
    """Read view at one ts over the region tier (reference:
    store/tikv/snapshot.go — Get :122, BatchGet :223, with lock
    resolution on read)."""

    def __init__(self, rm: RegionManager, tso: TSO, read_ts: int) -> None:
        self.rm = rm
        self.read_ts = read_ts
        self._resolver = LockResolver(rm, tso)

    def get(self, key: bytes) -> Optional[bytes]:
        backoff = 0.001
        for _ in range(12):
            try:
                return self.rm.get(self.rm.locate(key), key, self.read_ts)
            except RegionError:
                continue
            except KeyIsLockedError as e:
                if not self._resolver.resolve(e.lock):
                    time.sleep(backoff)
                    _note_lock_backoff(backoff)
                    backoff = min(backoff * 2, 0.1)
        raise CommitError(f"read of {key!r} kept hitting locks")

    def scan(self, start: bytes, end: bytes,
             limit: int = -1) -> list[tuple[bytes, bytes]]:
        backoff = 0.001
        for _ in range(12):
            try:
                return self.rm.scan(start, end, self.read_ts, limit)
            except RegionError:
                continue  # split/reload mid-scan: routing refreshed
            except KeyIsLockedError as e:
                if not self._resolver.resolve(e.lock):
                    time.sleep(backoff)
                    _note_lock_backoff(backoff)
                    backoff = min(backoff * 2, 0.1)
        raise CommitError("scan kept hitting locks")
