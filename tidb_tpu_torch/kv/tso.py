"""Timestamp oracles: hybrid physical/logical timestamps.

Port of `tidb_tpu/kv/tso.py`, all three oracles (equivalents of PD's TSO
service, reference: store/tikv/oracle/oracles/pd.go:77 and
oracle/oracles/local.go). Timestamps use PD's layout — physical
milliseconds << 18 | logical counter — because the MVCC tier derives lock
TTL expiry from `now_ts - lock_ts > ttl << 18` (reference:
oracle.ExtractPhysical). start_ts/commit_ts ordering is the basis of
snapshot-isolation visibility in the MVCC store.

* `TimestampOracle` — in-process allocator (single-server stores).
* `RemoteTSO` — RPC proxy to the store leader's allocator (socket
  followers; the PD-client role). Every timestamp is issued by the ONE
  leader allocator. When the leader is unreachable past the backoff
  budget the oracle degrades to re-issuing the last replicated
  timestamp for READS; such timestamps sit at or below
  `stale_watermark`, and the storage refuses to let a transaction whose
  start_ts is under the watermark write — degraded followers are
  read-only.
* `SharedTSO` — ONE allocator for all processes sharing a durable store
  directory: an mmap'd shared counter advanced under a dedicated flock,
  with a persisted allocation window (fsync'd every `_WINDOW_MS` of
  timestamp space, PD's TSO-window pattern) so a full-cluster crash can
  never re-issue a timestamp. Any commit_ts a sibling obtained is <= the
  counter, so every later snapshot ts is strictly greater: snapshot
  isolation is strict across processes.
"""

from __future__ import annotations

import fcntl
import mmap
import os
import struct
import threading
import time

from .. import obs

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


class RemoteTSO:
    """Leader-allocated timestamps over RPC (PD-client role).

    `next_ts` (snapshot acquisition) may fall back to a stale re-issue
    when degraded; `ts` (the 2PC committer's interface) NEVER does — a
    commit timestamp must come from the live allocator or the commit
    must fail typed."""

    def __init__(self, client, allow_stale: bool = True) -> None:
        self._client = client
        self._allow_stale = allow_stale
        self._lock = threading.Lock()
        self._seen = 0            # highest leader-issued ts witnessed
        self.stale_watermark = 0  # every stale re-issue is <= this
        # the commit ts this THREAD holds open in the leader's ledger
        # (commit_ts/commit_done pair up per committing thread; a
        # process-wide flag would let one thread's late done retire a
        # sibling's in-flight entry)
        self._commit_tl = threading.local()

    def _remote_next(self) -> int:
        # typed wait: time blocked on the leader's allocator is
        # tso_wait unless an enclosing frame (a 2PC phase) already
        # owns it
        with obs.wait("tso_wait", fallback=True):
            ts = int(self._client.call("tso_next")["ts"])
        with self._lock:
            if ts > self._seen:
                self._seen = ts
        return ts

    def commit_ts(self) -> int:
        """A COMMIT timestamp: allocated through the leader's
        pending-commit ledger (rpc/server.py tso_commit) so the
        closed-timestamp protocol of the follower read tier never
        closes past a commit whose records are still unpublished.
        Strict like ts(): never degrades to a stale re-issue."""
        with obs.wait("tso_wait", fallback=True):
            ts = int(self._client.call("tso_commit")["ts"])
        with self._lock:
            if ts > self._seen:
                self._seen = ts
        self._commit_tl.ts = ts
        return ts

    def commit_done(self) -> None:
        """Retire the pending-commit ledger entry once the commit phase
        finished (its records are published, or definitively never will
        be). Carries the exact ts so a done that arrives late — after
        the same client's NEXT commit replaced the ledger slot — is a
        no-op server-side. Best effort: the leader also retires the
        entry by replacement on the next tso_commit and on client
        reap."""
        ts = getattr(self._commit_tl, "ts", 0)
        if not ts:
            return
        self._commit_tl.ts = 0
        from ..rpc.errors import RPCError
        try:
            self._client.call("tso_commit_done", ts=ts, _budget_ms=500)
        except RPCError:
            pass

    def next_ts(self) -> int:
        from ..rpc.errors import RPCError
        if not (self._client.degraded and self._allow_stale):
            try:
                return self._remote_next()
            except RPCError:
                if not self._allow_stale:
                    raise
        # degraded read-only mode: re-issue the last replicated ts.
        # Re-issuing (rather than bumping) keeps every fallback value
        # strictly below anything the live allocator will ever hand
        # out, so the watermark check cleanly fences writes.
        with self._lock:
            if self.stale_watermark < self._seen:
                self.stale_watermark = self._seen
            return self._seen

    def ts(self) -> int:
        return self._remote_next()

    def observe(self, ts: int) -> None:
        """Track replicated commit timestamps locally (they were issued
        by the leader allocator, so no RPC is needed to stay ordered)."""
        with self._lock:
            if ts > self._seen:
                self._seen = ts

    def current(self) -> int:
        with self._lock:
            return self._seen

    def close(self) -> None:
        pass


# window persisted ahead of issued timestamps: every issued ts is < the
# on-disk window, so restart-after-crash floors above everything issued
_WINDOW_MS = 3000


class SharedTSO:
    """Strict cross-process TSO over a shared store directory.

    Files (all under `path`):
      tso.mem    — 8-byte mmap'd counter: the last issued timestamp.
                   MAP_SHARED, so every process sees each allocation
                   immediately; durability is NOT required of this file.
      tso.alloc  — flock'd for the read-bump-write critical section.
      tso.window — decimal upper bound W with invariant issued < W;
                   extended (+ fsync) whenever an allocation approaches
                   it. The PD TSO-window pattern (oracle/oracles/pd.go):
                   pay an fsync per ~3s of timestamp space, not per ts.
      tso.live   — held LOCK_SH by every live process; a LOCK_EX probe
                   succeeding means no process is live, so the prober
                   re-seeds tso.mem from max(mem, window, floor) —
                   recovery after a full-cluster crash where the mmap
                   page was never written back.
    """

    def __init__(self, path: str, floor: int = 0) -> None:
        self._lock = threading.Lock()
        self._alloc_f = open(os.path.join(path, "tso.alloc"), "a+b")
        self._window_path = os.path.join(path, "tso.window")
        mem_path = os.path.join(path, "tso.mem")
        self._live_f = open(os.path.join(path, "tso.live"), "a+b")
        with self._alloc_locked():  # serialize the 8-byte init vs peers
            with open(mem_path, "a+b") as f:
                f.seek(0, 2)
                if f.tell() < 8:
                    f.write(b"\0" * (8 - f.tell()))
                    f.flush()
        self._mem_f = open(mem_path, "r+b")
        self._mem = mmap.mmap(self._mem_f.fileno(), 8)
        # first-process re-seed: EX probe on tso.live (everyone else
        # holds SH); downgrade to SH afterwards and hold it for life
        try:
            fcntl.flock(self._live_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            first = True
        except OSError:
            first = False
        if first:
            with self._alloc_locked():
                last = max(self._read_mem(), self._read_window(), floor)
                self._write_mem(last)
        fcntl.flock(self._live_f, fcntl.LOCK_SH)  # downgrade (or join)
        self._window = self._read_window()

    # ---- low-level shared state -------------------------------------------
    def _read_mem(self) -> int:
        return struct.unpack("<q", self._mem[:8])[0]

    def _write_mem(self, ts: int) -> None:
        self._mem[:8] = struct.pack("<q", ts)

    def _read_window(self) -> int:
        try:
            with open(self._window_path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _extend_window(self, need: int) -> None:
        w = need + (_WINDOW_MS << _LOGICAL_BITS)
        tmp = self._window_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(w))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._window_path)
        # the rename itself must be durable: without fsync'ing the
        # directory a power loss can revert to the OLD window and re-issue
        # timestamps — the one invariant this file exists to keep
        dfd = os.open(os.path.dirname(self._window_path) or ".",
                      os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._window = w

    class _AllocLock:
        def __init__(self, f):
            self._f = f

        def __enter__(self):
            fcntl.flock(self._f, fcntl.LOCK_EX)

        def __exit__(self, *exc):
            fcntl.flock(self._f, fcntl.LOCK_UN)

    def _alloc_locked(self):
        return self._AllocLock(self._alloc_f)

    # ---- oracle interface --------------------------------------------------
    def next_ts(self) -> int:
        # the cross-process flock IS a wait: type it so a contended
        # shared allocator shows up as tso_wait, not untyped wall
        with obs.wait("tso_wait", fallback=True), \
                self._lock, self._alloc_locked():
            last = self._read_mem()
            # +1 carries logical overflow into physical: the borrow-next-
            # tick behavior of the in-process oracle, for free
            cand = max(last + 1, int(time.time() * 1000) << _LOGICAL_BITS)
            # cached window keeps file I/O off the per-ts path; a sibling
            # may have extended it further on disk, so a cache miss
            # re-reads before paying the fsync (stale-low cache is safe:
            # it only ever triggers this re-read under the same flock)
            if cand >= self._window:
                self._window = self._read_window()
                if cand >= self._window:
                    self._extend_window(cand)
            self._write_mem(cand)
            return cand

    def observe(self, ts: int) -> None:
        """With one shared allocator every sibling commit_ts is already
        <= the counter; this remains as a cheap invariant net for
        timestamps from OUTSIDE the allocator (none today)."""
        if ts <= self._read_mem():
            return
        with self._lock, self._alloc_locked():
            if ts > self._read_mem():
                if ts >= self._window:
                    self._window = self._read_window()
                    if ts >= self._window:
                        self._extend_window(ts)
                self._write_mem(ts)

    def ts(self) -> int:
        return self.next_ts()

    def current(self) -> int:
        return self._read_mem()

    def close(self) -> None:
        for h in (self._mem, self._mem_f, self._alloc_f, self._live_f):
            try:
                h.close()
            except OSError:
                pass
