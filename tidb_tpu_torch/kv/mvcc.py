"""Percolator MVCC store: lock/write/data columns over an ordered KV.

Counterpart of the reference's in-process TiKV MVCC engines (reference:
store/mockstore/mocktikv/mvcc_leveldb.go — Prewrite :commitOneKey paths,
Commit, Rollback, ResolveLock, Get/Scan with lock checks) and the
percolator model TiKV itself implements.

Column families:
  lock:  key -> (start_ts, primary, op, ttl)
  write: key + rev(commit_ts) -> (start_ts, kind)   kind: P/D/R
  data:  key + rev(start_ts)  -> value bytes

Port of `tidb_tpu/kv/mvcc.py`: the pure-Python ordered KV (`PyOrderedKV`,
the twin of the C++ engine `kv/native.NativeOrderedKV`) with its WAL and
snapshot files and the sync-log policy (`SyncPolicy`, group commit), and
`MVCCStore` with reads, percolator writes, pessimistic locks, lock
resolution, range destruction, the recovery scans and version GC (`gc`,
driven by the maintenance worker, `store/daemon.py`). The shared-directory
refresh lives here too: `PyOrderedKV(path, shared=True)` tails a WAL that
sibling processes append to (position-based, queueing every applied
record on `pending_refresh` for the storage's columnar fold), and a
store with a coordinator (`store/coordinator.py`, `rpc/remote.py`) runs
every mutation section inside the coordinator's section with the WAL
caught up. A range split (`rpc/ranged.py`) partitions a store through
`export_range` and `discard_range`, bounded on decoded user keys.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional

from .. import obs
from ..analysis import lockcheck
from ..util import failpoint
from .codec import encode_uint_desc

CF_LOCK = 0
CF_WRITE = 1
CF_DATA = 2

OP_PUT = b"P"
OP_DEL = b"D"
OP_ROLLBACK = b"R"
OP_LOCK = b"L"  # lock-only mutation (SELECT FOR UPDATE)


class KVError(Exception):
    pass


def fsync_dir(path: str) -> None:
    """Durable-rename helper: fsync the DIRECTORY so a tmp+rename
    sequence survives power loss (the rename itself lives in the
    directory's metadata; fsyncing only the file leaves the old name
    recoverable)."""
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class SyncPolicy:
    """THE storage.sync-log policy evaluator, shared by both engines'
    WALs (`PyOrderedKV`, `kv/native.NativeOrderedKV`) so the policy
    lives in one place:

      off      — never fsync (flushing to the OS is the caller's job)
      commit   — fsync at every boundary() call; an fsync failure
                 PROPAGATES so the commit is never acked undurable
      interval — group commit: at most one fsync per interval_ms. The
                 tail burst before an idle period is covered by a
                 deferred one-shot flush timer, so the loss window is
                 genuinely bounded by interval_ms, not by when the
                 next commit happens to arrive.

    Cross-commit group fsync (`commit` mode): with `defer_commit` set
    by the owning engine, boundary() leaves the commit's bytes flushed
    to the OS and the COMMIT PATH calls commit_sync() after releasing
    its locks. Concurrent committers rendezvous there on one in-flight
    fsync — an fsync covers every byte written before it started, so N
    waiters whose writes predate the leader's fsync all become durable
    for the price of one disk barrier (reference: raft-store write
    batching / MySQL binlog group commit). The durability contract is
    UNCHANGED: nobody returns from commit_sync() until an fsync that
    started after their last write completed, and a failed fsync
    propagates to (or is retried by) every waiter it stranded.

    `fsync` is the sink's own durability callable; it must tolerate
    being invoked after close (the deferred timer may race teardown).
    """

    __slots__ = ("policy", "interval_ms", "_fsync", "_lock", "_last",
                 "_dirty", "_timer", "_closed", "on_stall", "stall_ms",
                 "defer_commit", "group_max_batch", "group_max_wait_us",
                 "on_batch", "_cv", "_wgen", "_sgen", "_sync_active",
                 "_waiters")

    # an fsync slower than this reports a stall (a healthy fsync is
    # single-digit ms; the threshold flags the pathological tail)
    STALL_MS_DEFAULT = 100.0

    def __init__(self, policy: str, interval_ms: int, fsync) -> None:
        self.policy = policy
        self.interval_ms = interval_ms
        self._fsync = fsync
        self._lock = lockcheck.lock("SyncPolicy._lock")
        self._last = 0.0
        self._dirty = False
        self._timer = None
        self._closed = False
        # stall reporting hook (seconds -> None), wired by the Storage
        # to its event ring
        self.on_stall = None
        self.stall_ms = self.STALL_MS_DEFAULT
        # ---- cross-commit group fsync (commit mode) ----
        # defer_commit: the owning engine routes commit-boundary
        # durability through commit_sync() instead of the in-section
        # boundary() (False here so a bare SyncPolicy keeps the exact
        # fsync-per-boundary behavior)
        self.defer_commit = False
        # leader gather window: once elected, wait up to max-wait-µs
        # for more committers to join (0 = fsync immediately; the
        # natural rendezvous during a slow fsync already batches) —
        # skipped once max-batch committers are aboard
        self.group_max_batch = 64
        self.group_max_wait_us = 0
        # batch telemetry hook (batch_size -> None), wired by the
        # Storage to tidb_group_commit_batch_size; never fails a commit
        self.on_batch = None
        self._cv = threading.Condition(self._lock)
        # write generation vs the generation covered by the last
        # completed fsync: a committer whose writes are <= _sgen is
        # durable without touching the disk itself
        self._wgen = 0
        self._sgen = 0
        self._sync_active = False
        self._waiters = 0

    def mark_dirty(self) -> None:
        # plain flag store — called once per WAL record on the write
        # hot path; the group-commit write GENERATION advances at
        # mutation-section granularity in boundary() instead, so bulk
        # loads don't pay a lock round-trip per row
        self._dirty = True

    def boundary(self) -> None:
        """Commit-boundary hook. OSError from the sink propagates (the
        caller must not ack a commit whose durability failed)."""
        if not self._dirty or self.policy == "off":
            return
        if self.policy == "commit":
            if not self.defer_commit:
                self.flush()
                return
            # deferred: every record of this mutation section is
            # already written; CONSUME the dirty mark into one
            # generation bump that fences them all for the commit
            # path's commit_sync() rendezvous (which runs AFTER the
            # caller's locks release, so concurrent committers share
            # the fsync instead of serializing). A sibling section's
            # mark consumed here is safe: its records were written
            # before this bump, so this generation covers them; records
            # it writes later re-mark and re-fence at its own exit.
            with self._lock:
                self._dirty = False
                self._wgen += 1
            return
        now = time.monotonic()
        with self._lock:
            due = now - self._last >= self.interval_ms / 1000.0
            if not due:
                if self._timer is None and not self._closed:
                    # cover the tail burst: without this, commits that
                    # land inside the window and are followed by idle
                    # time would stay un-fsynced indefinitely
                    delay = self.interval_ms / 1000.0 - (now - self._last)
                    t = threading.Timer(max(delay, 0.001),
                                        self._deferred_flush)
                    t.daemon = True
                    t.name = "titpu-sync-flush"
                    self._timer = t
                    t.start()
                return
        self.flush()

    def _deferred_flush(self) -> None:
        with self._lock:
            self._timer = None
            if self._closed:
                return
        if self._dirty:
            try:
                self.flush()
            except OSError:
                pass  # still dirty: the next boundary retries loudly

    def flush(self) -> None:
        """Unconditional sync-now (checkpoint/close path too)."""
        with self._lock:
            start = self._wgen
        self._timed_fsync()
        with self._lock:
            self._dirty = False
            if start > self._sgen:
                self._sgen = start
            self._last = time.monotonic()
            self._cv.notify_all()

    def _timed_fsync(self) -> None:
        """The sink's fsync as the typed `fsync_wait` (and the
        `wal.fsync` span under TRACE); one slower than `stall_ms`
        reports to `on_stall`."""
        # dynamic twin of the blocking-call-under-hot-lock rule: a
        # disk barrier with a hot lock held is a typed finding (one
        # module-global bool probe when the checker is off)
        lockcheck.note_blocking("fsync", "SyncPolicy WAL fsync")
        t0 = time.perf_counter()
        with obs.wait("fsync_wait", span_name="wal.fsync"):
            self._fsync()
        dt = time.perf_counter() - t0
        if self.on_stall is not None and dt * 1e3 >= self.stall_ms:
            self.on_stall(dt)

    def _finish_sync(self, covered_gen: int) -> None:
        """Advance the covered generation after a group fsync. `_dirty`
        is deliberately NOT touched: a writer may have marked it
        between fsync start and here, and clearing it would let that
        writer's boundary() skip its generation fence (an undurable
        ack). Coverage decisions in commit mode ride the generations;
        `_dirty` only ever clears on flush()/clean(), whose callers
        hold the write path quiescent."""
        with self._lock:
            if covered_gen > self._sgen:
                self._sgen = covered_gen
            self._last = time.monotonic()
            self._cv.notify_all()

    def commit_sync(self) -> None:
        """Group-commit rendezvous: return once an fsync that STARTED
        after this caller's last write has completed. One caller (the
        leader) runs the fsync; everyone whose bytes were already in
        the OS buffers when it started is covered for free. An fsync
        failure propagates from the leader; stranded waiters retry as
        the next leader, so nobody returns undurable."""
        if self.policy != "commit":
            return
        with obs.wait("fsync_wait", span_name="wal.group_commit"):
            self._commit_sync()

    def _commit_sync(self) -> None:
        with self._lock:
            if self._dirty:
                # writes not yet fenced by a boundary() (direct
                # SyncPolicy users, or a sibling section's records
                # marked after the last fence): consume + fence them —
                # conservative, but only when unfenced writes exist
                self._dirty = False
                self._wgen += 1
            my = self._wgen
            if self._sgen >= my:
                return  # already covered by a completed fsync
            self._waiters += 1
            try:
                while self._sgen < my and self._sync_active:
                    self._cv.wait()
                if self._sgen >= my:
                    return
                self._sync_active = True
            finally:
                self._waiters -= 1
        # ---- leader path (no locks held) ----
        try:
            wait_s = self.group_max_wait_us / 1e6
            if wait_s > 0:
                with self._lock:
                    gather = self._waiters + 1 < self.group_max_batch
                if gather:
                    time.sleep(wait_s)
            with self._lock:
                start = self._wgen
                batch = self._waiters + 1  # every waiter wrote <= start
            # kill-9 site: the batch's bytes are flushed to the OS but
            # NOT fsynced, and none of its commits is acked yet
            failpoint.inject("kv/group-fsync")
            self._timed_fsync()
        except BaseException:
            with self._lock:
                self._sync_active = False
                self._cv.notify_all()  # a waiter takes over as leader
            raise
        self._finish_sync(start)
        with self._lock:
            self._sync_active = False
            self._cv.notify_all()
        if self.on_batch is not None:
            try:
                self.on_batch(batch)
            except Exception:  # noqa: BLE001 — telemetry only
                pass

    def clean(self) -> None:
        """The sink was made durable by other means (checkpoint wrote
        and fsynced a snapshot; the WAL restarted empty)."""
        with self._lock:
            self._dirty = False
            self._sgen = self._wgen
            self._cv.notify_all()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            t, self._timer = self._timer, None
        if t is not None:
            t.cancel()


@dataclass
class LockInfo:
    key: bytes
    primary: bytes
    start_ts: int
    op: bytes
    ttl: int


class KeyIsLockedError(KVError):
    def __init__(self, lock: LockInfo) -> None:
        super().__init__(
            f"key {lock.key!r} locked by txn {lock.start_ts}")
        self.lock = lock


class WriteConflictError(KVError):
    def __init__(self, key: bytes, start_ts: int, conflict_ts: int) -> None:
        super().__init__(
            f"write conflict on {key!r}: txn {start_ts} vs commit "
            f"{conflict_ts}")
        self.key = key
        self.start_ts = start_ts
        self.conflict_ts = conflict_ts


class TxnNotFoundError(KVError):
    pass


# ---------------------------------------------------------------------------
# ordered KV substrate (Python reference implementation)
# ---------------------------------------------------------------------------

class PyOrderedKV:
    """Sorted-key in-memory KV with 3 column families. The pure-Python
    twin of the C++ engine (`csrc/kvstore.cpp`); identical interface,
    including the WAL + snapshot file format when `path` is given (the
    record layout in kvstore.cpp write_rec), so either engine can reopen
    a directory the other wrote."""

    def __init__(self, path=None, shared: bool = False,
                 sync_log: str = "off",
                 sync_interval_ms: int = 100) -> None:
        self._maps: list[dict[bytes, bytes]] = [{}, {}, {}]
        self._keys: list[list[bytes]] = [[], [], []]
        self._dir = None
        self._wal = None
        self._shared = shared
        self._applied_off = 0
        # bumped whenever checkpoint() rotates (truncates) the WAL — the
        # closed-ts protocol brackets its lock-free size stats on it
        # (shared-mode engines never rotate, so a socket leader's
        # generation is constant)
        self.wal_generation = 0
        # durability policy (storage.sync-log): 'off' flushes to the OS
        # only (a machine crash can lose acked commits), 'commit' fsyncs
        # at every commit boundary, 'interval' group-commits — at most
        # one fsync per sync_interval_ms
        self.sync_log = sync_log
        self.sync_interval_ms = sync_interval_ms
        self._syncer = SyncPolicy(sync_log, sync_interval_ms,
                                  self._fsync_wal)
        # cross-commit group fsync: single-process stores defer the
        # commit-boundary fsync out of the mutation section (the commit
        # path's rendezvous in commit_sync runs after it drops its
        # locks). Shared-dir stores keep the in-section fsync: the flock
        # contract is durability BEFORE visibility to sibling processes,
        # and the flock serializes committers anyway.
        self._syncer.defer_commit = not shared
        # records applied by refresh() that the storage has not yet
        # folded into columnar epochs / catalog (shared mode only)
        self.pending_refresh: list[tuple[int, int, bytes, bytes]] = []
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._dir = str(path)
            self._replay(os.path.join(self._dir, "snapshot.kv"))
            wal_path = os.path.join(self._dir, "wal.log")
            valid = self._replay(wal_path)
            if valid >= 0 and not shared:
                # drop a torn tail (crash mid-append): appending after the
                # garbage would hide every later record from the next replay
                with open(wal_path, "ab") as f:
                    f.truncate(valid)
            self._applied_off = max(valid, 0)
            self._wal = open(wal_path, "ab")

    # ---- durability --------------------------------------------------------
    def _replay(self, path: str) -> int:
        """Apply valid records; returns the valid-prefix byte length
        (-1 when the file is absent)."""
        try:
            f = open(path, "rb")
        except OSError:
            return -1
        valid = 0
        with f:
            while True:
                hdr = f.read(10)
                if len(hdr) < 10:
                    return valid
                op, cf = hdr[0], hdr[1]
                klen, vlen = struct.unpack_from("<II", hdr, 2)
                if cf >= 3 or op not in (1, 2):
                    return valid  # torn/corrupt tail
                key = f.read(klen)
                val = f.read(vlen)
                if len(key) < klen or len(val) < vlen:
                    return valid
                if op == 1:
                    self._apply_put(cf, key, val)
                else:
                    self._apply_delete(cf, key)
                valid = f.tell()

    def _log(self, op: int, cf: int, key: bytes, value: bytes) -> None:
        if self._wal is not None:
            rec = struct.pack("<BBII", op, cf, len(key),
                              len(value)) + key + value
            if failpoint.is_enabled("kv/wal-torn-append"):
                # crash-injection site: half the record reaches the file,
                # then the armed action fires (a kill-9 mid-append). An
                # inert hit falls through and writes the remainder,
                # keeping the stream whole.
                half = rec[:max(1, len(rec) // 2)]
                self._wal.write(half)
                self._wal.flush()
                failpoint.inject("kv/wal-torn-append")
                self._wal.write(rec[len(half):])
            else:
                self._wal.write(rec)
            self._wal.flush()
            self._syncer.mark_dirty()
            # shared mode: our own appends are already in memory — advance
            # the tail cursor so refresh() skips them. Writes happen only
            # inside the coordinator section after refresh(), so the
            # cursor was at EOF when this append started.
            self._applied_off += len(rec)

    def sync_mirror(self) -> None:
        """The on-disk mirror's deferred fsync of a socket follower's
        engine (rpc/remote.py); this engine keeps no mirror."""

    def refresh(self) -> int:
        """Apply records other processes appended past our cursor
        (shared mode); applied records are also queued on
        `pending_refresh` for the storage layer's columnar fold. Returns
        the number of records applied."""
        if self._dir is None or not self._shared:
            return 0
        path = os.path.join(self._dir, "wal.log")
        try:
            size = os.path.getsize(path)
        except OSError:
            return 0
        if size <= self._applied_off:
            return 0
        n = 0
        with open(path, "rb") as f:
            f.seek(self._applied_off)
            while True:
                hdr = f.read(10)
                if len(hdr) < 10:
                    break
                op, cf = hdr[0], hdr[1]
                klen, vlen = struct.unpack_from("<II", hdr, 2)
                if cf >= 3 or op not in (1, 2):
                    break  # torn tail; tail_clean truncates under flock
                key = f.read(klen)
                val = f.read(vlen)
                if len(key) < klen or len(val) < vlen:
                    break
                if op == 1:
                    self._apply_put(cf, key, val)
                else:
                    self._apply_delete(cf, key)
                self.pending_refresh.append((op, cf, key, val))
                self._applied_off = f.tell()
                n += 1
        return n

    def tail_clean(self) -> None:
        """Truncate a torn tail left by a writer that crashed mid-append.
        Callers must hold the coordinator flock (nobody else can be
        appending) and have refresh()ed to the valid prefix."""
        if self._dir is None or not self._shared:
            return
        path = os.path.join(self._dir, "wal.log")
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size > self._applied_off:
            with open(path, "r+b") as f:
                f.truncate(self._applied_off)

    def checkpoint(self) -> None:
        if self._dir is None or self._wal is None:
            return
        if self._shared:
            # snapshot+truncate would destroy sibling processes' WAL
            # cursors and any records we have not refreshed yet; shared
            # dirs compact only via a dedicated offline pass
            return
        tmp = os.path.join(self._dir, "snapshot.tmp")
        with open(tmp, "wb") as f:
            for cf in range(3):
                for k in self._keys[cf]:
                    v = self._maps[cf][k]
                    f.write(struct.pack("<BBII", 1, cf, len(k), len(v))
                            + k + v)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, "snapshot.kv"))
        # the rename must be durable BEFORE the WAL truncates: a crash
        # between the two otherwise leaves the old snapshot + an empty
        # WAL — every record folded into the new snapshot gone
        fsync_dir(self._dir)
        self._wal.close()
        self._wal = open(os.path.join(self._dir, "wal.log"), "wb")
        self.wal_generation += 1
        self._syncer.clean()  # the fsync'd snapshot covers everything

    def _fsync_wal(self) -> None:
        wal = self._wal
        if wal is None:
            return
        try:
            wal.flush()
            os.fsync(wal.fileno())
        except ValueError:
            # the group fsync runs outside the engine locks, so a
            # concurrent checkpoint can rotate (close+reopen) the WAL
            # under us: its snapshot was written AND fsynced before the
            # rotation, so every record this fsync meant to cover is
            # already durable — closed-file here is success, not error
            return

    def sync(self) -> None:
        if self._wal is not None:
            self._syncer.flush()

    def maybe_sync(self) -> None:
        """Commit-boundary durability hook (called at every mutation
        section exit): fsync per the sync-log policy. 'interval' mode is
        the group commit; 'commit' mode leaves durability to the commit
        path's commit_sync() rendezvous (cross-commit group fsync)."""
        if self._wal is not None:
            self._syncer.boundary()

    def commit_sync(self) -> None:
        """Commit-ack durability: group-fsync rendezvous covering every
        byte this committer wrote (no-op unless sync-log=commit)."""
        if self._wal is not None:
            self._syncer.commit_sync()

    def close(self) -> None:
        self._syncer.close()
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # ---- mutations ---------------------------------------------------------
    def _apply_put(self, cf: int, key: bytes, value: bytes) -> None:
        m = self._maps[cf]
        if key not in m:
            bisect.insort(self._keys[cf], key)
        m[key] = value

    def _apply_delete(self, cf: int, key: bytes) -> None:
        m = self._maps[cf]
        if key in m:
            del m[key]
            ks = self._keys[cf]
            i = bisect.bisect_left(ks, key)
            if i < len(ks) and ks[i] == key:
                ks.pop(i)

    def put(self, cf: int, key: bytes, value: bytes) -> None:
        self._log(1, cf, key, value)
        self._apply_put(cf, key, value)

    def delete(self, cf: int, key: bytes) -> None:
        self._log(2, cf, key, b"")
        self._apply_delete(cf, key)

    def get(self, cf: int, key: bytes) -> Optional[bytes]:
        return self._maps[cf].get(key)

    def scan(self, cf: int, start: bytes, end: bytes,
             limit: int = -1) -> Iterator[tuple[bytes, bytes]]:
        ks = self._keys[cf]
        m = self._maps[cf]
        i = bisect.bisect_left(ks, start)
        n = 0
        while i < len(ks) and (not end or ks[i] < end):
            if limit >= 0 and n >= limit:
                return
            yield ks[i], m[ks[i]]
            n += 1
            i += 1

    def seek_prev(self, cf: int, key: bytes) -> Optional[tuple[bytes, bytes]]:
        """Greatest entry with k <= key (for newest-version lookups)."""
        ks = self._keys[cf]
        i = bisect.bisect_right(ks, key)
        if i == 0:
            return None
        k = ks[i - 1]
        return k, self._maps[cf][k]

# ---------------------------------------------------------------------------
# record encodings
# ---------------------------------------------------------------------------

def _lock_enc(l: LockInfo) -> bytes:
    return (struct.pack("<QQ", l.start_ts, l.ttl) + l.op
            + struct.pack("<I", len(l.primary)) + l.primary)


def _lock_dec(key: bytes, b: bytes) -> LockInfo:
    start_ts, ttl = struct.unpack_from("<QQ", b, 0)
    op = b[16:17]
    (plen,) = struct.unpack_from("<I", b, 17)
    return LockInfo(key, b[21:21 + plen], start_ts, op, ttl)


def _write_enc(start_ts: int, kind: bytes) -> bytes:
    return struct.pack("<Q", start_ts) + kind


def _write_dec(b: bytes) -> tuple[int, bytes]:
    return struct.unpack_from("<Q", b, 0)[0], b[8:9]


def _wkey(key: bytes, commit_ts: int) -> bytes:
    return key + b"\x00" + encode_uint_desc(commit_ts)


def _dkey(key: bytes, start_ts: int) -> bytes:
    return key + b"\x00" + encode_uint_desc(start_ts)


def _split_vkey(vkey: bytes) -> tuple[bytes, int]:
    from .codec import decode_uint_desc
    return vkey[:-9], decode_uint_desc(vkey[-8:])


# ---------------------------------------------------------------------------
# MVCC store
# ---------------------------------------------------------------------------

@dataclass
class Mutation:
    op: bytes  # OP_PUT / OP_DEL / OP_LOCK
    key: bytes
    value: bytes = b""


class MVCCStore:
    def __init__(self, engine=None, coord=None) -> None:
        self.kv = engine if engine is not None else PyOrderedKV()
        self._mu = lockcheck.rlock("MVCCStore._mu", hot=True)
        # the coordinator of a multi-process deployment: every mutation
        # runs inside its section with the WAL tail caught up, so
        # percolator lock/write records from sibling processes are always
        # visible to conflict checks (store/coordinator.py)
        self.coord = coord

    def _mutate(self):
        return _MutationSection(self)

    def refresh(self) -> int:
        """Locked WAL catch-up (shared mode): serializes with in-process
        mutators so the tail cursor never moves backwards under a
        concurrent append."""
        with self._mu:
            return self.kv.refresh()

    def drain_pending(self) -> list:
        with self._mu:
            out = self.kv.pending_refresh
            self.kv.pending_refresh = []
            return out

    def commit_sync(self) -> None:
        """Commit-ack durability rendezvous (see SyncPolicy.commit_sync).
        Called by the storage commit path AFTER releasing the commit
        lock, so concurrent committers amortize one fsync."""
        self.kv.commit_sync()

    # ---- reads -------------------------------------------------------------
    def get(self, key: bytes, read_ts: int) -> Optional[bytes]:
        with self._mu:
            self._check_lock(key, read_ts)
            return self._read_committed(key, read_ts)

    def scan(self, start: bytes, end: bytes, read_ts: int,
             limit: int = -1) -> list[tuple[bytes, bytes]]:
        """Committed (key, value) pairs visible at read_ts, ordered."""
        with self._mu:
            # lock check over the range
            for k, lv in self.kv.scan(CF_LOCK, start, end):
                lock = _lock_dec(k, lv)
                if lock.start_ts <= read_ts and lock.op != OP_LOCK:
                    raise KeyIsLockedError(lock)
            out: list[tuple[bytes, bytes]] = []
            last_key: Optional[bytes] = None
            it_start = _wkey(start, 0xFFFFFFFFFFFFFFFF) if start else b""
            for wk, wv in self.kv.scan(CF_WRITE, it_start,
                                       end if end else b""):
                key, commit_ts = _split_vkey(wk)
                if end and key >= end:
                    break
                if key == last_key or commit_ts > read_ts:
                    continue
                start_ts, kind = _write_dec(wv)
                if kind in (OP_ROLLBACK, OP_LOCK):
                    continue  # markers never settle a key
                last_key = key
                if kind == OP_PUT:
                    data = self.kv.get(CF_DATA, _dkey(key, start_ts))
                    if data is not None:
                        out.append((key, data))
                        if limit >= 0 and len(out) >= limit:
                            break
            return out

    def _check_lock(self, key: bytes, read_ts: int) -> None:
        lv = self.kv.get(CF_LOCK, key)
        if lv is not None:
            lock = _lock_dec(key, lv)
            if lock.start_ts <= read_ts and lock.op != OP_LOCK:
                raise KeyIsLockedError(lock)

    def _read_committed(self, key: bytes, read_ts: int) -> Optional[bytes]:
        probe = _wkey(key, read_ts)
        ent = None
        for wk, wv in self.kv.scan(CF_WRITE, probe, key + b"\x01"):
            k, commit_ts = _split_vkey(wk)
            if k != key:
                return None
            start_ts, kind = _write_dec(wv)
            if kind == OP_ROLLBACK or kind == OP_LOCK:
                continue
            if kind == OP_DEL:
                return None
            return self.kv.get(CF_DATA, _dkey(key, start_ts))
        return None

    # ---- percolator writes -------------------------------------------------
    def prewrite(self, mutations: list[Mutation], primary: bytes,
                 start_ts: int, ttl: int = 3000) -> None:
        """First phase (reference: mvcc_leveldb.go Prewrite; tikv
        prewrite.rs). All-or-nothing per call under the store mutex."""
        with self._mutate():
            errs: list[KVError] = []
            for m in mutations:
                e = self._prewrite_check(m.key, start_ts)
                if e is not None:
                    errs.append(e)
            if errs:
                raise errs[0]
            # wal.append: lock and data records reaching the engine (and
            # its WAL)
            with obs.span("wal.append"):
                for m in mutations:
                    self.kv.put(CF_LOCK, m.key, _lock_enc(
                        LockInfo(m.key, primary, start_ts, m.op, ttl)))
                    if m.op == OP_PUT:
                        self.kv.put(CF_DATA, _dkey(m.key, start_ts),
                                    m.value)

    def _prewrite_check(self, key: bytes, start_ts: int) -> Optional[KVError]:
        lv = self.kv.get(CF_LOCK, key)
        if lv is not None:
            lock = _lock_dec(key, lv)
            if lock.start_ts != start_ts:
                return KeyIsLockedError(lock)
            return None  # idempotent re-prewrite
        latest = self._latest_commit(key)
        if latest is not None and latest[0] >= start_ts:
            return WriteConflictError(key, start_ts, latest[0])
        return None

    def _latest_commit(self, key: bytes) -> Optional[tuple[int, int, bytes]]:
        """(commit_ts, start_ts, kind) of the newest write record."""
        for wk, wv in self.kv.scan(CF_WRITE,
                                   _wkey(key, 0xFFFFFFFFFFFFFFFF),
                                   key + b"\x01", limit=1):
            k, commit_ts = _split_vkey(wk)
            if k != key:
                return None
            start_ts, kind = _write_dec(wv)
            return commit_ts, start_ts, kind
        return None

    def commit(self, keys: list[bytes], start_ts: int,
               commit_ts: int) -> None:
        """Second phase (reference: mvcc_leveldb.go Commit)."""
        with self._mutate(), obs.span("wal.append"):
            for key in keys:
                lv = self.kv.get(CF_LOCK, key)
                if lv is None:
                    # lock gone: committed already (idempotent) or rolled back
                    st = self._find_txn_write(key, start_ts)
                    if st is not None and st != OP_ROLLBACK:
                        continue
                    raise TxnNotFoundError(
                        f"txn {start_ts} lock not found on {key!r}")
                lock = _lock_dec(key, lv)
                if lock.start_ts != start_ts:
                    raise TxnNotFoundError(
                        f"txn {start_ts} lock not found on {key!r} "
                        f"(held by {lock.start_ts})")
                self.kv.delete(CF_LOCK, key)
                # lock-only mutations leave a LOCK-kind write record too
                # (reference: TiKV WriteType::Lock): readers skip it, but
                # the prewrite conflict check MUST see it — it is how a
                # second optimistic claim of the same unique-index guard
                # key loses instead of silently double-committing
                self.kv.put(CF_WRITE, _wkey(key, commit_ts),
                            _write_enc(start_ts, lock.op))

    def rollback(self, keys: list[bytes], start_ts: int) -> None:
        """Abort a txn's keys (reference: mvcc_leveldb.go Rollback);
        writes a rollback marker so late prewrites cannot resurrect it."""
        with self._mutate():
            for key in keys:
                lv = self.kv.get(CF_LOCK, key)
                if lv is not None:
                    lock = _lock_dec(key, lv)
                    if lock.start_ts == start_ts:
                        self.kv.delete(CF_LOCK, key)
                        self.kv.delete(CF_DATA, _dkey(key, start_ts))
                st = self._find_txn_write(key, start_ts)
                if st is None:
                    self.kv.put(CF_WRITE, _wkey(key, start_ts),
                                _write_enc(start_ts, OP_ROLLBACK))
                elif st != OP_ROLLBACK:
                    raise KVError(
                        f"cannot rollback committed txn {start_ts}")

    def _find_txn_write(self, key: bytes, start_ts: int) -> Optional[bytes]:
        """kind of the write record this txn left on key, if any."""
        for wk, wv in self.kv.scan(CF_WRITE,
                                   _wkey(key, 0xFFFFFFFFFFFFFFFF),
                                   key + b"\x01"):
            k, _commit_ts = _split_vkey(wk)
            if k != key:
                return None
            st, kind = _write_dec(wv)
            if st == start_ts:
                return kind
        return None

    # ---- pessimistic locks -------------------------------------------------
    def pessimistic_lock(self, keys: list[bytes], primary: bytes,
                         start_ts: int, for_update_ts: int,
                         ttl: int = 20000) -> None:
        """Acquire lock-only (OP_LOCK) locks for a pessimistic txn
        (reference: store/tikv/pessimistic.go actionPessimisticLock;
        TiKV acquire_pessimistic_lock). Readers pass over OP_LOCK locks
        (see _check_lock); writers block on them. All-or-nothing: checks
        every key before writing any lock.

        Raises KeyIsLockedError when another txn holds any key and
        WriteConflictError when a commit newer than for_update_ts exists
        (the caller retries with a fresh for_update_ts)."""
        with self._mutate():
            for key in keys:
                lv = self.kv.get(CF_LOCK, key)
                if lv is not None:
                    lock = _lock_dec(key, lv)
                    if lock.start_ts != start_ts:
                        raise KeyIsLockedError(lock)
                    continue  # ours already (idempotent re-lock)
                latest = self._latest_commit(key)
                if latest is not None and latest[0] > for_update_ts:
                    raise WriteConflictError(key, start_ts, latest[0])
            for key in keys:
                if self.kv.get(CF_LOCK, key) is None:
                    self.kv.put(CF_LOCK, key, _lock_enc(
                        LockInfo(key, primary, start_ts, OP_LOCK, ttl)))

    def txn_heart_beat(self, primary: bytes, start_ts: int,
                       ttl: int) -> bool:
        """Extend the primary lock's TTL (reference: TiKV TxnHeartBeat —
        the ttlManager keepalive for long pessimistic txns). TTL only
        grows; returns False when the lock is gone (resolved/expired)."""
        with self._mutate():
            lv = self.kv.get(CF_LOCK, primary)
            if lv is None:
                return False
            lock = _lock_dec(primary, lv)
            if lock.start_ts != start_ts:
                return False
            if ttl > lock.ttl:
                lock.ttl = ttl
                self.kv.put(CF_LOCK, primary, _lock_enc(lock))
            return True

    def pessimistic_rollback(self, keys: list[bytes],
                             start_ts: int) -> None:
        """Release this txn's lock-only locks without leaving a rollback
        marker (reference: TiKV PessimisticRollback — the txn may still
        commit later; only the guards are dropped)."""
        with self._mutate():
            for key in keys:
                lv = self.kv.get(CF_LOCK, key)
                if lv is not None:
                    lock = _lock_dec(key, lv)
                    if lock.start_ts == start_ts and lock.op == OP_LOCK:
                        self.kv.delete(CF_LOCK, key)

    # ---- lock resolution ---------------------------------------------------
    def check_txn_status(self, primary: bytes, lock_ts: int,
                         current_ts: int) -> tuple[int, bool]:
        """(commit_ts, lock_expired): commit_ts>0 means committed;
        0 + expired means safe to roll back (reference:
        lock_resolver.go getTxnStatus)."""
        with self._mutate():
            lv = self.kv.get(CF_LOCK, primary)
            if lv is not None:
                lock = _lock_dec(primary, lv)
                if lock.start_ts == lock_ts:
                    expired = current_ts - lock_ts > (lock.ttl << 18)
                    if expired:
                        self.rollback([primary], lock_ts)
                        return 0, True
                    return 0, False
            kind = self._find_txn_write(primary, lock_ts)
            if kind == OP_ROLLBACK or kind is None:
                # already rolled back, or vanished: mark rollback
                self.rollback([primary], lock_ts)
                return 0, True
            # committed: find its commit_ts
            for wk, wv in self.kv.scan(CF_WRITE,
                                       _wkey(primary, 0xFFFFFFFFFFFFFFFF),
                                       primary + b"\x01"):
                k, commit_ts = _split_vkey(wk)
                if k != primary:
                    break
                st, kd = _write_dec(wv)
                if st == lock_ts and kd != OP_ROLLBACK:
                    return commit_ts, True
            raise TxnNotFoundError(f"txn {lock_ts} status unknown")

    def resolve_lock(self, key: bytes, start_ts: int,
                     commit_ts: int) -> None:
        """Roll a secondary forward (commit_ts>0) or back (reference:
        lock_resolver.go resolveLock)."""
        if commit_ts > 0:
            self.commit([key], start_ts, commit_ts)
        else:
            self.rollback([key], start_ts)

    # ---- recovery ----------------------------------------------------------
    def scan_latest(
        self, start: bytes, end: bytes
    ) -> list[tuple[bytes, int, bytes, Optional[bytes]]]:
        """Newest settled version per key in [start, end):
        (key, commit_ts, kind, value|None). Rollback/lock markers are
        skipped. Restart recovery uses this to re-fold committed rows into
        column epochs."""
        with self._mu:
            out: list[tuple[bytes, int, bytes, Optional[bytes]]] = []
            last_key: Optional[bytes] = None
            it_start = _wkey(start, 0xFFFFFFFFFFFFFFFF) if start else b""
            for wk, wv in self.kv.scan(CF_WRITE, it_start,
                                       end if end else b""):
                key, commit_ts = _split_vkey(wk)
                if end and key >= end:
                    break
                if key == last_key:
                    continue
                start_ts, kind = _write_dec(wv)
                if kind in (OP_ROLLBACK, OP_LOCK):
                    continue
                last_key = key
                val = self.kv.get(CF_DATA, _dkey(key, start_ts)) \
                    if kind == OP_PUT else None
                out.append((key, commit_ts, kind, val))
            return out

    def max_commit_ts(self) -> int:
        """Largest commit_ts in the write column (recovery TSO floor)."""
        with self._mu:
            best = 0
            for wk, _ in self.kv.scan(CF_WRITE, b"", b""):
                _, commit_ts = _split_vkey(wk)
                if commit_ts > best:
                    best = commit_ts
            return best

    def checkpoint(self) -> None:
        with self._mu:
            self.kv.checkpoint()

    def all_locks(self) -> list[LockInfo]:
        with self._mu:
            return [_lock_dec(k, v)
                    for k, v in self.kv.scan(CF_LOCK, b"", b"")]

    def unsafe_destroy_range(self, start: bytes, end: bytes) -> None:
        """Physically remove every version, lock and value in [start, end)
        bypassing MVCC (reference: TiKV UnsafeDestroyRange — the DROP/
        TRUNCATE TABLE data reclaim path). Callers guarantee no reader
        needs the range again."""
        with self._mutate():
            for cf in (CF_LOCK, CF_WRITE, CF_DATA):
                doomed = [k for k, _ in self.kv.scan(cf, start, end)]
                # versioned CFs suffix keys with \x00+ts — the plain range
                # end bound still covers them (suffix sorts below end)
                for k in doomed:
                    self.kv.delete(cf, k)

    # ---- range splits (rpc/ranged.py split protocol) ------------------------
    @staticmethod
    def _user_key(cf: int, raw: bytes) -> bytes:
        """The USER key a raw CF key encodes: lock CF keys are plain,
        data/write CF keys carry the \\x00+ts version suffix. Range
        bounds compare user keys — a raw-bound scan at a split point
        K would misfile versions of any user key that is a strict
        prefix of K (u < K but u+\\x00+ts can sort above K)."""
        return raw if cf == CF_LOCK else _split_vkey(raw)[0]

    def export_range(self, start: bytes,
                     end: bytes) -> list[tuple[int, bytes, bytes]]:
        """Every raw (cf, key, value) whose decoded USER key falls in
        [start, end) — the read half of a range split's WAL partition
        (the child's store is rebuilt from these verbatim: locks,
        write records and values keep their exact encoding, so the
        child replays and resolves orphans identically)."""
        with self._mu:
            out: list[tuple[int, bytes, bytes]] = []
            for cf in (CF_LOCK, CF_WRITE, CF_DATA):
                for k, v in self.kv.scan(cf, b"", b""):
                    u = self._user_key(cf, k)
                    if u >= start and (not end or u < end):
                        out.append((cf, k, v))
            return out

    def discard_range(self, start: bytes, end: bytes) -> int:
        """Physically drop every version, lock and value whose decoded
        USER key falls in [start, end) — the parent-retire half of a
        range split (the child now owns those keys). Differs from
        unsafe_destroy_range by bounding on DECODED keys, which is
        the correct comparison at a split point that some user key
        prefixes. Returns the raw record count removed; idempotent."""
        with self._mutate():
            removed = 0
            for cf in (CF_LOCK, CF_WRITE, CF_DATA):
                doomed = [k for k, _ in self.kv.scan(cf, b"", b"")
                          if (u := self._user_key(cf, k)) >= start
                          and (not end or u < end)]
                for k in doomed:
                    self.kv.delete(cf, k)
                removed += len(doomed)
            return removed

    # ---- GC ----------------------------------------------------------------
    def gc(self, safepoint: int) -> int:
        """Drop versions not visible at/after safepoint (reference:
        gcworker/gc_worker.go DoGC). Returns removed version count."""
        with self._mutate():
            removed = 0
            drop_w: list[bytes] = []
            drop_d: list[bytes] = []
            last_key: Optional[bytes] = None
            kept_newest = False
            for wk, wv in self.kv.scan(CF_WRITE, b"", b""):
                key, commit_ts = _split_vkey(wk)
                if key != last_key:
                    last_key = key
                    kept_newest = False
                start_ts, kind = _write_dec(wv)
                if commit_ts >= safepoint:
                    continue
                if kind in (OP_LOCK, OP_ROLLBACK):
                    # markers never settle a key: collect the marker but
                    # keep looking for the newest REAL version — treating
                    # a marker as the kept version would delete the live
                    # PUT beneath it
                    drop_w.append(wk)
                    continue
                if not kept_newest:
                    kept_newest = True
                    if kind == OP_PUT:
                        continue  # newest visible version stays
                    # newest real record below safepoint is DEL: drop it
                drop_w.append(wk)
                if kind == OP_PUT:
                    drop_d.append(_dkey(key, start_ts))
            for wk in drop_w:
                self.kv.delete(CF_WRITE, wk)
                removed += 1
            for dk in drop_d:
                self.kv.delete(CF_DATA, dk)
            return removed


class _MutationSection:
    """Mutation critical section: the coordinator's section (when
    present) plus the store mutex, entered with the shared WAL caught up
    so conflict checks see every sibling process's records; the engine's
    sync-log boundary at its exit."""

    __slots__ = ("store", "_coord")

    def __init__(self, store: MVCCStore) -> None:
        self.store = store
        self._coord = None

    def __enter__(self):
        c = self._coord = self.store.coord
        if c is not None:
            c.acquire()
            self.store.kv.refresh()
            self.store.kv.tail_clean()
        self.store._mu.acquire()
        return self

    def __exit__(self, *exc) -> None:
        # durability BEFORE visibility to siblings: the section's
        # records fsync per the sync-log policy while the coordinator's
        # section is still held (single-process stores defer the
        # commit-mode fsync to the commit path's group rendezvous, and
        # maybe_sync only fences them). A FAILED fsync must not strand
        # the locks, but it must still FAIL the section: acking a commit
        # whose durability call errored would void the sync-log contract
        c = self._coord
        sync_err: Optional[OSError] = None
        try:
            self.store.kv.maybe_sync()
        except OSError as e:
            sync_err = e
        # coordinator release NEXT, while the store mutex is still held:
        # a remote coordinator publishes (or reverts) the section's
        # buffered records in release(), and doing that outside the
        # mutex would let a concurrent local reader observe a commit
        # that a fenced flush then reverts
        try:
            if c is not None:
                c.release()
        finally:
            self.store._mu.release()
        if sync_err is not None and exc == (None, None, None):
            # surface only on the success path (never mask the original
            # exception already unwinding through this section)
            raise KVError(
                f"WAL fsync failed at commit boundary: {sync_err}"
            ) from sync_err
