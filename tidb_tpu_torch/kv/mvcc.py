"""Percolator MVCC store: lock/write/data columns over an ordered KV.

Counterpart of the reference's in-process TiKV MVCC engines (reference:
store/mockstore/mocktikv/mvcc_leveldb.go — Prewrite :commitOneKey paths,
Commit, Rollback, ResolveLock, Get/Scan with lock checks) and the
percolator model TiKV itself implements.

Column families:
  lock:  key -> (start_ts, primary, op, ttl)
  write: key + rev(commit_ts) -> (start_ts, kind)   kind: P/D/R
  data:  key + rev(start_ts)  -> value bytes

Port of the in-memory half of `tidb_tpu/kv/mvcc.py`: `PyOrderedKV`
without a path (the reference's own pure-Python engine, the twin of its
C++ `NativeOrderedKV`) and `MVCCStore` with reads, percolator writes,
pessimistic locks, lock resolution and range destruction. The WAL,
its sync policy and snapshot files, the shared-directory refresh and the
coordinator's mutation section are the durable and multi-process planes,
and `gc` belongs to the GC worker: not ported, so every mutation section
is the store mutex alone.
"""

from __future__ import annotations

import bisect
import struct
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

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
    """Sorted-key in-memory KV with 3 column families: the reference's
    pure-Python engine without a path (no WAL, no snapshot file)."""

    def __init__(self) -> None:
        self._maps: list[dict[bytes, bytes]] = [{}, {}, {}]
        self._keys: list[list[bytes]] = [[], [], []]

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
        self._apply_put(cf, key, value)

    def delete(self, cf: int, key: bytes) -> None:
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
    def __init__(self, engine=None) -> None:
        self.kv = engine if engine is not None else PyOrderedKV()
        self._mu = threading.RLock()

    def _mutate(self):
        return self._mu

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
            for m in mutations:
                self.kv.put(CF_LOCK, m.key, _lock_enc(
                    LockInfo(m.key, primary, start_ts, m.op, ttl)))
                if m.op == OP_PUT:
                    self.kv.put(CF_DATA, _dkey(m.key, start_ts), m.value)

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
        with self._mutate():
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
