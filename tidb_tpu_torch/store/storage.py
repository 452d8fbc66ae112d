"""Storage: the transactional store — percolator KV truth + columnar cache.

Port of the in-memory half of `tidb_tpu/store/storage.py` (its
`Storage(path=None)`). There is ONE transaction path: commits run the
percolator two-phase protocol through the region tier (TwoPhaseCommitter
over RegionManager over MVCCStore), over the reference's pure-Python
ordered KV (`kv/mvcc.PyOrderedKV`; the reference takes its C++ twin when
that builds, with the same answers). Each table owns its region
(register_table splits at the table prefix), so multi-table transactions
exercise region-grouped batches.

The per-table column epochs (TableStore) are the COPROCESSOR-FACING fold
of the same committed data — applied under the commit lock immediately
after the percolator commit lands. Snapshots read the columnar fold; the
KV tier holds the truth (locks, write records, versioned values).

Left out, with the planes they belong to: `path=` and everything durable
(the WAL, `sync_log`, group commit, epoch files, `checkpoint`,
`_recover`, the TSO lease), the multi-process and RPC planes (`shared`,
`remote`, ranges, replica reads, the coordinator, `refresh`), sequences,
user locks, privileges, bindings, the DDL job queue and the observability
planes (metrics, events, history, heat). Partitioned tables raise
`NotInSlice("partitioned table")`. The port states no durability
guarantee: every write lives in this process.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..catalog.schema import Catalog, TableInfo
from ..errno import (ER_SCHEMA_CHANGED, ER_TXN_TOO_LARGE,
                     ER_WRITE_CONFLICT, CodedError)
from ..errors import NotInSlice
from ..kv import codec, tablecodec
from ..kv.memdb import TOMBSTONE, MemDB
from ..kv.mvcc import (OP_DEL, OP_LOCK, OP_PUT, KeyIsLockedError, KVError,
                       MVCCStore, Mutation)
from ..kv.mvcc import WriteConflictError as KVWriteConflict
from ..kv.region import RegionManager
from ..kv.tso import TimestampOracle
from ..kv.twopc import CommitError, LockResolver, Snapshot, TwoPhaseCommitter
from ..stats.handle import StatsHandle
from .table_store import TableSnapshot, TableStore


class WriteConflictError(CodedError):
    """Another txn committed to a key after our start_ts (optimistic SI)."""

    errno = ER_WRITE_CONFLICT


class TxnTooLargeError(CodedError):
    """Encoded mutation bytes crossed performance.txn-total-size-limit
    (reference: kv.ErrTxnTooLarge / txn-total-size-limit, config.go) —
    a runaway txn must fail BEFORE prewrite floods the region tier."""

    errno = ER_TXN_TOO_LARGE


class Storage:
    def __init__(self) -> None:
        from ..session.sysvars import SysVarManager

        self.catalog = Catalog()
        # commit-time cap over a txn's ENCODED mutation bytes
        # (performance.txn-total-size-limit; 0 disables) — enforced in
        # commit() with ER_TXN_TOO_LARGE
        self.txn_total_size_limit = 100 * 1024 * 1024
        self.stats = StatsHandle()
        self.tables: dict[int, TableStore] = {}
        # the transactional KV truth: percolator MVCC over regions
        self.kv = MVCCStore()
        self.tso = TimestampOracle()
        self.rm = RegionManager(self.kv)
        self.committer = TwoPhaseCommitter(self.rm, self.tso)
        # GLOBAL sysvar plane (mysql.global_variables analog) — rides the
        # meta keyspace (put_meta / get_meta)
        self.sysvars = SysVarManager(self)
        self._commit_lock = threading.RLock()
        # seqlock generation for snapshot/fold consistency: odd while a
        # commit fold is in flight inside _commit_lock, even when
        # quiescent. Readers snapshot lock-free and retry on movement;
        # only a reader racing an active fold falls back to the lock.
        self._fold_seq = 0
        self._fold_depth = 0  # reentrancy: only the outermost bumps seq
        # active snapshot ts registry -> GC/compaction safepoint
        self._active_snapshots: dict[int, int] = {}
        self._snap_lock = threading.Lock()
        # waits-for edges for pessimistic deadlock detection
        # (reference: TiKV's deadlock detector service; util/deadlock)
        self._waits_for: dict[int, int] = {}
        self._waits_lock = threading.Lock()

    # ---- schema ------------------------------------------------------------
    def register_table(self, info: TableInfo) -> TableStore:
        if getattr(info, "partition", None) is not None:
            raise NotInSlice("partitioned table")
        store = TableStore(info)
        self.tables[info.id] = store
        # one region per table (reference: split-table-region on create,
        # ddl/split_region.go) — multi-table commits become multi-region
        try:
            self.rm.split(tablecodec.table_prefix(info.id))
        except ValueError:
            pass  # split point already a region boundary
        return store

    def unregister_table(self, table_id: int) -> None:
        self.tables.pop(table_id, None)

    def destroy_table_data(self, table_id: int) -> None:
        """Physically drop a table's KV range (DROP/TRUNCATE path;
        reference: UnsafeDestroyRange driven by the GC worker for dropped
        objects, ddl/delete_range.go + store/tikv/gcworker)."""
        lo, hi = tablecodec.table_range(table_id)
        self.kv.unsafe_destroy_range(lo, hi)

    def table_store(self, table_id: int) -> TableStore:
        return self.tables[table_id]

    def _kv_row(self, store: Optional[TableStore], row) -> list:
        """Physical row -> KV value encoding. String dictionary codes are
        decoded to the actual strings so the KV truth is self-contained."""
        if store is None:
            return list(row)
        out = []
        for v, d in zip(row, store.dictionaries):
            if d is not None and v is not None:
                out.append(d.decode(int(v)))
            else:
                out.append(v)
        return out

    # ---- snapshot registry (compaction safepoint) ---------------------------
    def acquire_snapshot_ts(self) -> int:
        ts = self.tso.next_ts()
        with self._snap_lock:
            self._active_snapshots[ts] = self._active_snapshots.get(ts, 0) + 1
        return ts

    def release_snapshot_ts(self, ts: int) -> None:
        with self._snap_lock:
            n = self._active_snapshots.get(ts, 0) - 1
            if n <= 0:
                self._active_snapshots.pop(ts, None)
            else:
                self._active_snapshots[ts] = n

    def safe_ts(self) -> int:
        """Newest ts that every active snapshot is at or above."""
        with self._snap_lock:
            if self._active_snapshots:
                return min(self._active_snapshots) - 1
        return self.tso.current()

    # ---- transactions ------------------------------------------------------
    def begin(self, pessimistic: bool = False) -> "Transaction":
        return Transaction(self, self.acquire_snapshot_ts(),
                           pessimistic=pessimistic)

    class DeadlockError(CodedError):
        errno = 1213  # ER_LOCK_DEADLOCK
        sqlstate = "40001"

    class LockWaitTimeout(CodedError):
        errno = 1205  # ER_LOCK_WAIT_TIMEOUT

    def pessimistic_lock_keys(self, txn: "Transaction", keys: list[bytes],
                              timeout_s: float = 50.0) -> bool:
        """Acquire pessimistic locks with wait + deadlock detection
        (reference: executor/adapter.go:533 handlePessimisticDML ->
        pessimistic.go lock-wait; deadlock detection is TiKV's detector
        service, here a local waits-for graph).

        WriteConflictError (a commit newer than txn.for_update_ts)
        propagates to the caller, which retries its whole statement at a
        fresh for_update_ts (adapter.go:623)."""
        if not keys:
            return False
        keys = sorted(keys)
        if txn.pessimistic_primary is None:
            txn.pessimistic_primary = keys[0]
        deadline = time.monotonic() + timeout_s
        backoff = 0.001
        waited = False
        while True:
            try:
                self.kv.pessimistic_lock(keys, txn.pessimistic_primary,
                                         txn.start_ts, txn.for_update_ts)
                with self._waits_lock:
                    self._waits_for.pop(txn.start_ts, None)
                txn.locked_keys.update(keys)
                txn.start_heartbeat()
                # True = we blocked on someone: the caller's read view may
                # predate whatever that someone committed and needs a
                # refresh before constraint checks
                return waited
            except KVError as e:
                if not isinstance(e, KeyIsLockedError):
                    with self._waits_lock:
                        self._waits_for.pop(txn.start_ts, None)
                    raise
                holder = e.lock.start_ts
                with self._waits_lock:
                    # cycle check before we block on `holder`
                    self._waits_for[txn.start_ts] = holder
                    seen = {txn.start_ts}
                    cur = holder
                    while cur in self._waits_for:
                        cur = self._waits_for[cur]
                        if cur in seen:
                            self._waits_for.pop(txn.start_ts, None)
                            raise Storage.DeadlockError(
                                "Deadlock found when trying to get lock; "
                                "try restarting transaction")
                        seen.add(cur)
                # the holder may be dead: TTL-expired locks resolve now
                try:
                    LockResolver(self.rm, self.tso).resolve(e.lock)
                except KVError:
                    pass
                if time.monotonic() >= deadline:
                    with self._waits_lock:
                        self._waits_for.pop(txn.start_ts, None)
                    raise Storage.LockWaitTimeout(
                        "Lock wait timeout exceeded; try restarting "
                        "transaction") from None
                waited = True
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.05)

    def commit(self, txn: "Transaction") -> int:
        """THE commit path: schema fence -> percolator 2PC through the
        region tier -> columnar fold. One source of truth (the KV write
        records), one fold (the epochs the coprocessor reads)."""
        mutations = txn.memdb.mutations()
        if not mutations:
            if txn.locked_keys:
                # lock-only txn (SELECT FOR UPDATE with no writes): the
                # guards served their purpose; drop them
                self.kv.pessimistic_rollback(sorted(txn.locked_keys),
                                             txn.start_ts)
            return txn.start_ts
        # fence + encode happen OUTSIDE the commit lock: prewrite can
        # block on other txns' row locks for the whole lock-wait budget,
        # and holding the commit lock there would stall every other
        # commit — including the lock holder's, a guaranteed deadlock.
        # The fence re-check inside the lock stays authoritative.
        self._check_schema_fence(txn)
        kv_muts = []
        written = set()
        try:
            for (table_id, handle), row in mutations.items():
                key = tablecodec.record_key(table_id, handle)
                written.add(key)
                if row is TOMBSTONE:
                    kv_muts.append(Mutation(OP_DEL, key))
                else:
                    kv_muts.append(Mutation(OP_PUT, key, codec.encode_key(
                        self._kv_row(self.tables.get(table_id), row))))
        except (IndexError, KeyError):
            # dictionary codes no longer decode: DDL rewrote the column
            # between our buffering and this encode
            raise WriteConflictError(
                "Information schema is changed during the execution "
                "of the statement; try again",
                errno=ER_SCHEMA_CHANGED) from None
        # pessimistic guards on unwritten keys commit as lock-only
        # records so 2PC clears them atomically (reference: OP_LOCK
        # mutations through prewrite; kv/memdb lock-only entries)
        for key in sorted((txn.locked_keys | txn.guard_keys) - written):
            kv_muts.append(Mutation(OP_LOCK, key))
        # performance.txn-total-size-limit over the ENCODED bytes —
        # measured post-encode, pre-prewrite, so an oversized txn fails
        # before prewriting a single lock
        limit = self.txn_total_size_limit
        if limit > 0:
            total = sum(len(m.key) + len(m.value) for m in kv_muts)
            if total > limit:
                # clear pessimistic locks/guards already written to the
                # KV (an orphaned OP_LOCK would stall writers on those
                # rows for the full lock TTL)
                self._best_effort_rollback(kv_muts, txn.start_ts)
                raise TxnTooLargeError(
                    f"Transaction is too large, size: {total} "
                    f"(txn-total-size-limit: {limit})")
        try:
            state = self.committer.prewrite_phase(kv_muts, txn.start_ts)
        except KVWriteConflict as e:
            self._best_effort_rollback(kv_muts, txn.start_ts)
            raise WriteConflictError(str(e)) from None
        except (KVError, CommitError) as e:
            self._best_effort_rollback(kv_muts, txn.start_ts)
            raise WriteConflictError(f"commit failed: {e}") from None
        with self._commit_lock, self._fold_section():
            try:
                self._check_schema_fence(txn)
            except WriteConflictError:
                self._best_effort_rollback(kv_muts, txn.start_ts)
                raise
            try:
                commit_ts = self.committer.commit_phase(state, txn.start_ts)
            except (KVError, CommitError) as e:
                self._best_effort_rollback(kv_muts, txn.start_ts)
                raise WriteConflictError(f"commit failed: {e}") from None
            # columnar fold of the committed mutations (the coprocessor's
            # read view) — inside the lock so no snapshot can observe the
            # KV commit without the fold
            for (table_id, handle), row in mutations.items():
                store = self.tables.get(table_id)
                if store is not None:
                    store.apply_commit(commit_ts, handle, row)
        # opportunistic compaction at the GC-safe ts
        safe = self.safe_ts()
        for (table_id, _), _ in mutations.items():
            store = self.tables.get(table_id)
            if store is not None:
                store.maybe_compact(min(safe, commit_ts - 1) if safe else 0)
        return commit_ts

    def _check_schema_fence(self, txn: "Transaction") -> None:
        """Fail txns whose buffered rows target a superseded table layout
        (reference: schema validator, domain/schema_validator.go)."""
        for table_id, token in txn.schema_tokens.items():
            store = self.tables.get(table_id)
            if store is not None and store.schema_token != token:
                raise WriteConflictError(
                    "Information schema is changed during the execution "
                    "of the statement; try again",
                    errno=ER_SCHEMA_CHANGED)

    @contextmanager
    def _fold_section(self):
        """Marks a fold in flight for the snapshot seqlock. Must be
        entered while holding _commit_lock. Reentrant: only the outermost
        transition flips the seq."""
        if self._fold_depth == 0:
            self._fold_seq += 1  # odd: writer active
        self._fold_depth += 1
        try:
            yield
        finally:
            self._fold_depth -= 1
            if self._fold_depth == 0:
                self._fold_seq += 1  # even: quiescent

    # ---- meta KV (sysvar persistence plane) ------------------------------
    def put_meta(self, name: bytes, value: bytes) -> None:
        """Metadata write through the SAME percolator path as row data
        (reference: meta/meta.go over the m-prefix keyspace). Non-catalog
        keys are last-writer-wins snapshots, so a conflict retries with a
        fresh ts; the catalog key never blind-retries."""
        from ..kv.backoff import BO_META, Backoffer, BackoffExhausted

        key = tablecodec.meta_key(name)
        retriable = name != b"catalog"
        bo = Backoffer(budget_ms=2000)
        while True:
            start_ts = self.tso.ts()
            try:
                with self._commit_lock:
                    self.committer.commit(
                        [Mutation(OP_PUT, key, value)], start_ts)
                return
            except KVWriteConflict:
                if not retriable:
                    raise
                try:
                    bo.sleep(BO_META)
                except BackoffExhausted as e:
                    raise WriteConflictError(
                        f"meta write on {name!r}: {e}") from None

    def get_meta(self, name: bytes) -> Optional[bytes]:
        snap = Snapshot(self.rm, self.tso, self.tso.next_ts())
        return snap.get(tablecodec.meta_key(name))

    def _best_effort_rollback(self, kv_muts, start_ts: int) -> None:
        """Clear any prewrite locks a failed commit left behind (the lock
        resolver would also reclaim them by TTL — this is just prompt)."""
        try:
            self.committer.rollback(kv_muts, start_ts)
        except Exception:
            pass

    def flush(self) -> None:
        """Fold all committed deltas into base epochs (test/bench helper)."""
        safe = self.safe_ts()
        for store in self.tables.values():
            store.compact(safe)


class Transaction:
    """A snapshot-isolation transaction; optimistic by default.

    Pessimistic mode (reference: session/txn pessimistic flag +
    store/tikv/pessimistic.go): DML acquires OP_LOCK guards at execution
    time via Storage.pessimistic_lock_keys, reads for DML happen at
    for_update_ts (latest), and commit converts the guards through the
    normal 2PC prewrite."""

    def __init__(self, storage: Storage, start_ts: int,
                 pessimistic: bool = False) -> None:
        self.storage = storage
        self.start_ts = start_ts
        self.memdb = MemDB()
        self._finished = False
        # table_id -> schema_token observed at first buffered write
        self.schema_tokens: dict[int, int] = {}
        self.pessimistic = pessimistic
        self.for_update_ts = start_ts
        self.pessimistic_primary: Optional[bytes] = None
        self.locked_keys: set[bytes] = set()
        # unique-index guard keys claimed by OPTIMISTIC DML: committed
        # as lock-only mutations so two concurrent claims of the same
        # unique value collide in 2PC prewrite
        self.guard_keys: set[bytes] = set()
        # per-statement read-ts override (FOR UPDATE / pessimistic DML
        # read latest; plain SELECT keeps the start_ts snapshot)
        self.stmt_read_ts: Optional[int] = None
        self._heartbeat_stop: Optional[threading.Event] = None

    def start_heartbeat(self) -> None:
        """TTL keepalive for the pessimistic primary lock (reference:
        2pc.go ttlManager goroutine -> TiKV TxnHeartBeat): without it an
        idle txn's locks expire after the initial TTL and contenders
        roll the txn back, failing its eventual COMMIT."""
        if self._heartbeat_stop is not None or \
                self.pessimistic_primary is None:
            return
        stop = threading.Event()
        self._heartbeat_stop = stop
        primary = self.pessimistic_primary
        start_physical = self.start_ts >> 18

        def beat() -> None:
            while not stop.wait(5.0):
                elapsed_ms = int(time.time() * 1000) - start_physical
                if not self.storage.kv.txn_heart_beat(
                        primary, self.start_ts, elapsed_ms + 20000):
                    return  # lock gone: resolved or finished
        threading.Thread(target=beat, name="titpu-txn-ttl",
                         daemon=True).start()

    def refresh_for_update_ts(self) -> int:
        """New for_update_ts for a (re)tried pessimistic statement
        (reference: executor/adapter.go:533)."""
        self.for_update_ts = self.storage.tso.next_ts()
        return self.for_update_ts

    # ---- writes ------------------------------------------------------------
    def set_row(self, table_id: int, handle: int, row: tuple) -> None:
        self._note_schema(table_id)
        self.memdb.set((table_id, handle), row)

    def delete_row(self, table_id: int, handle: int) -> None:
        self._note_schema(table_id)
        self.memdb.set((table_id, handle), TOMBSTONE)

    def _note_schema(self, table_id: int) -> None:
        if table_id not in self.schema_tokens:
            store = self.storage.tables.get(table_id)
            if store is not None:
                self.schema_tokens[table_id] = store.schema_token

    # ---- reads -------------------------------------------------------------
    def snapshot(self, table_id: int) -> TableSnapshot:
        """Snapshot at start_ts (or the statement's read-ts override)
        unioned with our own uncommitted writes.

        Built under the storage commit lock when a fold is in flight: a
        sibling's commit releases its KV row locks in commit_phase but
        appends the columnar fold a moment later (both inside
        _commit_lock); a pessimistic retry that resumes in between must
        not read the pre-commit columnar state. Seqlock fast path: when
        no fold is in flight the snapshot is lock-free."""
        store = self.storage.table_store(table_id)
        overlay = {h: v for h, v in self.memdb.iter_table(table_id)}
        ts = self.stmt_read_ts if self.stmt_read_ts is not None \
            else self.start_ts
        for _ in range(4):
            seq = self.storage._fold_seq
            if seq & 1:
                break  # fold active: wait on the lock
            snap = store.snapshot(ts, overlay or None)
            if self.storage._fold_seq == seq:
                return snap
        with self.storage._commit_lock:
            return store.snapshot(ts, overlay or None)

    # ---- lifecycle ---------------------------------------------------------
    def commit(self) -> int:
        assert not self._finished, "transaction already finished"
        try:
            return self.storage.commit(self)
        finally:
            self._finish()

    def rollback(self) -> None:
        if not self._finished:
            if self.locked_keys:
                self.storage.kv.pessimistic_rollback(
                    sorted(self.locked_keys), self.start_ts)
            self._finish()

    def _finish(self) -> None:
        self._finished = True
        if self._heartbeat_stop is not None:
            self._heartbeat_stop.set()
            self._heartbeat_stop = None
        self.storage.release_snapshot_ts(self.start_ts)
