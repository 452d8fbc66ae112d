"""Storage: the transactional store — percolator KV truth + columnar cache.

Port of `tidb_tpu/store/storage.py`: `Storage(path=None)` in memory, and
`Storage(path, sync_log=...)` durable — the KV WAL and snapshot under
`path/kv` (the C++ engine `kv/native.py` when it builds, its pure-Python
twin otherwise, as the reference chooses), columnar epoch snapshots under
`path/epochs`, the catalog, statistics, GLOBAL sysvars and accounts in the
meta keyspace of the same KV, and a TSO lease file. Reopening the
directory recovers everything committed (`_recover`), and `sync_log`
says when an acknowledged commit reaches the disk: 'commit' fsyncs before
the acknowledgement (one group fsync for every committer that rendezvous
on it), 'interval' at most once per `sync_interval_ms`, 'off' never.

The DDL job queue lives here (`ddl_jobs`, `ddl_history`, persisted as
`ddl:jobs` in the meta keyspace with each job's reorg checkpoint), with
its owner (`ddl_owner`: `owner.owner_manager`, an flock on a durable
directory): `_recover` resumes a pending job from its checkpoint.
`ddl_section` serializes the direct catalog DDL (CREATE/DROP TABLE and
friends) on the same owner. Sequences allocate from cached cursors with a
persisted high-water (`sequence_next`, `sequence_set`), flushed exactly at
a checkpoint. `user_locks` is the table of GET_LOCK's named locks
(`UserLocks`), shared by every session over the storage.

The three multi-process modes of the reference are here too:
`Storage(path, shared=True)` — processes sharing one directory, through
`store/coordinator.py` (the flock'd mutation section, the kill mailbox),
`kv/tso.SharedTSO` and the shared-WAL `PyOrderedKV`; with
`rpc_listen='host:port'` the same leader also serves the coordination
RPC tier (`rpc/server.py`); `Storage(path, remote='host:port')` (or
`path='rpc://host:port'`) is a socket follower with a private working
directory, mirroring the leader's WAL over RPC (`rpc/remote.py`),
allocating timestamps from the leader (`kv/tso.RemoteTSO`), folding in
the background (`rpc/apply.py`) and answering diagnostics on its own
listener (`rpc/diag.py`). `refresh` folds other processes' commits into
this process's columnar epochs and reloads the catalog when it moved;
`_check_schema_fence` aborts a transaction that buffered against a
superseded layout. A follower's private `path` has no epoch files, so,
as in the reference, it reads no rows of a table the leader
bulk-loaded (`TableStore.bulk_load` bypasses the KV). `close()` joins
every thread a mode starts and re-raises an error a serving thread
kept (`rpc/server.py`, `rpc/apply.py`, `rpc/failover.py`).

A socket follower with `election_timeout_ms > 0` runs the failover
watcher (`rpc/failover.py`): on leader loss it elects, and the winner
`promote_to_leader`s in place over its WAL mirror while the others
`repoint_leader`. A follower serves routed snapshot reads
(`rpc/replica.py`) on pooled internal sessions on `device` (None: the
card), holding the read's timestamp with `pin_snapshot_ts`.

The keyspace heat plane (`heat`, `obs_heat.RangeHeatRecorder`, off until
configured) is fed by the committer over local regions, the coprocessor
clients of the sessions and the point fast path; `arm_ranges` starts the
range plane (`ranges`, `rpc/ranged.RangePlane`) on a durable local store,
and `close()` closes it, re-raising an error its lease loop kept.

The long-lived locks (`_commit_lock`, `infoschema_lock`, `_lease_lock`)
come from the lock-order checker's factories (`analysis/lockcheck.py`).
The mesh plane's epoch listeners (`add_epoch_listener`) fire after every
base-epoch replacement and free a folded epoch's sharded tensors. GLOBAL
plan bindings (`bindings`,
`session/bindinfo.py`) ride the meta keyspace.

The observability planes live here as in the reference: `obs` (the
metrics, Top SQL, the wait profile and the event ring, which the
governor, the admission gate, the committer's lock resolver, the WAL's
fsync-stall hook, checkpoints and group commits record into),
`governor` and `admission` (`util/governor.py`, both off until
configured), `metrics_history` (its sampler thread started by the
server and joined by `close`), `diagnostics` (`obs_inspect.py`) and
`history` (`obs_history.py`, persisted under `<path>/history/`).
`maintenance` is the background worker (`store/daemon.py`: lock TTL, GC
at the safepoint under `gc_owner`, compaction, auto-analyze, checkpoint),
started by the server process and joined by `close`. `processlist` is
set by a serving `Server` (its live connections' rows).

A partitioned table is one `TableStore` per partition, each under its own
table id and region (`child_table_info`); the partitions share the first
partition's string dictionaries (until a reopen: `_load_epoch` gives each
partition its own epoch file's, as the reference does), and the first
partition's store is the table's handle allocator, whose counter
`_recover` raises over every partition's handles.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import struct
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Optional

import numpy as np

from ..analysis import lockcheck
from ..catalog.schema import Catalog, TableInfo
from ..chunk.column import Dictionary
from ..errno import (ER_SCHEMA_CHANGED, ER_TXN_TOO_LARGE,
                     ER_WRITE_CONFLICT, CodedError)
from ..kv import codec, tablecodec
from ..kv.memdb import TOMBSTONE, MemDB
from ..kv.mvcc import (OP_DEL, OP_LOCK, OP_PUT, KeyIsLockedError, KVError,
                       MVCCStore, Mutation, PyOrderedKV, fsync_dir)
from ..kv.native import NativeOrderedKV, NativeUnavailable, native_available
from ..kv.mvcc import WriteConflictError as KVWriteConflict
from ..kv.region import RegionManager
from ..kv.tso import TimestampOracle
from ..kv.twopc import CommitError, LockResolver, Snapshot, TwoPhaseCommitter
from ..obs import Observability
from ..stats.handle import StatsHandle
from ..util import failpoint
from .table_store import (ColumnEpoch, TableSnapshot, TableStore,
                          _column_dictionary, _epoch_ids)


class WriteConflictError(CodedError):
    """Another txn committed to a key after our start_ts (optimistic SI)."""

    errno = ER_WRITE_CONFLICT


class TxnTooLargeError(CodedError):
    """Encoded mutation bytes crossed performance.txn-total-size-limit
    (reference: kv.ErrTxnTooLarge / txn-total-size-limit, config.go) —
    a runaway txn must fail BEFORE prewrite floods the region tier."""

    errno = ER_TXN_TOO_LARGE


def _make_engine(path: Optional[str] = None, sync_log: str = "off",
                 sync_interval_ms: int = 100):
    """C++ ordered-KV engine when buildable, pure-python twin otherwise.
    With `path`, either engine opens WAL+snapshot files there (shared
    format, csrc/kvstore.cpp) and honors the sync-log policy."""
    try:
        if native_available():
            return NativeOrderedKV(path, sync_log=sync_log,
                                   sync_interval_ms=sync_interval_ms)
    except NativeUnavailable:
        pass
    if path is not None:
        return PyOrderedKV(path, sync_log=sync_log,
                           sync_interval_ms=sync_interval_ms)
    return None


# TSO lease horizon persisted ahead of issued timestamps (~2 min of
# physical time); restart floors the oracle at the lease so ts never repeat
_TSO_LEASE_MS = 120_000


class Storage:
    def __init__(self, path: Optional[str] = None,
                 shared: bool = False, remote=None,
                 rpc_listen=None, rpc_options=None,
                 sync_log: str = "off",
                 sync_interval_ms: int = 100,
                 device=None) -> None:
        """`path=None`: ephemeral in-memory store (tests, benches).
        `path=dir`: durable — KV WAL+snapshot under dir/kv, columnar epoch
        snapshots under dir/epochs, catalog/stats state in the meta
        keyspace of the same KV; reopening the directory recovers
        everything committed.

        `sync_log` (storage.sync-log): when the KV WAL reaches disk —
        'commit' fsyncs at every commit boundary (no acked commit can
        die with the machine), 'interval' group-commits at most one
        fsync per `sync_interval_ms`, 'off' leaves flushing to the OS
        (process death loses nothing, power loss may).

        `shared=True` (requires path): several server processes over one
        directory. `rpc_listen='host:port'|'unix:/path'` (with shared):
        also serve the coordination RPC tier, so followers join without
        sharing the disk. `remote='host:port'`: a socket follower, `path`
        its PRIVATE working dir; `path='rpc://host:port'` selects this
        mode with a throwaway working dir.

        `device`: where the sessions this storage makes itself run (a
        follower's replica-read serving sessions); None is the card."""
        from ..session.privileges import PrivilegeManager
        from ..session.sysvars import SysVarManager

        if sync_log not in ("off", "commit", "interval"):
            raise ValueError(
                f"sync_log must be off|commit|interval, got {sync_log!r}")
        if isinstance(path, str) and path.startswith("rpc://"):
            remote, path = path[len("rpc://"):], None
        self._owns_tmp_dir = remote is not None and path is None
        if self._owns_tmp_dir:
            import tempfile
            path = tempfile.mkdtemp(prefix="titpu-follower-")
        self.path = path
        self.remote = remote is not None
        self.shared = bool((shared or self.remote) and path is not None)
        self.sync_log = sync_log
        self.sync_interval_ms = sync_interval_ms
        self.coord = None
        self.rpc_server = None
        self._rpc_client = None
        self._rpc_options = rpc_options
        self._start_time = time.time()
        self.diag_listener = None
        self.device = device
        self.failover = None
        # range-sharded write leadership (rpc/ranged.py RangePlane);
        # None until [ranges] arms it — the statement path never reads
        # this attribute, so disabled costs exactly nothing
        self.ranges = None
        # True while promote_to_leader is mid-flight: diag_election
        # reports the transitional role so peer voters HOLD their
        # election open instead of dropping us from the electorate
        # (dropping the winner mid-promotion elects a second leader)
        self._promoting = False
        # diag fan-out state, owned here so concurrent first queries
        # never race a lazy init (rpc/diag.py uses these)
        self._diag_clients: dict = {}
        self._diag_clients_lock = threading.Lock()
        self._last_members = None
        self._last_members_ts = -1e9
        # follower read tier (rpc/apply.py + rpc/replica.py): per-
        # storage routing/serving knobs, the follower's continuous
        # apply engine (started at the end of __init__ for socket
        # followers; arm_replica_read re-evaluates after config seeds),
        # and the pooled internal sessions replica reads execute on
        from ..rpc.replica import ReplicaReadState
        self.replica_read = ReplicaReadState()
        self.apply_engine = None
        self._replica_pool: list = []
        self._replica_pool_lock = threading.Lock()
        if self.remote:
            from ..rpc.client import RpcClient, RpcOptions
            from ..rpc.diag import DiagListener
            from ..rpc.errors import RPCError
            from ..rpc.remote import RemoteCoordinator
            opts = self._rpc_options = rpc_options or RpcOptions()
            self._rpc_client = RpcClient(remote, opts)
            try:
                self._rpc_client.call("hello")  # fail fast on a dead leader
                # the diagnostics endpoint peers query for cluster_* rows;
                # registered with the leader now and re-announced on
                # every heartbeat (a restarted leader relearns the shape)
                self.diag_listener = DiagListener(self, opts.diag_listen)
                self._rpc_client.ping_params = {
                    "diag_addr": self.diag_listener.address,
                    "role": "follower"}
                try:
                    self._rpc_client.call(
                        "diag_register",
                        addr=self.diag_listener.address,
                        role="follower", _budget_ms=1000)
                except RPCError:
                    pass  # the next heartbeat re-registers
                self._rpc_client.start_heartbeat()
                self.coord = RemoteCoordinator(self._rpc_client, opts)
                # heartbeats carry our node id too, so a leader that
                # restarted rebuilds an id-accurate registry from beats
                self._rpc_client.ping_params["node_id"] = \
                    self.coord.node_id
            except BaseException:
                # a failed join leaks no accept thread, bound socket or
                # connected client (callers have no Storage to close)
                if self.diag_listener is not None:
                    self.diag_listener.close()
                self._rpc_client.close()
                raise
        elif self.shared:
            from .coordinator import SharedDirCoordinator
            self.coord = SharedDirCoordinator(path)
        self.catalog = Catalog()
        # per-storage metrics, slow log and statement digests
        self.obs = Observability()
        # the diagnostics service (the diag_* RPC plane answers from it;
        # local stores query it directly for the cluster_* tables)
        from ..rpc.diag import DiagService
        if self.diag_listener is not None:
            self.diag = self.diag_listener.service
        else:
            self.diag = DiagService(self)
        # server-wide overload protection (util/governor.py): the global
        # memory ledger + kill policy and the execution admission gate,
        # both off by default (limit 0 / tokens 0); their metrics ride
        # this storage's registry
        from ..util.governor import AdmissionGate, MemoryGovernor
        self.governor = MemoryGovernor(self.obs.metrics)
        self.admission = AdmissionGate(self.obs.metrics)
        self.governor.events = self.obs.events
        self.admission.events = self.obs.events
        # bounded time-series of counter/gauge samples feeding
        # metrics_schema and information_schema.metrics_summary; the
        # serving Server starts its thread (embedded stores sample on
        # demand), and close() always joins it
        from .. import obs as _obs
        self.metrics_history = _obs.MetricsHistory(
            [self.obs.metrics, _obs.PROCESS_METRICS])
        # the inspection engine's settings and edge-trigger memory
        from .. import obs_inspect as _inspect
        self.diagnostics = _inspect.DiagnosticsState()
        _inspect.track(self)
        # workload-history plane: per-digest (sql_digest, plan_digest)
        # history, persisted under <path>/history/; off by default
        from ..obs_history import WorkloadHistory
        self.history = WorkloadHistory(path=path,
                                       metrics=self.obs.metrics,
                                       events=self.obs.events)
        # keyspace heat plane (obs_heat.py): per-range traffic matrix +
        # hot-range detection + split advisories. Same zero-work-while-
        # disabled contract as Top SQL / history; [heatmap] config or
        # embedded callers arm it via heat.configure(enabled=True).
        from ..obs_heat import RangeHeatRecorder
        self.heat = RangeHeatRecorder(metrics=self.obs.metrics,
                                      events=self.obs.events)
        # commit-time cap over a txn's ENCODED mutation bytes
        # (performance.txn-total-size-limit; 0 disables) — enforced in
        # commit() with ER_TXN_TOO_LARGE
        self.txn_total_size_limit = 100 * 1024 * 1024
        self._tso_lease = 0
        # serializes lease-file persistence: concurrent committers both
        # crossing the extension threshold would race the SAME tmp+rename
        self._lease_lock = lockcheck.lock("Storage._lease_lock")
        if path is not None:
            os.makedirs(os.path.join(path, "epochs"), exist_ok=True)
            self._tso_lease = self._read_tso_lease()
        self.stats = StatsHandle()
        self.tables: dict[int, TableStore] = {}
        # the transactional KV truth: percolator MVCC over regions
        if self.remote:
            # socket follower: the engine mirrors the leader's WAL over
            # RPC; its appends publish through the leased mutation
            # section (rpc/remote.py), with a byte mirror under the
            # private dir
            from ..rpc.remote import RemoteKV
            engine = RemoteKV(self._rpc_client,
                              mirror_dir=os.path.join(path, "kv"),
                              sync_log=sync_log,
                              sync_interval_ms=sync_interval_ms)
            try:
                engine.bootstrap()
            except BaseException:
                engine.close()
                self.diag_listener.close()
                self._rpc_client.close()
                raise
            self.coord.engine = engine
        elif self.shared:
            # the shared-WAL refresh protocol lives in the Python engine;
            # the flock'd sections make its appends safe cross-process
            engine = PyOrderedKV(os.path.join(path, "kv"), shared=True,
                                 sync_log=sync_log,
                                 sync_interval_ms=sync_interval_ms)
        else:
            engine = _make_engine(
                os.path.join(path, "kv") if path is not None else None,
                sync_log=sync_log, sync_interval_ms=sync_interval_ms)
        self.kv = MVCCStore(engine=engine, coord=self.coord)
        if path is not None and self._tso_lease == 0 and not self.remote:
            # lease file missing/corrupt: floor from the largest commit ts
            # in the reopened KV so timestamps still never repeat
            self._tso_lease = self.kv.max_commit_ts()
        if self.remote:
            # leader-allocated timestamps (the PD-client role); floor the
            # stale-read fallback at the newest replicated commit, so a
            # leader lost right after bootstrap degrades to "last
            # replicated state", not to an empty ts-0 snapshot
            from ..kv.tso import RemoteTSO
            self.tso = RemoteTSO(
                self._rpc_client,
                allow_stale=self._rpc_client.options.stale_reads)
            self.tso.observe(self.kv.max_commit_ts())
        elif self.shared:
            # ONE allocator for every process on this directory: strict
            # SI across servers
            from ..kv.tso import SharedTSO
            self.tso = SharedTSO(path, floor=self._tso_lease)
        else:
            self.tso = TimestampOracle(floor=self._tso_lease)
        self.rm = RegionManager(self.kv)
        self.committer = TwoPhaseCommitter(self.rm, self.tso,
                                           events=self.obs.events,
                                           heat=self.heat)
        if self._rpc_client is not None:
            self._rpc_client.events = self.obs.events
        # group-commit event throttle (_note_group_commit)
        self._gc_lock = threading.Lock()
        self._gc_event_last = 0.0
        self._gc_batches = 0
        self._gc_commits = 0
        self._wire_fsync_stall()
        # GLOBAL sysvar plane (mysql.global_variables analog) — rides the
        # meta keyspace (put_meta / get_meta), so durable stores keep SET
        # GLOBAL across restarts
        self.sysvars = SysVarManager(self)
        # grant tables (mysql.user analog) — same persistence plane
        self.privileges = PrivilegeManager(self)
        # GET_LOCK user locks (builtin_miscellaneous.go lock family)
        self.user_locks = UserLocks()
        # GLOBAL SQL plan bindings (mysql.bind_info analog) — same
        # persistence plane
        from ..session.bindinfo import BindingManager
        self.bindings = BindingManager(self)
        # viewer-sensitive information_schema refresh+scan exclusion
        # (Session._refresh_infoschema holds this for the statement)
        self.infoschema_lock = lockcheck.rlock(
            "Storage.infoschema_lock", hot=True)
        # DDL job queue + history (the meta-KV DDLJobList analog,
        # reference meta/meta.go:571) — lives on storage so a replacement
        # worker resumes pending jobs with their reorg checkpoints
        self.ddl_jobs: list = []
        self.ddl_history: list = []
        # owner election: DDL jobs and background GC run on the owner
        # only (the mock for an in-memory store, an flock for processes
        # sharing this directory; a follower campaigns through the
        # leader, since a local flock would elect everybody)
        if self.remote:
            from ..rpc.remote import RemoteOwnerManager
            self.ddl_owner = RemoteOwnerManager(self._rpc_client, "ddl")
            self.gc_owner = RemoteOwnerManager(self._rpc_client, "gc")
        else:
            from ..owner import owner_manager
            self.ddl_owner = owner_manager(path, "ddl")
            self.gc_owner = owner_manager(path, "gc")
        # the background worker (GC / lock TTL / auto-analyze /
        # checkpoint), made at first use of `maintenance`
        self._maintenance = None
        # sequence cursors: values handed out, ahead of the persisted
        # high-water only by the cache batch
        self._seq_cursors: dict[int, int] = {}
        self._seq_lock = threading.Lock()
        self._commit_lock = lockcheck.rlock(
            "Storage._commit_lock", hot=True)
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
        # coprocessor clients caching this store's tables on a device,
        # held weakly: `destroy_table_data` frees a dropped table's
        # tensors in every one (each wire connection has its own client)
        self._cache_clients: weakref.WeakSet = weakref.WeakSet()
        self._cache_clients_lock = threading.Lock()
        # fn(store) after every base-epoch replacement of every table
        # (the mesh plane's eager eviction; add_epoch_listener)
        self._epoch_listeners: list = []
        if path is not None:
            self._recover()
            if not self.remote:
                self._extend_tso_lease()
            # persist schema on every catalog version bump from here on
            self.catalog.on_change = lambda: self.persist_catalog()
        if rpc_listen is not None:
            # leader: serve TSO/WAL/KILL coordination over the socket so
            # followers can join without sharing this directory
            if not self.shared or self.remote:
                raise ValueError(
                    "rpc_listen needs shared=True on the store-owning "
                    "server (a follower cannot re-serve the store)")
            from ..rpc.client import RpcOptions
            from ..rpc.server import CoordRPCServer
            opts = self._rpc_options = rpc_options or RpcOptions()
            self.rpc_server = CoordRPCServer(self, listen=rpc_listen,
                                             lease_ms=opts.lease_ms,
                                             tail_chunk=opts.tail_chunk)
        if self.remote and \
                (self._rpc_options.election_timeout_ms or 0) > 0:
            # automatic failover: watch the heartbeat, elect on leader
            # loss, promote or repoint (rpc/failover.py). The voter
            # roll is seeded NOW: a leader that dies before the first
            # healthy-tick refresh must not leave this follower with an
            # empty electorate (it would elect itself unopposed while
            # its unseen peers do the same — split brain)
            from ..rpc.diag import cluster_members
            from ..rpc.errors import survivable
            from ..rpc.failover import FailoverManager
            try:
                cluster_members(self, budget_ms=1000)
            except survivable():
                pass  # seeding is best-effort
            self.failover = FailoverManager(self, self._rpc_options)
            self.failover.start()
        if self.remote:
            # follower read tier: fold the mirror continuously and
            # advertise the closed/applied ts on every heartbeat
            # (rpc/apply.py). Env knobs cover embedded/test stores the
            # config seeds never reach.
            interval = os.environ.get("TIDB_TPU_REPLICA_APPLY_MS")
            if interval:
                try:
                    self.replica_read.apply_interval_ms = int(interval)
                except ValueError:
                    pass
            if os.environ.get("TIDB_TPU_REPLICA_READ", "").lower() \
                    in ("0", "false", "off"):
                self.replica_read.enabled = False
            self.arm_replica_read()

    # ---- schema ------------------------------------------------------------
    def register_table(self, info: TableInfo) -> TableStore:
        part = getattr(info, "partition", None)
        if part is not None:
            return self._register_partitioned(info, part)
        store = TableStore(info)
        self.tables[info.id] = store
        self.adopt_table_store(store)
        # one region per table (reference: split-table-region on create,
        # ddl/split_region.go) — multi-table commits become multi-region
        try:
            self.rm.split(tablecodec.table_prefix(info.id))
        except ValueError:
            pass  # split point already a region boundary
        return store

    def _register_partitioned(self, info: TableInfo, part) -> TableStore:
        """Each partition is a full physical TableStore under its own
        table id/region (reference: partitions ARE tables,
        table/tables/partition.go); they share the first partition's
        string dictionaries so cross-partition unions need no code
        remapping. Returns the first partition's store (the shared
        allocator)."""
        first: Optional[TableStore] = None
        for d in part.defs:
            store = TableStore(self.child_table_info(info, d))
            if first is None:
                first = store
            else:
                store.dictionaries = first.dictionaries
            self.tables[d.id] = store
            self.adopt_table_store(store)
            try:
                self.rm.split(tablecodec.table_prefix(d.id))
            except ValueError:
                pass
        assert first is not None
        return first

    def adopt_table_store(self, store: TableStore) -> None:
        """Wire a TableStore into this storage's epoch plumbing: the
        durable-snapshot hook and the eager-eviction listeners. Every
        TableStore that lands in self.tables passes through here:
        register_table, partition registration, TRUNCATE PARTITION's
        fresh store (or the mesh plane would never see that table's epoch
        folds)."""
        if self.path is not None:
            store.on_epoch = self._on_epoch_changed
        for fn in self._epoch_listeners:
            if fn not in store.evict_hooks:
                store.evict_hooks.append(fn)

    def add_epoch_listener(self, fn) -> None:
        """Attach `fn(store)` to fire after every base-epoch replacement
        of every table (current and future); idempotent per listener.
        The mesh plane's eager device-tensor eviction."""
        if fn in self._epoch_listeners:
            return
        self._epoch_listeners.append(fn)
        for store in list(self.tables.values()):
            if fn not in store.evict_hooks:
                store.evict_hooks.append(fn)

    @staticmethod
    def child_table_info(info: TableInfo, d) -> TableInfo:
        """A partition's physical TableInfo: parent schema, own id."""
        return dataclasses.replace(info, id=d.id,
                                   name=f"{info.name}#{d.name}",
                                   partition=None)

    def unregister_table(self, table_id: int) -> None:
        self.tables.pop(table_id, None)

    def destroy_table_data(self, table_id: int) -> None:
        """Physically drop a table's KV range + epoch snapshot (DROP/
        TRUNCATE path; reference: UnsafeDestroyRange driven by the GC
        worker for dropped objects, ddl/delete_range.go +
        store/tikv/gcworker). Without this, restart recovery would
        resurrect dropped rows from the KV truth."""
        lo, hi = tablecodec.table_range(table_id)
        self.kv.unsafe_destroy_range(lo, hi)
        if self.path is not None:
            try:
                os.remove(self._epoch_file(table_id))
            except OSError:
                pass
        # a dropped id never stages a newer epoch, so the clients' own
        # `_evict_stale` would never free its tensors
        with self._cache_clients_lock:
            clients = list(self._cache_clients)
        for client in clients:
            client.forget_table(table_id)

    def add_cache_client(self, client) -> None:
        """Register a coprocessor client that caches this store's tables
        on its device; `destroy_table_data` calls its `forget_table`.
        Held by a weak reference: a closed session's client goes."""
        with self._cache_clients_lock:
            self._cache_clients.add(client)

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

    def _fold_row(self, store: TableStore, values: list) -> tuple:
        """KV value -> physical row (inverse of _kv_row). Rows written
        before an ADD COLUMN carry the old arity: pad with the new
        columns' defaults (the instant-add-column read path; reference:
        rows keep origin version, defaults fill at decode,
        table/tables/tables.go DecodeRawRowData)."""
        cols = store.table.columns
        if len(values) < len(cols):
            from ..ddl.ddl import _phys_default
            values = list(values) + [
                None if c.default is None
                else _phys_default(c.ftype, c.default)
                for c in cols[len(values):]]
        out = []
        for v, d in zip(values, store.dictionaries):
            if v is None:
                out.append(None)
            elif d is not None:
                s = v.decode("utf-8") if isinstance(v, bytes) else str(v)
                out.append(d.encode(s))
            elif isinstance(v, bytes):
                out.append(v.decode("utf-8"))
            else:
                out.append(v)
        return tuple(out)

    # ---- durability plane ---------------------------------------------------
    def _lease_file(self) -> str:
        return os.path.join(self.path, "tso.lease")

    def _read_tso_lease(self) -> int:
        try:
            with open(self._lease_file()) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _extend_tso_lease(self) -> None:
        """Persist a ts horizon ahead of anything issued; cheap (runs only
        when current() nears the lease). Restart floors the oracle here,
        so commit timestamps stay monotonic across restarts even if the
        wall clock steps backwards."""
        lease = self.tso.current() + (_TSO_LEASE_MS << 18)
        tmp = self._lease_file() + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(lease))
            f.flush()
            if self.sync_log != "off":
                os.fsync(f.fileno())
        os.replace(tmp, self._lease_file())
        if self.sync_log != "off":
            # a lease bump lost to power loss would let a restarted
            # oracle re-issue timestamps the pre-crash process already
            # handed out; under sync-log=off the whole store accepts
            # the power-loss window, so the lease does too
            fsync_dir(self.path)
        self._tso_lease = lease

    def _maybe_extend_lease(self) -> None:
        if self.remote:
            return  # the leader persists the TSO horizon
        if self.path is not None and \
                self.tso.current() >= self._tso_lease - (
                    (_TSO_LEASE_MS // 2) << 18):
            with self._lease_lock:
                # re-check: a concurrent committer may have extended
                # while we waited (the lease covers everyone)
                if self.tso.current() >= self._tso_lease - (
                        (_TSO_LEASE_MS // 2) << 18):
                    self._extend_tso_lease()

    def persist_catalog(self) -> None:
        """Whole-catalog snapshot into the meta keyspace (reference: the
        m-prefix schema records, meta/meta.go:59-64,145-158). DDL-rate
        writes, so a full pickle beats incremental encoding complexity."""
        if self.path is None:
            return
        payload = pickle.dumps({
            "schemas": self.catalog.schemas,
            "next_id": self.catalog._next_id,
            "version": self.catalog.version,
        })
        self.put_meta(b"catalog", payload)

    def persist_ddl_jobs(self) -> None:
        """Pending DDL job queue (with reorg checkpoints) into meta-KV so a
        restart resumes interrupted jobs (reference: DDLJobList,
        meta/meta.go:571 + resumable reorg handles, ddl/reorg.go:263)."""
        if self.path is None:
            return
        self.put_meta(b"ddl:jobs", pickle.dumps(self.ddl_jobs))

    def _on_epoch_changed(self, store: TableStore, required: bool) -> None:
        """required=True (bulk load / DDL rewrite): the epoch holds data
        the KV truth cannot rebuild — persist now. required=False
        (compaction): folded deltas are still in KV, so just mark dirty
        and let checkpoint() write the snapshot off the commit path."""
        if required:
            self._persist_epoch(store)
            store.epoch_dirty = False
        else:
            store.epoch_dirty = True

    def _epoch_file(self, table_id: int) -> str:
        return os.path.join(self.path, "epochs", f"t{table_id}.npz")

    def _persist_epoch(self, store: TableStore) -> None:
        """Columnar epoch snapshot (atomic tmp+rename): the fold's
        checkpoint; the KV WAL covers everything with commit_ts >
        fold_ts."""
        epoch = store.epoch
        payload: dict = {
            "handles": epoch.handles,
            "fold_ts": np.int64(epoch.fold_ts),
            "next_handle": np.int64(store._next_handle),
            "ncols": np.int64(len(epoch.columns)),
        }
        for ci, (data, valid) in enumerate(zip(epoch.columns, epoch.valids)):
            payload[f"col{ci}"] = data
            if valid is not None:
                payload[f"valid{ci}"] = valid
            d = store.dictionaries[ci]
            if d is not None:
                payload[f"dict{ci}"] = np.array(list(d.values), dtype=object)
        path = self._epoch_file(store.table.id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            if self.sync_log != "off":
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.sync_log != "off":
            # full crash-atomic sequence (tmp + fsync + rename + dir
            # fsync): a half-written epoch must never shadow the
            # previous good one — recovery treats the epoch as the fold
            # floor and skips the WAL below its fold_ts
            fsync_dir(os.path.dirname(path))

    def _load_epoch(self, store: TableStore) -> None:
        path = self._epoch_file(store.table.id)
        if not os.path.exists(path):
            return
        try:
            z_ctx = np.load(path, allow_pickle=True)
        except Exception:  # noqa: BLE001 — torn/corrupt archive
            # an unreadable epoch snapshot (crash mid-write on a
            # filesystem without atomic rename, bit rot) must degrade
            # to a full refold from the KV truth, never to a crash at
            # open — drop it so the next checkpoint rewrites it
            try:
                os.remove(path)
            except OSError:
                pass
            return
        with z_ctx as z:
            ncols = int(z["ncols"])
            if ncols != store.table.num_columns:
                return  # schema moved past this snapshot; refold from KV
            handles = z["handles"]
            columns = [z[f"col{ci}"] for ci in range(ncols)]
            valids = [
                z[f"valid{ci}"] if f"valid{ci}" in z else None
                for ci in range(ncols)
            ]
            dicts: list = []
            for ci in range(ncols):
                cft = store.table.columns[ci].ftype
                if getattr(cft, "elems", ()) and cft.is_string:
                    # ENUM: the fixed validating dictionary, rebuilt from
                    # the schema (codes are definition positions)
                    dicts.append(_column_dictionary(cft))
                elif f"dict{ci}" in z:
                    d = Dictionary()
                    for v in z[f"dict{ci}"]:
                        d.encode(str(v))
                    dicts.append(d)
                else:
                    dicts.append(None)
            epoch = ColumnEpoch(
                epoch_id=next(_epoch_ids),
                fold_ts=int(z["fold_ts"]),
                handles=handles,
                columns=columns,
                valids=valids,
            )
            store.restore_epoch(epoch, dicts, int(z["next_handle"]))

    def _recover(self) -> None:
        """Bootstrap from the reopened KV + epoch snapshots: catalog, table
        stores, committed rows newer than each epoch's fold, stats, pending
        DDL. Orphaned percolator locks are resolved first (the restarted
        process has no live transactions)."""
        raw = self.get_meta(b"catalog")
        if raw is None:
            return  # fresh directory
        if not self.remote:
            # a JOINING follower must not touch locks: siblings may have
            # live transactions (the leader resolved true orphans at its
            # own startup)
            self._resolve_orphans()
        state = pickle.loads(raw)
        self.catalog.schemas = state["schemas"]
        self.catalog._next_id = state["next_id"]
        self.catalog.version = state["version"]
        for schema in self.catalog.schemas.values():
            for info in schema.tables.values():
                self.register_table(info)
                part = getattr(info, "partition", None)
                ids = [d.id for d in part.defs] if part is not None \
                    else [info.id]
                for tid in ids:
                    self._refold(self.tables[tid])
                if part is not None:
                    # the first partition's store allocates handles for
                    # the WHOLE table: its counter must cover handles
                    # living in every sibling partition
                    first = self.tables[ids[0]]
                    first._next_handle = max(
                        self.tables[tid]._next_handle for tid in ids)
        self.stats.load_from_kv(self, self.catalog)
        raw = self.get_meta(b"ddl:jobs")
        if raw:
            self.ddl_jobs = pickle.loads(raw)
        if self.ddl_jobs:
            # owner-takeover: drive interrupted jobs from their persisted
            # reorg checkpoints (reference: ddl_worker.go:419 + reorg.go:263).
            # A job that legitimately rolls back (e.g. unique validation
            # fails) is a normal outcome, not a reason to refuse to open.
            from ..ddl import DDL, DDLError

            ddl = DDL(self, self.catalog)
            while self.ddl_jobs:
                try:
                    ddl.run_job(self.ddl_jobs[0])
                except DDLError:
                    pass

    def _refold(self, store: TableStore) -> None:
        """One physical table at recovery: its epoch file, then the
        committed KV rows newer than the epoch's fold, in commit order."""
        tid = store.table.id
        self._load_epoch(store)
        lo, hi = tablecodec.record_range(tid)
        folds = []
        for key, commit_ts, kind, val in self.kv.scan_latest(lo, hi):
            if commit_ts <= store.epoch.fold_ts:
                continue
            _, handle = tablecodec.decode_record_key(key)
            if kind == OP_DEL:
                if store.epoch.handle_pos.get(handle) is not None:
                    folds.append((commit_ts, handle, TOMBSTONE))
            else:
                row = self._fold_row(store, codec.decode_key(val))
                folds.append((commit_ts, handle, row))
                store.note_handle(handle)
        folds.sort(key=lambda t: t[0])
        for commit_ts, handle, row in folds:
            store.apply_commit(commit_ts, handle, row)

    def _resolve_orphans(self) -> None:
        """Roll crashed transactions forward or back from their primary's
        fate (reference: lock_resolver.go at restart; every pre-crash lock
        is orphaned by definition)."""
        far_future = self.tso.next_ts() + (1 << 62)
        for lock in self.kv.all_locks():
            try:
                commit_ts, _ = self.kv.check_txn_status(
                    lock.primary, lock.start_ts, far_future)
                self.kv.resolve_lock(lock.key, lock.start_ts, commit_ts)
            except KVError:
                pass

    def checkpoint(self, dirty_only: bool = False) -> None:
        """Fold the KV WAL into a snapshot file and persist table epochs
        (clean-shutdown / periodic maintenance entry). dirty_only skips
        epochs whose snapshot is already current; the WAL always folds."""
        if self.path is None:
            return
        t0 = time.perf_counter()
        self._flush_sequence_cursors()
        for store in list(self.tables.values()):
            if dirty_only and not store.epoch_dirty:
                continue
            self._persist_epoch(store)
            store.epoch_dirty = False
            # crash-injection site: a kill here leaves some epochs
            # persisted and the KV WAL not yet folded — recovery must
            # treat the half-finished checkpoint as noise
            failpoint.inject("storage/mid-checkpoint")
        self.kv.checkpoint()
        dt = time.perf_counter() - t0
        if dt >= 1.0:
            # a slow checkpoint competes with the commit path for the
            # WAL and its fsync: the event ring explains the spike
            self.obs.events.record(
                "checkpoint_stall", severity="warn",
                detail=f"checkpoint took {dt * 1e3:.0f}ms "
                       f"({len(self.tables)} tables, "
                       f"dirty_only={dirty_only})")

    def _wire_fsync_stall(self) -> None:
        """Point the WAL's sync policy at this storage's event ring (a
        slow fsync) and group-commit telemetry."""
        syncer = self.kv.kv._syncer
        events = self.obs.events

        def _fsync_stall(dt_s: float) -> None:
            events.record("fsync_stall", severity="warn",
                          detail=f"wal fsync took {dt_s * 1e3:.1f}ms "
                                 f"(policy {syncer.policy})")

        syncer.on_stall = _fsync_stall
        syncer.on_batch = self._note_group_commit

    def _note_group_commit(self, batch: int) -> None:
        """Group-fsync batch telemetry: every batch lands in the
        tidb_group_commit_batch_size histogram and its counter twins;
        the event ring gets a throttled group_commit note (cumulative
        since the last one), at most one each 5 s."""
        self.obs.group_commit_batch.observe(batch)
        self.obs.group_commit_fsyncs.inc()
        self.obs.group_commit_commits.inc(batch)
        emit = None
        with self._gc_lock:
            self._gc_batches += 1
            self._gc_commits += batch
            now = time.monotonic()
            if batch > 1 and now - self._gc_event_last >= 5.0:
                self._gc_event_last = now
                emit = (self._gc_commits, self._gc_batches)
                self._gc_batches = 0
                self._gc_commits = 0
        if emit is not None:
            commits, batches = emit
            self.obs.events.record(
                "group_commit",
                detail=f"{commits} commits over {batches} wal fsyncs "
                       f"({commits / max(batches, 1):.1f} avg batch) "
                       "since the last note")

    def configure_group_commit(self, max_batch: Optional[int] = None,
                               max_wait_us: Optional[int] = None) -> None:
        """Apply the storage.group-commit-* knobs to the engine's
        SyncPolicy."""
        syncer = self.kv.kv._syncer
        if max_batch is not None:
            syncer.group_max_batch = max(int(max_batch), 1)
        if max_wait_us is not None:
            syncer.group_max_wait_us = max(int(max_wait_us), 0)

    @property
    def maintenance(self):
        """The storage's background worker (GC / lock-TTL / auto-analyze /
        checkpoint); created lazily, started by the server process or
        tests (reference: gcworker started by the tikv store,
        gc_worker.go:95)."""
        if self._maintenance is None:
            from .daemon import MaintenanceWorker
            self._maintenance = MaintenanceWorker(self, self.catalog)
        return self._maintenance

    @property
    def diag_address(self) -> str:
        """Where THIS server's diag service answers: the leader serves
        it on the coordination port, a follower on its diag listener."""
        if self.rpc_server is not None:
            return self.rpc_server.address
        if self.diag_listener is not None:
            return self.diag_listener.address
        return ""

    def transport_health(self) -> dict:
        """Multi-process transport state for the status port. Socket
        modes include the membership view — peer id, diag address,
        role, last-heartbeat age — the registry the cluster_* tables fan
        out over."""
        if self.remote:
            h = self._rpc_client.health()
            h["mode"] = "socket-follower"
            h["node_id"] = self.coord.node_id
            h["diag_address"] = self.diag_address
            h["term"] = self._rpc_client.term
            if self.failover is not None:
                h["failover"] = self.failover.describe()
            if self.apply_engine is not None:
                h["replica_apply"] = self.apply_engine.info()
            from ..rpc.diag import cluster_members
            h["members"] = cluster_members(self, budget_ms=500)
            return h
        if self.rpc_server is not None:
            return {"mode": "socket-leader",
                    "address": self.rpc_server.address,
                    "term": self.rpc_server.term,
                    "clients": self.rpc_server.client_count(),
                    "members": self.rpc_server.members()}
        if self.shared:
            return {"mode": "shared-dir", "node_id": self.coord.node_id}
        return {"mode": "local"}

    # ---- range-sharded write leadership (rpc/ranged.py) ---------------------
    def arm_ranges(self, enabled: bool = False, count: int = 1,
                   split_points=(), lease_ms: int = 1000,
                   resolve_ttl_ms: int = 3000,
                   listen: str = "127.0.0.1:0",
                   auto_split: bool = False,
                   split_cooldown_ms: int = 10000,
                   max_auto_splits: int = 4) -> None:
        """Start the range plane to match the [ranges] settings (called
        from Config.seed_ranges on startup/SIGHUP). lease-ms,
        resolve-ttl-ms and the auto-split actuator knobs reload live;
        enabling/disabling or reshaping the table needs a restart (the
        table is durable, first writer wins). Only a durable local
        store can host range leaders — followers and in-memory stores
        route to one that does."""
        if self.ranges is not None:
            if enabled:
                self.ranges.set_knobs(
                    lease_ms=lease_ms, resolve_ttl_ms=resolve_ttl_ms,
                    auto_split=auto_split,
                    split_cooldown_ms=split_cooldown_ms,
                    max_auto_splits=max_auto_splits)
            return
        if not enabled or self.remote or self.path is None:
            return
        from ..rpc.ranged import RangePlane
        self.ranges = RangePlane(self, count=count,
                                 split_points=split_points,
                                 lease_ms=lease_ms,
                                 resolve_ttl_ms=resolve_ttl_ms,
                                 listen=listen,
                                 auto_split=auto_split,
                                 split_cooldown_ms=split_cooldown_ms,
                                 max_auto_splits=max_auto_splits)
        # the heat matrix resolves against the authoritative table the
        # plane just bootstrapped (first writer wins; re-seed adopts)
        self.heat.set_specs(self.ranges.server.specs)

    def arm_replica_read(self) -> None:
        """Start or stop the continuous apply engine to match the
        replica-read settings (called from __init__ and from
        Config.seed_replica_read). Leaders and local stores never run
        one — the engine folds a MIRROR."""
        if not self.remote:
            return
        from ..rpc.apply import ApplyEngine
        if self.replica_read.enabled and self.apply_engine is None:
            self.apply_engine = ApplyEngine(
                self, interval_ms=self.replica_read.apply_interval_ms)
        elif self.replica_read.enabled:
            # a reseed with a new cadence adjusts the running engine
            self.apply_engine.interval_ms = max(
                10, int(self.replica_read.apply_interval_ms))
        elif self.apply_engine is not None:
            eng, self.apply_engine = self.apply_engine, None
            client = self._rpc_client
            # the heartbeat must stop advertising a serving replica
            # (atomic dict REPLACEMENT — the heartbeat thread unpacks
            # ping_params concurrently)
            client.ping_params = {**client.ping_params,
                                  "serving": False, "applied_ts": 0,
                                  "apply_lag_ms": 0.0}
            eng.close()

    def pin_snapshot_ts(self, ts: int) -> None:
        """Register an EXTERNALLY chosen snapshot ts (a routed replica
        read at the router's read_ts) with the compaction safepoint;
        released through release_snapshot_ts like any acquired one."""
        with self._snap_lock:
            self._active_snapshots[ts] = \
                self._active_snapshots.get(ts, 0) + 1

    # ---- leader failover (rpc/failover.py drives these) ---------------------
    def promote_to_leader(self, listen: str = "127.0.0.1:0") -> str:
        """Promote this socket FOLLOWER to the cluster leader in place.

        The on-disk WAL mirror (rpc/remote.py RemoteKV) is a byte-prefix
        of the dead leader's (snapshot, WAL) pair, so it re-opens as the
        authoritative store and surviving followers keep tailing from
        their own offsets. The fencing term bumps and persists BEFORE
        the new coordination server answers anything, so a zombie of
        the old epoch is rejected from the first request (reference
        analog: raft term bump on election, Ongaro & Ousterhout §5.2).
        Returns the new coordination address."""
        if not self.remote:
            return self.rpc_server.address if self.rpc_server else ""
        from ..rpc.client import RpcOptions

        client = self._rpc_client
        opts = self._rpc_options or RpcOptions()
        new_term = int(client.term) + 1
        # the transitional flag keeps peer voters from dropping us from
        # the electorate mid-promotion (they hold their election open
        # until we answer as a leader)
        self._promoting = True
        try:
            # the apply engine folds the mirror this promotion is about
            # to re-open as the authoritative engine: stop it first
            if self.apply_engine is not None:
                eng, self.apply_engine = self.apply_engine, None
                eng.close()
            addr = self._promote_locked(client, opts, new_term, listen)
            self.obs.events.record(
                "leader_promoted", severity="warn",
                detail=f"promoted in place at {addr} "
                       f"(fencing term {new_term})")
            return addr
        finally:
            self._promoting = False

    def _promote_locked(self, client, opts, new_term: int,
                        listen: str) -> str:
        from ..kv.tso import SharedTSO
        from ..owner import owner_manager
        from ..rpc.server import CoordRPCServer, write_term
        from .coordinator import SharedDirCoordinator

        with self._commit_lock:
            # records the last tail applied to the mirror engine but no
            # fold has taken yet: fold them before the engine goes
            self._drain_refresh()
            old_engine = self.kv.kv
            mirror_dir = getattr(old_engine, "mirror_dir", None) or \
                os.path.join(self.path, "kv")
            # 1. seal the mirror: everything replicated is on disk
            mw = getattr(old_engine, "_mirror_wal", None)
            if mw is not None:
                mw.flush()
                os.fsync(mw.fileno())
            old_engine.close()
            # 2. the bumped fencing term, durable beside the WAL
            write_term(os.path.join(mirror_dir, "term"), new_term)
            # 3. the mirror becomes the authoritative engine (replayed
            #    exactly like a leader restart; shared mode so local and
            #    remote mutators coexist through the flock)
            engine = PyOrderedKV(mirror_dir, shared=True,
                                 sync_log=self.sync_log,
                                 sync_interval_ms=self.sync_interval_ms)
            self.kv.kv = engine
            self._wire_fsync_stall()
            # 4. coordination over OUR directory now
            self.coord = SharedDirCoordinator(self.path)
            self.kv.coord = self.coord
            # 5. ONE timestamp allocator, floored a full lease horizon
            #    above anything witnessed: the dead leader may have
            #    issued timestamps nobody replicated, and a commit_ts
            #    reuse would corrupt MVCC visibility
            floor = max(self.tso.current(), self.kv.max_commit_ts()) \
                + (_TSO_LEASE_MS << 18)
            self.tso = SharedTSO(self.path, floor=floor)
            self.committer = TwoPhaseCommitter(self.rm, self.tso,
                                               events=self.obs.events,
                                               heat=self.heat)
            # 6. owner elections are kernel flocks on our dir
            self.ddl_owner = owner_manager(self.path, "ddl")
            self.gc_owner = owner_manager(self.path, "gc")
            # 7. identity flip BEFORE serving: diag answers as leader
            self.remote = False
            self.shared = True
            self._rpc_client = None
            # 8. the old client (and its heartbeat thread) dies with the
            #    old epoch; stragglers re-resolve via diag_election
            client.ping_params = {}
            client.close()
            self.rpc_server = CoordRPCServer(
                self, listen=listen, lease_ms=opts.lease_ms,
                tail_chunk=opts.tail_chunk, term=new_term)
            self._extend_tso_lease()
            # 9. the dead leader's in-flight prewrites replicated as
            #    orphan locks; resolve them exactly like a restart does
            self._resolve_orphans()
        return self.rpc_server.address

    def repoint_leader(self, addr: str, term: int = 0) -> None:
        """Re-resolve this follower to a newly promoted leader: swap
        the client's address, adopt the bumped term, and re-register
        the diag endpoint so the new membership registry fills without
        waiting a heartbeat interval. The WAL tail position carries
        over unchanged — the new leader's log is a byte-superset of
        ours (it won the election on length)."""
        client = self._rpc_client
        if client is None:
            return
        client.repoint(addr, int(term))
        self.obs.events.record(
            "leader_repointed",
            detail=f"following new leader at {addr} (term {term})")
        from ..rpc.errors import RPCError
        try:
            if self.diag_listener is not None:
                client.call("diag_register",
                            addr=self.diag_listener.address,
                            role="follower", _budget_ms=1000)
        except RPCError:
            pass  # the next heartbeat re-registers

    def _tso_commit_done(self) -> None:
        """Retire this storage's pending-commit ledger entry (socket
        followers; rpc/server.py closed_info). No-op on local oracles.
        Called OUTSIDE the commit lock — it is an RPC, and best effort
        (the leader also retires the entry at the next commit)."""
        done = getattr(self.tso, "commit_done", None)
        if done is not None:
            done()

    def close(self) -> None:
        """Clean shutdown of every mode. A follower stops its failover
        watcher (a leader-loss election must not fire, or promote,
        halfway through the teardown) and its apply engine, deregisters and closes its diag listener, then its RPC
        client (and the heartbeat); a leader closes its RPC server.
        Every thread they started is joined. Then: the metrics-history
        sampler, the maintenance worker and the range plane (its lease
        loop, listener and range leaders) are closed and joined, the live
        workload-history window persisted, the store checkpointed
        (epochs + KV snapshot, WAL truncated, sequence cursors; a shared
        WAL is never truncated) and the engine's files, the TSO and the
        owner locks released. An error a serving thread kept (the apply
        loop, an RPC handler) or that ended the maintenance loop is
        re-raised after the store is closed, as is one the range plane's
        lease loop kept."""
        from ..rpc.diag import close_peer_clients
        from ..rpc.errors import RPCError
        errors: list = []

        def keep(fn) -> None:
            try:
                fn()
            except Exception as e:
                errors.append(e)

        # the failover watcher first: a leader-loss election must not
        # fire (or promote!) halfway through our own teardown
        if self.failover is not None:
            fo, self.failover = self.failover, None
            keep(fo.close)
        # the apply engine next: its tick path runs RPC + fold against
        # the structures torn down below
        if self.apply_engine is not None:
            eng, self.apply_engine = self.apply_engine, None
            keep(eng.close)
        self.metrics_history.stop()
        self.history.flush()
        if self.diag_listener is not None:
            if self._rpc_client is not None:
                # stop announcing BEFORE deregistering: a heartbeat
                # firing between the unregister and the client teardown
                # would re-register the closed address for a lease
                # horizon
                self._rpc_client.ping_params = {}
                try:
                    # best-effort, so peers stop fanning out to the
                    # closed address until the lease horizon passes
                    self._rpc_client.call("diag_unregister",
                                          _budget_ms=500)
                except RPCError:
                    pass
            keep(self.diag_listener.close)
        close_peer_clients(self)
        try:
            if self._maintenance is not None:
                keep(self._maintenance.stop)
            if self.ranges is not None:
                rp, self.ranges = self.ranges, None
                keep(rp.close)
        finally:
            if self.rpc_server is not None:
                keep(self.rpc_server.close)
            self.ddl_owner.close()
            self.gc_owner.close()
            if self.path is not None:
                if self.remote:
                    # a follower's checkpoint writes through the leader;
                    # a dead leader must not turn shutdown into a hang
                    try:
                        self.checkpoint()
                    except RPCError:
                        pass
                    self._rpc_client.close()
                else:
                    self.checkpoint()
                self.kv.kv.close()
                close_tso = getattr(self.tso, "close", None)
                if close_tso is not None:
                    close_tso()
                if self.coord is not None and \
                        hasattr(self.coord, "close"):
                    self.coord.close()
                if self._owns_tmp_dir and self.remote:
                    # rpc:// shorthand: the throwaway scratch dir is ours
                    import shutil
                    shutil.rmtree(self.path, ignore_errors=True)
        if errors:
            raise errors[0]

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
        txn = Transaction(self, self.acquire_snapshot_ts(),
                          pessimistic=pessimistic)
        # a snapshot ts at/below the oracle's stale watermark was
        # re-issued while the leader was unreachable: reads are fine
        # (bounded staleness), writes must fail typed (_check_writable)
        wm = getattr(self.tso, "stale_watermark", None)
        txn.degraded = wm is not None and txn.start_ts <= wm
        return txn

    def _check_writable(self, txn: "Transaction") -> None:
        if txn.degraded:
            from ..rpc.errors import LeaderUnavailable
            raise LeaderUnavailable(
                "store leader unreachable: this server is serving "
                "stale reads only; writes are rejected until the "
                "leader lease is renewed")

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
        self._check_writable(txn)
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
        if mutations:
            self._check_writable(txn)
        if not mutations:
            if txn.locked_keys:
                # lock-only txn (SELECT FOR UPDATE with no writes): the
                # guards served their purpose; drop them
                self.kv.pessimistic_rollback(sorted(txn.locked_keys),
                                             txn.start_ts)
            return txn.start_ts
        self._maybe_extend_lease()
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
            self.obs.conflicts.inc()
            self._best_effort_rollback(kv_muts, txn.start_ts)
            raise WriteConflictError(str(e)) from None
        except (KVError, CommitError) as e:
            self._best_effort_rollback(kv_muts, txn.start_ts)
            raise WriteConflictError(f"commit failed: {e}") from None
        try:
            with self._commit_lock, self._fold_section():
                if self.shared:
                    # fold sibling commits observed during prewrite and
                    # adopt any schema change BEFORE the authoritative
                    # fence check
                    self.kv.refresh()
                    self._drain_refresh()
                try:
                    self._check_schema_fence(txn)
                except WriteConflictError:
                    self._best_effort_rollback(kv_muts, txn.start_ts)
                    raise
                try:
                    commit_ts = self.committer.commit_phase(
                        state, txn.start_ts)
                except (KVError, CommitError) as e:
                    self._best_effort_rollback(kv_muts, txn.start_ts)
                    raise WriteConflictError(
                        f"commit failed: {e}") from None
                # columnar fold of the committed mutations (the
                # coprocessor's read view) — inside the lock so no
                # snapshot can observe the KV commit without the fold
                failpoint.inject("storage/before-fold")
                for (table_id, handle), row in mutations.items():
                    store = self.tables.get(table_id)
                    if store is not None:
                        store.apply_commit(commit_ts, handle, row)
        finally:
            # pending-commit ledger retire (socket followers): by now
            # the commit records are published or never will be, so the
            # leader's closed ts may advance past our commit_ts
            self._tso_commit_done()
        # durability BEFORE the ack, AFTER the commit lock: under
        # sync-log=commit the engine deferred the boundary fsync out of
        # the mutation sections, so concurrent committers rendezvous
        # here on ONE in-flight fsync (cross-commit group commit). A
        # failed fsync must not ack — but the commit IS already applied
        # and visible, so the error must NOT read as a retryable write
        # conflict (a client retrying a "failed" increment would
        # double-apply it): KVError propagates untyped ("result
        # unknown"), and _run_in_txn's autocommit retry ignores it.
        try:
            self.kv.commit_sync()
        except OSError as e:
            raise KVError(
                "commit durability unknown: WAL fsync failed after the "
                f"commit was applied ({e}); do not blindly retry"
            ) from e
        self.obs.commits.inc()
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

    # ---- sequences ---------------------------------------------------------
    SEQ_CACHE = 1000

    def sequence_next(self, seq) -> int:
        """Allocate the next value; persists the durable high-water a
        cache batch ahead (clamped at the exhaustion sentinel) so a
        CRASH never re-issues a handed-out non-cycle value; a clean
        checkpoint writes the exact cursor back, so clean restarts
        waste nothing (reference: ddl/sequence.go + meta autoid-style
        batching)."""
        with self._seq_lock:
            cur = self._seq_cursors.get(seq.id, seq.next_value)
            v = cur
            wrapped = False
            if v > seq.max_value or v < seq.min_value:
                if not seq.cycle:
                    raise ValueError(
                        f"sequence {seq.name} has run out")
                v = seq.start
                wrapped = True
            nxt = v + seq.increment
            self._seq_cursors[seq.id] = nxt
            if wrapped or (seq.increment > 0 and nxt > seq.next_value) \
                    or (seq.increment < 0 and nxt < seq.next_value):
                high = nxt + seq.increment * self.SEQ_CACHE
                if seq.increment > 0:
                    # never persist past "just exhausted": restart must
                    # still hand out the values below max_value
                    high = min(high, seq.max_value + seq.increment)
                else:
                    high = max(high, seq.min_value + seq.increment)
                seq.next_value = high
                self.persist_catalog()
            return v

    def sequence_set(self, seq, value: int) -> None:
        with self._seq_lock:
            self._seq_cursors[seq.id] = value + seq.increment
            seq.next_value = value + seq.increment * (self.SEQ_CACHE + 1)
            if seq.increment > 0:
                seq.next_value = min(seq.next_value,
                                     seq.max_value + seq.increment)
            self.persist_catalog()

    def _flush_sequence_cursors(self) -> None:
        """Write exact cursors into the catalog so a clean shutdown
        loses no sequence values (crash recovery falls back to the
        batched high-water)."""
        dirty = False
        with self._seq_lock:
            for schema in self.catalog.schemas.values():
                for seq in (getattr(schema, "sequences", {}) or {}
                            ).values():
                    cur = self._seq_cursors.get(seq.id)
                    if cur is not None and cur != seq.next_value:
                        seq.next_value = cur
                        dirty = True
        if dirty:
            self.persist_catalog()

    # ---- multi-process refresh (shared and remote modes) ----------------
    def refresh(self) -> None:
        """Catch up with the other processes of the cluster: tail the
        WAL, fold their committed rows into this process's columnar
        epochs, and reload the catalog when the meta plane moved (the
        reference's domain reload, domain/domain.go:352, on demand:
        sessions call it per statement, and every mutation section
        refreshes the KV implicitly)."""
        if not self.shared:
            return
        from .. import obs
        with obs.span("domain.refresh"):
            self.kv.refresh()
            self._drain_refresh()
            # a socket follower's mirror fsync, out of the hot locks
            self.kv.kv.sync_mirror()
        # a sibling's CREATE/DROP BINDING lands in the meta plane; drop
        # the cache so the next match reloads
        self.bindings.invalidate()

    def _drain_refresh(self) -> None:
        """Fold the records the last WAL tail applied: each committed
        row write lands in its table's columnar epoch at its commit ts;
        a write of the catalog key reloads the catalog. The whole drain,
        the catalog reload included, runs under the commit lock and
        inside a fold section: a socket follower's apply engine drains
        from its own thread, and a statement whose refresh found nothing
        left to drain must still wait for that fold to end. (The
        reference drains before it takes the lock and reloads the
        catalog after it, so a statement there can plan against a table
        whose store the reload has registered but not yet refolded:
        ROADMAP queue 3.)"""
        from ..kv.mvcc import (CF_DATA, CF_WRITE, _dkey, _split_vkey,
                               _write_dec)
        eng = self.kv.kv
        meta_catalog = tablecodec.meta_key(b"catalog")
        catalog_moved = False
        with self._commit_lock:
            pending = self.kv.drain_pending()
            if not pending:
                return
            with self._fold_section():
                for op, cf, key, val in pending:
                    if cf != CF_WRITE or op != 1:
                        continue
                    ukey, commit_ts = _split_vkey(key)
                    self.tso.observe(commit_ts)
                    if ukey == meta_catalog:
                        catalog_moved = True
                        continue
                    try:
                        table_id, handle = \
                            tablecodec.decode_record_key(ukey)
                    except (ValueError, struct.error):
                        continue  # meta, stats and index planes
                    store = self.tables.get(table_id)
                    if store is None:
                        continue
                    start_ts, kind = _write_dec(val)
                    if kind == OP_DEL:
                        store.apply_commit(commit_ts, handle, TOMBSTONE)
                    elif kind == OP_PUT:
                        data = eng.get(CF_DATA, _dkey(ukey, start_ts))
                        if data is not None:
                            store.apply_commit(commit_ts, handle,
                                               self._fold_row(
                                                   store,
                                                   codec.decode_key(data)))
                if catalog_moved:
                    self._reload_catalog()

    def _reload_catalog(self) -> None:
        """Adopt a sibling's schema change: rebuild the stores of tables
        whose definition moved (their schema_token changes, so in-flight
        local transactions abort at the fence — the reference's schema
        validator, domain/schema_validator.go) and register new tables.
        Unchanged tables keep their stores and epochs."""
        raw = self.get_meta(b"catalog")
        if raw is None:
            return
        state = pickle.loads(raw)
        if state["version"] == self.catalog.version:
            return
        old_infos = {}
        for schema in self.catalog.schemas.values():
            for info in schema.tables.values():
                old_infos[info.id] = pickle.dumps(info)
        self.catalog.schemas = state["schemas"]
        self.catalog._next_id = max(self.catalog._next_id,
                                    state["next_id"])
        self.catalog.version = state["version"]
        for schema in self.catalog.schemas.values():
            for info in schema.tables.values():
                part = getattr(info, "partition", None)
                ids = [d.id for d in part.defs] if part is not None \
                    else [info.id]
                changed = pickle.dumps(info) != old_infos.get(info.id)
                if info.id in old_infos and not changed and \
                        all(tid in self.tables for tid in ids):
                    continue
                old_tokens = {tid: self.tables[tid].schema_token
                              for tid in ids if tid in self.tables}
                self.register_table(info)
                for tid in ids:
                    # a rebuilt store presents a NEW schema token so
                    # in-flight local transactions that buffered against
                    # the old layout abort at the commit fence
                    self.tables[tid].schema_token = \
                        old_tokens.get(tid, 0) + 1
                    self._refold_table(self.tables[tid])
                if part is not None:
                    # the first partition's store allocates handles for
                    # the whole table, as after a reopen (`_recover`)
                    first = self.tables[ids[0]]
                    first._next_handle = max(
                        self.tables[tid]._next_handle for tid in ids)
        live = set()
        for schema in self.catalog.schemas.values():
            for info in schema.tables.values():
                part = getattr(info, "partition", None)
                live.update(d.id for d in part.defs) \
                    if part is not None else live.add(info.id)
        for tid in [t for t in self.tables if t not in live]:
            del self.tables[tid]

    def _refold_table(self, store: TableStore) -> None:
        """Rebuild a store's rows from the KV truth (epoch snapshot when
        current, committed deltas above its fold), raising its handle
        allocator over every handle it folds (a partitioned table's
        allocator, its first partition's store, is raised over all of
        them by `_reload_catalog`)."""
        self._load_epoch(store)
        lo, hi = tablecodec.record_range(store.table.id)
        folds = []
        for key, commit_ts, kind, val in self.kv.scan_latest(lo, hi):
            if commit_ts <= store.epoch.fold_ts:
                continue
            _, handle = tablecodec.decode_record_key(key)
            if kind == OP_DEL:
                folds.append((commit_ts, handle, TOMBSTONE))
            else:
                folds.append((commit_ts, handle, self._fold_row(
                    store, codec.decode_key(val))))
        for commit_ts, handle, row in folds:
            store.apply_commit(commit_ts, handle, row)
            store._next_handle = max(store._next_handle, handle + 1)

    # ---- meta KV (catalog, stats, sysvar and account persistence) ---------
    @contextmanager
    def ddl_section(self):
        """Critical section for direct catalog DDL (CREATE/DROP TABLE
        and friends), gated on the DDL owner — the same lock ALTER-family
        jobs take in `DDL.run_job`. The whole-catalog persist is
        last-writer-wins, so {fold the sibling catalog -> mutate ->
        persist} must be atomic against a sibling's DDL. The lock order
        everywhere is owner -> mutation/coordinator."""
        with self.ddl_owner:
            self.refresh()  # adopt sibling catalog inside the gate
            yield

    def put_meta(self, name: bytes, value: bytes) -> None:
        """Durable metadata write through the SAME percolator path as row
        data (reference: meta/meta.go over the m-prefix keyspace).
        Non-catalog keys are last-writer-wins snapshots, so a conflict
        retries with a fresh ts; the catalog key never blind-retries."""
        from ..kv.backoff import BO_META, Backoffer, BackoffExhausted

        key = tablecodec.meta_key(name)
        retriable = name != b"catalog"
        bo = Backoffer(budget_ms=2000)
        while True:
            # .ts() is the STRICT allocator interface: on a degraded
            # follower it raises typed instead of re-issuing a stale
            # timestamp that a WRITE would then carry
            start_ts = self.tso.ts()
            try:
                try:
                    with self._commit_lock:
                        self.committer.commit(
                            [Mutation(OP_PUT, key, value)], start_ts)
                finally:
                    self._tso_commit_done()
                # meta writes are acked durable like row commits: join
                # the group-fsync rendezvous outside the commit lock
                try:
                    self.kv.commit_sync()
                except OSError as e:
                    raise KVError(
                        f"meta write on {name!r}: WAL fsync failed "
                        f"after the commit was applied ({e})"
                    ) from e
                return
            except KVWriteConflict:
                if not retriable:
                    raise
                if self.shared:
                    self.kv.refresh()
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


class UserLocks:
    """Named advisory locks for GET_LOCK/RELEASE_LOCK (reference:
    builtin_miscellaneous.go lockFunc family). Reentrant per holder,
    released explicitly, en masse, or on connection close."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._held: dict[str, tuple[Any, int]] = {}  # name -> (who, depth)

    def acquire(self, name: str, who, timeout_s: float) -> bool:
        import time as _t

        from ..util import interrupt
        infinite = timeout_s < 0  # MySQL: negative timeout waits forever
        deadline = _t.monotonic() + timeout_s
        with self._cv:
            while True:
                cur = self._held.get(name)
                if cur is None or cur[0] == who:
                    depth = cur[1] + 1 if cur else 1
                    self._held[name] = (who, depth)
                    return True
                interrupt.check()  # KILL QUERY cancels a blocked wait
                remain = 0.5 if infinite else deadline - _t.monotonic()
                if remain <= 0:
                    return False
                self._cv.wait(min(remain, 0.5))

    def release(self, name: str, who) -> Optional[int]:
        """1 released, 0 held by someone else, None not held (MySQL)."""
        with self._cv:
            cur = self._held.get(name)
            if cur is None:
                return None
            if cur[0] != who:
                return 0
            if cur[1] > 1:
                self._held[name] = (who, cur[1] - 1)
            else:
                del self._held[name]
                self._cv.notify_all()
            return 1

    def release_all(self, who) -> int:
        with self._cv:
            mine = [k for k, (w, _) in self._held.items() if w == who]
            n = sum(self._held[k][1] for k in mine)
            for k in mine:
                del self._held[k]
            if mine:
                self._cv.notify_all()
            return n

    def holder(self, name: str) -> Optional[Any]:
        with self._cv:
            cur = self._held.get(name)
            return cur[0] if cur else None


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
        # set by Storage.begin: the snapshot ts was re-issued by a
        # degraded follower's oracle (reads only)
        self.degraded = False

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
