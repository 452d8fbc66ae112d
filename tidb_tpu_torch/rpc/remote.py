"""Follower-side adapters: storage plumbing over the RPC client.

Port of `tidb_tpu/rpc/remote.py`.

These present the exact surfaces the shared-directory deployment wires
into Storage — the ordered-KV engine, the mutation-section coordinator,
the owner managers — so the storage/session layers run unchanged on a
server that shares NOTHING with the leader but a socket (reference: a
tidb-server knows TiKV only through the client in store/tikv/; swapping
mockstore for a real cluster is a constructor argument).

Replication model: the leader's WAL is the single bus. A follower
mirrors it by position-based tailing (RemoteKV.refresh), and publishes
its own mutations by appending the records it buffered during the
flock-granted mutation section — flushed BEFORE the lease is released,
under its fencing token, so the next section holder's refresh always
sees them. If the flush is fenced off (lease lost) the buffered
records are REVERTED from the local maps via their undo log: the
follower returns to exactly the replicated state and the statement
fails with a typed, retryable error — never a divergent store."""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..kv.backoff import BO_TXN_LOCK, Backoffer
from ..kv.mvcc import PyOrderedKV
from ..store.coordinator import SharedDirCoordinator
from .client import RpcClient, RpcOptions
from .errors import LeaderUnavailable, ResultUndetermined, RPCError
from .frame import MAX_FRAME


class RemoteKV(PyOrderedKV):
    """In-memory ordered KV mirroring the leader's WAL over RPC.

    Inherits the maps/scan machinery and the record format from the
    pure-python engine; overrides the durability plane: appends buffer
    locally (with an undo log) until the mutation section flushes them
    to the leader, and refresh() tails the leader instead of a file.

    With `mirror_dir` the follower also keeps an on-disk MIRROR of the
    replicated stream — the leader's snapshot.kv byte-for-byte plus
    every tailed/published WAL byte in the same order. The mirror is
    what makes in-place PROMOTION possible: a follower that wins the
    election re-opens its mirror as the authoritative (snapshot, WAL)
    pair, and because every follower's mirror is a byte-prefix of the
    dead leader's file, surviving peers keep tailing from their own
    offsets against the new leader without re-bootstrapping."""

    def __init__(self, client: RpcClient,
                 mirror_dir: Optional[str] = None,
                 sync_log: str = "off",
                 sync_interval_ms: int = 100) -> None:
        super().__init__(path=None, sync_log=sync_log,
                         sync_interval_ms=sync_interval_ms)
        self._client = client
        self._applied_off = 0          # leader-WAL byte position
        self._buf: list[bytes] = []    # records awaiting flush
        self._undo: list = []          # (cf, key, old_value) LIFO
        self._seq = 0                  # client-assigned append sequence
        self.mirror_dir = mirror_dir
        self._mirror_wal = None
        from ..kv.mvcc import SyncPolicy
        self._mirror_sync = SyncPolicy(sync_log, sync_interval_ms,
                                       self._fsync_mirror)
        # sync-log=commit: appended mirror bytes wait for sync_mirror(),
        # which the storage runs once the store mutex and the commit lock
        # are released and before the refresh or commit that appended
        # them returns (an fsync under either lock would stall every
        # reader and writer of this follower behind the disk barrier)
        self._mirror_pending = False
        if mirror_dir is not None:
            import os
            os.makedirs(mirror_dir, exist_ok=True)
            # a stale mirror (earlier join, possibly of a different
            # leader epoch) cannot be trusted to prefix-match the
            # current stream: restart the mirror with the bootstrap
            for name in ("wal.log", "snapshot.kv"):
                try:
                    os.remove(os.path.join(mirror_dir, name))
                except OSError:
                    pass
            self._mirror_wal = open(
                os.path.join(mirror_dir, "wal.log"), "wb")

    # ---- bootstrap / tail --------------------------------------------------
    def bootstrap(self) -> None:
        # the snapshot streams in chunks like the WAL (a store with a
        # long pre-shared life can exceed any single frame); a record
        # split at a chunk boundary carries over as `rem`
        import os
        off, rem = 0, b""
        snap_tmp = None
        if self.mirror_dir is not None:
            snap_tmp = open(
                os.path.join(self.mirror_dir, "snapshot.tmp"), "wb")
        try:
            while True:
                r = self._client.call(
                    "wal_bootstrap", offset=off,
                    _budget_ms=self._client.options.lock_budget_ms)
                data = r.get("snapshot", b"")
                off += len(data)
                if snap_tmp is not None and data:
                    snap_tmp.write(data)
                if rem or data:
                    valid, _ = self._replay_bytes(rem + data, queue=False)
                    rem = (rem + data)[valid:]
                if not r.get("more"):
                    break
            if snap_tmp is not None:
                snap_tmp.flush()
                os.fsync(snap_tmp.fileno())
                snap_tmp.close()
                snap_tmp = None
                if off:
                    from ..kv.mvcc import fsync_dir
                    os.replace(
                        os.path.join(self.mirror_dir, "snapshot.tmp"),
                        os.path.join(self.mirror_dir, "snapshot.kv"))
                    fsync_dir(self.mirror_dir)
                else:
                    os.remove(
                        os.path.join(self.mirror_dir, "snapshot.tmp"))
        finally:
            if snap_tmp is not None:
                snap_tmp.close()
        self._applied_off = 0
        self.refresh()  # the log itself streams via chunked tailing
        self.pending_refresh.clear()  # nothing folded yet; _recover scans
        self.sync_mirror()

    def _replay_bytes(self, data: bytes, queue: bool = True
                      ) -> tuple[int, int]:
        """Apply the valid record prefix of `data`; returns
        (valid_byte_length, records_applied). A torn tail (leader mid-
        append) is left for the next tail to complete."""
        import struct
        off = n = 0
        ln = len(data)
        while off + 10 <= ln:
            op, cf = data[off], data[off + 1]
            klen, vlen = struct.unpack_from("<II", data, off + 2)
            end = off + 10 + klen + vlen
            if cf >= 3 or op not in (1, 2) or end > ln:
                break
            key = data[off + 10:off + 10 + klen]
            val = data[off + 10 + klen:end]
            if op == 1:
                self._apply_put(cf, key, val)
            else:
                self._apply_delete(cf, key)
            if queue:
                self.pending_refresh.append((op, cf, key, val))
            off = end
            n += 1
        return off, n

    def refresh(self) -> int:
        total = 0
        opts = self._client.options
        # degraded fast path: serve the last replicated state instead of
        # paying the backoff budget per statement; the heartbeat probes
        # recovery and clears the flag (follower-read degrade, the
        # bounded-staleness mode the status port reports)
        if self._client.degraded and opts.stale_reads:
            return 0
        limit = 0  # 0 = server's chunk; grows when a record spans chunks
        while True:
            try:
                r = self._client.call("wal_tail",
                                      offset=self._applied_off,
                                      limit=limit)
            except RPCError:
                if opts.stale_reads:
                    return total
                raise
            data = r.get("data", b"")
            ws = r.get("wal_size")
            if isinstance(ws, int) and ws < self._applied_off:
                # the serving leader holds LESS log than we replicated:
                # a post-failover leader that never saw our tail (the
                # documented loss window). Silently waiting would hang
                # forever; diverged state needs an operator (or a
                # re-join with a fresh working dir).
                raise RPCError(
                    f"replication diverged: this follower is at WAL "
                    f"offset {self._applied_off} but the leader holds "
                    f"only {ws} bytes; re-join with a fresh working "
                    "dir to resync")
            if not data:
                return total
            valid, n = self._replay_bytes(data)
            self._mirror_append(data[:valid])
            self._applied_off += valid
            total += n
            if not r.get("more"):
                # the server reached its file tip; a residual partial
                # record is the leader mid-append — the next tail
                # completes it (valid < len(data) is NOT an error here)
                return total
            # more bytes exist server-side, so a partial record at the
            # chunk edge is a chunking artifact: loop. A record larger
            # than the chunk makes no progress — double the ask.
            if valid == 0 and len(data) >= MAX_FRAME - 4096:
                # the record cannot fit ANY frame: fail typed, never
                # spin (the leader's local append path has no frame cap)
                raise RPCError(
                    f"WAL record at offset {self._applied_off} exceeds "
                    f"the transport frame limit ({MAX_FRAME}); this "
                    "follower cannot mirror the store")
            limit = min(2 * len(data), MAX_FRAME - 4096) \
                if valid == 0 else 0

    def tail_clean(self) -> None:
        pass  # the leader owns the file; its tail hygiene applies

    # ---- on-disk mirror ----------------------------------------------------
    def _fsync_mirror(self) -> None:
        import os
        mw = self._mirror_wal
        if mw is not None and not mw.closed:
            mw.flush()
            os.fsync(mw.fileno())

    def _mirror_append(self, data: bytes) -> None:
        if self._mirror_wal is None or not data:
            return
        self._mirror_wal.write(data)
        self._mirror_wal.flush()
        self._mirror_sync.mark_dirty()
        if self._mirror_sync.policy == "commit":
            self._mirror_pending = True
            return
        # mirror durability is promotion-quality, not the ack path
        # (the leader's fsync is) — a failed mirror fsync must not
        # fail replication
        try:
            self._mirror_sync.boundary()
        except OSError:
            pass

    def sync_mirror(self) -> None:
        """fsync the mirror bytes appended since the last one (commit
        mode), outside the hot locks. A failed mirror fsync must not
        fail replication."""
        if not self._mirror_pending:
            return
        self._mirror_pending = False
        try:
            self._mirror_sync.flush()
        except OSError:
            pass

    def commit_sync(self) -> None:
        super().commit_sync()
        self.sync_mirror()

    def close(self) -> None:
        self.sync_mirror()
        self._mirror_sync.close()
        super().close()
        if self._mirror_wal is not None:
            try:
                self._mirror_wal.close()
            except OSError:
                pass
            self._mirror_wal = None

    # ---- buffered append with undo -----------------------------------------
    def _log(self, op: int, cf: int, key: bytes, value: bytes) -> None:
        import struct
        self._undo.append((cf, key, self._maps[cf].get(key)))
        self._buf.append(struct.pack("<BBII", op, cf, len(key),
                                     len(value)) + key + value)

    def flush_section(self, token: Optional[int]) -> None:
        """Publish the section's records to the leader WAL; called by
        the coordinator while the mutation lease is still held. Any
        failure reverts the local application wholesale."""
        if not self._buf:
            return
        data = b"".join(self._buf)
        if len(data) + 4096 > MAX_FRAME:
            # fail typed BEFORE the wire: a frame this large would be
            # rejected locally by send_frame, and retrying it under
            # BO_RPC would burn the budget into a misleading
            # ResultUndetermined for a deterministic local condition
            self._revert()
            raise RPCError(
                f"transaction publishes {len(data)} bytes in one "
                f"mutation section, over the transport frame limit "
                f"({MAX_FRAME}); split the statement or commit in "
                "smaller transactions")
        self._seq += 1
        try:
            r = self._client.call("wal_append", seq=self._seq,
                                  expected=self._applied_off, data=data,
                                  token=token or 0,
                                  term=self._client.term)
        except LeaderUnavailable as e:
            # the request may have landed before the leader went dark:
            # the outcome is UNKNOWN, not failed (reference:
            # ErrResultUndetermined). Locally we revert to the last
            # replicated state; if the append did land, the next tail
            # re-applies it — either way the store never diverges.
            self._revert()
            raise ResultUndetermined(
                f"wal publish outcome unknown: {e}") from None
        except BaseException:
            # typed rejections (stale lease, offset fence) and local
            # faults: the leader definitively did NOT apply the records
            self._revert()
            raise
        # the leader wrote our records at exactly `expected` (the offset
        # fence guarantees it), so the mirror appends the same bytes at
        # the same position — prefix equality with the leader's file is
        # preserved through our own publishes
        self._mirror_append(data)
        self._applied_off = int(r["offset"])
        self._buf, self._undo = [], []

    def _revert(self) -> None:
        for cf, key, old in reversed(self._undo):
            if old is None:
                self._apply_delete(cf, key)
            else:
                self._apply_put(cf, key, old)
        self._buf, self._undo = [], []


class RemoteCoordinator:
    """The SharedDirCoordinator surface over RPC: the mutation critical
    section becomes a leader-granted lease on the same store.lock flock,
    and the kill mailbox/process registry become calls."""

    def __init__(self, client: RpcClient,
                 options: Optional[RpcOptions] = None) -> None:
        self.client = client
        self.options = options or client.options
        self.engine: Optional[RemoteKV] = None  # wired by Storage
        self._tlock = threading.RLock()
        self._depth = 0
        self._token: Optional[int] = None
        self._kill_seq = 0
        self.node_id = int(client.call("node_claim")["node_id"])

    # ---- mutation critical section ----------------------------------------
    def acquire(self) -> None:
        self._tlock.acquire()
        self._depth += 1
        if self._depth > 1:
            return
        try:
            if self.client.degraded:
                raise LeaderUnavailable(
                    "store leader unreachable: this server is serving "
                    "reads only (writes need the mutation lease)")
            bo = Backoffer(budget_ms=self.options.lock_budget_ms)
            while True:
                r = self.client.call("lock_acquire", name="mutation",
                                     term=self.client.term)
                if r.get("granted"):
                    self._token = int(r["token"])
                    return
                bo.sleep(BO_TXN_LOCK)
        except BaseException:
            self._depth -= 1
            self._tlock.release()
            raise

    def release(self) -> None:
        self._depth -= 1
        try:
            if self._depth == 0:
                token, self._token = self._token, None
                try:
                    if self.engine is not None:
                        self.engine.flush_section(token)
                finally:
                    try:
                        self.client.call("lock_release", name="mutation",
                                         token=token or 0, _budget_ms=500)
                    except RPCError:
                        pass  # the lease reaper will reclaim it
        finally:
            # a flush failure must surface typed, never with the RLock
            # still held — that would hang every later writer
            self._tlock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # ---- registry / kill mailbox -------------------------------------------
    global_conn_id = staticmethod(SharedDirCoordinator.global_conn_id)
    split_conn_id = staticmethod(SharedDirCoordinator.split_conn_id)

    def register_server(self, port: int, status_port) -> None:
        self.client.call("node_register", node_id=self.node_id,
                         port=port, status_port=status_port)

    def servers(self) -> dict:
        return self.client.call("servers").get("servers", {})

    def post_kill(self, conn_id: int, query_only: bool) -> None:
        self.client.call("kill_post", conn_id=conn_id,
                         query_only=query_only)

    def poll_kills(self) -> list[tuple[int, bool]]:
        # the poll consumes the mailbox server-side, so a retry of the
        # SAME poll must replay the consumed result, not drain an empty
        # box — the seq gives the server that dedup key (same contract
        # as wal_append). Advance only on success: a poll that died
        # after the server drained the box is replayed by the next one.
        seq = self._kill_seq + 1
        try:
            r = self.client.call("kill_poll", node_id=self.node_id,
                                 seq=seq, _budget_ms=500)
        except RPCError:
            return []  # mailbox polling must never kill the poller
        self._kill_seq = seq
        return [(int(local), bool(qo)) for local, qo in r.get("kills", [])]


class RemoteOwnerManager:
    """Owner election over a leader-granted lease (reference:
    owner/manager.go etcd campaign; the flock manager's shape kept so
    storage wiring is a one-line swap). A lost leader surfaces as a
    failed campaign — DDL fails typed instead of running unfenced."""

    def __init__(self, client: RpcClient, key: str = "ddl") -> None:
        self.client = client
        self.key = key
        self._thread_lock = threading.RLock()
        self._token: Optional[int] = None

    def try_campaign(self) -> bool:
        if not self._thread_lock.acquire(blocking=False):
            return False
        try:
            r = self.client.call("lock_acquire", name=self.key,
                                 _budget_ms=1000)
        except RPCError:
            self._thread_lock.release()
            if self.client.degraded:
                raise
            return False
        if r.get("granted"):
            self._token = int(r["token"])
            return True
        self._thread_lock.release()
        return False

    def campaign(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while True:
            if self.try_campaign():
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def resign(self) -> None:
        token, self._token = self._token, None
        try:
            self.client.call("lock_release", name=self.key,
                             token=token or 0, _budget_ms=500)
        except RPCError:
            pass
        try:
            self._thread_lock.release()
        except RuntimeError:
            pass

    def close(self) -> None:
        pass

    def __enter__(self):
        if not self.campaign():
            raise LeaderUnavailable(
                f"could not become {self.key} owner (store leader "
                "unreachable or lease held)")
        return self

    def __exit__(self, *exc) -> None:
        self.resign()


__all__ = ["RemoteKV", "RemoteCoordinator", "RemoteOwnerManager"]
