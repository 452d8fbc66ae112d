"""Range-sharded write leadership: per-range leases over a shared
durable root, serving percolator RPCs with fencing checks.

The tier splits the keyspace into ranges (kv/rangemeta.py) whose write
leadership is held by INDEPENDENTLY-leased leaders — possibly different
processes per range — so durable writes scale past one commit lock /
one WAL and a single crash only stalls the ranges that process led
(reference: the region model — raftstore leaders per region, not per
store; PAPER.md L7). Three pieces:

* RangeDirectory — the filesystem directory service under
  `<root>/ranges/`: the range table (`meta.json`, first writer wins),
  and per range a grant file + fencing-term file + WAL directory.
  Lease acquisition takes an flock only for the read-modify-write of
  the grant; TENURE is the grant's wall-clock expiry, never the flock
  (a SIGKILLed holder's flock vanishes with the process — the grant
  must keep fencing until it times out). Terms bump exactly when
  ownership changes hands, and persist crash-atomically (the
  rpc/server.py write_term idiom), so a deposed leader — or a client
  that last spoke to it — presents a provably stale term forever after.

* RangeLeader — one hosted range: an MVCCStore over the range's own
  WAL directory (sync_log='commit' by default: acked means fsynced),
  replayed on open, plus the range's closed timestamp (min pending
  lock start_ts - 1, else max committed ts — the per-range analog of
  the follower tier's pending-commit ledger).

* RangeServer — a FrameListener answering `range_*` percolator RPCs.
  Every data request carries the client's (range_id, epoch, term)
  context and is gated BEFORE any data access: wrong host answers
  NotLeaderError, an older routing table answers EpochNotMatchError,
  a superseded term answers StaleTermError, and a grant past its
  expiry refuses to serve at all — stale routing can produce a typed
  retry, never a silently wrong result. A lease loop acquires unheld
  ranges (election = the deterministic lease race over the shared
  directory; the WAL replay makes takeover lossless for acked commits)
  and renews held ones.

Loss window (document over deny): leadership fencing is checked at
request entry, not per WAL byte. A leader paused (SIGSTOP) MID-handler
past its lease expiry can still append after a successor opened the
same WAL — the same bounded window the pull-replication tier documents.
Kill-9 (the failure mode the chaos suite drives) has no such window:
a dead process appends nothing.

Port of `tidb_tpu/rpc/ranged.py`, whole, but for one race the reference
has: a split's recovery acts only on a journal it reads again under the
range's gate. The reference recovers from a copy read before the gate,
so a lease tick that meets a split of its own process in flight rebuilds
the new child from the parent's retired half: empty, and counted twice.

The port's error policy:
the lease loop survives only `errors.survivable()` errors (a failed
renewal, a transport or KV error, a split recovery that could not finish
this tick). Any other error ends the loop and is kept as `error`;
`RangeServer.close()` re-raises it (after the teardown), and with it
`RangePlane.close()` and `Storage.close()`. A split that fails before its
table commits still rolls back and re-raises whatever the error, as the
reference's does. `RangeServer._mu` is declared hot for the lock-order
checker (analysis/registry.py HOT_LOCKS). The close joins the lease
thread and, through the listener, every connection thread.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import threading
import time
from contextlib import contextmanager
from typing import Optional

from .. import obs
from ..analysis import lockcheck
from ..kv.mvcc import (KVError, KeyIsLockedError, MVCCStore, Mutation,
                       PyOrderedKV, TxnNotFoundError, WriteConflictError,
                       fsync_dir)
from ..kv.rangemeta import RangeSpec, split_keyspace, split_spec
from ..util import failpoint
from .errors import (EpochNotMatchError, NotLeaderError, RPCError,
                     StaleLeaseError, StaleTermError, survivable,
                     traced_response, wire_error)
from .frame import get_range_ctx, get_trace_ctx
from .server import FrameListener, read_term, write_term


def _now_ms() -> float:
    # wall clock on purpose: grant expiries must compare across
    # processes, which monotonic clocks never do
    return time.time() * 1000.0


def _write_json_atomic(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---- the directory service ---------------------------------------------------
class RangeDirectory:
    """Range table + per-range lease grants under `<root>/ranges/`.

    Layout:
        ranges/meta.json          the range table (id, bounds, epoch)
        ranges/meta.lock          flock serializing table writes
        ranges/r<id>/lease.lock   flock serializing grant writes
        ranges/r<id>/grant.json   {owner, token, term, expires_ms, ...}
        ranges/r<id>/term         persisted fencing term (write_term)
        ranges/r<id>/data/        the range's own WAL directory
        ranges/r<id>/split.json   in-flight split journal (parent side)
    """

    def __init__(self, root: str) -> None:
        self.root = root
        self.dir = os.path.join(root, "ranges")
        os.makedirs(self.dir, exist_ok=True)

    # ---- paths ----
    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.json")

    def _range_dir(self, rid: int) -> str:
        return os.path.join(self.dir, f"r{int(rid)}")

    def data_dir(self, rid: int) -> str:
        return os.path.join(self._range_dir(rid), "data")

    def _grant_path(self, rid: int) -> str:
        return os.path.join(self._range_dir(rid), "grant.json")

    def _term_path(self, rid: int) -> str:
        return os.path.join(self._range_dir(rid), "term")

    def split_path(self, rid: int) -> str:
        return os.path.join(self._range_dir(rid), "split.json")

    @contextmanager
    def _flock(self, path: str):
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # releases the flock with the fd

    # ---- the range table ----
    def bootstrap(self, specs: Optional[list] = None) -> list[RangeSpec]:
        """Write the range table if absent (first writer wins — every
        later bootstrapper adopts the existing table regardless of its
        own knobs, so concurrently started servers can never disagree
        about range bounds). Returns the authoritative table."""
        with self._flock(os.path.join(self.dir, "meta.lock")):
            existing = self.load_specs()
            if existing is not None:
                return existing
            specs = list(specs) if specs else split_keyspace(1)
            _write_json_atomic(self._meta_path(), {
                "ranges": [{"id": s.id, "start": s.start_key.hex(),
                            "end": s.end_key.hex(), "epoch": s.epoch}
                           for s in specs]})
            for s in specs:
                os.makedirs(self.data_dir(s.id), exist_ok=True)
            return specs

    def load_specs(self) -> Optional[list[RangeSpec]]:
        doc = _read_json(self._meta_path())
        if not doc:
            return None
        # sorted by start on every read: locate_spec bisects and the
        # router scans in table order — a split inserts mid-table
        return sorted(
            [RangeSpec(int(r["id"]), bytes.fromhex(r["start"]),
                       bytes.fromhex(r["end"]), int(r.get("epoch", 1)))
             for r in doc["ranges"]],
            key=lambda s: s.start_key)

    def bump_epoch(self, rid: int) -> int:
        """Advance one range's routing epoch (the metadata-changed
        signal: clients carrying the old epoch get EpochNotMatchError
        and reload the table). Bounds stay put — live reshapes go
        through begin_split."""
        with self._flock(os.path.join(self.dir, "meta.lock")):
            doc = _read_json(self._meta_path())
            if not doc:
                raise RPCError("range table missing")
            new = 0
            for r in doc["ranges"]:
                if int(r["id"]) == int(rid):
                    r["epoch"] = new = int(r.get("epoch", 1)) + 1
            if not new:
                raise RPCError(f"unknown range {rid}")
            _write_json_atomic(self._meta_path(), doc)
            return new

    # ---- the split journal ----
    def read_split(self, rid: int) -> Optional[dict]:
        """The parent-side split journal, if a split is in flight:
        {parent, child, split (hex), state: pending|ready}."""
        return _read_json(self.split_path(rid))

    def begin_split(self, parent_id: int, split_key: bytes,
                    trigger: str = "manual"
                    ) -> tuple[RangeSpec, RangeSpec]:
        """Crash-atomically commit one split's table delta. Protocol,
        all under the meta flock: (1) journal the intent next to the
        parent's grant (state=pending), (2) rewrite meta.json with the
        two children — the tmp+fsync+rename+dirfsync discipline makes
        that rename THE commit point. A crash between the two leaves a
        pending journal whose child id is absent from the meta: the
        successor's recovery rolls the split BACK deterministically. A
        crash after leaves both, and recovery rolls FORWARD. Returns
        (left, right) — the parent keeps its id as the left child,
        both at epoch parent+1 (in-flight requests stamped with the
        old epoch get EpochNotMatchError and re-route)."""
        split_key = bytes(split_key)
        with self._flock(os.path.join(self.dir, "meta.lock")):
            specs = self.load_specs()
            if not specs:
                raise RPCError("range table missing")
            parent = next((s for s in specs
                           if s.id == int(parent_id)), None)
            if parent is None:
                raise RPCError(f"unknown range {parent_id}")
            if self.read_split(parent.id) is not None:
                raise RPCError(f"range {parent.id} already splitting")
            child_id = max(s.id for s in specs) + 1
            try:
                left, right = split_spec(parent, split_key, child_id)
            except ValueError as e:
                raise RPCError(str(e)) from e
            _write_json_atomic(self.split_path(parent.id), {
                "parent": int(parent.id), "child": int(child_id),
                "split": split_key.hex(), "state": "pending",
                "trigger": str(trigger)})
            try:
                failpoint.inject("range/split-before-meta-commit")
                table = sorted(
                    [s for s in specs if s.id != parent.id]
                    + [left, right], key=lambda s: s.start_key)
                _write_json_atomic(self._meta_path(), {
                    "ranges": [{"id": s.id, "start": s.start_key.hex(),
                                "end": s.end_key.hex(),
                                "epoch": s.epoch} for s in table]})
            except BaseException:
                # the meta never committed: withdraw the intent (the
                # in-process twin of the successor's roll-back)
                try:
                    os.unlink(self.split_path(parent.id))
                except OSError:
                    pass
                raise
            os.makedirs(self.data_dir(child_id), exist_ok=True)
            return left, right

    def mark_split_ready(self, rid: int) -> None:
        """The child's store is complete and durable: from here the
        split only rolls FORWARD (recovery must never rebuild a ready
        child — it may already hold post-split writes)."""
        j = self.read_split(rid)
        if j is not None:
            j["state"] = "ready"
            _write_json_atomic(self.split_path(rid), j)

    def clear_split(self, rid: int) -> None:
        try:
            os.unlink(self.split_path(rid))
            fsync_dir(self._range_dir(rid))
        except OSError:
            pass

    def pending_children(self) -> set[int]:
        """Child range ids whose split journal is still pending — their
        data dirs may be partial, so NOBODY may acquire their lease
        until the parent-side recovery marks them ready."""
        out: set[int] = set()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            if not n.startswith("r"):
                continue
            j = _read_json(os.path.join(self.dir, n, "split.json"))
            if j and j.get("state") == "pending":
                out.add(int(j.get("child", -1)))
        return out

    # ---- grants ----
    def read_grant(self, rid: int) -> Optional[dict]:
        """Lock-free grant read (atomic rename makes it torn-proof) —
        what routers use to find a range's current leader."""
        return _read_json(self._grant_path(rid))

    def acquire(self, rid: int, owner: str,
                lease_ms: int) -> Optional[dict]:
        """Take the range's lease if it is free, expired, or already
        ours. The token bumps on EVERY grant write (per-tenure fencing
        for renewal); the TERM bumps only when ownership changes hands
        (the cross-process fencing epoch a deposed leader can never
        re-present). Returns the grant, or None while another owner's
        grant is still live."""
        os.makedirs(self._range_dir(rid), exist_ok=True)
        with self._flock(os.path.join(self._range_dir(rid),
                                      "lease.lock")):
            g = _read_json(self._grant_path(rid))
            now = _now_ms()
            if g and g.get("owner") != owner \
                    and float(g.get("expires_ms", 0)) > now:
                return None  # live grant held elsewhere
            prev_owner = g.get("owner", "") if g else ""
            # the term floor survives a torn/corrupt grant file: the
            # dedicated term file is the durable fencing record
            term = max(int(g.get("term", 0)) if g else 0,
                       read_term(self._term_path(rid)))
            if prev_owner != owner:
                term += 1
                write_term(self._term_path(rid), term)
            grant = {"range_id": int(rid), "owner": owner,
                     "token": (int(g.get("token", 0)) if g else 0) + 1,
                     "term": term, "expires_ms": now + int(lease_ms),
                     "prev_owner": prev_owner,
                     # the closed-ts FLOOR a successor inherits: the
                     # predecessor published this value and routed
                     # reads may already have trusted it, so the new
                     # leader's closed_ts must never start below it
                     "closed_ts": int(g.get("closed_ts", 0)) if g
                     else 0}
            _write_json_atomic(self._grant_path(rid), grant)
            return grant

    def renew(self, rid: int, owner: str, token: int,
              lease_ms: int, closed_ts: Optional[int] = None) -> dict:
        """Extend our own grant; StaleLeaseError when the grant is no
        longer ours (another process acquired while our lease was
        expired — the holder must fence itself immediately). The lease
        heartbeat doubles as the closed-ts publication: routers read
        the grant's closed_ts lock-free to compute read coverage, so
        the published value only ever ratchets up."""
        with self._flock(os.path.join(self._range_dir(rid),
                                      "lease.lock")):
            g = _read_json(self._grant_path(rid))
            if not g or g.get("owner") != owner \
                    or int(g.get("token", -1)) != int(token):
                raise StaleLeaseError(
                    f"range {rid} grant is {g and g.get('owner')!r} "
                    f"token {g and g.get('token')}, not {owner!r} "
                    f"token {token}")
            g["expires_ms"] = _now_ms() + int(lease_ms)
            if closed_ts is not None:
                g["closed_ts"] = max(int(g.get("closed_ts", 0)),
                                     int(closed_ts))
            _write_json_atomic(self._grant_path(rid), g)
            return g

    def release(self, rid: int, owner: str, token: int) -> bool:
        """Zero our grant's expiry so a successor can acquire without
        waiting out the lease (graceful shutdown / forced transfer)."""
        with self._flock(os.path.join(self._range_dir(rid),
                                      "lease.lock")):
            g = _read_json(self._grant_path(rid))
            if not g or g.get("owner") != owner \
                    or int(g.get("token", -1)) != int(token):
                return False
            g["expires_ms"] = 0
            _write_json_atomic(self._grant_path(rid), g)
            return True


# ---- one hosted range --------------------------------------------------------
class RangeLeader:
    """A range this process leads: its own durable MVCC store (WAL
    replay on open makes takeover lossless for acked commits) plus the
    lease/fencing state the request gate checks — and the per-range
    pending-commit LEDGER the closed timestamp is computed from (the
    follower tier's `closed_info` slot protocol, scoped to this range's
    2PC traffic).

    Ledger rules:
      * a prewrite ENTERS an entry pinned at its start_ts;
      * commit with done=True (single-range txn, or the coordinator's
        txn_done already covers it) RETIRES the entry;
      * commit with done=False (a cross-range participant whose
        secondaries are not yet durable everywhere) RE-PINS the entry
        at commit_ts and stamps the wall clock — the closed ts may
        not pass a half-committed transaction on ANY participant;
      * rollback / orphan resolution / a txn_done RPC retires;
      * a commit-pinned entry whose txn_done was lost (coordinator
        death, partition) self-retires after hold_ms — by then the
        locks its unresolved secondaries still hold pin the closed ts
        through the lock union, and resolution retires those.

    The published value is MONOTONIC: max over (ledger ∪ live locks
    → min-1, else newest commit), floored at the grant's closed_ts —
    the predecessor's published value after a leader transfer, the
    parent's after a split handoff. Safety: every published value is
    ≤ the TSO's current reading at publication (a pending entry pins
    below its txn's eventual commit_ts; with none, _max_commit is an
    already-allocated ts), and every future commit_ts allocation is
    strictly above the TSO — so a later prewrite that dips the
    candidate can never invalidate an already-published closed ts."""

    def __init__(self, spec: RangeSpec, grant: dict, data_dir: str,
                 sync_log: str = "commit",
                 hold_ms: int = 3000) -> None:
        self.spec = spec
        self.grant = dict(grant)
        self.store = MVCCStore(PyOrderedKV(data_dir, sync_log=sync_log))
        self._max_commit = self.store.max_commit_ts()
        self.fenced = False
        self.hold_ms = int(hold_ms)
        # ledger entries: start_ts -> [pin_ts, committed_wall_ms or 0]
        # (plain Lock, not hot-declared: every critical section is a
        # dict op; closed_ts() is called off the lease tick while
        # handlers mutate under the leader gate)
        self._ledger_mu = threading.Lock()
        self._pending: dict[int, list] = {}
        # transfer/split floor: never publish below what a predecessor
        # already published (routers may have trusted it)
        self._closed = int(grant.get("closed_ts", 0) or 0)
        # re-derive pending entries from replayed-but-unresolved
        # prewrites in the per-range WAL: a lock that survived replay
        # is a transaction whose fate this leader does not know yet
        for lk in self.store.all_locks():
            self._pending.setdefault(int(lk.start_ts),
                                     [int(lk.start_ts), 0.0])
        # split/serve exclusion: every data handler holds this across
        # its fencing check AND its store op, and split_range holds it
        # exclusively while it bumps the epoch and partitions the
        # store — so a request that passed the gate pre-split can
        # never mutate the parent after the child copy was cut. Plain
        # RLock, deliberately NOT hot-declared: the split does file
        # I/O under it, and handler critical sections already
        # serialize per range on MVCCStore._mu anyway.
        self.gate = threading.RLock()

    @property
    def term(self) -> int:
        return int(self.grant.get("term", 0))

    def note_commit(self, commit_ts: int) -> None:
        if commit_ts > self._max_commit:
            self._max_commit = commit_ts

    # ---- pending-commit ledger ----
    def ledger_enter(self, start_ts: int) -> None:
        with self._ledger_mu:
            self._pending.setdefault(int(start_ts),
                                     [int(start_ts), 0.0])

    def ledger_commit(self, start_ts: int, commit_ts: int,
                      done: bool) -> None:
        with self._ledger_mu:
            if done:
                self._pending.pop(int(start_ts), None)
            else:
                self._pending[int(start_ts)] = [int(commit_ts),
                                                _now_ms()]

    def ledger_retire(self, start_ts: int) -> None:
        with self._ledger_mu:
            self._pending.pop(int(start_ts), None)

    def adopt_handoff(self, floor: int, pending: dict) -> None:
        """Split handoff: inherit the parent's published floor and its
        pending entries before this child's closed_ts may advance.
        Entries for keys the sibling owns are harmless — they only
        delay closing until the coordinator's txn_done/hold expiry."""
        with self._ledger_mu:
            if int(floor) > self._closed:
                self._closed = int(floor)
            for ts, ent in dict(pending).items():
                self._pending.setdefault(int(ts), list(ent))

    def ledger_snapshot(self) -> dict:
        with self._ledger_mu:
            return {ts: list(ent)
                    for ts, ent in self._pending.items()}

    def closed_ts(self) -> int:
        """Everything at or below this ts is settled on this range —
        no routed read at or below it can ever meet an unresolved
        lock or miss a later-arriving commit."""
        now = _now_ms()
        with self._ledger_mu:
            if self._pending:
                # lost-txn_done fallback: a commit-pinned entry past
                # the hold deadline stops pinning (bounded liveness —
                # any still-unresolved secondary lock keeps pinning
                # through the lock union below)
                dead = [ts for ts, (pin, cms) in self._pending.items()
                        if cms and now - cms > self.hold_ms]
                for ts in dead:
                    del self._pending[ts]
            pins = [pin for pin, _cms in self._pending.values()]
        pins.extend(lk.start_ts for lk in self.store.all_locks())
        # an IDLE range still closes forward: every TSO implementation
        # allocates at or above its wall reading (physical<<18), so
        # with the cluster's shared/synced clock no future commit_ts
        # can land at or below (now - margin) — the follower protocol's
        # min(tso.current(), pending-1) with the wall clock standing
        # in for the oracle the range tier doesn't own
        idle = max(self._max_commit,
                   max(0, int(time.time() * 1000) - 5) << 18)
        cand = min(pins) - 1 if pins else idle
        with self._ledger_mu:
            if cand > self._closed:
                self._closed = cand
            return self._closed

    def close(self) -> None:
        close = getattr(self.store.kv, "close", None)
        if close is not None:
            close()


def _kv_guarded(fn) -> dict:
    """Run one store operation and fold its typed KV failures into the
    response envelope — KV errors are RESULTS the committer interprets
    (resolve the lock, retry the conflict), not transport errors, so
    they must not burn the client's retry budget or trip its breaker."""
    try:
        # range.apply: the store mutation/read itself (child spans —
        # wal.append, wal.fsync — open inside the engine) riding back
        # to the coordinator's stitched trace via traced_response
        with obs.span("range.apply"):
            return {"ok": True, "v": fn()}
    except KeyIsLockedError as e:
        lk = e.lock
        return {"ok": False, "err_kv": {
            "kind": "locked", "key": lk.key, "primary": lk.primary,
            "start_ts": lk.start_ts, "op": lk.op, "ttl": lk.ttl}}
    except WriteConflictError as e:
        return {"ok": False, "err_kv": {
            "kind": "conflict", "key": e.key, "start_ts": e.start_ts,
            "conflict_ts": e.conflict_ts}}
    except TxnNotFoundError as e:
        return {"ok": False, "err_kv": {"kind": "txn_not_found",
                                        "msg": str(e)}}
    except KVError as e:
        return {"ok": False, "err_kv": {"kind": "kv", "msg": str(e)}}


# ---- the server ---------------------------------------------------------------
class RangeServer(FrameListener):
    """Per-range write leadership over the frame protocol."""

    _thread_prefix = "titpu-range"

    def __init__(self, root: str, listen: str = "127.0.0.1:0",
                 lease_ms: int = 1000, specs: Optional[list] = None,
                 sync_log: str = "commit", events=None,
                 heat=None, auto_split: bool = False,
                 split_cooldown_ms: int = 10_000,
                 max_auto_splits: int = 4,
                 hold_ms: int = 3000) -> None:
        self.directory = RangeDirectory(root)
        self.specs = self.directory.bootstrap(specs)
        self.lease_ms = int(lease_ms)
        # how long a cross-range commit may hold a range's ledger open
        # waiting for the coordinator's txn_done (mirrors the orphan
        # resolve TTL: past it, resolution owns the cleanup)
        self.hold_ms = int(hold_ms)
        self.events = events
        self._sync_log = str(sync_log)
        # heat-driven auto-split actuator knobs ([ranges] auto-split /
        # split-cooldown-ms / max-auto-splits; all hot-reloadable).
        # Disabled (the default) the lease tick returns before touching
        # the heat plane — the zero-work contract the poison test pins.
        self.auto_split = bool(auto_split)
        self.split_cooldown_ms = int(split_cooldown_ms)
        self.max_auto_splits = int(max_auto_splits)
        self._auto_splits = 0
        self._last_auto_split_ms = 0.0
        # keyspace heat recorder: the LEADER apply is the single
        # counting site for routed writes (the range tier's committers
        # carry no recorder — see kv/twopc.py)
        self.heat = heat
        # guards the hosted-leader map only — every critical section is
        # a dict op; declared in HOT_LOCKS (it sits on the 2PC data path)
        self._mu = lockcheck.lock("RangeServer._mu", hot=True)
        self._leaders: dict[int, RangeLeader] = {}
        self._closed = False
        fam, target = self._start_listener(listen)
        import socket as _socket
        if fam == _socket.AF_INET:
            host = target[0] or "127.0.0.1"
            self.address = f"{host}:{self.port}"
        else:
            self.address = str(listen)
        # one synchronous pass before serving: a just-constructed server
        # already hosts every free range (tests need no settle loop)
        self._lease_tick()
        self._stop = threading.Event()
        self._lease_thread = threading.Thread(
            target=self._lease_loop, name="titpu-range-lease",
            daemon=True)
        self._lease_thread.start()

    # ---- lease plane ----
    def _lease_loop(self) -> None:
        period = max(0.05, self.lease_ms / 3000.0)
        while not self._stop.wait(period):
            try:
                self._lease_tick()
            except survivable() as e:  # the next tick retries
                if self.events is not None:
                    self.events.record("range_lease_error", str(e),
                                       severity="warning")
            except Exception as e:
                # not an error the plane survives: keep it for close()
                with self._conns_mu:
                    if self.error is None:
                        self.error = e
                if self.events is not None:
                    self.events.record(
                        "range_lease_error",
                        f"lease loop ended: {type(e).__name__}: {e}",
                        severity="critical")
                return

    def _lease_tick(self) -> None:
        specs = self.directory.load_specs()
        if specs:
            self.specs = specs
        drop = failpoint.inject("range/lease-drop")
        # a child range mid-split (journal pending) has a possibly
        # partial data dir: nobody may serve it until the parent-side
        # recovery (or the splitter itself) marks it ready
        embargoed = self.directory.pending_children()
        for spec in self.specs:
            with self._mu:
                leader = self._leaders.get(spec.id)
            if leader is not None:
                leader.spec = spec  # adopt epoch bumps
                if drop is not None and (
                        drop is True or int(drop) == spec.id):
                    self.directory.release(spec.id, self.address,
                                           leader.grant["token"])
                    self._drop_leader(spec.id, "lease-drop failpoint")
                    continue
                try:
                    # the heartbeat publishes the range's closed ts:
                    # routers read it lock-free off the grant file /
                    # range_table RPC to compute read coverage
                    leader.grant = self.directory.renew(
                        spec.id, self.address, leader.grant["token"],
                        self.lease_ms, closed_ts=leader.closed_ts())
                except (StaleLeaseError, OSError) as e:
                    self._drop_leader(spec.id, f"lease lost: {e}")
            elif spec.id not in embargoed:
                try:
                    g = self.directory.acquire(spec.id, self.address,
                                               self.lease_ms)
                except OSError:
                    g = None
                if g:
                    self._open_leader(spec, g)
        self._recover_splits()
        self._auto_split_tick()

    def _open_leader(self, spec: RangeSpec, grant: dict,
                     floor: int = 0,
                     pending: Optional[dict] = None) -> None:
        leader = RangeLeader(spec, grant,
                             self.directory.data_dir(spec.id),
                             sync_log=self._sync_log,
                             hold_ms=self.hold_ms)
        if floor or pending:
            # split handoff: the parent's published floor + pending
            # ledger land on the child BEFORE it serves (grant floors
            # cover leader TRANSFER; a fresh child has no grant
            # history, so the splitter hands its own down explicitly)
            leader.adopt_handoff(floor, pending or {})
        with self._mu:
            self._leaders[spec.id] = leader
        obs.RANGE_LEADERS.inc()
        # publish immediately: until the first heartbeat lands, the
        # grant would otherwise advertise only the inherited floor
        try:
            leader.grant = self.directory.renew(
                spec.id, self.address, leader.grant["token"],
                self.lease_ms, closed_ts=leader.closed_ts())
        except (StaleLeaseError, OSError):
            pass  # the lease tick will fence or retry
        prev = grant.get("prev_owner", "")
        if prev and prev != self.address:
            obs.RANGE_TRANSFERS.inc()
            if self.events is not None:
                self.events.record(
                    "range_transfer",
                    f"r{spec.id} {prev} -> {self.address} "
                    f"term={grant['term']}", severity="warning")

    def _drop_leader(self, rid: int, why: str) -> None:
        with self._mu:
            leader = self._leaders.pop(rid, None)
        if leader is None:
            return
        leader.fenced = True
        obs.RANGE_LEADERS.dec()
        if self.events is not None:
            self.events.record("range_transfer",
                               f"r{rid} dropped by {self.address}: "
                               f"{why}", severity="warning")
        leader.close()

    # ---- online splits ----
    def split_range(self, rid: int, split_key: bytes,
                    trigger: str = "manual", advised_by: str = ""
                    ) -> tuple[RangeSpec, RangeSpec]:
        """Split one hosted range at split_key, online. Under the
        leader's gate (no data request interleaves): journal + commit
        the two-entry table delta (begin_split's meta rename is THE
        commit point and bumps both children to epoch parent+1), cut
        the child's WAL stream out of the parent's store, mark the
        journal ready, retire the parent's half, clear the journal —
        then lease and serve the child immediately. A kill-9 anywhere
        in that sequence is recovered deterministically by
        _recover_splits on whichever process next leads the parent:
        back before the meta commit, forward after. In-flight 2PC
        stamped with the parent's old epoch gets EpochNotMatchError
        and re-routes through the client's reload loop."""
        rid = int(rid)
        split_key = bytes(split_key)
        with self._mu:
            leader = self._leaders.get(rid)
        if leader is None or leader.fenced:
            raise NotLeaderError(f"range {rid} not led here")
        with leader.gate:
            left, right = self.directory.begin_split(
                rid, split_key, trigger=trigger)
            # table committed: the split now only moves forward (here,
            # or via _recover_splits on a successor)
            leader.spec = left
            failpoint.inject("range/split-after-meta-commit")
            self._materialize_child(leader, right)
            self.directory.mark_split_ready(rid)
            failpoint.inject("range/split-before-parent-retire")
            leader.store.discard_range(split_key, right.end_key)
            self.directory.clear_split(rid)
            # ledger handoff, captured under the gate: BOTH children
            # inherit the parent's published closed floor and pending
            # entries before either side's closed_ts may advance (the
            # left child IS the parent leader and keeps its ledger;
            # the right child receives a copy at adoption)
            handoff_floor = leader.closed_ts()
            handoff_pending = leader.ledger_snapshot()
        self.specs = self.directory.load_specs() or self.specs
        self._note_split(left, right, trigger, advised_by)
        self._adopt_child(right, floor=handoff_floor,
                          pending=handoff_pending)
        return left, right

    def _materialize_child(self, parent: RangeLeader,
                           child: RangeSpec) -> None:
        """Partition the per-range WAL stream: every lock/version whose
        decoded USER key falls in the child's bounds, rewritten into
        the child's own data dir so both sides replay independently.
        Rebuilds from scratch (rmtree first) so a recovery retry over
        a half-written child dir is idempotent; the parent still holds
        every pre-split byte until the retire step, which only ever
        runs after the journal says ready."""
        child_dir = self.directory.data_dir(child.id)
        if os.path.isdir(child_dir):
            shutil.rmtree(child_dir, ignore_errors=True)
        os.makedirs(child_dir, exist_ok=True)
        items = parent.store.export_range(child.start_key,
                                          child.end_key)
        kv = PyOrderedKV(child_dir, sync_log=self._sync_log)
        try:
            mid = max(1, len(items) // 2)
            for i, (cf, k, v) in enumerate(items):
                kv.put(cf, k, v)
                if i + 1 == mid:
                    failpoint.inject("range/split-mid-wal-partition")
            if not items:
                failpoint.inject("range/split-mid-wal-partition")
            kv.sync()
        finally:
            kv.close()

    def _adopt_child(self, child: RangeSpec, floor: int = 0,
                     pending: Optional[dict] = None) -> None:
        """Serve the fresh child now — its lease is free, its journal
        is cleared, and waiting a lease tick would stall writes to the
        upper half of the just-split keyspace."""
        try:
            g = self.directory.acquire(child.id, self.address,
                                       self.lease_ms)
        except OSError:
            g = None
        if g:
            self._open_leader(child, g, floor=floor, pending=pending)

    def _note_split(self, left: RangeSpec, right: RangeSpec,
                    trigger: str, advised_by: str = "") -> None:
        if self.heat is not None:
            # re-key the heat plane: the parent's pre-split cells span
            # bounds no live range has — both children start clean
            self.heat.on_split(left.id, self.specs)
        obs.RANGE_SPLITS.inc(trigger=str(trigger))
        if self.events is not None:
            detail = (f"r{left.id} -> r{left.id}+r{right.id} at "
                      f"{right.start_key.hex()[:24]} "
                      f"epoch={left.epoch} trigger={trigger}")
            if advised_by:
                detail += f" advisory={advised_by}"
            self.events.record("range_split", detail, severity="info")

    def _recover_splits(self) -> None:
        """Finish — or deterministically roll back — any split journal
        a crashed leader left on a range we now lead. Runs every lease
        tick; a journal with no leader here is someone else's to
        recover (whoever wins the parent's lease)."""
        for rid in self.hosted_ids():
            j = self.directory.read_split(rid)
            if j is None:
                continue
            with self._mu:
                leader = self._leaders.get(rid)
            if leader is None or leader.fenced:
                continue
            try:
                self._finish_split(leader, j)
            except survivable() as e:  # the next tick retries
                if self.events is not None:
                    self.events.record(
                        "range_split_error",
                        f"r{rid} split recovery failed: {e}",
                        severity="warning")

    def _finish_split(self, leader: RangeLeader, j: dict) -> None:
        """One journal's recovery. The meta rename decides direction:
        child id absent from the table → the split never committed,
        roll BACK (scrap the partial child dir, withdraw the intent);
        present → roll FORWARD (rebuild the child unless the journal
        already says ready — a ready child may hold post-split writes
        and must NEVER be rebuilt — then retire the parent's half)."""
        rid = int(j["parent"])
        child_id = int(j["child"])
        split_key = bytes.fromhex(j["split"])
        trigger = str(j.get("trigger", "manual"))
        with leader.gate:
            # `j` was read before the gate: a split_range of this process
            # holds the gate from its journal to its clear, so a journal
            # read while it ran is gone now. Recovering from that stale
            # copy would rebuild the child from the parent's retired half,
            # an empty copy over the child's rows (the reference does)
            if self.directory.read_split(rid) != j:
                return
            specs = self.directory.load_specs() or []
            by_id = {s.id: s for s in specs}
            if child_id not in by_id:
                shutil.rmtree(self.directory.data_dir(child_id),
                              ignore_errors=True)
                self.directory.clear_split(rid)
                if self.events is not None:
                    self.events.record(
                        "range_split_rollback",
                        f"r{rid} pending split at "
                        f"{split_key.hex()[:24]} rolled back",
                        severity="warning")
                return
            left, right = by_id[rid], by_id[child_id]
            leader.spec = left
            if j.get("state") != "ready":
                self._materialize_child(leader, right)
                self.directory.mark_split_ready(rid)
            failpoint.inject("range/split-before-parent-retire")
            leader.store.discard_range(split_key, right.end_key)
            self.directory.clear_split(rid)
            handoff_floor = leader.closed_ts()
            handoff_pending = leader.ledger_snapshot()
        self.specs = self.directory.load_specs() or self.specs
        self._note_split(left, right, trigger)
        self._adopt_child(right, floor=handoff_floor,
                          pending=handoff_pending)

    def _auto_split_tick(self) -> None:
        """The heat→split actuator: consume the range-split-advisory
        findings and execute the advised split. Knob-gated and
        rate-limited; disabled (the default) this returns before
        touching the heat plane at all — the zero-work contract the
        poison test pins. At most one split per tick: the cooldown
        paces a salted-key workload instead of shattering it."""
        if not self.auto_split or self.heat is None \
                or not self.heat.enabled:
            return
        if self._auto_splits >= self.max_auto_splits:
            return
        if _now_ms() - self._last_auto_split_ms \
                < self.split_cooldown_ms:
            return
        for f in self.heat.findings():
            if f.get("rule") != "range-split-advisory":
                continue
            item = str(f.get("item", ""))
            try:
                rid = int(item.lstrip("r"))
            except ValueError:
                continue
            with self._mu:
                leader = self._leaders.get(rid)
            if leader is None or leader.fenced:
                continue
            if self.directory.read_split(rid) is not None:
                continue
            # the finding's value is a truncated hex digest for the
            # event board — refetch the full weighted-median key
            key = self.heat.split_advisory(rid)
            spec = leader.spec
            if key is None or not (
                    spec.start_key < key
                    and (not spec.end_key or key < spec.end_key)):
                continue
            try:
                failpoint.inject("range/auto-split")
                self.split_range(
                    rid, key, trigger="auto",
                    advised_by=str(f.get("value", ""))[:48])
            except RPCError as e:
                if self.events is not None:
                    self.events.record(
                        "range_split_error",
                        f"r{rid} auto-split failed: {e}",
                        severity="warning")
                continue
            self._auto_splits += 1
            self._last_auto_split_ms = _now_ms()
            return

    # ---- request gate ----
    @contextmanager
    def _gate(self, params: dict):
        """The fencing gate every data request passes BEFORE any data
        access; raises typed so the client refreshes + retries instead
        of acting on a stale view. Yields the leader WITH its gate
        lock held, so the fencing verdict stays true through the store
        op — a split that lands between the check and the apply would
        otherwise let a pre-split request mutate keys the child now
        owns. Traced as range.lease_gate so a fencing rejection's cost
        is visible in the stitched tree."""
        rc = get_range_ctx(params)
        if rc is None:
            raise RPCError("missing range context")
        rid = int(rc["range_id"])
        with self._mu:
            leader = self._leaders.get(rid)
        if leader is None or leader.fenced:
            g = self.directory.read_grant(rid)
            hint = (f" (grant: {g['owner']} term {g['term']})"
                    if g else "")
            raise NotLeaderError(f"range {rid} not led here{hint}")
        with leader.gate:
            with obs.span("range.lease_gate"):
                self._check_gate(leader, rc, rid)
            yield leader

    def _check_gate(self, leader: RangeLeader, rc: dict,
                    rid: int) -> None:
        if leader.fenced:
            raise NotLeaderError(f"range {rid} not led here")
        if float(leader.grant.get("expires_ms", 0)) <= _now_ms():
            # our own lease ran out and the renew loop hasn't caught it
            # yet — refusing here is what makes the lease a fence
            raise NotLeaderError(f"range {rid} lease expired on "
                                 f"{self.address}")
        if int(rc.get("epoch", 0)) != int(leader.spec.epoch):
            raise EpochNotMatchError(
                f"range {rid} epoch {rc.get('epoch')} != "
                f"{leader.spec.epoch} — reload the range table")
        cterm = int(rc.get("term", 0))
        if cterm < leader.term:
            raise StaleTermError(f"range {rid} request term {cterm} < "
                                 f"current {leader.term}")
        if cterm > leader.term:
            # the CLIENT has seen a newer tenure than ours: we are the
            # deposed one (a renew raced); never serve on a stale term
            raise NotLeaderError(f"range {rid} deposed: request term "
                                 f"{cterm} > local {leader.term}")

    # ---- dispatch ----
    def _dispatch(self, req) -> dict:
        if not isinstance(req, dict) or "m" not in req:
            return wire_error(None, RPCError("bad request"))
        rid = req.get("id")
        method = str(req.get("m"))
        params = req.get("p") if isinstance(req.get("p"), dict) else {}
        handler = getattr(self, f"_h_{method}", None) \
            if method.startswith("range_") else None
        if handler is None:
            return wire_error(rid, RPCError(
                f"unknown range method {method!r}"))
        return traced_response(rid, method, lambda: handler(params),
                               get_trace_ctx(req))

    # ---- percolator handlers ----
    def _h_range_prewrite(self, params: dict) -> dict:
        with self._gate(params) as leader:
            muts = [Mutation(bytes(m[0]), bytes(m[1]), bytes(m[2]))
                    for m in params["mutations"]]
            out = _kv_guarded(lambda: leader.store.prewrite(
                muts, bytes(params["primary"]),
                int(params["start_ts"]),
                int(params.get("ttl", 3000))))
            if out["ok"]:
                # the prewrite enters this range's pending-commit
                # ledger; primary-commit/rollback/txn_done retires it
                leader.ledger_enter(int(params["start_ts"]))
            # the leader-side apply is where a routed write lands on
            # the keyspace heatmap (exactly once: the coordinator's
            # committer carries no recorder over the range tier)
            if out["ok"] and self.heat is not None \
                    and self.heat.enabled:
                self.heat.note_range(
                    leader.spec.id,
                    write_rows=len(muts),
                    write_bytes=sum(len(m.value or b"")
                                    for m in muts),
                    keys=[m.key for m in muts])
        # applied-but-unacked: a kill here is the harshest prewrite
        # crash — the lock is durable, the coordinator never heard back
        failpoint.inject("range/before-prewrite-ack")
        return out

    def _h_range_commit(self, params: dict) -> dict:
        with self._gate(params) as leader:
            commit_ts = int(params["commit_ts"])
            out = _kv_guarded(lambda: leader.store.commit(
                [bytes(k) for k in params["keys"]],
                int(params["start_ts"]), commit_ts))
            if out["ok"]:
                leader.note_commit(commit_ts)
                # done=False: a cross-range participant — the entry
                # stays, re-pinned at commit_ts, until every
                # participant's secondaries are durable and the
                # coordinator's txn_done (or the hold TTL) retires it.
                # Absent flag = single-range traffic: retire now.
                leader.ledger_commit(int(params["start_ts"]),
                                     commit_ts,
                                     bool(params.get("done", True)))
        failpoint.inject("range/before-commit-ack")
        return out

    def _h_range_rollback(self, params: dict) -> dict:
        with self._gate(params) as leader:
            out = _kv_guarded(lambda: leader.store.rollback(
                [bytes(k) for k in params["keys"]],
                int(params["start_ts"])))
            if out["ok"]:
                leader.ledger_retire(int(params["start_ts"]))
            return out

    def _h_range_txn_done(self, params: dict) -> dict:
        """A cross-range transaction's secondaries are durable on every
        participant: release the ledger hold so closed_ts may pass its
        commit_ts. Best-effort by design — a lost txn_done is covered
        by the hold TTL + orphan resolution."""
        with self._gate(params) as leader:
            leader.ledger_retire(int(params["start_ts"]))
            return {"ok": True}

    def _h_range_get(self, params: dict) -> dict:
        with self._gate(params) as leader:
            out = _kv_guarded(lambda: leader.store.get(
                bytes(params["key"]), int(params["read_ts"])))
            if out["ok"] and self.heat is not None \
                    and self.heat.enabled:
                v = out["v"]
                self.heat.note_range(
                    leader.spec.id, read_rows=1,
                    read_bytes=len(v) if v else 0)
            return out

    def _h_range_scan(self, params: dict) -> dict:
        with self._gate(params) as leader:
            spec = leader.spec
            start = max(bytes(params.get("start", b"")),
                        spec.start_key)
            end = bytes(params.get("end", b""))
            if spec.end_key and (not end or end > spec.end_key):
                end = spec.end_key
            out = _kv_guarded(
                lambda: [list(kv) for kv in leader.store.scan(
                    start, end, int(params["read_ts"]),
                    int(params.get("limit", -1)))])
            if out["ok"] and self.heat is not None \
                    and self.heat.enabled:
                rows = out["v"]
                self.heat.note_range(
                    leader.spec.id, read_rows=len(rows),
                    read_bytes=sum(len(kv[1] or b"") for kv in rows))
            return out

    def _h_range_check_txn_status(self, params: dict) -> dict:
        with self._gate(params) as leader:

            def run():
                commit_ts, expired = leader.store.check_txn_status(
                    bytes(params["primary"]), int(params["lock_ts"]),
                    int(params["current_ts"]))
                return {"commit_ts": commit_ts, "expired": expired}

            out = _kv_guarded(run)
            if out["ok"] and (out["v"]["expired"]
                              or out["v"]["commit_ts"]):
                # the transaction's fate is decided (rolled back on
                # expiry / already committed): its ledger entry no
                # longer guards anything the lock union doesn't
                leader.ledger_retire(int(params["lock_ts"]))
            return out

    def _h_range_resolve_lock(self, params: dict) -> dict:
        with self._gate(params) as leader:
            out = _kv_guarded(lambda: leader.store.resolve_lock(
                bytes(params["key"]), int(params["start_ts"]),
                int(params["commit_ts"])))
            if out["ok"]:
                obs.RANGE_ORPHAN_RESOLUTIONS.inc()
                leader.ledger_retire(int(params["start_ts"]))
            return out

    def _h_range_split(self, params: dict) -> dict:
        """Operator-triggered online split (the chaos harness drives
        the in-process protocol through this same door)."""
        left, right = self.split_range(
            int(params["range_id"]), bytes(params["split_key"]),
            trigger=str(params.get("trigger", "manual")))
        return {"parent": left.to_wire(), "child": right.to_wire()}

    # ---- metadata / diagnostics ----
    def _h_range_table(self, params: dict) -> dict:
        """The routing bootstrap for clients without filesystem access
        to the shared root: table + every range's current grant."""
        specs = self.directory.load_specs() or self.specs
        grants = {}
        for s in specs:
            g = self.directory.read_grant(s.id)
            if g:
                grants[int(s.id)] = {"owner": g.get("owner", ""),
                                     "term": int(g.get("term", 0)),
                                     "expires_ms":
                                         float(g.get("expires_ms", 0)),
                                     "closed_ts":
                                         int(g.get("closed_ts", 0))}
        return {"specs": [s.to_wire() for s in specs],
                "grants": grants}

    def _h_range_info(self, params: dict) -> dict:
        return {"ranges": self.describe()}

    def describe(self) -> list[dict]:
        """Hosted ranges, one row each — what /status and cluster_info
        render."""
        with self._mu:
            leaders = sorted(self._leaders.items())
        out = []
        for rid, leader in leaders:
            rr, rb, wr, wb = self.heat.range_totals(rid) \
                if self.heat is not None else (0, 0, 0, 0)
            out.append({"range_id": rid, "leader": self.address,
                        "term": leader.term,
                        "epoch": leader.spec.epoch,
                        "token": int(leader.grant.get("token", 0)),
                        "closed_ts": leader.closed_ts(),
                        # commit progress independent of the heat
                        # plane: the closed-ts-stall rule compares it
                        # against a static closed_ts
                        "max_commit_ts": int(leader._max_commit),
                        "pending": len(leader._pending),
                        "start": leader.spec.start_key.hex(),
                        "end": leader.spec.end_key.hex(),
                        "read_rows": rr, "read_bytes": rb,
                        "write_rows": wr, "write_bytes": wb})
        return out

    def hosted_ids(self) -> list[int]:
        with self._mu:
            return sorted(self._leaders)

    def close(self, release: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._lease_thread.join()
        self._close_listener()
        with self._mu:
            leaders = dict(self._leaders)
            self._leaders.clear()
        for rid, leader in leaders.items():
            leader.fenced = True
            if release:
                try:
                    self.directory.release(rid, self.address,
                                           leader.grant["token"])
                except OSError:
                    pass
            obs.RANGE_LEADERS.dec()
            leader.close()
        # an error the lease loop or a connection thread kept
        self._raise_kept()


class RangePlane:
    """The [ranges]-armed subsystem one Storage owns: a RangeServer
    rooted under the storage path plus the knobs mirror. Entirely OFF
    the statement path — arming starts a listener and a lease loop;
    statements never consult it, which is what makes `[ranges]`
    disabled byte-identical to the pre-range engine."""

    def __init__(self, storage, count: int = 1, split_points=(),
                 lease_ms: int = 1000, resolve_ttl_ms: int = 3000,
                 listen: str = "127.0.0.1:0", auto_split: bool = False,
                 split_cooldown_ms: int = 10_000,
                 max_auto_splits: int = 4) -> None:
        self.storage = storage
        self.resolve_ttl_ms = int(resolve_ttl_ms)
        self.server = RangeServer(
            storage.path, listen=listen, lease_ms=int(lease_ms),
            specs=split_keyspace(int(count), split_points),
            events=storage.obs.events,
            heat=getattr(storage, "heat", None),
            auto_split=auto_split,
            split_cooldown_ms=split_cooldown_ms,
            max_auto_splits=max_auto_splits,
            hold_ms=int(resolve_ttl_ms))

    def router(self, **kw):
        from ..kv.rangeclient import RangeRouter
        return RangeRouter(root=self.storage.path, **kw)

    def closed_over(self, start: bytes,
                    end: bytes) -> list[tuple[int, int]]:
        """Per-range published closed timestamps over [start, end) —
        the same durable floors RangeRouter.closed_over serves remote
        readers, read straight off the directory (the plane shares its
        filesystem root, no client machinery). closed_ts 0 = no grant
        published yet, which counts as uncovered."""
        d = self.server.directory
        specs = d.load_specs() or self.server.specs
        out: list[tuple[int, int]] = []
        for s in sorted(specs, key=lambda s: s.start_key):
            if end and s.start_key and s.start_key >= end:
                break
            if s.end_key and s.end_key <= start:
                continue
            g = d.read_grant(s.id)
            out.append((int(s.id),
                        int(g.get("closed_ts", 0)) if g else 0))
        return out

    def committer(self, tso, **kw):
        from ..kv.twopc import TwoPhaseCommitter
        kw.setdefault("lock_ttl", self.resolve_ttl_ms)
        kw.setdefault("events", self.storage.obs.events)
        return TwoPhaseCommitter(self.router(), tso, **kw)

    def set_knobs(self, lease_ms: Optional[int] = None,
                  resolve_ttl_ms: Optional[int] = None,
                  auto_split: Optional[bool] = None,
                  split_cooldown_ms: Optional[int] = None,
                  max_auto_splits: Optional[int] = None) -> None:
        """The SIGHUP-reloadable subset."""
        if lease_ms is not None:
            self.server.lease_ms = max(int(lease_ms), 50)
        if resolve_ttl_ms is not None:
            self.resolve_ttl_ms = max(int(resolve_ttl_ms), 1)
            # the ledger hold mirrors the resolve TTL: past it, orphan
            # resolution owns the cleanup a lost txn_done left behind
            self.server.hold_ms = self.resolve_ttl_ms
            with self.server._mu:
                leaders = list(self.server._leaders.values())
            for ld in leaders:
                ld.hold_ms = self.resolve_ttl_ms
        if auto_split is not None:
            self.server.auto_split = bool(auto_split)
        if split_cooldown_ms is not None:
            self.server.split_cooldown_ms = max(int(split_cooldown_ms),
                                                0)
        if max_auto_splits is not None:
            self.server.max_auto_splits = max(int(max_auto_splits), 0)

    def status(self) -> dict:
        return {"listen": self.server.address,
                "lease_ms": self.server.lease_ms,
                "resolve_ttl_ms": self.resolve_ttl_ms,
                "auto_split": self.server.auto_split,
                "split_cooldown_ms": self.server.split_cooldown_ms,
                "max_auto_splits": self.server.max_auto_splits,
                "auto_splits_done": self.server._auto_splits,
                "table": [s.to_wire() | {"start": s.start_key.hex(),
                                         "end": s.end_key.hex()}
                          for s in self.server.specs],
                "hosted": self.server.describe()}

    def close(self) -> None:
        self.server.close()


__all__ = ["RangeDirectory", "RangeLeader", "RangeServer", "RangePlane"]
