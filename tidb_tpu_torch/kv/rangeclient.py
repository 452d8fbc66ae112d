"""Range router: the client half of range-sharded write leadership.

Duck-types the RegionManager surface kv/twopc.py's committer and
LockResolver run against — locate / prewrite / commit / rollback / get
/ check_txn_status / resolve_lock / scan — but routes every call to the
addressed range's CURRENT leader over the frame RPC tier (reference:
store/tikv/region_cache.go:274 + region_request.go — the client-side
region cache with epoch/leader invalidation in front of every kv RPC).

Routing state is two caches with different lifetimes:

* the range TABLE (bounds + epochs) — reloaded when a server answers
  EpochNotMatchError;
* per-range leader GRANTS (owner address + fencing term) — refreshed
  when a server answers NotLeaderError/StaleTermError or stops
  answering at all.

Both refresh paths run under one typed kv/backoff.py Backoffer, so a
leader kill burns a bounded, observable budget (BO_REGION_MISS for
routing staleness, BO_RPC for dead transports) instead of either
hanging or failing the statement on the first stale read of the world.
Typed KV outcomes (KeyIsLockedError and friends) come back in-band and
re-raise locally — they are the COMMITTER's control flow, not routing
failures, and never consume this budget.

Routing truth comes from the shared durable root when this process can
see it (`root=`), or from any live range server's `range_table` RPC
(`seeds=`) when it cannot.

Port of `tidb_tpu/kv/rangeclient.py`, whole.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..rpc.client import RpcClient, RpcOptions
from ..rpc.errors import (EpochNotMatchError, LeaderUnavailable,
                          NotLeaderError, RPCError, StaleLeaseError,
                          StaleTermError)
from ..rpc.frame import RANGE_KEY, make_range_ctx
from ..rpc.ranged import RangeDirectory
from .backoff import BO_REGION_MISS, BO_RPC, Backoffer
from .mvcc import (KeyIsLockedError, KVError, LockInfo, Mutation,
                   TxnNotFoundError, WriteConflictError)
from .rangemeta import RangeSpec, locate_spec
from .region import RegionError


class RangeHandle:
    """What locate() hands the committer: enough to group mutations by
    range and to stamp the request's routing context. Leader identity
    is NOT here on purpose — it is resolved per attempt from the grant
    cache, so a handle never pins a request to a dead owner."""

    __slots__ = ("id", "start_key", "end_key", "epoch")

    def __init__(self, spec: RangeSpec) -> None:
        self.id = spec.id
        self.start_key = spec.start_key
        self.end_key = spec.end_key
        self.epoch = spec.epoch

    def contains(self, key: bytes) -> bool:
        return self.start_key <= key and (not self.end_key
                                          or key < self.end_key)


def _raise_kv(err: dict) -> None:
    kind = err.get("kind")
    if kind == "locked":
        raise KeyIsLockedError(LockInfo(
            bytes(err["key"]), bytes(err["primary"]),
            int(err["start_ts"]), bytes(err["op"]), int(err["ttl"])))
    if kind == "conflict":
        raise WriteConflictError(bytes(err["key"]),
                                 int(err["start_ts"]),
                                 int(err["conflict_ts"]))
    if kind == "txn_not_found":
        raise TxnNotFoundError(err.get("msg", "txn not found"))
    raise KVError(err.get("msg", "kv error"))


class RangeRouter:
    def __init__(self, root: Optional[str] = None, seeds=(),
                 options: Optional[RpcOptions] = None,
                 budget_ms: int = 8000,
                 attempt_budget_ms: int = 400) -> None:
        if root is None and not seeds:
            raise ValueError("RangeRouter needs a shared root or seeds")
        self.directory = RangeDirectory(root) if root else None
        self.seeds = [str(s) for s in seeds]
        self.options = options or RpcOptions()
        # total routing budget per logical call; each ATTEMPT gets a
        # small transport budget so a dead leader is detected in one
        # refused connect, not a full per-call retry budget
        self.budget_ms = int(budget_ms)
        self.attempt_budget_ms = int(attempt_budget_ms)
        self._mu = threading.Lock()
        self._specs: list[RangeSpec] = []
        self._grants: dict[int, dict] = {}
        self._clients: dict[str, RpcClient] = {}
        self._load_table()
        if not self._specs:
            raise RPCError("range table unavailable from "
                           f"root={root!r} seeds={self.seeds}")

    # ---- routing state -----------------------------------------------------
    def _load_table(self) -> None:
        if self.directory is not None:
            specs = self.directory.load_specs()
            if specs:
                with self._mu:
                    self._specs = specs
            return
        for seed in list(self.seeds):
            try:
                r = self._client(seed).call(
                    "range_table", _budget_ms=self.attempt_budget_ms)
            except RPCError:
                continue
            # sorted defensively: locate_spec bisects, and a split
            # inserts the new child mid-table
            specs = sorted((RangeSpec.from_wire(d)
                            for d in r.get("specs", [])),
                           key=lambda s: s.start_key)
            if not specs:
                continue
            grants = {int(k): dict(v)
                      for k, v in (r.get("grants") or {}).items()}
            with self._mu:
                self._specs = specs
                self._grants.update(grants)
            return

    def _grant(self, rid: int) -> Optional[dict]:
        now_ms = time.time() * 1000.0
        with self._mu:
            g = self._grants.get(rid)
        if g and float(g.get("expires_ms", 0)) > now_ms:
            return g
        if self.directory is not None:
            g = self.directory.read_grant(rid)
        else:
            g = None
            self._load_table()
            with self._mu:
                g = self._grants.get(rid)
        if g and float(g.get("expires_ms", 0)) > now_ms:
            with self._mu:
                self._grants[rid] = g
                owner = str(g.get("owner", ""))
                # learned leaders become table sources too — the seed
                # list stays useful after every original seed died
                if owner and not self.directory \
                        and owner not in self.seeds:
                    self.seeds.append(owner)
            return g
        return None

    def _invalidate_grant(self, rid: int) -> None:
        with self._mu:
            self._grants.pop(rid, None)

    def _client(self, addr: str) -> RpcClient:
        with self._mu:
            c = self._clients.get(addr)
            if c is None:
                c = RpcClient(addr, self.options, _heartbeat=False)
                self._clients[addr] = c
        return c

    # ---- the routed call ----------------------------------------------------
    def _call(self, rid: int, epoch: int, method: str, **params):
        bo = Backoffer(budget_ms=self.budget_ms)
        while True:
            g = self._grant(rid)
            if g is None:
                # nobody holds the range yet (mid-failover): wait for
                # the lease race to settle. BackoffExhausted escapes
                # typed when it never does. The ledger types this as
                # lease_wait — blocked on leadership, not on routing.
                bo.sleep(BO_REGION_MISS, wait_state="lease_wait")
                continue
            params[RANGE_KEY] = make_range_ctx(rid, epoch,
                                               int(g.get("term", 0)))
            client = self._client(str(g["owner"]))
            try:
                r = client.call(method,
                                _budget_ms=self.attempt_budget_ms,
                                **params)
            except EpochNotMatchError as e:
                # the range TABLE moved under us: reload it and force
                # the caller to re-locate/re-group (region-retry path)
                self._load_table()
                raise RegionError(str(e)) from e
            except (NotLeaderError, StaleTermError,
                    StaleLeaseError) as e:
                self._invalidate_grant(rid)
                bo.sleep(BO_REGION_MISS, wait_state="lease_wait")
                continue
            except LeaderUnavailable as e:
                self._invalidate_grant(rid)
                bo.sleep(BO_RPC)
                continue
            if not r.get("ok", True):
                _raise_kv(r.get("err_kv") or {})
            return r.get("v")

    # ---- the RegionManager surface ------------------------------------------
    def locate(self, key: bytes) -> RangeHandle:
        with self._mu:
            specs = self._specs
        return RangeHandle(locate_spec(specs, key))

    def regions(self) -> list[RangeHandle]:
        with self._mu:
            return [RangeHandle(s) for s in self._specs]

    def prewrite(self, region: RangeHandle, mutations: list[Mutation],
                 primary: bytes, start_ts: int, ttl: int = 3000) -> None:
        self._call(region.id, region.epoch, "range_prewrite",
                   mutations=[[m.op, m.key, m.value] for m in mutations],
                   primary=primary, start_ts=start_ts, ttl=ttl)

    def commit(self, region: RangeHandle, keys: list[bytes],
               start_ts: int, commit_ts: int,
               done: bool = True) -> None:
        # done=False marks a cross-range participant: the range keeps
        # its pending-commit ledger entry (closed_ts held below
        # commit_ts) until txn_done reports every secondary durable
        self._call(region.id, region.epoch, "range_commit", keys=keys,
                   start_ts=start_ts, commit_ts=commit_ts, done=done)

    def txn_done(self, region: RangeHandle, start_ts: int) -> None:
        """Release one participant range's ledger hold. Best-effort:
        a lost call costs closed-ts latency (the hold TTL), never
        correctness, so routing trouble is swallowed."""
        try:
            self._call(region.id, region.epoch, "range_txn_done",
                       start_ts=start_ts)
        except (RPCError, RegionError, KVError):
            pass

    def rollback(self, region: RangeHandle, keys: list[bytes],
                 start_ts: int) -> None:
        self._call(region.id, region.epoch, "range_rollback", keys=keys,
                   start_ts=start_ts)

    def get(self, region: RangeHandle, key: bytes, read_ts: int):
        return self._call(region.id, region.epoch, "range_get", key=key,
                          read_ts=read_ts)

    def check_txn_status(self, primary: bytes, lock_ts: int,
                         current_ts: int) -> tuple[int, bool]:
        h = self.locate(primary)
        v = self._call(h.id, h.epoch, "range_check_txn_status",
                       primary=primary, lock_ts=lock_ts,
                       current_ts=current_ts)
        return int(v["commit_ts"]), bool(v["expired"])

    def resolve_lock(self, key: bytes, start_ts: int,
                     commit_ts: int) -> None:
        h = self.locate(key)
        self._call(h.id, h.epoch, "range_resolve_lock", key=key,
                   start_ts=start_ts, commit_ts=commit_ts)

    def closed_over(self, start: bytes, end: bytes,
                    refresh: bool = False) -> list[tuple[int, int]]:
        """Per-range published closed timestamps over the key span
        [start, end): [(range_id, closed_ts), ...] in key order. The
        span's COVERED timestamp is the min — a snapshot read at or
        below it is settled on every range it touches. closed_ts 0 =
        no grant/publication visible (counts as uncovered). refresh
        reloads the range table and bypasses the grant cache, so a
        waiting reader observes heartbeat progress AND mid-wait
        splits (a child range it has never routed to still gates)."""
        if refresh:
            self._load_table()
        out: list[tuple[int, int]] = []
        for h in self.regions():
            if end and h.start_key and h.start_key >= end:
                break
            if h.end_key and h.end_key <= start:
                continue
            if self.directory is not None:
                # raw grant read: a published closed_ts is a floor
                # FOREVER (monotonic across transfers), so even an
                # expired grant's value safely covers reads at/below it
                g = self.directory.read_grant(h.id)
            else:
                if refresh:
                    self._invalidate_grant(h.id)
                g = self._grant(h.id)
            out.append((int(h.id),
                        int(g.get("closed_ts", 0)) if g else 0))
        return out

    def scan(self, start: bytes, end: bytes, read_ts: int,
             limit: int = -1) -> list[tuple[bytes, bytes]]:
        out: list[tuple[bytes, bytes]] = []
        for h in self.regions():
            if end and h.start_key and h.start_key >= end:
                break
            if h.end_key and h.end_key <= start:
                continue
            rows = self._call(h.id, h.epoch, "range_scan", start=start,
                              end=end, read_ts=read_ts, limit=limit)
            out.extend((bytes(k), bytes(v)) for k, v in rows)
            if limit >= 0 and len(out) >= limit:
                return out[:limit]
        return out

    def close(self) -> None:
        with self._mu:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()


__all__ = ["RangeRouter", "RangeHandle"]
