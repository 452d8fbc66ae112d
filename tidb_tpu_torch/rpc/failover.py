"""Automatic leader failover: detection, election, fenced promotion.

Port of `tidb_tpu/rpc/failover.py`, with the port's error policy: the
watcher survives only `errors.survivable()` errors (a failed membership
refresh, a peer poll that timed out, a transport error inside an
election round). Any other error — a torch or CUDA error while the
promoted leader re-folds its tables among them — ends the watch loop and
is kept as `error`; `close()` re-raises it, and `Storage.close()` with
it. The reference catches every exception in those three places.

The socket cluster has ONE leader (the Storage that owns the durable
directory and serves coordination RPC). Before this module existed,
leader death left followers in degraded read-only mode forever. Now
every follower runs a FailoverManager:

* DETECT — the heartbeat (rpc/client.py) flips `degraded` on ping
  failure; a follower continuously degraded past the election timeout
  considers the leader dead (reference analog: raft election timeout,
  Ongaro & Ousterhout §5.2).

* ELECT — deterministic, no ballots: among the live members of the
  leader's diag registry (each polled over its diag endpoint for
  `diag_election`), the follower with the LONGEST replicated WAL
  position wins; ties break to the LOWEST node id. Every live voter
  computes the same winner from the same frozen positions (the dead
  leader no longer advances anyone), so the protocol needs no rounds —
  the raft up-to-date rule collapsed onto a total order.

* PROMOTE — the winner promotes IN PLACE (store/storage.py
  promote_to_leader): it re-opens its on-disk WAL mirror as the
  authoritative (snapshot, WAL) pair, bumps the fencing term, persists
  it, and starts serving coordination RPC on its promote-listen
  address. Because every follower's mirror is a byte-prefix of the dead
  leader's file, survivors repoint and keep tailing from their own
  offsets — no re-bootstrap.

* FENCE — the bumped term rejects the zombies: a client still carrying
  the old term has wal_append/lock_acquire refused (StaleTermError),
  and a restarted old leader answers with its stale term, which peers
  treat as leader loss, not liveness (rpc/client.py term checks).

Known loss window (documented in README): replication is PULL-based —
the dead leader may hold acked commits no follower tailed yet. Those
are on the old leader's durable disk (sync-log) but not on the new
leader; a restarted old leader must re-join as a follower with a fresh
working dir rather than serve its divergent tail. Quorum is also not
required: in a full network partition both sides can elect, exactly
like any non-quorum failover — deploy followers accordingly.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .errors import survivable


class FailoverManager:
    """Per-follower election driver. Started by Storage for socket
    followers when options.election_timeout_ms > 0; close() joins the
    thread (the no-leaked-threads contract every listener follows)."""

    def __init__(self, storage, options) -> None:
        self.storage = storage
        self.options = options
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._degraded_since: Optional[float] = None
        # consecutive failed diag polls per peer: a peer leaves the
        # electorate only after PEER_STRIKES misses, so one dropped
        # poll under load cannot shrink the voter roll and let two
        # followers both compute themselves the winner (split brain)
        self._peer_fails: dict = {}
        # observability (surfaced via transport_health)
        self.state = "healthy"
        self.elections = 0
        self.last_result = ""
        # a non-survivable error that ended the loop (close re-raises)
        self.error: Optional[BaseException] = None

    PEER_STRIKES = 3

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="titpu-failover", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self.error = self.error, None
        if err is not None:
            raise err

    def describe(self) -> dict:
        return {"state": self.state, "elections": self.elections,
                "last_result": self.last_result,
                "timeout_ms": self.options.election_timeout_ms}

    # ---- the watch loop ----------------------------------------------------
    def _loop(self) -> None:
        interval = max(0.2, self.options.lease_ms / 2000.0)
        refresh_every = max(1.0, self.options.lease_ms / 1000.0)
        last_refresh = 0.0
        while not self._stop.wait(interval):
            st = self.storage
            if not getattr(st, "remote", False):
                self.state = "promoted"
                return  # we are the leader now; nothing to watch
            client = st._rpc_client
            if client is None or client._closed:
                return
            now = time.monotonic()
            if not client.degraded:
                self._degraded_since = None
                self.state = "healthy"
                if now - last_refresh >= refresh_every:
                    # keep the membership view warm: it is the voter
                    # roll once the leader stops answering
                    try:
                        from .diag import cluster_members
                        cluster_members(st, budget_ms=500)
                    except survivable():
                        pass
                    last_refresh = now
                continue
            if self._degraded_since is None:
                self._degraded_since = now
                self.state = "degraded"
                continue
            if (now - self._degraded_since) * 1000.0 < \
                    self.options.election_timeout_ms:
                continue
            self.state = "electing"
            try:
                if self._run_election():
                    self._degraded_since = None
            except survivable() as e:  # the next tick retries
                self.last_result = f"election error: {e}"[:200]
            except Exception as e:
                self.last_result = f"election error: {e}"[:200]
                self.state = "failed"
                self.error = e
                return

    # ---- one election round ------------------------------------------------
    def _candidacy(self) -> tuple[int, int]:
        st = self.storage
        engine = st.kv.kv
        return (int(getattr(engine, "_applied_off", 0)),
                int(getattr(st.coord, "node_id", 0) or 0))

    def _run_election(self) -> bool:
        """One deterministic round. Returns True when resolved (promoted
        or repointed); False re-arms the next poll tick — the computed
        winner may still be mid-promotion."""
        from .diag import _peer_client

        st = self.storage
        client = st._rpc_client
        self.elections += 1
        my_pos, my_id = self._candidacy()
        if st._last_members is None:
            # the voter roll was NEVER learned (the leader died inside
            # the join window): electing against an unknown electorate
            # means electing unopposed while unseen peers do the same.
            # Stay degraded; an operator (or a returning leader) must
            # resolve this one.
            self.last_result = "no membership view: refusing to elect"
            return False
        members = list(st._last_members)
        peers = [m for m in members
                 if m.get("role") != "leader" and m.get("addr")
                 and m.get("addr") != st.diag_address]
        votes = [(my_pos, my_id)]
        unresolved = False
        for m in peers:
            addr = str(m["addr"])
            try:
                r = _peer_client(st, addr).call(
                    "diag_election", _budget_ms=1500)
            except survivable():
                n = self._peer_fails.get(addr, 0) + 1
                self._peer_fails[addr] = n
                if n < self.PEER_STRIKES:
                    # maybe just a dropped poll: without its vote the
                    # winner computation could disagree with the
                    # peer's own — hold the election open this round
                    unresolved = True
                continue  # struck out: dead peer, not an elector
            self._peer_fails.pop(addr, None)
            term = int(r.get("term", 0) or 0)
            leader_addr = str(r.get("leader_addr") or "")
            if leader_addr and term > client.term:
                # someone already promoted (term bumped past ours):
                # adopt, don't re-elect
                st.repoint_leader(leader_addr, term)
                self.state = "repointed"
                self.last_result = \
                    f"repointed to {leader_addr} (term {term})"
                return True
            if r.get("role") == "follower":
                votes.append((int(r.get("wal_pos", 0) or 0),
                              int(r.get("node_id", 0) or 0)))
            elif not leader_addr:
                # transitional peer (mid-promotion, or a role we do
                # not recognize): neither a vote nor an exclusion —
                # hold the election open until it settles
                unresolved = True
        if unresolved:
            self.last_result = "election held open: peer poll failed " \
                               "(retrying before shrinking the roll)"
            return False
        # longest replicated WAL wins; ties to the lowest node id —
        # every live voter reaches the same answer from the same data
        win_pos, win_id = max(votes, key=lambda v: (v[0], -v[1]))
        if (win_pos, win_id) == (my_pos, my_id):
            addr = st.promote_to_leader(
                listen=self.options.promote_listen)
            self.state = "promoted"
            self.last_result = f"promoted at {addr} " \
                               f"(term {st.rpc_server.term})"
            return True
        self.last_result = \
            f"waiting for node {win_id} (wal {win_pos}) to promote"
        return False


__all__ = ["FailoverManager"]
