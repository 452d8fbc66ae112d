"""Cluster diagnostics plane: per-server diag endpoints + RPC fan-out.

Port of `tidb_tpu/rpc/diag.py`, whole, with the range plane's
`type='range'` rows of cluster_info, `diag_hot_ranges`, and the mesh
flight recorder's `diag_mesh_shards` and `diag_mesh_storage`.
The fan-out degrades a member to an error row only for
`errors.survivable()` errors; any other error in a worker is re-raised
in the querying thread after the join.

Counterpart of the reference's cluster memtables (reference: TiDB 4.0
infoschema/cluster.go + executor/memtable_reader.go — every server
exposes its processlist/slow-log/metrics over its status port, and the
`information_schema.cluster_*` tables fan out to all members listed in
PD's registry). Here:

* DiagService  — answers diag queries from THIS server's live state
  (processlist provider, slow-query ring, statement digests, metrics
  registries, build/config info).
* DiagListener — a minimal frame-protocol server every follower runs so
  peers can reach its DiagService; the leader needs none (its
  CoordRPCServer dispatches diag_* to the same service).
* cluster_members / cluster_rows — membership enumeration (the leader's
  registry, fed by diag_register + heartbeat pings) and the fan-out
  that materializes the cluster_* memtables: one sub-request per live
  member under the normal BO_RPC budget, an unreachable peer degrading
  to an error row + session warning, never a failed query.

Failpoint sites at the fan-out edge (armed by tests/test_cluster_obs.py):
  diag/peer-down  — the peer call fails immediately (dead-peer path)
  diag/slow-peer  — latency injection ahead of the peer call

Trust model: the diag endpoints answer unauthenticated, the SAME model
as the coordination port they extend (which already streams the whole
WAL) and the HTTP status port (which already serves slow-query SQL
text) — the transport plane assumes a trusted network segment; bind
diag-listen/transport.listen accordingly.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any

from .. import obs
from ..util import failpoint
from .errors import RPCError, survivable, traced_response, wire_error
from .frame import get_trace_ctx
from .server import FrameListener

# cluster table -> diag RPC method serving its per-server rows
TABLE_METHODS = {
    "cluster_info": "diag_info",
    "cluster_processlist": "diag_processlist",
    "cluster_slow_query": "diag_slow_query",
    "cluster_statements_summary": "diag_statements",
    "cluster_load": "diag_load",
    "cluster_top_sql": "diag_top_sql",
    "cluster_mesh_shards": "diag_mesh_shards",
    "cluster_mesh_storage": "diag_mesh_storage",
    "cluster_inspection_result": "diag_inspection",
    "cluster_statements_summary_history": "diag_history",
    "cluster_plan_history": "diag_plan_history",
    "cluster_tidb_wait_profile": "diag_wait_profile",
    "cluster_hot_ranges": "diag_hot_ranges",
}


class DiagService:
    """One server's diagnostics, in wire-encodable form. Every method
    returns {"rows": [...]} shaped exactly like the matching cluster_*
    table minus the (instance, error) columns the fan-out adds."""

    def __init__(self, storage) -> None:
        self.storage = storage

    def _role(self) -> str:
        if getattr(self.storage, "remote", False):
            return "follower"
        if getattr(self.storage, "rpc_server", None) is not None:
            return "leader"
        return "shared" if getattr(self.storage, "shared", False) \
            else "local"

    def diag_info(self) -> dict:
        from ..server.conn import SERVER_VERSION
        started = getattr(self.storage, "_start_time", 0.0)
        coord = getattr(self.storage, "coord", None)
        rows = [[
            self._role(),
            int(getattr(coord, "node_id", 0) or 0),
            SERVER_VERSION,
            os.getpid(),
            time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(started))
            if started else "",
            round(time.time() - started, 3) if started else 0.0,
            *self._replica_cols(),
            None, None, None, None, None, None, None, None,
        ]]
        # one type='range' row per range whose write leadership this
        # member currently holds ([ranges] disabled adds nothing);
        # the trailing four are the keyspace heat plane's lifetime
        # traffic columns (zeros while [heatmap] is disabled)
        plane = getattr(self.storage, "ranges", None)
        if plane is not None:
            for d in plane.server.describe():
                rows.append(["range", None, None, None, None, None,
                             None, None, None,
                             int(d["range_id"]), str(d["leader"]),
                             int(d["term"]), int(d["closed_ts"]),
                             int(d.get("read_rows", 0)),
                             int(d.get("read_bytes", 0)),
                             int(d.get("write_rows", 0)),
                             int(d.get("write_bytes", 0))])
        return {"rows": rows}

    def _replica_cols(self) -> list:
        """The follower-read-tier columns of cluster_info: this
        server's applied/closed ts, apply lag, and whether it serves
        routed replica reads. A leader's 'applied' point is the newest
        issued timestamp (it serves every read, but not as a replica —
        serving stays 0)."""
        st = self.storage
        eng = getattr(st, "apply_engine", None)
        if eng is not None:
            # the SAME serving condition the heartbeat advertises
            # (enabled AND synced at least once) — the two surfaces an
            # operator compares must never contradict each other
            return [int(eng.applied_ts), round(eng.lag_ms(), 1),
                    1 if (st.replica_read.enabled
                          and eng.applied_ts > 0) else 0]
        tso = getattr(st, "tso", None)
        cur = int(tso.current()) if tso is not None else 0
        return [cur, 0.0, 0]

    def diag_replica_read(self, sql: str = "", db: str = "",
                          read_ts: int = 0, term: int = 0,
                          time_zone: str = "SYSTEM") -> dict:
        """A routed snapshot SELECT served from this follower's local
        engine at exactly read_ts (rpc/replica.py serve_replica_read:
        term fence, bounded closed-ts wait, SELECT-only)."""
        from .replica import serve_replica_read
        return serve_replica_read(self.storage, sql=sql, db=db,
                                  read_ts=read_ts, term=term,
                                  time_zone=time_zone)

    def diag_processlist(self) -> dict:
        provider = getattr(self.storage, "processlist", None)
        rows = []
        for r in (provider() if provider is not None else []):
            rows.append([int(r[0]), str(r[1] or ""), str(r[2] or ""),
                         str(r[3] or ""), str(r[4] or ""), int(r[5]),
                         str(r[6] or ""),
                         None if r[7] is None else str(r[7])])
        return {"rows": rows}

    def diag_slow_query(self) -> dict:
        rows = []
        for e in self.storage.obs.slow_queries():
            rows.append([e["ts"], e["db"], float(e["duration_ms"]),
                         e["sql"], e.get("plan_digest", ""),
                         obs.fmt_stages_ms(e.get("stages")),
                         int(e.get("mem_max", 0)),
                         int(e.get("spill_count", 0)),
                         obs.fmt_ops_ms(e.get("operators")),
                         float(e.get("mesh_skew", 0.0)),
                         obs.fmt_waits_ms(e.get("waits"))])
        return {"rows": rows}

    def diag_top_sql(self) -> dict:
        """This server's Top SQL attribution windows, row-shaped for
        information_schema.tidb_top_sql (the cluster_top_sql fan-out
        adds instance/error). Empty while topsql is disabled."""
        return {"rows": self.storage.obs.topsql.table_rows()}

    def diag_wait_profile(self) -> dict:
        """This server's typed wait-state attribution windows,
        row-shaped for information_schema.tidb_wait_profile. Empty
        while performance.wait-profile-enabled is false."""
        return {"rows": self.storage.obs.waitprofile.table_rows()}

    def diag_hot_ranges(self) -> dict:
        """This server's keyspace heat matrix, row-shaped for
        information_schema.tidb_hot_ranges (the cluster_hot_ranges
        fan-out adds instance/error). Empty — with zero recorder
        work — while [heatmap] is disabled."""
        return {"rows": self.storage.heat.table_rows()}

    def diag_mesh_shards(self) -> dict:
        """This server's mesh flight-recorder dispatch ring (empty while
        the storage has no mesh client). Reads the EXISTING client: a
        diag scrape never builds a mesh."""
        from ..copr import mesh as _mesh
        return {"rows": _mesh.shard_rows(self.storage)}

    def diag_mesh_storage(self) -> dict:
        """This server's per-slot memory provenance ledger."""
        from ..copr import mesh as _mesh
        return {"rows": _mesh.storage_rows(self.storage)}

    def diag_events(self) -> dict:
        """The structured server event ring, newest last."""
        rows = []
        for e in self.storage.obs.events.snapshot():
            rows.append([int(e["id"]), e["ts"], e["kind"], e["severity"],
                         int(e["conn_id"]), e["digest"], e["detail"]])
        return {"rows": rows}

    def diag_history(self) -> dict:
        """This server's workload-history windows (durable records +
        the live window), row-shaped for statements_summary_history.
        Empty — with zero work — while history.enabled is false."""
        h = self.storage.history
        return {"rows": h.table_rows() if h.enabled else []}

    def diag_plan_history(self) -> dict:
        """Per-(digest, plan) rollup of this server's retained
        history, row-shaped for tidb_plan_history."""
        h = self.storage.history
        return {"rows": h.plan_rows() if h.enabled else []}

    def diag_inspection(self) -> dict:
        """This server's inspection findings: every registered rule of
        the obs_inspect engine evaluated over one telemetry snapshot.
        Empty — with ZERO rule work — while diagnostics.enabled is
        false (obs_inspect.result_rows short-circuits)."""
        from .. import obs_inspect
        return {"rows": obs_inspect.result_rows(self.storage)}

    def diag_statements(self) -> dict:
        rows = []
        for e in self.storage.obs.statements.snapshot():
            rows.append([
                e["digest"], e["schema_name"], e["digest_text"],
                e["sample_text"], e["exec_count"], e["errors"],
                round(e["sum_latency_ms"], 3),
                round(e["max_latency_ms"], 3), e["sum_rows"],
                e["last_seen"]])
        return {"rows": rows}

    def diag_load(self) -> dict:
        """Current gauge/counter values — the device/host telemetry the
        cluster_load table correlates with bench regressions."""
        obs.run_gauge_probes()
        rows = []
        for reg in (self.storage.obs.metrics, obs.PROCESS_METRICS):
            for name, v in reg.flat_samples():
                dev = name.startswith(("tidb_device_", "tidb_jit_",
                                       "tidb_copr_", "tidb_mesh_"))
                rows.append(["device" if dev else "host", name,
                             float(v)])
        return {"rows": rows}

    def diag_election(self) -> dict:
        """This server's candidacy state for leader elections (polled by
        peers' FailoverManagers over the diag port): node id, replicated
        WAL position, known term, and — once anyone has promoted or
        repointed — where the CURRENT leader answers coordination RPC.
        Leaders answer too, so a partitioned follower that regains this
        endpoint immediately learns who rules."""
        st = self.storage
        rpc_server = getattr(st, "rpc_server", None)
        if rpc_server is not None:
            return {"node_id": int(getattr(st.coord, "node_id", 0) or 0),
                    "wal_pos": rpc_server._wal_size(),
                    "term": rpc_server.term,
                    "role": "leader",
                    "leader_addr": rpc_server.address}
        if getattr(st, "_promoting", False):
            # mid-promotion: neither follower nor leader yet. Voters
            # must HOLD their election open — treating this window as
            # "not an elector" elected a second leader (split brain)
            return {"node_id": int(getattr(st.coord, "node_id", 0) or 0),
                    "wal_pos": 0, "term": 0,
                    "role": "promoting", "leader_addr": ""}
        client = getattr(st, "_rpc_client", None)
        engine = getattr(st.kv, "kv", None)
        return {"node_id": int(getattr(st.coord, "node_id", 0) or 0),
                "wal_pos": int(getattr(engine, "_applied_off", 0)),
                "term": int(getattr(client, "term", 0) or 0),
                "role": self._role(),
                "leader_addr": str(getattr(client, "addr", "") or "")
                if client is not None and not client.degraded else ""}

    def handle(self, method: str, **params) -> dict:
        fn = getattr(self, method, None)
        if fn is None or not method.startswith("diag_"):
            raise RPCError(f"unknown diag method {method}")
        return fn(**params) if params else fn()


class DiagListener(FrameListener):
    """Minimal frame-protocol listener serving ONE service: this
    server's DiagService. Followers run it (registered with the leader
    at hello/heartbeat time) so any peer can pull their diagnostics.
    The socket machinery — accept/serve loops, oversized-response
    guard, accept-waking teardown — is the shared FrameListener core
    CoordRPCServer also runs on; there is no lease state here."""

    _thread_prefix = "titpu-diag"

    def __init__(self, storage, listen: str = "127.0.0.1:0") -> None:
        self.service = DiagService(storage)
        fam, target = self._start_listener(listen, backlog=16)
        if fam == socket.AF_INET:
            host = self._listener.getsockname()[0]
            if host in ("0.0.0.0", "::", ""):
                # the bound address is what gets REGISTERED with the
                # leader and dialed by every peer — a wildcard would
                # hand them an unconnectable 0.0.0.0 (each peer's own
                # loopback); fail loudly at startup instead
                self._close_listener()
                raise ValueError(
                    f"diag-listen {listen!r} binds a wildcard address; "
                    "peers must be handed a routable host (e.g. "
                    "\"10.0.0.5:0\")")
            self.address = f"{host}:{self.port}"
        else:
            self.address = f"unix:{target}"

    def _dispatch(self, req: Any) -> dict:
        if not isinstance(req, dict) or "m" not in req:
            return wire_error(None, RPCError("bad request"))
        rid = req.get("id")
        method = str(req.get("m"))
        params = req.get("p") if isinstance(req.get("p"), dict) else {}
        return traced_response(
            rid, method,
            lambda: self.service.handle(method, **params),
            get_trace_ctx(req))

    def close(self) -> None:
        self._close_listener()
        self._raise_kept()


# ---- membership + fan-out ---------------------------------------------------

def cluster_members(storage, budget_ms: int = 1000) -> list[dict]:
    """Live members as {id, addr, role, hb_age_s}. The leader reads its
    own registry; a follower asks the leader — and when the leader is
    unreachable, the leader stays listed with a `down` marker so its
    absence surfaces as an error row + warning rather than a silently
    shrunken cluster. Local/shared-dir stores are single-member."""
    rpc_server = getattr(storage, "rpc_server", None)
    if rpc_server is not None:
        return rpc_server.members()
    if getattr(storage, "remote", False):
        own = {"id": int(getattr(storage.coord, "node_id", 0) or 0),
               "addr": storage.diag_address, "role": "follower",
               "hb_age_s": 0.0}
        client = storage._rpc_client
        cached = storage._last_members
        age = time.monotonic() - storage._last_members_ts
        if cached and not client.degraded \
                and age < client.options.lease_ms / 1000.0:
            # fresh-enough registry view: /status scrapes and repeated
            # cluster_* reads must not add a leader round-trip (and a
            # turn on the shared coordination client's mutex) per call;
            # staleness is bounded by the lease, the heartbeat cadence
            return [dict(m) for m in cached]
        if not (client.degraded and cached):
            try:
                r = client.call("members", _budget_ms=budget_ms)
                members = [m for m in r.get("members", [])
                           if isinstance(m, dict)]
                for m in members:
                    if m.get("role") == "leader":
                        # the leader self-advertises its bound host,
                        # which under a wildcard bind is loopback;
                        # substitute the address THIS follower provably
                        # reaches it at (its transport.remote target)
                        m["addr"] = str(client.addr)
                if not any(m.get("addr") == own["addr"]
                           for m in members):
                    members.append(own)  # not registered yet
                storage._last_members = members
                storage._last_members_ts = time.monotonic()
                return members
            except RPCError as e:
                down = f"{type(e).__name__}: {e}"[:250]
        else:
            # heartbeat already knows the leader is gone: serve the
            # cached shape without paying another backoff budget (the
            # /status scrape path calls this on every poll)
            down = "leader unreachable (degraded)"
        # leader unreachable: fall back to the last registry view so
        # the OTHER followers stay visible (live ones answer their
        # diag ports directly; the leader degrades to an error row
        # instead of the cluster silently shrinking to one server)
        cached = storage._last_members
        if cached:
            out = []
            for m in cached:
                m = dict(m)
                if m.get("role") == "leader":
                    m["down"] = down
                out.append(m)
            return out
        return [own, {"id": 0, "addr": str(client.addr),
                      "role": "leader", "hb_age_s": None, "down": down}]
    return [{"id": 0, "addr": "", "role": "local", "hb_age_s": 0.0}]


def _peer_client(storage, addr: str):
    """Cached non-heartbeating RpcClient per peer diag address (cache
    and lock live on the Storage, initialized in its __init__ so two
    first-queries cannot race the setup)."""
    from .client import RpcClient, RpcOptions
    with storage._diag_clients_lock:
        c = storage._diag_clients.get(addr)
        if c is None:
            opts = storage._rpc_options or RpcOptions()
            c = storage._diag_clients[addr] = RpcClient(
                addr, opts, _heartbeat=False)
        return c


def close_peer_clients(storage) -> None:
    with storage._diag_clients_lock:
        clients, storage._diag_clients = storage._diag_clients, {}
    for c in clients.values():
        c.close()


def _call_member(storage, member: dict, method: str) -> dict:
    """One member's diag payload: local members answer in-process, remote
    ones over their diag endpoint under the BO_RPC budget. The failpoint
    sites live HERE, on the remote edge, so chaos lands on the fan-out
    and not on the local rows."""
    down = member.get("down")
    if down:
        # already known unreachable (e.g. the leader, discovered during
        # membership): surface the error row without burning another
        # backoff budget against a dead endpoint
        raise RPCError(str(down))
    addr = str(member.get("addr") or "")
    if not addr or addr == storage.diag_address:
        return storage.diag.handle(method)
    if failpoint.inject("diag/peer-down"):
        raise RPCError(f"failpoint diag/peer-down: peer {addr}")
    d = failpoint.inject("diag/slow-peer")
    if isinstance(d, (int, float)) and not isinstance(d, bool) and d > 0:
        time.sleep(float(d))
    client = _peer_client(storage, addr)
    if client.breaker_state == "open":
        # the peer already burned breaker-threshold budgets: degrade to
        # the error row NOW instead of rediscovering the dead endpoint
        # (and paying another Backoffer budget) on every fan-out; the
        # half-open probe after the cooldown re-admits it
        raise RPCError(
            f"peer {addr}: rpc circuit breaker open (failing fast)")
    # capped below the transport budget: cluster_processlist fans out
    # while holding the viewer-sensitive infoschema lock, and a dead
    # peer must not push the hold time toward that lock's 10s acquire
    # timeout (siblings would see 'information_schema busy')
    budget = min(client.options.backoff_budget_ms, 2000)
    return client.call(method, _budget_ms=budget)


def cluster_rows(storage, tname: str, ncols: int,
                 viewer=None) -> list[list]:
    """Materialize one cluster_* table: fan out to every member, tag
    rows with the member's instance address, and degrade an unreachable
    peer to [instance, NULL..., error] plus a session warning.

    Members are queried in PARALLEL (reference: memtable_reader.go
    issues its per-store requests concurrently), so N dead peers cost
    one capped budget of wall time, not N — which also bounds how long
    cluster_processlist holds the viewer-sensitive infoschema lock.
    Under an active TRACE each worker runs beneath its own child
    collector and the caller grafts the subtrees back (the span stack
    is thread-local), so the stitched tree matches sequential hops."""
    method = TABLE_METHODS[tname]
    members = cluster_members(storage)
    results: list = [None] * len(members)
    # a worker's error that is not a member's transport or engine
    # failure: re-raised here after the join
    kept: list = []
    parent = obs.active_collector()
    into = parent._stack[-1] if parent is not None else None
    child_colls: list = [None] * len(members)

    def fetch(i: int, member: dict, use_child: bool) -> None:
        try:
            if use_child:
                # worker thread: its own collector (the caller's span
                # stack is thread-local), grafted back after the join;
                # it inherits the statement's trace_id so the peer's
                # spans stay attributable to ONE Dapper trace
                with obs.SpanCollector("diag.fanout") as child:
                    child.trace_id = parent.trace_id
                    child_colls[i] = child
                    results[i] = (_call_member(storage, member, method),
                                  None)
            else:
                # caller thread: the active collector (if any) is
                # already in TLS — spans open directly on it
                results[i] = (_call_member(storage, member, method),
                              None)
        except survivable() as e:
            # a member's transport or engine failure degrades to an
            # error row, never fails the query
            results[i] = (None, f"{type(e).__name__}: {e}"[:250])
        except Exception as e:
            kept.append(e)

    if len(members) <= 1:
        for i, member in enumerate(members):
            fetch(i, member, use_child=False)
    else:
        threads = [threading.Thread(target=fetch,
                                    args=(i, m, parent is not None),
                                    name="titpu-diag-fanout",
                                    daemon=True)
                   for i, m in enumerate(members)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if kept:
        raise kept[0]
    if parent is not None:
        for child in child_colls:
            if child is not None:
                obs.graft_collector(parent, into, child)

    # evict cached clients for addresses that left the membership —
    # follower restarts bind fresh ephemeral ports, and without this a
    # long-lived server accretes one dead client per churned address
    addrs = {str(m.get("addr") or "") for m in members}
    with storage._diag_clients_lock:
        stale = [a for a in storage._diag_clients if a not in addrs]
        dropped = [storage._diag_clients.pop(a) for a in stale]
    for c in dropped:
        c.close()

    out: list[list] = []
    for member, (payload, err) in zip(members, results):
        inst = str(member.get("addr") or member.get("role") or "local")
        if err is not None:
            out.append([inst] + [None] * (ncols - 2) + [err])
            if viewer is not None and hasattr(viewer, "add_warning"):
                viewer.add_warning(
                    f"cluster diagnostics: member {inst} unreachable "
                    f"({err})")
            continue
        for r in payload.get("rows", []):
            out.append([inst] + list(r) + [None])
    if tname == "cluster_processlist" and viewer is not None \
            and viewer.user is not None \
            and not storage.privileges.check(
                viewer.user, "PROCESS", "*", "*",
                roles=viewer.active_roles):
        # without PROCESS only your own connections are visible (the
        # rule the per-server processlist table already applies);
        # error rows (user column NULL, error set) stay visible
        out = [r for r in out
               if r[2] == viewer.user or r[-1] is not None]
    return out


__all__ = ["DiagService", "DiagListener", "TABLE_METHODS",
           "cluster_members", "cluster_rows", "close_peer_clients"]
