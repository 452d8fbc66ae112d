"""CoordRPCServer: the store-owning process's coordination endpoint.

Port of `tidb_tpu/rpc/server.py`, with one difference kept on purpose: a
handler error that `errors.survivable()` does not name is not turned
into a wire error. The connection thread keeps the first such error on
the listener (`error`), drops that connection (the peer sees a
transport error) and `close()` re-raises it after the teardown. Every
thread the listener starts (accept, connections, the reaper) is joined
by `close()`.

Embedded in the leader (the one server whose Storage owns the durable
directory), it exports the three services every other deployment shape
gets from the shared directory — TSO allocation, WAL append/tail, KILL
mailbox — plus the named leases (mutation section, DDL/GC owner) that
serialize cluster mutators. The reference splits these across PD (TSO,
store/tikv/oracle/oracles/pd.go), TiKV raftstore (the log), and etcd
(owner election, owner/manager.go); one process plays all three here
because the storage tier is embedded.

Crucial property: remote grants take the SAME flocks the shared-dir
mode uses (store.lock, ddl.owner.lock, ...), so a socket follower and a
disk-sharing sibling can coexist against one directory — local and
remote mutators stay mutually exclusive through the kernel.

Safety under lease loss: every grant carries a fencing token; a WAL
append from a deposed holder (lease expired while it was paused or
partitioned) is rejected with StaleLeaseError BEFORE touching the file,
and the append offset is double-checked against the file size as a
second net (reference analog: raft terms fencing a deposed leader's
proposals)."""

from __future__ import annotations

import fcntl
import os
import socket
import threading
import time
from typing import Any, Optional

from ..analysis import lockcheck
from ..errno import CodedError
from .errors import RPCError, StaleLeaseError, StaleTermError, \
    WalOffsetMismatch, traced_response, wire_error
from .frame import MAX_FRAME, FrameError, decode, encode, get_trace_ctx, \
    parse_addr, recv_frame, send_frame

# one tail response carries at most this many bytes; clients loop
TAIL_CHUNK = 4 << 20


def read_term(path: str) -> int:
    """The persisted fencing term (0 when absent/corrupt — a torn term
    file reads as 'unknown', and the caller re-persists)."""
    try:
        with open(path) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def write_term(path: str, term: int) -> None:
    """Crash-atomic term persistence: tmp + fsync + rename + dir fsync
    (losing a term bump to power loss would let the next incarnation
    reuse a fenced epoch)."""
    from ..kv.mvcc import fsync_dir
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(int(term)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


class _Client:
    __slots__ = ("last_seen", "node_id", "node_fd", "last_seq",
                 "last_seq_result", "kill_seq", "kill_result",
                 "diag_addr", "role", "diag_departed",
                 "applied_ts", "apply_lag_ms", "serving", "load",
                 "peer_term", "pending_commit")

    def __init__(self) -> None:
        self.last_seen = time.monotonic()
        self.node_id: Optional[int] = None
        self.node_fd: Optional[int] = None
        self.last_seq = -1
        self.last_seq_result: Optional[int] = None
        self.kill_seq = -1
        self.kill_result: Optional[list] = None
        # membership registry fields (the diag plane): where this
        # client's diagnostics listener answers, and what role it plays;
        # diag_departed latches on clean unregister so a straggler
        # heartbeat (its ping was in flight during the peer's close)
        # cannot resurrect the dead address
        self.diag_addr: Optional[str] = None
        self.role: Optional[str] = None
        self.diag_departed = False
        # follower-read tier advertisement (rpc/apply.py rides the
        # heartbeat): closed/applied ts, apply lag, the serving flag,
        # the admission-gate load signal, and the term the peer lives
        # in (a lower term marks a deposed-epoch replica non-serving)
        self.applied_ts = 0
        self.apply_lag_ms: Optional[float] = None
        self.serving = False
        self.load = 0
        self.peer_term = 0
        # the ONE remote commit timestamp this client may be holding
        # unpublished (issued by tso_commit, retired by tso_commit_done
        # / the next tso_commit / the mutation-lease release) — the
        # pending-commit ledger closed_info caps the closed ts under
        self.pending_commit = 0


class _Grant:
    __slots__ = ("client_id", "token")

    def __init__(self, client_id: str, token: int) -> None:
        self.client_id = client_id
        self.token = token


class FrameListener:
    """Frame-protocol server core shared by CoordRPCServer and the diag
    listeners (rpc/diag.py): bind + accept loop, the per-connection
    serve loop with the oversized-response guard (an over-MAX_FRAME
    payload answers typed instead of tearing the stream — a torn stream
    would make the client retry a deterministic failure), and a
    teardown that wakes a blocked accept(). Subclasses implement
    `_dispatch(req) -> response dict`."""

    _thread_prefix = "titpu-frame"

    def _start_listener(self, listen, backlog: int = 64):
        """Bind + start accepting; returns (family, target) so the
        subclass can compute its advertised address."""
        self._shutdown = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conn_threads: set[threading.Thread] = set()
        self._conns_mu = threading.Lock()
        # the first non-survivable handler error, re-raised by close()
        self.error: Optional[BaseException] = None
        fam, target = parse_addr(listen)
        ls = socket.socket(fam, socket.SOCK_STREAM)
        if fam == socket.AF_INET:
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind(target)
        ls.listen(backlog)
        self._listener = ls
        self.port = ls.getsockname()[1] if fam == socket.AF_INET else 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name=f"{self._thread_prefix}-accept", daemon=True)
        self._accept_thread.start()
        return fam, target

    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(sock,),
                                 name=f"{self._thread_prefix}-conn",
                                 daemon=True)
            with self._conns_mu:
                self._conns.add(sock)
                self._conn_threads.add(t)
                # started under the lock, so close() never joins a
                # thread that has not started
                t.start()

    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            while not self._shutdown.is_set():
                try:
                    req = decode(recv_frame(sock))
                except (ConnectionError, FrameError, OSError,
                        ValueError):
                    return  # torn stream: client reconnects
                try:
                    resp = self._dispatch(req)
                except Exception as e:
                    # not an error the RPC plane survives: keep it for
                    # close(), drop this connection
                    with self._conns_mu:
                        if self.error is None:
                            self.error = e
                    return
                payload = encode(resp)
                if len(payload) > MAX_FRAME:
                    payload = encode({"id": resp.get("id"), "err": {
                        "type": "RPCError",
                        "msg": f"response too large for one frame "
                               f"({len(payload)} > {MAX_FRAME})"}})
                try:
                    send_frame(sock, payload)
                except OSError:
                    return
        finally:
            with self._conns_mu:
                self._conns.discard(sock)
                self._conn_threads.discard(threading.current_thread())
            try:
                sock.close()
            except OSError:
                pass

    def _close_listener(self) -> None:
        self._shutdown.set()
        try:
            # wake a blocked accept() — closing the fd alone leaves the
            # accept thread parked until a connection arrives
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)
        with self._conns_mu:
            conns = list(self._conns)
            self._conns.clear()
            threads = list(self._conn_threads)
        for s in conns:
            try:
                # shutdown wakes a serve loop blocked in recv()
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=5.0)

    def _raise_kept(self) -> None:
        """Re-raise the handler error a connection thread kept."""
        err, self.error = self.error, None
        if err is not None:
            raise err


class CoordRPCServer(FrameListener):
    _thread_prefix = "titpu-rpc"

    def __init__(self, storage, listen="127.0.0.1:0",
                 lease_ms: int = 3000,
                 tail_chunk: int = TAIL_CHUNK,
                 term: Optional[int] = None) -> None:
        if storage.path is None:
            raise ValueError("RPC coordination needs a durable store dir")
        self.storage = storage
        self.path = storage.path
        self.lease_ms = lease_ms
        # the server owns the chunk size; clients drive the tail loop
        # off the response's `more` flag, never off their own constant
        self.tail_chunk = tail_chunk
        self._mu = lockcheck.lock("CoordRPCServer._mu")
        self._clients: dict[str, _Client] = {}
        self._grants: dict[str, _Grant] = {}   # lock name -> grant
        self._lock_fds: dict[str, int] = {}    # lock name -> flock fd
        self._next_token = 1
        self._wal_path = os.path.join(self.path, "kv", "wal.log")
        self._snap_path = os.path.join(self.path, "kv", "snapshot.kv")
        os.makedirs(os.path.join(self.path, "kv"), exist_ok=True)
        # the cluster fencing TERM, persisted beside the WAL it fences:
        # a fresh leader starts at 1, a clean restart resumes the stored
        # term, and a PROMOTED follower passes term=stored+1. Mutating
        # requests carrying a lower term are rejected (StaleTermError) —
        # the raft-term analog that stops a deposed leader's clients
        # from split-braining the log.
        self._term_path = os.path.join(self.path, "kv", "term")
        self.term = int(term) if term is not None else \
            max(1, read_term(self._term_path))
        write_term(self._term_path, self.term)
        # O_APPEND handle for remote records: interleaves safely with
        # the leader engine's own appends (both under the mutation flock)
        self._append_f = open(self._wal_path, "ab")
        # remote appends honor the SAME storage.sync-log policy as the
        # engine's own WAL writes (one shared evaluator, kv/mvcc.py)
        from ..kv.mvcc import SyncPolicy
        engine = storage.kv.kv
        self._append_sync = SyncPolicy(
            getattr(engine, "sync_log", "off"),
            getattr(engine, "sync_interval_ms", 100),
            self._fsync_append)
        # cross-commit group fsync for remote appends: concurrent
        # wal_append handler threads rendezvous on one fsync instead of
        # serializing one disk barrier per append (the mutation lease
        # serializes WRITERS, but pipelined appends from the leased
        # client's sessions still overlap their durability waits)
        self._append_sync.defer_commit = True
        self._append_sync.on_batch = storage._note_group_commit
        self._append_sync.on_stall = getattr(
            getattr(engine, "_syncer", None), "on_stall", None)
        fam, target = self._start_listener(listen)
        if fam == socket.AF_INET:
            # the advertised address doubles as the leader's dialable
            # diag endpoint in members(); a wildcard bind can't name a
            # single routable host, so loopback stands in and followers
            # substitute the leader address they actually dialed
            # (rpc/diag.py cluster_members)
            host = self._listener.getsockname()[0]
            if host in ("0.0.0.0", "::", ""):
                host = "127.0.0.1"
            self.address = f"{host}:{self.port}"
        else:
            self.address = f"unix:{target}"
        self._reaper = threading.Thread(target=self._reaper_loop,
                                        name="titpu-rpc-reaper",
                                        daemon=True)
        self._reaper.start()

    def _fsync_append(self) -> None:
        f = self._append_f
        if not f.closed:
            f.flush()
            os.fsync(f.fileno())

    # ---- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._append_sync.close()
        self._close_listener()
        self._reaper.join(timeout=5.0)
        with self._mu:
            for name in list(self._grants):
                self._release_locked(name)
            for fd in self._lock_fds.values():
                try:
                    os.close(fd)
                except OSError:
                    pass
            self._lock_fds.clear()
            for c in self._clients.values():
                if c.node_fd is not None:
                    try:
                        os.close(c.node_fd)
                    except OSError:
                        pass
            self._clients.clear()
        try:
            self._append_f.close()
        except OSError:
            pass
        self._raise_kept()

    # ---- dispatch ----------------------------------------------------------
    def _dispatch(self, req: Any) -> dict:
        if not isinstance(req, dict) or "m" not in req:
            return {"id": None,
                    "err": {"type": "RPCError", "msg": "bad request"}}
        rid = req.get("id")
        method = req.get("m")
        params = req.get("p") or {}
        client_id = str(req.get("c") or "")
        handler = getattr(self, f"_h_{method}", None)
        if handler is not None:
            fn = lambda: handler(client_id, **params)  # noqa: E731
            with self._mu:
                c = self._clients.get(client_id)
                if c is None:
                    c = self._clients[client_id] = _Client()
                c.last_seen = time.monotonic()
        elif isinstance(method, str) and method.startswith("diag_"):
            # the diag service (shared with follower DiagListeners)
            # serves the leader's own diagnostics over this port;
            # registry methods like diag_register keep _h_ handlers.
            # NO _Client entry: diag fan-out callers are not cluster
            # participants and must not inflate client_count()
            fn = lambda: self.storage.diag.handle(  # noqa: E731
                method, **(params if isinstance(params, dict) else {}))
        else:
            return wire_error(rid, RPCError(f"unknown method {method}"))
        # trace propagation: a request under an active client TRACE
        # runs its handler beneath a SpanCollector and ships the span
        # rows back for stitching (rpc/frame.py trace ctx)
        return traced_response(rid, method, fn, get_trace_ctx(req))

    # ---- liveness ----------------------------------------------------------
    def _h_ping(self, client_id: str, diag_addr=None, role=None,
                node_id=None, applied_ts=None, apply_lag_ms=None,
                serving=None, load=None, term=None) -> dict:
        # heartbeats may carry the sender's diag registration so a
        # restarted leader relearns the membership within one beat
        if diag_addr:
            self._register_member(client_id, str(diag_addr),
                                  str(role or "follower"))
        if node_id is not None or applied_ts is not None:
            with self._mu:
                c = self._clients.get(client_id)
                if c is not None:
                    if node_id is not None and c.node_id is None:
                        # a follower that repointed here after a
                        # promotion keeps its original node id; record
                        # it so members() and the election registry
                        # stay id-accurate
                        c.node_id = int(node_id)
                    if applied_ts is not None:
                        # the follower-read advertisement (rpc/apply.py)
                        c.applied_ts = int(applied_ts)
                        c.apply_lag_ms = float(apply_lag_ms or 0.0)
                        c.load = int(load or 0)
                        c.peer_term = int(term or 0)
                        # a replica living in a FENCED epoch (it last
                        # applied a deposed leader's stream) is never
                        # a serving candidate, whatever it advertises
                        c.serving = bool(serving) and \
                            c.peer_term >= self.term
        # the term rides every beat: clients track the cluster epoch
        # from it, and a client that knows a HIGHER term than ours
        # treats us as a deposed leader (StaleTermError client-side)
        return {"ok": True, "lease_ms": self.lease_ms, "term": self.term}

    def _h_hello(self, client_id: str) -> dict:
        return {"lease_ms": self.lease_ms,
                "wal_size": self._wal_size(),
                "term": self.term}

    def client_count(self) -> int:
        with self._mu:
            horizon = time.monotonic() - 3 * self.lease_ms / 1000.0
            return sum(1 for c in self._clients.values()
                       if c.last_seen >= horizon)

    # ---- membership registry (the diag plane) ------------------------------
    def _register_member(self, client_id: str, addr: str,
                         role: str) -> None:
        with self._mu:
            c = self._clients.get(client_id)
            if c is None:
                c = self._clients[client_id] = _Client()
            if c.diag_departed:
                return  # cleanly closed; a straggler ping can't rejoin
            c.diag_addr, c.role = addr, role

    def _h_diag_register(self, client_id: str, addr: str = "",
                         role: str = "follower") -> dict:
        self._register_member(client_id, str(addr), str(role))
        return {}

    def _h_diag_unregister(self, client_id: str) -> dict:
        """Clean shutdown: drop the member now instead of letting the
        cluster_* fan-out burn its budget against the closed address
        until the lease horizon passes."""
        with self._mu:
            c = self._clients.get(client_id)
            if c is None:
                c = self._clients[client_id] = _Client()
            c.diag_addr = c.role = None
            c.diag_departed = True
        return {}

    def members(self) -> list[dict]:
        """Cluster shape: the leader itself plus every registered client
        with a diag address, tagged with heartbeat age so operators (and
        the cluster_* fan-out) can judge liveness. The same 3-lease
        horizon client_count applies bounds how long a crashed peer
        keeps contributing error rows — past it the peer has departed."""
        # the leader row carries the serving-tier columns too: its
        # "applied" point is simply the newest issued timestamp, and it
        # is not a replica-read candidate (serving False) — leader
        # reads are just reads
        out = [{"id": 0, "addr": self.address, "role": "leader",
                "hb_age_s": 0.0,
                "applied_ts": int(self.storage.tso.current()),
                "apply_lag_ms": 0.0, "serving": False, "load": 0}]
        now = time.monotonic()
        horizon = 3 * self.lease_ms / 1000.0
        with self._mu:
            for c in self._clients.values():
                age = now - c.last_seen
                if c.diag_addr and age <= horizon:
                    out.append({
                        "id": c.node_id if c.node_id is not None else -1,
                        "addr": c.diag_addr,
                        "role": c.role or "follower",
                        "hb_age_s": round(age, 3),
                        "applied_ts": int(c.applied_ts),
                        "apply_lag_ms": c.apply_lag_ms,
                        "serving": bool(c.serving),
                        "load": int(c.load)})
        return out

    def _h_members(self, client_id: str) -> dict:
        return {"members": self.members()}

    # ---- TSO ---------------------------------------------------------------
    def _h_tso_next(self, client_id: str) -> dict:
        return {"ts": self.storage.tso.next_ts()}

    def _h_tso_commit(self, client_id: str) -> dict:
        """A COMMIT timestamp for a remote committer: allocated like any
        other, but entered into the pending-commit ledger until the
        records it stamps are published (or the commit dies).

        Allocation and registration happen under the SAME storage
        commit lock _h_closed_info computes under — otherwise a
        closed_info interleaving between next_ts() and the ledger write
        would see tso.current() >= ts with an empty pending list and
        close past an in-flight commit.

        ONE slot per client is safe: the follower's Storage serializes
        its whole commit phase (allocation through publish) under its
        own commit lock, so a new tso_commit from the same client means
        the previous commit finished — publish included — and its entry
        retires by replacement."""
        with self.storage._commit_lock:
            ts = self.storage.tso.next_ts()
            with self._mu:
                c = self._clients[client_id]
                c.pending_commit = ts
        return {"ts": ts}

    def _h_tso_commit_done(self, client_id: str, ts: int = 0) -> dict:
        """The remote commit phase completed (published or definitively
        not going to): retire the pending entry so the closed ts can
        advance past it. The retire is TS-MATCHED: a done that lost a
        race with the client's next tso_commit (the commit lock on the
        follower was released before the done RPC fired) must not wipe
        the successor's in-flight entry. Best-effort on the client
        side — a lost done is recovered by the client's next tso_commit
        or the client reaper."""
        with self._mu:
            c = self._clients.get(client_id)
            if c is not None and (not ts or c.pending_commit == int(ts)):
                c.pending_commit = 0
        return {}

    def _h_closed_info(self, client_id: str) -> dict:
        """The closed-timestamp point for follower serving: every commit
        with commit_ts <= closed_ts has its WAL records inside the
        first wal_size bytes (rpc/apply.py adopts the pair once its
        fold passes wal_size). Correctness: local commits allocate
        their commit_ts AND append their records under the storage
        commit lock we hold here, so anything after us is > our
        tso.current(); remote commits allocate via tso_commit, whose
        ledger caps us below any still-unpublished timestamp. (Disk-
        sharing sibling WRITER processes bypass both fences — the
        serving tier assumes the socket-cluster shape, where the
        leader process is the only local mutator.)"""
        st = self.storage
        # the WAL stat is disk I/O — kept OUTSIDE the commit lock
        # (blocking-call-under-hot-lock). Between appends the size
        # only grows, so a post-lock stat still covers every record of
        # commits <= closed_ts and the extra bytes belong to newer
        # commits the MVCC read at closed_ts never sees. The one size
        # DECREASE is a checkpoint rotating the WAL (which never held
        # this lock, before or after this change): bracketing stats
        # detect a rotation racing the closed-ts read and retry, so a
        # truncated size is never paired with a pre-truncation
        # closed_ts.
        # rotation epoch of the leader's WAL: in the serving shape the
        # leader is shared-mode and never rotates (PyOrderedKV shared
        # checkpoint is a no-op), so the generation is constant; the
        # bracket still guards any future rotation path — a size
        # comparison alone cannot see a truncate-then-regrow (same
        # file, size already past the pre-rotation stat)
        def _wal_gen() -> int:
            return int(getattr(getattr(st.kv, "kv", None),
                               "wal_generation", 0))

        for _ in range(3):
            gen0 = _wal_gen()
            before = self._wal_size()
            with st._commit_lock:
                closed = int(st.tso.current())
                with self._mu:
                    pend = [c.pending_commit
                            for c in self._clients.values()
                            if c.pending_commit]
                if pend:
                    closed = min(closed, min(pend) - 1)
            wal = self._wal_size()
            if _wal_gen() == gen0 and wal >= before:
                return {"wal_size": wal, "closed_ts": closed,
                        "term": self.term}
        # a rotation raced every retry: REFUSE to advance rather than
        # pair a fresh closed_ts with a size that may not cover its
        # records — the apply engine's `closed > applied_ts` guard
        # makes a zero pair one skipped tick, never a regression
        return {"wal_size": 0, "closed_ts": 0, "term": self.term}

    # ---- named leases (mutation section, ddl/gc owner) ---------------------
    def _lock_file(self, name: str) -> str:
        if name == "mutation":
            return os.path.join(self.path, "store.lock")
        if name in ("ddl", "gc"):
            return os.path.join(self.path, f"{name}.owner.lock")
        safe = "".join(ch if ch.isalnum() else "_" for ch in name)
        return os.path.join(self.path, f"rpc.{safe}.lock")

    def _lock_fd(self, name: str) -> int:
        fd = self._lock_fds.get(name)
        if fd is None:
            fd = os.open(self._lock_file(name),
                         os.O_CREAT | os.O_RDWR, 0o644)
            self._lock_fds[name] = fd
        return fd

    def _expired(self, client_id: str) -> bool:
        c = self._clients.get(client_id)
        return c is None or \
            time.monotonic() - c.last_seen > self.lease_ms / 1000.0

    def _release_locked(self, name: str) -> None:
        """Drop a grant; caller holds self._mu. Deliberately does NOT
        retire the holder's pending commit: mutation sections are also
        taken by NON-commit paths (pessimistic locking) on other
        sessions of the same client, and their release racing a
        sibling's in-flight commit would clear a live ledger entry —
        closed_ts would pass an unpublished commit. A pending entry a
        lost tso_commit_done leaves behind only delays closing (the
        client's next commit or the reaper clears it); conservative
        beats wrong."""
        self._grants.pop(name, None)
        fd = self._lock_fds.get(name)
        if fd is not None:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            except OSError:
                pass

    def _check_term(self, term) -> None:
        """Reject a mutator still living in a fenced epoch. term=0 means
        the caller predates term fencing (direct RpcClient users) and is
        admitted — the lease tokens still protect the WAL."""
        if term and int(term) < self.term:
            raise StaleTermError(
                f"request term {int(term)} is fenced: cluster is at "
                f"term {self.term} (a new leader was elected; "
                "re-resolve and retry)")

    def _h_lock_acquire(self, client_id: str, name: str = "",
                        term: int = 0) -> dict:
        self._check_term(term)
        with self._mu:
            grant = self._grants.get(name)
            if grant is not None:
                if grant.client_id == client_id:
                    return {"granted": True, "token": grant.token}
                if not self._expired(grant.client_id):
                    return {"granted": False}
                # deposed holder: force-release; its token is now stale
                self._release_locked(name)
            fd = self._lock_fd(name)
            try:
                # non-blocking: a local process (shared-dir sibling or
                # the leader itself) may hold the kernel lock
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return {"granted": False}
            token = self._next_token
            self._next_token += 1
            self._grants[name] = _Grant(client_id, token)
            return {"granted": True, "token": token}

    def _h_lock_release(self, client_id: str, name: str = "",
                        token: int = 0) -> dict:
        with self._mu:
            grant = self._grants.get(name)
            if grant is not None and grant.client_id == client_id \
                    and grant.token == int(token):
                self._release_locked(name)
        return {}  # stale releases are no-ops (lease already reaped)

    def _reaper_loop(self) -> None:
        """Expire grants whose holder stopped heartbeating — this is
        what unblocks leader-local mutators stuck in the kernel flock
        behind a dead remote client."""
        interval = max(0.1, self.lease_ms / 2000.0)
        while not self._shutdown.wait(interval):
            with self._mu:
                for name, grant in list(self._grants.items()):
                    if self._expired(grant.client_id):
                        self._release_locked(name)
                horizon = time.monotonic() - \
                    max(10 * self.lease_ms / 1000.0, 30.0)
                for cid, c in list(self._clients.items()):
                    if c.last_seen < horizon:
                        if c.node_fd is not None:
                            try:
                                os.close(c.node_fd)  # frees the slot
                            except OSError:
                                pass
                        del self._clients[cid]

    # ---- WAL append/tail ---------------------------------------------------
    def _wal_size(self) -> int:
        try:
            return os.path.getsize(self._wal_path)
        except OSError:
            return 0

    def _h_wal_bootstrap(self, client_id: str, offset: int = 0) -> dict:
        """Initial mirror: the snapshot file (same record format as the
        WAL; present only when the directory had a pre-shared life),
        streamed in chunks exactly like wal_tail so neither the snapshot
        nor the log ever has to fit one frame."""
        try:
            with open(self._snap_path, "rb") as f:
                f.seek(int(offset))
                snap = f.read(self.tail_chunk)
                more = bool(snap) and f.read(1) != b""
        except OSError:
            snap, more = b"", False
        return {"snapshot": snap, "more": more,
                "wal_size": self._wal_size()}

    def _h_wal_tail(self, client_id: str, offset: int = 0,
                    limit: int = 0) -> dict:
        """Position-based incremental tail: bytes past `offset`. `more`
        tells the client whether the file extends past this response —
        the loop's ONLY termination signal, so server and client need no
        shared chunk constant. `limit` lets a client outgrow the default
        chunk when a single record spans it."""
        n = min(int(limit) or self.tail_chunk, MAX_FRAME - 4096)
        size = self._wal_size()
        try:
            with open(self._wal_path, "rb") as f:
                f.seek(int(offset))
                data = f.read(max(n, 1))
                more = bool(data) and f.read(1) != b""
        except OSError:
            data, more = b"", False
        # wal_size lets a tailer detect DIVERGENCE: an offset beyond the
        # file means the tailer replicated more than this leader holds
        # (possible only across a failover data-loss window) and must
        # fail typed instead of waiting forever for bytes that never come
        return {"data": data, "more": more, "wal_size": size}

    def _h_wal_append(self, client_id: str, seq: int = 0,
                      expected: int = 0, data: bytes = b"",
                      token: int = 0, term: int = 0) -> dict:
        seq = int(seq)
        self._check_term(term)
        with self._mu:
            c = self._clients[client_id]
            if seq == c.last_seq and c.last_seq_result is not None:
                # idempotent retry of the in-flight append (the response
                # was lost, not the write) — reference analog: region
                # request replay after a recycled connection
                return {"offset": c.last_seq_result}
            grant = self._grants.get("mutation")
            if grant is None or grant.client_id != client_id \
                    or grant.token != int(token):
                raise StaleLeaseError(
                    "wal append fenced: mutation lease "
                    f"{'lost' if grant is None else 'superseded'} "
                    f"(token {token})")
            size = self._wal_size()
            if int(expected) != size:
                raise WalOffsetMismatch(
                    f"append expected WAL at {expected} but file is at "
                    f"{size}")
            self._append_f.write(bytes(data))
            self._append_f.flush()
            off = size + len(data)
        # the ack below IS the follower's commit acknowledgement: honor
        # the sync-log policy first — but OUTSIDE self._mu, or every
        # unrelated RPC (pings, tso) queues behind each disk fsync.
        # commit mode rendezvous on a shared in-flight fsync (group
        # commit); a failed fsync propagates (typed) instead of acking
        # undurable.
        self._append_sync.mark_dirty()
        self._append_sync.boundary()
        self._append_sync.commit_sync()
        with self._mu:
            c = self._clients[client_id]
            c.last_seq = seq
            c.last_seq_result = off
        return {"offset": off}

    # ---- node registry + kill mailbox --------------------------------------
    def _h_node_claim(self, client_id: str) -> dict:
        from ..store.coordinator import TSO_NODE_SLICES
        with self._mu:
            c = self._clients[client_id]
            if c.node_id is not None:
                return {"node_id": c.node_id}
            for nid in range(TSO_NODE_SLICES):
                fd = os.open(
                    os.path.join(self.path, "procs", f"node{nid}.lock"),
                    os.O_CREAT | os.O_RDWR, 0o644)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    os.close(fd)
                    continue
                c.node_id, c.node_fd = nid, fd
                return {"node_id": nid}
        raise CodedError("no free node slots in store dir")

    def _h_node_register(self, client_id: str, node_id: int = 0,
                         port: int = 0, status_port=None) -> dict:
        import json
        info = {"pid": -1, "client": client_id, "port": int(port),
                "status_port": status_port, "started": time.time(),
                "remote": True}
        p = os.path.join(self.path, "procs", f"node{int(node_id)}.json")
        with open(p + ".tmp", "w") as f:
            json.dump(info, f)
        os.replace(p + ".tmp", p)
        return {}

    def _h_servers(self, client_id: str) -> dict:
        coord = self.storage.coord
        return {"servers": coord.servers() if coord is not None else {}}

    def _h_kill_post(self, client_id: str, conn_id: int = 0,
                     query_only: bool = False) -> dict:
        self.storage.coord.post_kill(int(conn_id), bool(query_only))
        return {}

    def _h_kill_poll(self, client_id: str, node_id: int = 0,
                     seq: int = 0) -> dict:
        seq = int(seq)
        with self._mu:
            c = self._clients[client_id]
            if seq and seq == c.kill_seq and c.kill_result is not None:
                # retry of a poll that already drained the mailbox (the
                # response was lost): replay, don't lose the kills
                return {"kills": c.kill_result}
        kills = [[local, qo] for local, qo
                 in self.storage.coord.poll_kills(int(node_id))]
        with self._mu:
            c = self._clients[client_id]
            c.kill_seq, c.kill_result = seq, kills
        return {"kills": kills}


__all__ = ["CoordRPCServer", "FrameListener", "TAIL_CHUNK",
           "read_term", "write_term"]
