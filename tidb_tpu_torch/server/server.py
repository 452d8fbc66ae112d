"""MySQL wire server: accept loop, connection registry, graceful shutdown.

Port of `tidb_tpu/server/server.py`: the worker pool, the connection
reactor, the 1040 gate, KILL, TLS (an operator's pair or auto-tls, and
require_secure_transport), the PROXY protocol, the processlist, the HTTP
status server (`server/status.py`), the graceful close and the start of
the storage's metrics-history sampler (the thread
`titpu-metrics-history`, joined by `Storage.close`, not by the server:
the store outlives a server restart). `device` (None: the card) is
handed to every connection's `Session`. Over a shared or remote store
the connection ids are global (the node id in the top byte, the
reference's layout), the server registers with the coordinator, and a
thread (`titpu-kill-mailbox`, joined by `close`) polls the coordinator's
mailbox for the KILLs other servers address to this one.

Counterpart of the reference's server package (reference: server/server.go —
NewServer, Run accept loop :308, onConn :411, Kill :548, graceful drain
:605,621; token-limiter concurrency cap :141).

Thread-light connection plane: the reference runs a goroutine per
connection; goroutines are cheap, OS threads are not. Here an IDLE
connection costs no thread at all — it parks on one selector-based
reactor thread (_Reactor) and only occupies a worker while a command is
executing. The worker pool (_WorkerPool) grows on demand — a submitted
command never queues behind a busy pool, so a parked transaction
holder's COMMIT cannot deadlock behind its own lock-waiters — and
workers idling past the configured cap exit, so the steady-state thread
count tracks executing-statement concurrency (which the admission gate
bounds), not connection count. `max-server-connections`-scale fan-in of
mostly-idle clients is then a registry entry + one selector key each.
"""

from __future__ import annotations

import selectors
import socket
import threading
import time
from collections import deque
from typing import Optional

from ..store.storage import Storage
from .conn import ClientConn


class _WorkerPool:
    """Grow-on-demand worker threads with a bounded idle reserve.

    submit() never queues behind busy workers: if nobody is idle, a new
    thread spawns (execution concurrency is governed upstream by the
    admission gate / token-limit, so this cannot run away). A worker
    that finishes and finds `idle_cap` colleagues already waiting — or
    waits `idle_ttl` seconds without work — exits."""

    def __init__(self, idle_cap: int = 8, idle_ttl: float = 10.0) -> None:
        self.idle_cap = max(int(idle_cap), 1)
        self.idle_ttl = idle_ttl
        self._cv = threading.Condition()
        self._tasks: deque = deque()
        self._idle = 0
        self._count = 0
        self._seq = 0
        self._closed = False
        self._threads: set = set()

    def configure(self, idle_cap: int) -> None:
        self.idle_cap = max(int(idle_cap), 1)

    def thread_count(self) -> int:
        with self._cv:
            return self._count

    def submit(self, fn) -> None:
        with self._cv:
            if self._closed:
                return
            self._tasks.append(fn)
            if self._idle >= len(self._tasks):
                # enough idle workers for every pending task (notify is
                # per-submit; comparing against the queue DEPTH, not
                # just `idle > 0`, keeps a burst of submits from
                # stranding a task behind one busy worker — the
                # COMMIT-deadlock guarantee depends on it)
                self._cv.notify()
                return
            self._seq += 1
            self._count += 1
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"titpu-conn-worker-{self._seq}")
            # started under the lock, so close() never joins a thread
            # that has not started (start() does not take the lock)
            t.start()
            self._threads.add(t)

    def _worker(self) -> None:
        while True:
            fn = None
            with self._cv:
                while fn is None:
                    if self._tasks:
                        fn = self._tasks.popleft()
                        break
                    if self._closed or self._idle >= self.idle_cap:
                        self._retire_locked()
                        return
                    self._idle += 1
                    timed_out = not self._cv.wait(self.idle_ttl)
                    self._idle -= 1
                    if timed_out and not self._tasks:
                        self._retire_locked()
                        return
            try:
                fn()
            except Exception:  # noqa: BLE001 — a handler crash must
                pass           # never take the pool down

    def _retire_locked(self) -> None:
        self._count -= 1
        self._threads.discard(threading.current_thread())

    def close(self, timeout: float = 5.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            threads = list(self._threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.05))


class _Reactor:
    """One selector thread owning every PARKED (idle) connection.

    Readability wakes a connection: it is unregistered and handed to
    the worker pool, which serves commands until the socket drains and
    re-parks it. The same thread sweeps @@wait_timeout — an idle
    connection past its deadline is closed without a farewell, exactly
    like the per-thread read-deadline behavior it replaces."""

    SWEEP_S = 1.0

    def __init__(self, server: "Server", pool: _WorkerPool) -> None:
        self.server = server
        self.pool = pool
        self._sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._pending: list = []      # conns awaiting registration
        self._discard: set = set()    # conns tearing down
        self._closed = False
        # self-pipe: park()/close() from other threads wake the select
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="titpu-conn-reactor")
        self._thread.start()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def park(self, conn: ClientConn) -> None:
        conn.parked_at = time.monotonic()
        with self._lock:
            closed = self._closed
            if not closed:
                self._pending.append(conn)
        if closed:
            # outside the lock: close() re-enters via discard()
            conn.close()
            return
        self._wake()

    def discard(self, conn: ClientConn) -> None:
        """A connection closing from outside the reactor (KILL, server
        drain): drop its selector key at the next loop turn."""
        with self._lock:
            self._discard.add(conn)
        self._wake()

    def parked_count(self) -> int:
        return len(self._sel.get_map()) - 1  # minus the wake pipe

    def _loop(self) -> None:
        last_sweep = time.monotonic()
        while True:
            with self._lock:
                if self._closed:
                    break
                pending, self._pending = self._pending, []
                doomed, self._discard = self._discard, set()
            for conn in pending:
                try:
                    self._sel.register(conn.sock, selectors.EVENT_READ,
                                       conn)
                except (OSError, ValueError, KeyError):
                    conn.close()
            if doomed:
                for key in list(self._sel.get_map().values()):
                    if key.data in doomed:
                        self._unregister(key.fileobj)
            try:
                events = self._sel.select(timeout=self.SWEEP_S)
            except OSError:
                events = []
            for key, _ in events:
                if key.data is None:
                    try:  # drain wakeups
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                conn = key.data
                self._unregister(key.fileobj)
                self.pool.submit(conn.serve_ready)
            now = time.monotonic()
            if now - last_sweep >= self.SWEEP_S:
                last_sweep = now
                self._sweep_idle(now)
        self._sel.close()
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _unregister(self, fileobj) -> None:
        try:
            self._sel.unregister(fileobj)
        except (KeyError, ValueError, OSError):
            pass

    def _sweep_idle(self, now: float) -> None:
        """@@wait_timeout reaping for parked connections (re-read per
        sweep so SET SESSION wait_timeout applies to the current wait)."""
        for key in list(self._sel.get_map().values()):
            conn = key.data
            if conn is None:
                continue
            timeout = conn._idle_timeout()
            if timeout is not None and \
                    now - getattr(conn, "parked_at", now) > timeout:
                self._unregister(key.fileobj)
                # close on a WORKER: rollback_if_active can block on
                # the storage commit lock, and the reactor thread must
                # never block (it is every parked connection's wakeup)
                self.pool.submit(conn.close)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._wake()
        self._thread.join(timeout=5.0)


class Server:
    def __init__(
        self,
        storage: Optional[Storage] = None,
        host: str = "127.0.0.1",
        port: int = 4000,
        default_db: str = "test",
        users: Optional[dict[str, str]] = None,
        allow_unknown_users: bool = True,
        max_connections: int = 512,
        status_port: Optional[int] = None,
        status_host: Optional[str] = None,
        skip_grant_table: bool = False,
        ssl_cert: Optional[str] = None,
        ssl_key: Optional[str] = None,
        ssl_ca: Optional[str] = None,
        auto_tls: bool = False,
        require_secure_transport: bool = False,
        proxy_protocol_networks: str = "",
        conn_workers: int = 0,
        device=None,
    ) -> None:
        self.storage = storage if storage is not None else Storage()
        self.host = host
        self.port = port
        self.default_db = default_db
        self.users = users if users is not None else {"root": ""}
        self.allow_unknown_users = allow_unknown_users
        self.max_connections = max_connections
        # where every connection's Session runs its coprocessor (None:
        # the card)
        self.device = device
        # HTTP status/metrics port (reference: server/http_status.go;
        # port 10080 by default there — here opt-in via status_port).
        # status_host lets operators keep /metrics on loopback while SQL
        # listens externally.
        self.status_port = status_port
        self.status_host = status_host if status_host is not None else host
        self._status_server = None
        # --skip-grant-table: every connection authenticates as an
        # all-privilege session regardless of credentials (reference:
        # privileges.SkipWithGrant; the account-lockout escape hatch)
        self.skip_grant_table = skip_grant_table
        # TLS (reference: server/server.go:227 LoadTLSCertificates +
        # auto-tls cert generation in config). ssl_cert/ssl_key load an
        # operator-provided pair; auto_tls generates an ephemeral
        # self-signed pair at startup. require_secure_transport rejects
        # plaintext connections like the MySQL sysvar.
        self.require_secure_transport = require_secure_transport
        self.ssl_ctx = self._build_ssl_ctx(ssl_cert, ssl_key, ssl_ca,
                                           auto_tls)
        if require_secure_transport and self.ssl_ctx is None:
            # with no TLS context every connection would be rejected —
            # an unrecoverable lockout; refuse to start instead
            raise RuntimeError(
                "require_secure_transport needs ssl-cert/ssl-key or "
                "auto-tls")
        # PROXY protocol (reference: server/server.go:273 wraps the
        # listener via go-proxyprotocol with an allowed-network list):
        # comma list of CIDRs/hosts the LB connects from, or "*" for any
        self.proxy_networks = self._parse_networks(proxy_protocol_networks)

        self._listener: Optional[socket.socket] = None
        self._conns: dict[int, ClientConn] = {}
        self._lock = threading.Lock()
        self._next_conn_id = 1
        self._shutdown = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._kill_thread: Optional[threading.Thread] = None
        # thread-light conn plane: worker-pool idle reserve
        # (performance.conn-worker-threads; 0 = auto)
        self.conn_workers = conn_workers or self.auto_conn_workers()
        self._pool: Optional[_WorkerPool] = None
        self._reactor: Optional[_Reactor] = None

    @staticmethod
    def auto_conn_workers() -> int:
        import os as _os
        return min(8, max(2, (_os.cpu_count() or 4) // 2))

    @staticmethod
    def _parse_networks(spec: str):
        if not spec:
            return None
        import ipaddress
        if spec.strip() == "*":
            return "*"
        nets = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "/" not in part:
                # single host: full-length prefix for its address family
                # (a bare IPv6 with /32 would trust 2^96 hosts)
                part += f"/{ipaddress.ip_address(part).max_prefixlen}"
            nets.append(ipaddress.ip_network(part, strict=False))
        return nets or None

    def proxy_expected(self, peer_ip: str) -> bool:
        """True when a PROXY header must precede this peer's stream."""
        if self.proxy_networks is None:
            return False
        if self.proxy_networks == "*":
            return True
        import ipaddress
        try:
            ip = ipaddress.ip_address(peer_ip)
        except ValueError:
            return False
        # dual-stack listeners report IPv4 peers as ::ffff:a.b.c.d
        mapped = getattr(ip, "ipv4_mapped", None)
        if mapped is not None:
            ip = mapped
        return any(
            ip in n for n in self.proxy_networks
            if n.version == ip.version)

    @staticmethod
    def _build_ssl_ctx(cert: Optional[str], key: Optional[str],
                       ca: Optional[str], auto_tls: bool):
        import ssl as _ssl
        if not cert and not auto_tls:
            return None
        ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        if ca:
            # security.ssl-ca: verify client certificates against the
            # operator CA when a client presents one (reference:
            # util.NewTLSConfig ClientCAs + VerifyClientCertIfGiven)
            ctx.load_verify_locations(cafile=ca)
            ctx.verify_mode = _ssl.CERT_OPTIONAL
        if cert:
            ctx.load_cert_chain(cert, key or cert)
            return ctx
        try:
            pem = _self_signed_pem()
        except Exception as e:  # noqa: BLE001 - cryptography unavailable
            # fail fast: a silent downgrade to plaintext (or, with
            # require_secure_transport, a server that rejects everyone
            # with no explanation) is worse than refusing to start
            raise RuntimeError(
                f"auto-tls certificate generation failed: {e!r}; "
                "provide ssl-cert/ssl-key or disable auto-tls") from e
        import tempfile
        with tempfile.NamedTemporaryFile(
                "wb", suffix=".pem", delete=False) as f:
            f.write(pem)
            path = f.name
        ctx.load_cert_chain(path, path)
        import os
        os.unlink(path)
        return ctx

    # ---- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Bind + start accepting in a background thread; returns once the
        listener is live (port readable via .port, 0 picks a free one)."""
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(128)
        self.port = ls.getsockname()[1]
        self._listener = ls
        self._pool = _WorkerPool(idle_cap=self.conn_workers)
        self._reactor = _Reactor(self, self._pool)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="titpu-mysql-accept", daemon=True)
        self._accept_thread.start()
        sv = self.storage.sysvars
        sv.set_config_default("require_secure_transport",
                              int(self.require_secure_transport))
        if self.ssl_ctx is not None:
            # reflect TLS support in the compat sysvars clients probe
            sv.set_config_default("have_ssl", "YES")
            sv.set_config_default("have_openssl", "YES")
        # KILL routing: sessions resolve KILL <id> through the storage
        self.storage.kill_router = self.kill
        # SHOW PROCESSLIST provider (reference: infoschema PROCESSLIST
        # rows built from the server's client connections)
        self.storage.processlist = self._processlist
        # KILL ownership lookup (the reference's ER_KILL_DENIED check)
        self.storage.conn_owner = self.conn_owner
        coord = self.storage.coord
        if coord is not None:
            coord.register_server(self.port, self.status_port)
            self._kill_thread = threading.Thread(
                target=self._kill_mailbox_loop, name="titpu-kill-mailbox",
                daemon=True)
            self._kill_thread.start()
        # a serving deployment samples its metrics ring in the
        # background (embedded stores sample on demand); Storage.close()
        # joins the thread
        self.storage.metrics_history.start()
        if self.status_port is not None:
            from .status import StatusServer
            self._status_server = StatusServer(self.status_host,
                                               self.status_port,
                                               sql_server=self)
            self._status_server.start()
            self.status_port = self._status_server.port

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._shutdown.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break  # listener closed
            with self._lock:
                if len(self._conns) >= self.max_connections:
                    conn = None
                else:
                    conn_id = self._next_conn_id
                    self._next_conn_id += 1
                    coord = self.storage.coord
                    if coord is not None:
                        # server-id-carrying global ids (reference:
                        # util/globalconn GCID; tests/globalkilltest)
                        conn_id = coord.global_conn_id(coord.node_id,
                                                       conn_id)
                    conn = ClientConn(self, sock, conn_id)
                    self.storage.obs.connections.inc()
                    self._conns[conn_id] = conn
            if conn is None:
                # connection gate: a clean ER_CON_COUNT_ERROR before any
                # handshake work — no salt, no auth, no session object
                # (reference: server.go onConn rejecting over the cap;
                # MySQL sends the ERR in place of the initial handshake)
                self._reject_connection(sock)
                continue
            # handshake runs on a pooled worker; once authenticated the
            # connection parks on the reactor and costs no thread until
            # its next command arrives
            self._pool.submit(conn.start)

    def _reject_connection(self, sock: socket.socket) -> None:
        """Send errno 1040 as the greeting and close. Best-effort under
        a short timeout so a stalled flood client cannot wedge the
        accept loop."""
        from . import packet as P
        self.storage.obs.conn_rejects.inc()
        try:
            sock.settimeout(1.0)
            payload = P.err_packet(1040, "Too many connections", "08004")
            sock.sendall(len(payload).to_bytes(3, "little") + b"\x00"
                         + payload)
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def deregister(self, conn_id: int) -> None:
        with self._lock:
            self._conns.pop(conn_id, None)

    def kill_connection(self, conn_id: int) -> bool:
        """KILL <id> semantics (reference: server/server.go:548)."""
        return self.kill(conn_id, query_only=False)

    def kill(self, conn_id: int, query_only: bool) -> bool:
        """KILL QUERY interrupts the running statement (the engine polls
        the session's kill flag between plan nodes); KILL CONNECTION also
        tears the socket down."""
        with self._lock:
            conn = self._conns.get(conn_id)
        if conn is None:
            return False
        conn.session.killed.set()
        if not query_only:
            conn.kill()
        return True

    def conn_owner(self, conn_id: int) -> Optional[str]:
        """The authenticated user of a live connection, or None when the
        id is unknown here (reference: server.go Kill checks SuperPriv ||
        same-user)."""
        with self._lock:
            conn = self._conns.get(conn_id)
        if conn is None:
            return None
        return conn.session.user or conn.user or ""

    def _kill_mailbox_loop(self) -> None:
        """Poll the coordinator's kill mailbox for requests addressed to
        this server (a socket follower's poll is an RPC that answers []
        while the leader is unreachable)."""
        coord = self.storage.coord
        while not self._shutdown.is_set():
            try:
                for local, query_only in coord.poll_kills():
                    self.kill(coord.global_conn_id(coord.node_id, local),
                              query_only)
            except OSError:
                pass
            self._shutdown.wait(0.1)

    def connection_count(self) -> int:
        with self._lock:
            return len(self._conns)

    def _processlist(self) -> list[tuple]:
        """(Id, User, Host, db, Command, Time, State, Info, Mem_max,
        Spill_count) per live connection; Host prefers the PROXY-header
        real client address. Mem_max is the LIVE statement tracker's
        peak while one is registered (so a statement the governor is
        about to kill shows its weight), else the last statement's —
        the after-the-fact explainability the governor kill policy
        needs (reference: infoschema PROCESSLIST's MEM column)."""
        with self._lock:
            conns = list(self._conns.values())
        rows = []
        for c in conns:
            s = c.session
            host = c.client_addr
            if host is None:
                try:
                    host = "%s:%s" % c.sock.getpeername()[:2]
                except OSError:
                    host = ""
            info = s.in_flight_sql
            t = int(time.time() - s.in_flight_since) \
                if info and s.in_flight_since else 0
            live = getattr(s, "_live_mem", None)
            mem = int(live.peak_footprint()) if live is not None \
                else int(getattr(s, "last_mem_peak", 0))
            spills = int(live.spill_count) if live is not None \
                else int(getattr(s, "last_spill_count", 0))
            rows.append((c.conn_id, c.user or s.user or "", host,
                         s.current_db, "Query" if info else "Sleep", t,
                         "" if info is None else "executing", info,
                         mem, spills))
        return rows

    def close(self, drain_timeout: float = 5.0) -> None:
        """Graceful shutdown: stop accepting, then drain/kill connections
        (reference: server/server.go:605 graceful down + :621 KillAll)."""
        self._shutdown.set()
        if self._status_server is not None:
            self._status_server.close()
            self._status_server = None
        if self._listener is not None:
            try:
                # shutdown wakes the accept loop's blocked accept() (a
                # bare close leaves that thread parked in the kernel)
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        t0 = time.monotonic()
        while time.monotonic() - t0 < drain_timeout:
            if self.connection_count() == 0:
                break
            time.sleep(0.05)
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            c.kill()
        if self._reactor is not None:
            self._reactor.close()
        if self._pool is not None:
            self._pool.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=1.0)
        if self._kill_thread is not None:
            self._kill_thread.join()
            self._kill_thread = None


def _self_signed_pem() -> bytes:
    """Ephemeral self-signed cert+key PEM for auto-TLS (the analog of the
    reference's auto-tls generated certificates)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([
        x509.NameAttribute(NameOID.COMMON_NAME, "TiDB-TPU auto TLS")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .sign(key, hashes.SHA256())
    )
    return (
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption())
        + cert.public_bytes(serialization.Encoding.PEM)
    )
