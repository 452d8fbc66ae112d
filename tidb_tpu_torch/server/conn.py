"""Per-connection handler: handshake, auth, command dispatch loop.

Port of `tidb_tpu/server/conn.py`, with the SSLRequest upgrade,
require_secure_transport and the PROXY protocol (v1 and v2). A statement
error answers as an ERR packet, as the reference's does; a device or
kernel fault (a RuntimeError that carries no errno) is not a statement
error, and closes the connection instead.

Counterpart of the reference's clientConn (reference: server/conn.go —
handshake :235, readOptionalSSLRequestAndHandshakeResponse :665, command
loop Run :725, dispatch :929, handleQuery :1409, writeResultset :1718).
mysql_native_password auth: scramble = SHA1(pwd) XOR SHA1(salt +
SHA1(SHA1(pwd))); with an empty server-side password any client response
is accepted (the bootstrap root account, like the reference's default).
"""

from __future__ import annotations

import hashlib
import secrets
import struct
import threading
import traceback
from typing import TYPE_CHECKING, Optional

from ..errno import CodedError, error_of
from ..session.session import ResultSet, Session
from . import packet as P

if TYPE_CHECKING:
    from .server import Server

SERVER_VERSION = "5.7.25-TiDB-TPU-v0.1"

_CAPS = (P.CLIENT_LONG_PASSWORD | P.CLIENT_LONG_FLAG
         | P.CLIENT_CONNECT_WITH_DB | P.CLIENT_PROTOCOL_41
         | P.CLIENT_TRANSACTIONS | P.CLIENT_SECURE_CONNECTION
         | P.CLIENT_MULTI_STATEMENTS | P.CLIENT_MULTI_RESULTS
         | P.CLIENT_PLUGIN_AUTH)


class _SockIO:
    """Exact-length socket reads for PacketIO. A buffered makefile reader
    would be faster per syscall but over-reads: at the TLS upgrade the
    client's first handshake bytes can land in the Python buffer while
    ssl wraps the raw fd — a deadlock. recv(n) never takes more than the
    current packet needs, so the upgrade sees a clean socket and the
    reactor's readability check sees every byte."""

    __slots__ = ("sock", "_wbuf")

    def __init__(self, sock) -> None:
        self.sock = sock
        self._wbuf = bytearray()

    def read(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                break
            buf += chunk
        return bytes(buf)

    def write(self, data: bytes) -> None:
        # buffer until flush: the command loop flushes once per command,
        # so a large resultset coalesces instead of one send per row
        self._wbuf += data
        if len(self._wbuf) >= 1 << 16:
            self.flush()

    def flush(self) -> None:
        if self._wbuf:
            self.sock.sendall(self._wbuf)
            self._wbuf.clear()


class ClientConn:
    def __init__(self, server: "Server", sock, conn_id: int) -> None:
        self.server = server
        self.sock = sock
        self.conn_id = conn_id
        self.session = Session(server.storage, db=server.default_db,
                               device=server.device)
        self.session.conn_id = conn_id
        sio = _SockIO(sock)
        self.io = P.PacketIO(sio, sio)
        self.salt = secrets.token_bytes(20)
        self.capabilities = 0
        self.user = ""
        self.alive = True
        # stmt_id -> (n_params, bound param types from the last EXECUTE)
        self._stmt_meta: dict[int, tuple[int, Optional[list]]] = {}
        self.killed = threading.Event()
        # reactor bookkeeping: when this conn last parked idle
        # (@@wait_timeout reaping reads it on the sweep)
        self.parked_at = 0.0
        self.tls = False
        self.client_addr: Optional[str] = None  # PROXY-header real client

    # ---- handshake ---------------------------------------------------------
    def _caps(self) -> int:
        caps = _CAPS
        if self.server.ssl_ctx is not None:
            caps |= P.CLIENT_SSL
        return caps

    def _secure_transport_required(self) -> bool:
        """Live sysvar, not the constructor flag: SET GLOBAL
        require_secure_transport takes effect for new connections (the
        server start mirrors its config flag into the sysvar default)."""
        v = self.server.storage.sysvars.get_global(
            "require_secure_transport")
        return str(v).lower() in ("1", "on", "true", "yes")

    def write_initial_handshake(self) -> None:
        payload = (
            b"\x0a" + SERVER_VERSION.encode() + b"\x00"
            + struct.pack("<I", self.conn_id)
            + self.salt[:8] + b"\x00"
            + struct.pack("<H", self._caps() & 0xFFFF)
            + bytes([P._CHARSET_UTF8MB4 & 0xFF])
            + struct.pack("<H", P.SERVER_STATUS_AUTOCOMMIT)
            + struct.pack("<H", (self._caps() >> 16) & 0xFFFF)
            + bytes([21])  # auth plugin data length
            + b"\x00" * 10
            + self.salt[8:20] + b"\x00"
            + b"mysql_native_password\x00"
        )
        self.io.write_packet(payload)
        self.io.flush()

    def read_handshake_response(self) -> None:
        data = self.io.read_packet()
        caps = struct.unpack_from("<I", data, 0)[0]
        if caps & P.CLIENT_SSL and self.server.ssl_ctx is not None \
                and len(data) <= 32:
            # SSLRequest (reference: server/conn.go:665
            # readOptionalSSLRequestAndHandshakeResponse): upgrade the
            # socket, keep the packet sequence running, then read the
            # real (now encrypted) handshake response
            seq = self.io.sequence
            self.sock = self.server.ssl_ctx.wrap_socket(
                self.sock, server_side=True)
            sio = _SockIO(self.sock)
            self.io = P.PacketIO(sio, sio)
            self.io.sequence = seq
            self.tls = True
            data = self.io.read_packet()
            caps = struct.unpack_from("<I", data, 0)[0]
        self.capabilities = caps
        if self._secure_transport_required() and not self.tls:
            from ..errno import ER_SECURE_TRANSPORT_REQUIRED
            self.io.write_packet(P.err_packet(
                ER_SECURE_TRANSPORT_REQUIRED,
                "Connections using insecure transport are "
                "prohibited while --require_secure_transport=ON.",
                "HY000"))
            self.io.flush()
            raise ConnectionError("insecure transport rejected")
        pos = 4 + 4 + 1 + 23  # caps, max packet, charset, filler
        end = data.index(b"\x00", pos)
        self.user = data[pos:end].decode()
        pos = end + 1
        if caps & P.CLIENT_SECURE_CONNECTION:
            alen = data[pos]
            auth = data[pos + 1:pos + 1 + alen]
            pos += 1 + alen
        else:
            end = data.index(b"\x00", pos)
            auth = data[pos:end]
            pos = end + 1
        db = None
        if caps & P.CLIENT_CONNECT_WITH_DB and pos < len(data):
            end = data.index(b"\x00", pos)
            db = data[pos:end].decode()
            pos = end + 1
        if not self._check_auth(self.user, auth):
            self.io.write_packet(P.err_packet(
                1045, f"Access denied for user '{self.user}'", "28000"))
            self.io.flush()
            raise ConnectionError("auth failed")
        if db:
            try:
                self.session.catalog.schema(db)
                self.session.current_db = db
            except KeyError:
                pass
        self.io.write_packet(P.ok_packet())
        self.io.flush()

    def _check_auth(self, user: str, auth: bytes) -> bool:
        """Server-config accounts (operator-provisioned, incl. the root
        bootstrap password) take precedence — otherwise the grant-table
        root row (empty auth) would accept any password. Accounts created
        in the grant table verify against their stored double-SHA1
        (reference: privilege/privileges/privileges.go auth + cache)."""
        if self.server.skip_grant_table:
            # --skip-grant-table: accept anyone as an unchecked internal
            # session (reference: privileges.SkipWithGrant)
            return True
        pwd = self.server.users.get(user)
        if pwd is not None:
            if pwd == "":
                return True
            want = _native_scramble(pwd, self.salt)
            return secrets.compare_digest(want, auth)
        pm = self.server.storage.privileges
        if pm.exists(user):
            ok = pm.verify_native(user, self.salt, auth)
            if ok:
                self.session.user = user
                # login activates the account's DEFAULT roles (MySQL
                # semantics with activate_all_roles_on_login=OFF)
                self.session.active_roles = pm.default_roles(user)
            return ok
        return self.server.allow_unknown_users

    # ---- PROXY protocol ----------------------------------------------------
    def _read_proxy_header(self) -> None:
        """Consume a PROXY protocol v1/v2 header when the peer is a
        configured load balancer (reference: server/server.go:273 wraps
        the listener in go-proxyprotocol). The real client address
        replaces the socket peer for observability. The LB sends the
        header before any MySQL bytes, so reading it first is safe even
        though MySQL is a server-speaks-first protocol."""
        try:
            peer = self.sock.getpeername()[0]
        except OSError:
            return
        if not self.server.proxy_expected(peer):
            return
        sio = _SockIO(self.sock)
        sig = sio.read(6)
        if sig == b"PROXY ":
            line = bytearray()
            while not line.endswith(b"\r\n"):
                if len(line) >= 101:  # v1 max line is 107 bytes total
                    raise ConnectionError("PROXY v1 line too long")
                c = sio.read(1)
                if not c:
                    raise ConnectionError("truncated PROXY header")
                line += c
            parts = line[:-2].decode("ascii", "replace").split()
            # TCP4/TCP6 src dst sport dport | UNKNOWN
            if len(parts) >= 4 and parts[0] in ("TCP4", "TCP6"):
                self.client_addr = parts[1]
            return
        if sig == b"\r\n\r\n\x00\r":
            rest = sio.read(6)  # remaining v2 signature
            if rest != b"\nQUIT\n":
                raise ConnectionError("bad PROXY v2 signature")
            hdr = sio.read(4)  # ver/cmd, family, length (BE16)
            if len(hdr) < 4:
                raise ConnectionError("truncated PROXY v2 header")
            ln = int.from_bytes(hdr[2:4], "big")
            body = sio.read(ln)
            if len(body) < ln:
                raise ConnectionError("truncated PROXY v2 body")
            fam = hdr[1] >> 4
            if fam == 1 and ln >= 12:  # AF_INET
                import socket as _s
                self.client_addr = _s.inet_ntoa(body[0:4])
            elif fam == 2 and ln >= 36:  # AF_INET6
                import socket as _s
                self.client_addr = _s.inet_ntop(_s.AF_INET6, body[0:16])
            return
        raise ConnectionError(
            "connection from a proxy-protocol network sent no PROXY "
            "header")

    # ---- command loop ------------------------------------------------------
    def _idle_timeout(self) -> Optional[float]:
        """@@wait_timeout as the socket read deadline for the NEXT
        command (reference: server/conn.go Run reads under the
        wait_timeout deadline; MySQL reaps idle connections the same
        way). Re-read every iteration so SET SESSION wait_timeout takes
        effect for the following wait. None/<=0 disables."""
        try:
            v = self.session._sysvar_value("wait_timeout")
            secs = float(v) if v not in (None, "") else 0.0
        except Exception:  # noqa: BLE001 — a bad value must not reap
            return None
        return secs if secs > 0 else None

    def start(self) -> None:
        """Handshake on a pooled worker, then park on the reactor: an
        authenticated-but-idle connection costs no thread (reference
        contrast: server/conn.go Run holds a goroutine per conn; the
        OS-thread analog stopped scaling at max-server-connections)."""
        try:
            self._read_proxy_header()
            self.write_initial_handshake()
            self.read_handshake_response()
        except Exception:  # noqa: BLE001 — malformed handshakes must
            self.close()   # never leak a registered connection
            return
        self._park_or_continue()

    def _park_or_continue(self) -> None:
        """After the handshake: serve immediately-pipelined commands on
        this worker, else park."""
        if self._buffered_input():
            self.serve_ready()
        else:
            self._park()

    def _park(self) -> None:
        """Hand the socket to the reactor; no thread is held while the
        connection idles. Bytes that race this hand-off are safe: the
        selector sees them the moment the fd registers. (TLS is the
        exception — decrypted-but-unread records are invisible to the
        selector — which is why callers check _buffered_input first.)"""
        if not self.alive or self.killed.is_set():
            self.close()
            return
        reactor = getattr(self.server, "_reactor", None)
        if reactor is None:
            self.close()
            return
        reactor.park(self)

    def _buffered_input(self) -> bool:
        pending = getattr(self.sock, "pending", None)
        if pending is not None:
            try:
                if pending():
                    return True
            except (OSError, ValueError):
                return False
        import select as _select
        try:
            r, _, _ = _select.select([self.sock], [], [], 0)
        except (OSError, ValueError):
            return False
        return bool(r)

    def serve_ready(self) -> None:
        """Serve the commands available on the socket, then re-park.
        Runs on a pool worker; the blocking packet read only continues
        a command whose first bytes already arrived (the reactor woke
        us), so a slow statement — not an idle connection — is the only
        thing that holds a worker."""
        try:
            while self.alive and not self.killed.is_set():
                self.io.reset_sequence()
                try:
                    # the reactor only wakes us when the FIRST bytes
                    # arrived; the rest of the packet reads under the
                    # wait_timeout deadline so a stalled half-packet
                    # (slowloris) cannot pin a pool worker forever —
                    # the same reap the parked sweep applies. The
                    # statement itself runs with no deadline (below).
                    self.sock.settimeout(self._idle_timeout())
                    data = self.io.read_packet()
                except (ConnectionError, OSError, ValueError):
                    self.close()
                    return
                finally:
                    try:
                        self.sock.settimeout(None)
                    except OSError:
                        pass
                if not data:
                    self.close()
                    return
                if not self.dispatch(data[0], data[1:]):
                    self.close()
                    return
                self.io.flush()
                if not self._buffered_input():
                    break
            self._park()
        except Exception as e:  # noqa: BLE001 — a reactor-served conn
            # must close, or a malformed payload (UnicodeDecodeError from
            # COM_QUERY bytes, struct.error from a short COM_STMT frame)
            # leaks a zombie holding its txn locks forever
            if _device_fault(e):
                traceback.print_exception(e)
            self.close()

    def dispatch(self, cmd: int, payload: bytes) -> bool:
        if cmd == P.COM_QUIT:
            return False
        if cmd == P.COM_PING:
            self.io.write_packet(P.ok_packet(status=self._status()))
            return True
        if cmd == P.COM_INIT_DB:
            return self._com_init_db(payload)
        if cmd == P.COM_QUERY:
            return self._com_query(payload.decode("utf-8"))
        if cmd == P.COM_STMT_PREPARE:
            return self._com_stmt_prepare(payload.decode("utf-8"))
        if cmd == P.COM_STMT_EXECUTE:
            return self._com_stmt_execute(payload)
        if cmd == P.COM_STMT_CLOSE:
            sid = struct.unpack_from("<I", payload, 0)[0]
            self.session.close_prepared(sid)
            self._stmt_meta.pop(sid, None)
            return True  # COM_STMT_CLOSE sends no response
        if cmd == P.COM_STMT_RESET:
            self.io.write_packet(P.ok_packet(status=self._status()))
            return True
        if cmd == P.COM_FIELD_LIST:
            # deprecated command: empty column list terminator
            self.io.write_packet(P.eof_packet(status=self._status()))
            return True
        self.io.write_packet(P.err_packet(
            1047, f"Unknown command {cmd:#x}", "08S01"))
        return True

    def _com_init_db(self, payload: bytes) -> bool:
        db = payload.decode("utf-8")
        try:
            self.session.catalog.schema(db)
        except KeyError:
            self.io.write_packet(P.err_packet(
                1049, f"Unknown database '{db}'", "42000"))
            return True
        self.session.current_db = db
        self.io.write_packet(P.ok_packet(status=self._status()))
        return True

    def _com_query(self, sql: str) -> bool:
        try:
            rs = self.session.execute(sql)
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._write_error(e)
            return True
        self._write_resultset(rs)
        return True

    def _write_error(self, e: Exception) -> None:
        """A statement error answers as an ERR packet; a device fault
        re-raises, and serve_ready closes the connection."""
        if _device_fault(e):
            raise e
        code, state = error_of(e)
        self.io.write_packet(P.err_packet(code, str(e), state))

    def _write_resultset(self, rs: ResultSet, binary: bool = False) -> None:
        if not rs.column_names:
            self.io.write_packet(P.ok_packet(
                affected=rs.affected, status=self._status()))
            return
        self.io.write_packet(P.lenenc_int(len(rs.column_names)))
        types = rs.column_types or [None] * len(rs.column_names)
        for name, ft in zip(rs.column_names, types):
            self.io.write_packet(P.column_def(name, ft))
        self.io.write_packet(P.eof_packet(status=self._status()))
        for row in rs.rows:
            self.io.write_packet(
                P.binary_row(row, types) if binary else P.text_row(row))
        self.io.write_packet(P.eof_packet(status=self._status()))

    # ---- prepared statements (reference: server/conn_stmt.go) ----------
    def _com_stmt_prepare(self, sql: str) -> bool:
        try:
            sid, n_params = self.session.prepare(sql)
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._write_error(e)
            return True
        self._stmt_meta[sid] = (n_params, None)
        self.io.write_packet(P.stmt_prepare_ok(sid, 0, n_params))
        if n_params:
            for i in range(n_params):
                self.io.write_packet(P.column_def(f"?{i}", None))
            self.io.write_packet(P.eof_packet(status=self._status()))
        return True

    def _com_stmt_execute(self, payload: bytes) -> bool:
        sid = struct.unpack_from("<I", payload, 0)[0]
        meta = self._stmt_meta.get(sid)
        if meta is None:
            self.io.write_packet(P.err_packet(
                1243, f"Unknown prepared statement handler ({sid})"))
            return True
        n_params, prev_types = meta
        pos = 9  # stmt_id(4) + flags(1) + iteration count(4)
        try:
            params: list = []
            if n_params:
                params, types = P.decode_binary_params(
                    payload, pos, n_params, prev_types)
                self._stmt_meta[sid] = (n_params, types)
            rs = self.session.execute_prepared(sid, params)
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._write_error(e)
            return True
        self._write_resultset(rs, binary=True)
        return True

    def _status(self) -> int:
        s = P.SERVER_STATUS_AUTOCOMMIT
        if self.session.in_explicit_txn:
            s |= P.SERVER_STATUS_IN_TRANS
        return s

    def kill(self) -> None:
        """Kill this connection (reference: server/server.go:548 Kill)."""
        self.killed.set()
        try:
            self.sock.shutdown(2)
        except OSError:
            pass

    def close(self) -> None:
        self.alive = False
        reactor = getattr(self.server, "_reactor", None)
        if reactor is not None:
            # drop our selector key before the fd closes (a closed fd
            # in the selector map would poison every later select)
            reactor.discard(self)
        try:
            self.session.rollback_if_active()
        except Exception:  # noqa: BLE001
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.server.deregister(self.conn_id)


def _native_scramble(password: str, salt: bytes) -> bytes:
    """mysql_native_password: SHA1(pwd) XOR SHA1(salt + SHA1(SHA1(pwd)))."""
    p1 = hashlib.sha1(password.encode()).digest()
    p2 = hashlib.sha1(p1).digest()
    p3 = hashlib.sha1(salt + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, p3))


def _device_fault(e: BaseException) -> bool:
    """A torch, CUDA or kernel error (RuntimeError without an errno), as
    opposed to a statement's error."""
    return isinstance(e, RuntimeError) and not isinstance(e, CodedError)
