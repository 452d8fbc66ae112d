"""TLS and the PROXY protocol on the port's wire server, against the
reference's, packet for packet.

The cases of tests/test_tls.py and tests/test_proxy_protocol.py run
against the port's `Server(device="cpu")` and the reference's `Server`
side by side, each over its own in-memory store, through one raw client
that can send a PROXY header (v1 or v2) and upgrade to TLS with an
SSLRequest: every packet must be byte-equal (the greeting's salt and
connection id masked), and so must the ERR packets of a refused login
(3159 for plaintext under require_secure_transport, 1045 for a wrong
password over TLS), SHOW PROCESSLIST's rows (the PROXY header's address
as Host) and each server's `client_addr`. Most servers load the
self-signed pair under tests/data/ (for tests only); the auto-tls cases
need `cryptography`, as the reference's do. Every server is closed and
its threads joined (`test_torch_server._close`). Tolerance: none.
"""

from __future__ import annotations

import os
import socket
import ssl
import struct

import pytest

from mysql_client import _scramble
from test_torch_server import _close
from tidb_tpu.server import Server as RefServer
from tidb_tpu.server import server as ref_server_mod
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server import server as port_server_mod
from tidb_tpu_torch.store.storage import Storage

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CERT = os.path.join(DATA, "tls_test_cert.pem")
KEY = os.path.join(DATA, "tls_test_key.pem")
TLS = {"ssl_cert": CERT, "ssl_key": KEY}

V2_SIG = b"\r\n\r\n\x00\r\nQUIT\n"


def _v1(src: str) -> bytes:
    return f"PROXY TCP4 {src} 10.0.0.1 56324 4000\r\n".encode()


def _v2(src: str) -> bytes:
    body = socket.inet_aton(src) + socket.inet_aton("10.0.0.1") + \
        struct.pack(">HH", 55555, 4000)
    return V2_SIG + bytes([0x21, 0x11]) + struct.pack(">H", len(body)) + \
        body


def _v2_inet6(src: str) -> bytes:
    body = socket.inet_pton(socket.AF_INET6, src) + \
        socket.inet_pton(socket.AF_INET6, "::1") + \
        struct.pack(">HH", 55555, 4000)
    return V2_SIG + bytes([0x21, 0x21]) + struct.pack(">H", len(body)) + \
        body


class Wire:
    """A raw MySQL client: optional PROXY preamble and TLS upgrade; keeps
    every packet it reads."""

    def __init__(self, port: int, use_ssl: bool = False,
                 preamble: bytes = b"", user: str = "root",
                 password: str = "") -> None:
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=30)
        if preamble:
            self.sock.sendall(preamble)
        self.seq = 0
        self.tls = False
        self.greeting = self.read()
        self.auth = None
        if self.greeting[0] == 0xFF:
            return
        pos = self.greeting.index(b"\x00", 1) + 1
        salt = self.greeting[pos + 4:pos + 12] + \
            self.greeting[pos + 31:pos + 43]
        caps = 0x0F7FF
        if use_ssl:
            caps |= 0x800
            self.write(struct.pack("<IIB", caps, 2**24 - 1, 255)
                       + b"\x00" * 23)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock)
            self.tls = True
        auth = _scramble(password, salt) if password else b""
        self.write(struct.pack("<IIB", caps, 2**24 - 1, 255) + b"\x00" * 23
                   + user.encode() + b"\x00" + bytes([len(auth)]) + auth
                   + b"\x00")
        self.auth = self.read()

    def _recv(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("server closed the connection")
            out += chunk
        return out

    def read(self) -> bytes:
        head = self._recv(4)
        self.seq = (head[3] + 1) % 256
        return self._recv(int.from_bytes(head[:3], "little"))

    def write(self, payload: bytes) -> None:
        self.sock.sendall(len(payload).to_bytes(3, "little")
                          + bytes([self.seq]) + payload)
        self.seq = (self.seq + 1) % 256

    def masked_greeting(self) -> bytes:
        g = bytearray(self.greeting)
        if g[0] == 0xFF:
            return bytes(g)
        pos = g.index(b"\x00", 1) + 1
        g[pos:pos + 12] = b"\x00" * 12
        g[pos + 31:pos + 43] = b"\x00" * 12
        return bytes(g)

    def query(self, sql: str) -> list[bytes]:
        self.seq = 0
        self.write(b"\x03" + sql.encode())
        out = [self.read()]
        if out[0][0] in (0x00, 0xFF):
            return out
        out += [self.read() for _ in range(out[0][0] + 1)]
        while True:
            out.append(self.read())
            if out[-1][0] == 0xFF or (out[-1][0] == 0xFE
                                      and len(out[-1]) < 9):
                return out

    def close(self) -> None:
        try:
            self.seq = 0
            self.write(b"\x01")
        except OSError:
            pass
        self.sock.close()


def _pair(**kw):
    port = Server(Storage(), port=0, device="cpu", **kw)
    ref = RefServer(RefStorage(), port=0, **kw)
    port.start()
    ref.start()
    return port, ref


def _login(srv, **kw):
    """-> (client, its handshake packets)"""
    c = Wire(srv.port, **kw)
    return c, (c.masked_greeting(), c.auth, c.tls)


def _both(servers, sqls, **kw) -> list:
    """The same login and statements on each server: -> one list of
    (handshake, responses) per server."""
    out = []
    for srv in servers:
        c, hs = _login(srv, **kw)
        out.append((hs, [c.query(q) for q in sqls]))
        c.close()
    return out


def _conn_of(srv):
    with srv._lock:
        return next(iter(srv._conns.values()))


def test_tls_handshake_and_queries():
    servers = _pair(**TLS)
    try:
        assert all(s.ssl_ctx is not None for s in servers)
        got = _both(servers, [
            "select 1 + 1", "create table t (a int, b varchar(10))",
            "insert into t values (1, 'enc'), (2, 'rypted')",
            "select b from t order by a", "select @@have_ssl",
            "select @@require_secure_transport"], use_ssl=True)
        assert got[0][0][2] is True
        assert got[0] == got[1]
    finally:
        _close(*servers)


def test_plaintext_still_allowed_by_default():
    servers = _pair(**TLS)
    try:
        got = _both(servers, ["select 2 + 2"])
        assert got[0][0][2] is False
        assert got[0] == got[1]
    finally:
        _close(*servers)


def test_tls_with_password_auth():
    servers = _pair(users={"root": "", "alice": "secret"}, **TLS)
    try:
        got = _both(servers, ["select 1"], use_ssl=True, user="alice",
                    password="secret")
        assert got[0] == got[1]
        bad = [_login(s, use_ssl=True, user="alice", password="wrong")[1]
               for s in servers]
        assert bad[0][1][0] == 0xFF and bad[0] == bad[1]
    finally:
        _close(*servers)


def test_require_secure_transport_rejects_plaintext():
    servers = _pair(require_secure_transport=True, **TLS)
    try:
        refused = [_login(s)[1] for s in servers]
        assert struct.unpack_from("<H", refused[0][1], 1)[0] == 3159
        assert refused[0] == refused[1]
        got = _both(servers, ["select 5"], use_ssl=True)
        assert got[0] == got[1]
    finally:
        _close(*servers)


def test_set_global_require_secure_transport_takes_effect():
    """The enforcement reads the live sysvar, so SET GLOBAL flips it for
    new connections without a restart."""
    servers = _pair(**TLS)
    try:
        got = []
        for srv in servers:
            c, hs = _login(srv)
            seen = [hs, c.query("set global require_secure_transport = 1")]
            seen.append(_login(srv)[1])  # plaintext refused now
            c2, hs2 = _login(srv, use_ssl=True)
            seen += [hs2, c2.query(
                "set global require_secure_transport = 0")]
            c2.close()
            c3, hs3 = _login(srv)
            seen += [hs3, c3.query("select 7")]
            c3.close()
            c.close()
            got.append(seen)
        assert struct.unpack_from("<H", got[0][2][1], 1)[0] == 3159
        assert got[0] == got[1]
    finally:
        _close(*servers)


def test_require_secure_transport_without_tls_refuses_start():
    msgs = []
    for cls, st in ((RefServer, RefStorage), (Server, Storage)):
        with pytest.raises(RuntimeError) as e:
            cls(st(), port=0, require_secure_transport=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_client_against_non_tls_server_fails_cleanly():
    servers = _pair()
    try:
        assert all(s.ssl_ctx is None for s in servers)
        greetings = []
        for srv in servers:
            c = Wire(srv.port)
            # no CLIENT_SSL in the greeting: the client must not upgrade
            pos = c.greeting.index(b"\x00", 1) + 1 + 4 + 9
            assert not struct.unpack_from("<H", c.greeting, pos)[0] & 0x800
            greetings.append(c.masked_greeting())
            c.close()
        assert greetings[0] == greetings[1]
        got = _both(servers, ["select 3"])
        assert got[0] == got[1]
    finally:
        _close(*servers)


def test_auto_tls():
    """auto-tls mints an ephemeral pair with `cryptography`."""
    pytest.importorskip("cryptography")
    servers = _pair(auto_tls=True)
    try:
        got = _both(servers, ["select 1 + 1"], use_ssl=True)
        assert got[0][0][2] is True and got[0] == got[1]
    finally:
        _close(*servers)


def test_auto_tls_without_cryptography_refuses_start(monkeypatch):
    """A failed certificate minting refuses the start with the same
    RuntimeError on both packages; it never falls back to plaintext."""
    def missing():
        raise ModuleNotFoundError("No module named 'cryptography'")

    msgs = []
    for mod, cls, st in ((ref_server_mod, RefServer, RefStorage),
                         (port_server_mod, Server, Storage)):
        monkeypatch.setattr(mod, "_self_signed_pem", missing)
        with pytest.raises(RuntimeError) as e:
            cls(st(), port=0, auto_tls=True)
        msgs.append(str(e.value))
    assert "auto-tls certificate generation failed" in msgs[1]
    assert msgs[0] == msgs[1]


def test_ssl_ca_verifies_client_certificates_if_given():
    servers = _pair(ssl_ca=CERT, **TLS)
    try:
        modes = [s.ssl_ctx.verify_mode for s in servers]
        assert modes == [ssl.CERT_OPTIONAL, ssl.CERT_OPTIONAL]
        got = _both(servers, ["select 9"], use_ssl=True)
        assert got[0] == got[1]
    finally:
        _close(*servers)


@pytest.mark.parametrize("preamble,addr", [
    (_v1("203.0.113.7"), "203.0.113.7"),
    (_v2("198.51.100.9"), "198.51.100.9"),
    (_v2_inet6("2001:db8::7"), "2001:db8::7"),
    (b"PROXY UNKNOWN\r\n", None),
], ids=["v1", "v2", "v2-inet6", "v1-unknown"])
def test_proxy_header(preamble, addr):
    """The real client address replaces the socket peer: client_addr,
    and SHOW PROCESSLIST's Host."""
    servers = _pair(proxy_protocol_networks="*")
    try:
        got = []
        for srv in servers:
            c, hs = _login(srv, preamble=preamble)
            first = c.query("select 1 + 1")
            assert _conn_of(srv).client_addr == addr
            plist = c.query("show processlist")
            got.append((hs, first, plist))
            c.close()
        if addr is not None:
            assert addr.encode() in b"".join(got[1][2])
            assert got[0] == got[1]
        else:
            # the socket peer's ephemeral port differs: compare the rest
            assert got[0][:2] == got[1][:2]
            assert len(got[0][2]) == len(got[1][2])
    finally:
        _close(*servers)


@pytest.mark.parametrize("preamble", [
    b"", b"PROXY TCP4 " + b"9" * 120 + b"\r\n",
    V2_SIG[:6] + b"\nQUIX\n" + b"\x21\x11\x00\x0c",
    V2_SIG + b"\x21\x11\x00\x40" + b"\x00" * 8,
], ids=["bare", "v1-too-long", "v2-bad-signature", "v2-truncated"])
def test_proxy_network_requires_a_header(preamble):
    """A connection from an allowed LB network that sends no valid
    header is dropped by both servers, never misparsed."""
    servers = _pair(proxy_protocol_networks="*")
    try:
        for srv in servers:
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=10)
            try:
                s.sendall(preamble or b"\x00" * 16)
                if preamble.startswith(V2_SIG):
                    s.shutdown(socket.SHUT_WR)  # the v2 body ends early
                try:
                    data = s.recv(4)
                except socket.timeout:
                    pytest.fail("the connection was not dropped")
                except OSError:
                    data = b""  # reset
                assert data == b""
            finally:
                s.close()
    finally:
        _close(*servers)


def test_non_proxy_network_unaffected():
    servers = _pair(proxy_protocol_networks="192.0.2.0/24")
    try:
        got = _both(servers, ["select 3"])
        assert got[0] == got[1]
    finally:
        _close(*servers)


def test_proxy_then_tls():
    servers = _pair(proxy_protocol_networks="*", **TLS)
    try:
        got = []
        for srv in servers:
            c, hs = _login(srv, use_ssl=True,
                           preamble=_v1("203.0.113.8"))
            got.append((hs, c.query("select 5"), _conn_of(srv).client_addr))
            c.close()
        assert got[0][0][2] is True and got[0][2] == "203.0.113.8"
        assert got[0] == got[1]
    finally:
        _close(*servers)


@pytest.mark.parametrize("spec", [
    "", "*", " * ", "10.0.0.0/8", "127.0.0.1", "192.0.2.0/24, 10.1.2.3",
    "::1", "2001:db8::/32,127.0.0.1", ",",
])
def test_proxy_networks_match(spec):
    peers = ["127.0.0.1", "10.9.9.9", "192.0.2.44", "::1",
             "::ffff:127.0.0.1", "2001:db8::5", "not-an-ip"]
    ref = RefServer(RefStorage(), port=0, proxy_protocol_networks=spec)
    port = Server(Storage(), port=0, device="cpu",
                  proxy_protocol_networks=spec)
    assert [ref.proxy_expected(p) for p in peers] == \
        [port.proxy_expected(p) for p in peers]
    assert str(RefServer._parse_networks(spec)) == \
        str(Server._parse_networks(spec))
