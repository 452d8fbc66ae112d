"""The port's MySQL wire server against the reference's, byte for byte.

The port's `Server(device="cpu")` and the reference's `Server` run side by
side, each over its own in-memory store; one statement corpus goes to both
through a raw client built on tests/mysql_client.py's encoding, and every
response packet must be byte-equal: DDL, DML, explicit transactions, an
error per errno class, NULLs and every column type rendered (text and
binary protocol), SHOW, information_schema reads and online DDL (ALTER
TABLE, CREATE INDEX, a unique index that fails), prepared statements,
COM_PING, COM_INIT_DB (to a database that does not exist, too) and KILL.
Only the handshake's salt and connection id are masked. Auth, the 1040
gate, @@wait_timeout reaping and KILL CONNECTION are checked on both
servers as in tests/test_server.py and tests/test_conn_plane.py. Every
server is closed and its threads joined.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import pytest

from mysql_client import MiniClient, MySQLError, _scramble
from tidb_tpu.server import Server as RefServer
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.store.storage import Storage

USERS = {"root": "", "alice": "secret"}


class Raw:
    """A MySQL client that returns each response as its raw packets."""

    def __init__(self, port: int, user: str = "root", password: str = "",
                 db: str = "") -> None:
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        self.rfile = self.sock.makefile("rb")
        self.seq = 0
        self.greeting = self.read()
        if self.greeting[0] == 0xFF:
            return  # refused at the connection gate
        pos = self.greeting.index(b"\x00", 1) + 1
        self.conn_id = struct.unpack_from("<I", self.greeting, pos)[0]
        salt = self.greeting[pos + 4:pos + 12] + \
            self.greeting[pos + 31:pos + 43]
        auth = _scramble(password, salt) if password else b""
        self.write(struct.pack("<IIB", 0x0F7FF, 2**24 - 1, 255)
                   + b"\x00" * 23 + user.encode() + b"\x00"
                   + bytes([len(auth)]) + auth + db.encode() + b"\x00")
        self.auth = self.read()

    def masked_greeting(self) -> bytes:
        """The greeting with its connection id and salt zeroed."""
        g = bytearray(self.greeting)
        pos = g.index(b"\x00", 1) + 1
        g[pos:pos + 12] = b"\x00" * 12          # id + salt part 1
        g[pos + 31:pos + 43] = b"\x00" * 12     # salt part 2
        return bytes(g)

    def read(self) -> bytes:
        head = self.rfile.read(4)
        if len(head) < 4:
            raise ConnectionError("server closed the connection")
        self.seq = (head[3] + 1) % 256
        return self.rfile.read(int.from_bytes(head[:3], "little"))

    def write(self, payload: bytes) -> None:
        self.sock.sendall(len(payload).to_bytes(3, "little")
                          + bytes([self.seq]) + payload)

    def command(self, cmd: int, payload: bytes = b"",
                kind: str = "query") -> list[bytes]:
        self.seq = 0
        self.write(bytes([cmd]) + payload)
        if kind == "none":
            return []
        out = [self.read()]
        if kind == "single" or out[0][0] == 0xFF or (
                out[0][0] == 0x00 and kind in ("query", "execute")):
            return out
        if kind == "prepare":
            ncols, nparams = struct.unpack_from("<HH", out[0], 5)
            for n in (nparams, ncols):
                if n:
                    out += [self.read() for _ in range(n + 1)]
            return out
        out += [self.read() for _ in range(out[0][0] + 1)]  # defs + EOF
        while True:
            out.append(self.read())
            if out[-1][0] == 0xFF or (out[-1][0] == 0xFE
                                      and len(out[-1]) < 9):
                return out

    def query(self, sql: str) -> list[bytes]:
        return self.command(0x03, sql.encode())

    def close(self) -> None:
        try:
            self.command(0x01, kind="none")
        except OSError:
            pass
        self.sock.close()


def _execute_payload(stmt_id: int, params: list) -> bytes:
    """COM_STMT_EXECUTE with every parameter's type bound."""
    nb = bytearray((len(params) + 7) // 8)
    types, values = b"", b""
    for i, v in enumerate(params):
        if v is None:
            nb[i // 8] |= 1 << (i % 8)
            types += struct.pack("<BB", 6, 0)  # MYSQL_TYPE_NULL
        elif isinstance(v, int):
            types += struct.pack("<BB", 8, 0)
            values += struct.pack("<q", v)
        elif isinstance(v, float):
            types += struct.pack("<BB", 5, 0)
            values += struct.pack("<d", v)
        else:
            b = str(v).encode()
            types += struct.pack("<BB", 253, 0)
            values += bytes([len(b)]) + b
    return (struct.pack("<IBI", stmt_id, 0, 1)
            + (bytes(nb) + b"\x01" + types + values if params else b""))


def _servers(**kw):
    port = Server(Storage(), port=0, device="cpu", **kw)
    ref = RefServer(RefStorage(), port=0, **kw)
    port.start()
    ref.start()
    return port, ref


def _close(*servers) -> None:
    """Close each server (its close joins its reactor and workers) and
    join its accept thread. The reference's close leaves that thread
    blocked in accept() on the closed listener, so its listener is shut
    down first, as the port's close does; and each package's start runs
    its store's metrics-history sampler, which only `Storage.close`
    stops, so that sampler is stopped here (these in-memory stores are
    never closed)."""
    for srv in servers:
        if isinstance(srv, RefServer) and srv._listener is not None:
            try:
                srv._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            # its accept thread may still be starting the worker it
            # spawned for the last connection, and the reference's pool
            # close joins every worker it spawned, started or not: let
            # that thread end first
            srv._accept_thread.join(timeout=5.0)
        srv.close(drain_timeout=0.2)
        srv._accept_thread.join(timeout=5.0)
        assert not srv._accept_thread.is_alive()
        srv.storage.metrics_history.stop()
        assert not srv.storage.metrics_history.running


COLUMNS = ("a tinyint, b smallint, c int, d bigint primary key, e float, "
           "f double, g decimal(10,3), h date, i datetime, j varchar(20), "
           "k char(4), l boolean, m text, n year, o timestamp")

CORPUS = [
    "select 1 + 1",
    "select 1/0, null, 'x', 1.5e3, -7, 2.50",
    "create database d1",
    "create database d1",
    f"create table ty ({COLUMNS})",
    "insert into ty values (1, 2, 3, 4, 1.5, 2.25, 12.345, '2024-02-29', "
    "'2024-02-29 12:34:56', 'abc', 'xy', true, 'long text', 2024, "
    "'2020-01-01 00:00:00')",
    "insert into ty (d) values (5), (6)",
    "insert into ty (d, a, j) values (7, -128, ''), (8, 127, 'z')",
    "select * from ty order by d",
    "select a, g, h, i, j from ty where d = 4",
    "select count(*), sum(g), avg(c), min(h), max(j) from ty",
    "select d, j is null, coalesce(j, 'none') from ty order by d desc",
    # an error of each class the wire must encode
    "select * from nope",
    "select nope from ty",
    "selec 1",
    "insert into ty (d) values (4)",
    "insert into ty (d) values (1, 2)",
    "set no_such_var = 1",
    "drop database nope",
    "create table ty (x int)",
    "create table nn (id int primary key, v int not null)",
    "insert into nn values (1, null)",
    "select @@no_such_sysvar",
    # DML and transactions (the status flags of OK packets)
    "insert into ty (d, a) values (9, null)",
    "update ty set c = c + 1 where d = 4",
    "update ty set c = 0 where d > 100",
    "delete from ty where d = 5",
    "replace into ty (d, j) values (6, 'replaced')",
    "insert into ty (d, c) values (6, 1) on duplicate key update c = c + 10",
    "begin",
    "insert into ty (d) values (10)",
    "select count(*) from ty",
    "rollback",
    "begin",
    "insert into ty (d) values (11)",
    "update ty set j = 'in txn' where d = 11",
    "commit",
    "start transaction",
    "select j from ty where d = 11 for update",
    "commit",
    "select d, j from ty order by d",
    "set @x = 5",
    "select @x + 1, @@autocommit, @@wait_timeout",
    "set session wait_timeout = 100",
    "select @@session.wait_timeout",
    "explain select * from ty where d = 4",
    "truncate table nn",
    "select count(*) from nn",
    "kill 999",
    "kill query 999",
    "drop table ty",
    "drop table ty",
    "use d1",
    "use nope",
    "create table t2 (id int primary key, s varchar(8))",
    "insert into t2 values (1, 'a'), (2, NULL)",
    "select * from t2 order by id",
    # the schema surface: SHOW, information_schema and online DDL
    "show tables",
    "show create table t2",
    "select table_name, column_name, data_type, column_type from "
    "information_schema.columns where table_schema = 'd1' "
    "order by table_name, ordinal_position",
    "alter table t2 add column c int default 3",
    "create index ks on t2 (s)",
    "create unique index ks2 on t2 (c)",
    "select * from t2 order by id",
    "show index from t2",
    "select table_name, table_rows from information_schema.tables "
    "where table_schema = 'd1'",
]


PREPARED = [
    ("select ? + 1, ?", [41, "x"]),
    ("select ? + 1, ?", [None, 2.5]),
    ("select 1 + 1", []),
    ("create table p (id bigint primary key, v varchar(10), f double, "
     "g decimal(6,2), h date)", []),
    ("insert into p values (?, ?, ?, ?, ?)", [1, "one", 1.25, "3.50",
                                              "2020-02-02"]),
    ("insert into p values (?, ?, ?, ?, ?)", [2, None, None, None, None]),
    ("select * from p where id = ?", [1]),
    ("select * from p order by id", []),
    ("update p set v = ? where id = ?", ["two", 2]),
    ("select id, v from p where v = ?", ["two"]),
    ("insert into p values (?, ?, ?, ?, ?)", [1, "dup", 0.0, "0", None]),
    ("select * from nope where id = ?", [1]),
    ("selec ?", [1]),
]



COMMANDS = [(0x0E, b""), (0x02, b"nope"), (0x02, b"test"),
            (0x1A, b"\x01\x00\x00\x00"), (0x04, b"t2\x00"), (0x7F, b"")]


def _session_script(srv) -> dict:
    """Everything the byte-equal tests compare, from one server: the
    greeting, auth answers, the corpus, the commands, prepared
    statements and KILL, each as its raw response packets."""
    c1, c2 = Raw(srv.port), Raw(srv.port)
    out = {"greeting": c1.masked_greeting(), "auth": [c1.auth]}
    for user, pw in (("alice", "secret"), ("alice", "wrong"),
                     ("mallory", "x")):
        c = Raw(srv.port, user, pw)
        out["auth"].append(c.auth)
        c.close()
    out["corpus"] = [c1.query(sql) for sql in CORPUS]
    out["commands"] = [c1.command(cmd, payload, kind="single")
                       for cmd, payload in COMMANDS]
    out["prepared"] = []
    for sql, params in PREPARED:
        prep = c1.command(0x16, sql.encode(), kind="prepare")
        resp = [prep]
        if prep[0][0] == 0x00:
            sid = struct.unpack_from("<I", prep[0], 1)[0]
            resp.append(c1.command(0x17, _execute_payload(sid, params),
                                   kind="execute"))
            resp.append(c1.command(0x19, struct.pack("<I", sid),
                                   kind="none"))
            # executing a closed statement answers 1243
            resp.append(c1.command(0x17, _execute_payload(sid, params),
                                   kind="execute"))
        out["prepared"].append(resp)
    # KILL QUERY of an idle connection, then KILL (CONNECTION) of it
    c1.query("use test")
    out["kill"] = [c1.query(f"kill query {c2.conn_id}"),
                   c1.query(f"kill {c2.conn_id}")]
    try:
        for _ in range(5):
            c2.query("select 1")
        out["killed_conn_answers"] = True
    except (ConnectionError, OSError):
        out["killed_conn_answers"] = False
    c1.close()
    c2.sock.close()
    return out


@pytest.fixture(scope="module")
def recorded():
    """Both servers (users root and alice) run the same script, then
    close: no listener outlives the fixture's setup."""
    port, ref = _servers(users=USERS, allow_unknown_users=False)
    try:
        return {"port": _session_script(port), "ref": _session_script(ref)}
    finally:
        _close(port, ref)


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_corpus_byte_equal(recorded, i):
    assert recorded["port"]["corpus"][i] == recorded["ref"]["corpus"][i], \
        CORPUS[i]


def test_greeting_and_auth_packets_equal(recorded):
    for key in ("greeting", "auth"):
        assert recorded["port"][key] == recorded["ref"][key], key
    assert [a[0] for a in recorded["port"]["auth"]] == [0, 0, 0xFF, 0xFF]


@pytest.mark.parametrize("i", range(len(COMMANDS)))
def test_commands_byte_equal(recorded, i):
    assert recorded["port"]["commands"][i] == \
        recorded["ref"]["commands"][i], hex(COMMANDS[i][0])


@pytest.mark.parametrize("i", range(len(PREPARED)))
def test_prepared_statements_byte_equal(recorded, i):
    assert recorded["port"]["prepared"][i] == \
        recorded["ref"]["prepared"][i], PREPARED[i][0]


def test_kill_query_and_connection(recorded):
    """The same OK packets for both KILLs, and the killed connection is
    gone on both servers."""
    assert recorded["port"]["kill"] == recorded["ref"]["kill"]
    assert [k[0][0] for k in recorded["port"]["kill"]] == [0, 0]
    assert not recorded["port"]["killed_conn_answers"]
    assert not recorded["ref"]["killed_conn_answers"]


def test_connection_gate_answers_1040():
    port, ref = _servers(max_connections=2)
    try:
        refused = {}
        for name, srv in (("port", port), ("ref", ref)):
            held = [Raw(srv.port), Raw(srv.port)]
            extra = Raw(srv.port)
            refused[name] = extra.greeting
            extra.sock.close()
            with pytest.raises(MySQLError) as exc:
                MiniClient("127.0.0.1", srv.port)
            assert exc.value.code == 1040
            for c in held:
                c.close()
        assert refused["port"] == refused["ref"]
        assert refused["port"][:3] == b"\xff\x10\x04"
    finally:
        _close(port, ref)


def test_wait_timeout_reaps_a_parked_connection():
    port, ref = _servers()
    try:
        clients = {}
        for name, srv in (("port", port), ("ref", ref)):
            cl = MiniClient("127.0.0.1", srv.port)
            cl.execute("set session wait_timeout = 1")
            clients[name] = (srv, cl)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and any(
                srv.connection_count() for srv, _ in clients.values()):
            time.sleep(0.1)
        for name, (srv, cl) in clients.items():
            assert srv.connection_count() == 0, name
            with pytest.raises((ConnectionError, OSError, MySQLError)):
                cl.query("select 1")
            cl.sock.close()
    finally:
        _close(port, ref)


def test_concurrent_connections_share_the_store():
    port, ref = _servers()
    try:
        counts = {}
        for name, srv in (("port", port), ("ref", ref)):
            c1 = MiniClient("127.0.0.1", srv.port)
            c1.execute("create table ct (a bigint)")
            errs: list[Exception] = []

            def worker(base: int) -> None:
                try:
                    c = MiniClient("127.0.0.1", srv.port)
                    for i in range(10):
                        c.execute(f"insert into ct values ({base + i})")
                    c.close()
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            threads = [threading.Thread(target=worker, args=(k * 100,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errs
            counts[name] = c1.query("select count(*), sum(a) from ct")
            c1.close()
        assert counts["port"] == counts["ref"] == [("40", "6180")]
    finally:
        _close(port, ref)


def test_server_close_leaves_no_thread():
    before = set(threading.enumerate())
    port = Server(Storage(), port=0, device="cpu")
    port.start()
    cl = MiniClient("127.0.0.1", port.port)
    assert cl.ping()
    assert cl.query("select 1") == [("1",)]
    port.close(drain_timeout=0.2)
    # the server started its store's metrics-history sampler; closing the
    # store joins it
    port.storage.close()
    assert [t.name for t in set(threading.enumerate()) - before] == []
    with pytest.raises((ConnectionError, OSError, MySQLError)):
        cl.query("select 1")
    cl.sock.close()


def test_device_fault_closes_the_connection(monkeypatch):
    """A statement error answers as an ERR packet; a device or kernel
    fault (a RuntimeError without an errno) is not a statement error: the
    connection closes instead of answering."""
    from tidb_tpu_torch.errno import CodedError
    from tidb_tpu_torch.session.session import Session as PortSession

    srv = Server(Storage(), port=0, device="cpu")
    srv.start()
    try:
        execute = PortSession.execute

        def faulty(self, sql):
            if "fault" in sql:
                raise RuntimeError("CUDA error: an illegal memory access")
            if "coded" in sql:
                raise CodedError("coded failure", errno=1105)
            return execute(self, sql)

        monkeypatch.setattr(PortSession, "execute", faulty)
        cl = MiniClient("127.0.0.1", srv.port)
        with pytest.raises(MySQLError) as exc:
            cl.query("select 'coded'")
        assert exc.value.code == 1105
        assert cl.query("select 1") == [("1",)]
        with pytest.raises((ConnectionError, OSError)):
            cl.query("select 'fault'")
        cl.sock.close()
    finally:
        srv.close(drain_timeout=0.2)
        srv.storage.close()


def test_no_server_thread_outlives_the_file():
    """Runs last: every server this file started is closed, so no
    connection thread may be left."""
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and _conn_threads():
        time.sleep(0.05)
    assert not _conn_threads()


def _conn_threads() -> set:
    return {t for t in threading.enumerate() if t.is_alive()
            and t.name.startswith(("titpu-conn-", "titpu-mysql-accept"))}
