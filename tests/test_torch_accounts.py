"""Accounts, grants, roles and the per-statement privilege checks of the
port, held to the reference statement for statement.

The 14 cases of tests/test_roles.py and the 11 of tests/test_column_privs.py
run through `Twin`s (tests/test_torch_functions.py): one `Session` of each
package (the port's with `device="cpu"`) over its own store, outcomes
(rows, or the error's class, errno and message), warnings and engine tags
equal after every statement; the grant tables are read back from both
stores and compared. TRACE of a DML compares the two span trees by
name. SHOW PROCESSLIST and information_schema.processlist answer on both
behind the PROCESS gate, from a provider's rows and over each package's
server.

The account cases of tests/test_compat.py run the same way; the
server-backed ones over each package's own `Server(storage, port=0)`, with
real native-password logins against users that SQL created, and every
answer (rows, or errno and message) compared between the two servers.
A last wire case reads TPC-H at SF0.01 as a non-root user with a column
grant and a role: Q6 equal on both servers, 1142 for a column or a table
outside the grants, the role widening the checks after SET ROLE, an
UPDATE refused. Each server is closed and its threads joined.
Tolerance: none.
"""

from __future__ import annotations

import pytest

from mysql_client import MiniClient, MySQLError
from test_torch_functions import Twin
from test_torch_server import _close, _servers
from tidb_tpu.bench import tpch_data as RTD
from tidb_tpu.server import Server as RefServer
from tidb_tpu.session import Session as RefSession
from tidb_tpu.sql.parser import parse_one as ref_parse_one
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.sql.parser import parse_one
from tidb_tpu_torch.store.storage import Storage


def grant_tables(tk: Twin) -> None:
    """Every account's (and every granted role's) grants, column grants,
    roles and default roles must be the same in both stores."""
    def state(s):
        pm = s.storage.privileges
        users = pm.account_names()
        names = sorted(set(users).union(*(pm.roles_of(n) for n in users)))
        return {n: (sorted(pm.grants_for(n)), sorted(pm.col_grants_for(n)),
                    sorted(pm.roles_of(n)), sorted(pm.default_roles(n)),
                    pm.is_role(n)) for n in names}
    tk.both(state)


# ==================== tests/test_roles.py ====================

@pytest.fixture()
def tk():
    t = Twin()
    t.must_exec("create table rt (a int)")
    t.must_exec("insert into rt values (1), (2)")
    return t


def _user_session(tk, name):
    return tk.sibling(user=name)


def test_role_grants_flow_through_activation(tk):
    tk.must_exec("create role 'reader'")
    tk.must_exec("grant select on test.* to 'reader'")
    tk.must_exec("create user 'u1' identified by ''")
    tk.must_exec("grant 'reader' to 'u1'")
    u = _user_session(tk, "u1")
    with pytest.raises(Exception) as ei:
        u.execute("select a from rt")
    assert ei.value.errno == 1142
    u.execute("set role 'reader'")
    assert u.execute("select a from rt order by a").rows == [(1,), (2,)]
    u.execute("set role none")
    with pytest.raises(Exception):
        u.execute("select a from rt")
    u.execute("set role all")
    assert len(u.execute("select a from rt").rows) == 2
    assert u.query("select current_role()") == [("`reader`@`%`",)]
    grant_tables(tk)


def test_set_role_requires_granted(tk):
    tk.must_exec("create role 'r2'")
    tk.must_exec("create user 'u2' identified by ''")
    u = _user_session(tk, "u2")
    with pytest.raises(Exception) as ei:
        u.execute("set role 'r2'")
    assert "has not been granted" in str(ei.value)


def test_default_roles_and_login_activation(tk):
    tk.must_exec("create role 'writer'")
    tk.must_exec("grant select, insert on test.* to 'writer'")
    tk.must_exec("create user 'u3' identified by ''")
    tk.must_exec("grant 'writer' to 'u3'")
    tk.must_exec("set default role all to 'u3'")
    assert tk.both(lambda s: s.storage.privileges.default_roles("u3")) \
        == {"writer"}
    u = _user_session(tk, "u3")
    u.execute("set role default")
    u.execute("insert into rt values (3)")
    assert len(u.execute("select a from rt").rows) == 3
    grant_tables(tk)


def test_nested_roles_expand_transitively(tk):
    tk.must_exec("create role 'base', 'derived'")
    tk.must_exec("grant select on test.* to 'base'")
    tk.must_exec("grant 'base' to 'derived'")
    tk.must_exec("create user 'u4' identified by ''")
    tk.must_exec("grant 'derived' to 'u4'")
    u = _user_session(tk, "u4")
    u.execute("set role 'derived'")
    assert len(u.execute("select a from rt").rows) == 2


def test_drop_role_removes_edges_and_access(tk):
    tk.must_exec("create role 'temp'")
    tk.must_exec("grant select on test.* to 'temp'")
    tk.must_exec("create user 'u5' identified by ''")
    tk.must_exec("grant 'temp' to 'u5'")
    u = _user_session(tk, "u5")
    u.execute("set role 'temp'")
    assert len(u.execute("select a from rt").rows) == 2
    tk.must_exec("drop role 'temp'")
    with pytest.raises(Exception):
        u.execute("select a from rt")
    grant_tables(tk)


def test_revoke_role(tk):
    tk.must_exec("create role 'rr'")
    tk.must_exec("grant select on test.* to 'rr'")
    tk.must_exec("create user 'u6' identified by ''")
    tk.must_exec("grant 'rr' to 'u6'")
    tk.must_exec("revoke 'rr' from 'u6'")
    u = _user_session(tk, "u6")
    with pytest.raises(Exception):
        u.execute("set role 'rr'")


def test_show_grants_lists_roles(tk):
    tk.must_exec("create role 'viewer'")
    tk.must_exec("create user 'u7' identified by ''")
    tk.must_exec("grant 'viewer' to 'u7'")
    rows = tk.must_query("show grants for 'u7'")
    assert any("'viewer'" in r[0] for r in rows)


def test_roles_cannot_login(tk):
    tk.must_exec("create role 'nologin'")
    assert not tk.both(lambda s: s.storage.privileges.verify_native(
        "nologin", b"x" * 20, b""))


def test_show_grants_output_parses_back(tk):
    tk.must_exec("create role 'rt1'")
    tk.must_exec("create user 'u9' identified by ''")
    tk.must_exec("grant 'rt1'@'%' to 'u9'@'%'")
    assert tk.both(lambda s: s.storage.privileges.roles_of("u9")) == \
        {"rt1"}


def test_partial_failure_mutates_nothing(tk):
    tk.must_exec("create role 'ok1'")
    with pytest.raises(Exception):
        tk.must_exec("create role 'fresh', 'ok1'")
    assert not tk.both(lambda s: s.storage.privileges.is_role("fresh"))
    with pytest.raises(Exception):
        tk.must_exec("grant 'ok1' to 'ghost_user'")
    tk.must_exec("create user 'u10' identified by ''")
    with pytest.raises(Exception):
        tk.execute("grant 'ok1' to 'u10', 'ghost_user'")
    assert tk.both(lambda s: s.storage.privileges.roles_of("u10")) == set()


def test_set_default_role_multi_user_atomic(tk):
    tk.must_exec("create role 'dr'")
    tk.must_exec("create user 'u12' identified by ''")
    tk.must_exec("grant 'dr' to 'u12'")
    with pytest.raises(Exception):
        tk.must_exec("set default role all to 'u12', 'ghost'")
    assert tk.both(lambda s: s.storage.privileges.default_roles("u12")) \
        == set()


def test_trace_dml_shows_twopc_spans(tk):
    """TRACE of a DML runs it through both packages; the span trees'
    names (times excluded) are equal and hold the 2PC phases."""
    names = [[r[0] for r in s.query("trace insert into rt values (42)")]
             for s in (tk.port, tk.ref)]
    assert names[0] == names[1]
    assert any("twopc.prewrite" in o for o in names[0]), names[0]
    assert any("twopc.commit" in o for o in names[0]), names[0]
    assert tk.query("select a from rt order by a") == [(1,), (2,), (42,)]


def test_drop_user_clears_role_edges(tk):
    tk.must_exec("create role 'edge'")
    tk.must_exec("create user 'u11' identified by ''")
    tk.must_exec("grant 'edge' to 'u11'")
    tk.must_exec("drop user 'edge'")
    assert tk.both(lambda s: s.storage.privileges.roles_of("u11")) == set()
    tk.must_exec("create role 'edge'")
    assert tk.both(lambda s: s.storage.privileges.roles_of("u11")) == set()


def test_roles_survive_restart(tmp_path):
    stores = {"port": (Storage, lambda st: Session(st, device="cpu")),
              "ref": (RefStorage, RefSession)}
    got = {}
    for name, (Store, new_session) in stores.items():
        path = str(tmp_path / name)
        st = Store(path)
        s = new_session(st)
        s.execute("create role 'persisted'")
        s.execute("grant select on *.* to 'persisted'")
        s.execute("create user 'u8' identified by ''")
        s.execute("grant 'persisted' to 'u8'")
        st.close()
        st2 = Store(path)
        pm = st2.privileges
        got[name] = (pm.is_role("persisted"), pm.roles_of("u8"),
                     pm.check("u8", "SELECT", "any", "t",
                              roles={"persisted"}))
        st2.close()
    assert got["port"] == got["ref"] == (True, {"persisted"}, True)


# ==================== tests/test_column_privs.py ====================

@pytest.fixture()
def ck():
    t = Twin()
    t.must_exec("create table ct (a int, b int, secret int)")
    t.must_exec("insert into ct values (1, 10, 99), (2, 20, 98)")
    return t


def _user(tk, name):
    tk.must_exec(f"create user '{name}' identified by ''")
    return tk.sibling(user=name)


def test_column_select_scope(ck):
    u = _user(ck, "c1")
    ck.must_exec("grant select (a, b) on ct to 'c1'")
    assert u.execute("select a, b from ct order by a").rows == \
        [(1, 10), (2, 20)]
    assert u.execute("select a from ct where b > 15").rows == [(2,)]
    with pytest.raises(Exception) as ei:
        u.execute("select secret from ct")
    assert "secret" in str(ei.value)
    # the reference types a column refusal as 1142 too (MySQL: 1143)
    assert ei.value.errno == 1142
    with pytest.raises(Exception):
        u.execute("select * from ct")
    with pytest.raises(Exception):
        u.execute("select a from ct where secret > 0")


def test_column_insert_update_scope(ck):
    u = _user(ck, "c2")
    ck.must_exec("grant insert (a, b), select (a, b) on ct to 'c2'")
    u.execute("insert into ct (a, b) values (3, 30)")
    with pytest.raises(Exception):
        u.execute("insert into ct (a, secret) values (4, 1)")
    ck.must_exec("grant update (b) on ct to 'c2'")
    u.execute("update ct set b = 31 where a = 3")
    with pytest.raises(Exception):
        u.execute("update ct set secret = 0 where a = 3")
    assert ck.query("select a, b, secret from ct order by a") == \
        [(1, 10, 99), (2, 20, 98), (3, 31, None)]


def test_full_table_grant_bypasses_column_checks(ck):
    u = _user(ck, "c3")
    ck.must_exec("grant select on ct to 'c3'")
    assert len(u.execute("select * from ct").rows) == 2


def test_revoke_column_grant(ck):
    u = _user(ck, "c4")
    ck.must_exec("grant select (a, b) on ct to 'c4'")
    assert len(u.execute("select a from ct").rows) == 2
    ck.must_exec("revoke select (b) on ct from 'c4'")
    with pytest.raises(Exception):
        u.execute("select b from ct")
    assert len(u.execute("select a from ct").rows) == 2
    grant_tables(ck)


def test_show_grants_renders_columns(ck):
    _user(ck, "c5")
    ck.must_exec("grant select (b, a) on ct to 'c5'")
    rows = ck.must_query("show grants for 'c5'")
    assert any("SELECT (a, b) ON test.ct" in r[0] for r in rows), rows


def test_usage_alignment_with_column_lists(ck):
    u = _user(ck, "c7")
    ck.must_exec("grant usage, select (a) on ct to 'c7'")
    assert len(u.execute("select a from ct").rows) == 2
    with pytest.raises(Exception):
        u.execute("select secret from ct")


def test_view_mediated_access_still_works(ck):
    u = _user(ck, "c8")
    ck.must_exec("create view vw as select a, b from ct")
    ck.must_exec("grant select on vw to 'c8'")
    assert len(u.execute("select a from vw").rows) == 2


def test_partial_grant_failure_mutates_nothing(ck):
    _user(ck, "c9")
    with pytest.raises(Exception):
        ck.must_exec("grant select, insert (a) on test.* to 'c9'")
    assert ck.both(lambda s: s.storage.privileges.grants_for("c9")) == []


def test_update_requires_select_on_read_columns(ck):
    u = _user(ck, "c10")
    ck.must_exec("grant update (a), select (a) on ct to 'c10'")
    u.execute("update ct set a = 5 where a = 1")
    with pytest.raises(Exception):
        u.execute("update ct set a = 6 where secret = 99")
    with pytest.raises(Exception):
        u.execute("update ct set a = secret where a = 5")
    assert ck.query("select a from ct order by a") == [(2,), (5,)]


def test_processlist_requires_process_priv(ck):
    """SHOW PROCESSLIST and information_schema.processlist behind the
    PROCESS gate, with a provider's rows on both stores (the wire case
    below reads a real server's): a user without PROCESS sees only its
    own rows, the GRANT widens it, and the two packages answer alike."""
    rows_all = [(1, "root", "h", "test", "Query", 0, "", "select 1", 5, 0),
                (2, "c11", "h", "test", "Query", 0, "", "select 2", 7, 1)]
    for s in ck.sessions:
        s.storage.processlist = lambda: rows_all
    u = _user(ck, "c11")
    try:
        assert [r[1] for r in u.query("show processlist")] == ["c11"]
        assert u.query("select id, user, mem_max, spill_count from "
                       "information_schema.processlist") == \
            [(2, "c11", 7, 1)]
        ck.must_exec("grant process on *.* to 'c11'")
        assert len(u.query("show processlist")) == 2
        assert len(u.query("select * from information_schema.processlist")
                   ) == 2
        assert ck.both(lambda s: s.storage.privileges.check(
            "c11", "PROCESS", "*", "*"))
    finally:
        for s in ck.sessions:
            del s.storage.processlist


def test_processlist_over_the_wire():
    """Each package's server lists its live connections: the same rows
    on both (Host without the client's ephemeral port), a PROCESS-less
    user seeing only its own, information_schema.processlist agreeing."""
    port, ref = _servers(users={"root": ""}, allow_unknown_users=False)
    try:
        got = []
        for srv in (port, ref):
            root = MiniClient("127.0.0.1", srv.port)
            root.execute("create user 'pl' identified by 'pw'")
            root.execute("grant select on test.* to 'pl'")
            user = MiniClient("127.0.0.1", srv.port, user="pl",
                              password="pw")

            def masked(rows):
                return [(r[0], r[1], r[2].rsplit(":", 1)[0]) + r[3:]
                        for r in rows]
            seen = [masked(root.query("show processlist")),
                    masked(user.query("show processlist")),
                    user.query("select id, user, command, info from "
                               "information_schema.processlist")]
            root.execute("grant process on *.* to 'pl'")
            seen.append(masked(user.query("show processlist")))
            got.append(seen)
            user.close()
            root.close()
        assert got[0] == got[1]
        assert [r[1] for r in got[0][1]] == ["pl"]
        assert [r[1] for r in got[0][3]] == ["root", "pl"]
    finally:
        _close(port, ref)


def test_column_grants_through_roles(ck):
    ck.must_exec("create role 'colrole'")
    ck.must_exec("grant select (a) on ct to 'colrole'")
    u = _user(ck, "c6")
    ck.must_exec("grant 'colrole' to 'c6'")
    u.execute("set role 'colrole'")
    assert len(u.execute("select a from ct").rows) == 2
    with pytest.raises(Exception):
        u.execute("select b from ct")


# ==================== the privilege gate and the fast path ==============

def test_point_statements_checked_before_the_fast_path(ck, monkeypatch):
    ck.must_exec("create table pk (id int primary key, v int)")
    ck.must_exec("insert into pk values (1, 10), (2, 20)")
    u = _user(ck, "fp")
    reached = []
    real = Session._try_fast_path
    monkeypatch.setattr(Session, "_try_fast_path",
                        lambda self, stmt: reached.append(stmt)
                        or real(self, stmt))
    for sql in ("select v from pk where id = 1",
                "update pk set v = 11 where id = 1",
                "insert into pk values (3, 30)",
                "delete from pk where id = 2"):
        with pytest.raises(Exception) as ei:
            u.execute(sql)
        assert ei.value.errno == 1142, sql
    assert reached == []
    ck.must_exec("grant select, update on pk to 'fp'")
    assert u.query("select v from pk where id = 1") == [(10,)]
    u.execute("update pk set v = 11 where id = 1")
    assert ck.query("select v from pk order by id") == [(11,), (20,)]
    assert ck.port.last_engines == ck.ref.last_engines


# ==================== the account cases of tests/test_compat.py ==========

@pytest.fixture()
def servers():
    port, ref = _servers(users={"root": ""}, allow_unknown_users=False)
    yield port, ref
    _close(port, ref)


def _answer(fn):
    """fn() -> its value, or the wire error's code and message."""
    try:
        return ("ok", fn())
    except MySQLError as e:
        return ("error", e.code, str(e))
    except ConnectionError:
        return ("refused",)


def _connect(srv, **kw):
    return MiniClient("127.0.0.1", srv.port, **kw)


def _login(srv, user, password) -> tuple:
    def go():
        c = _connect(srv, user=user, password=password)
        c.close()
        return True
    return _answer(go)


def test_alter_user_set_password_rename_user(servers):
    def script(srv):
        root = _connect(srv)
        out = [_answer(lambda: root.execute(
            "create user 'pw1' identified by 'first'")),
            _answer(lambda: root.execute(
                "alter user 'pw1' identified by 'second'")),
            _login(srv, "pw1", "first"), _login(srv, "pw1", "second")]
        c = _connect(srv, user="pw1", password="second")
        out.append(_answer(lambda: c.execute("set password = 'third'")))
        c.close()
        c2 = _connect(srv, user="pw1", password="third")
        out.append(_answer(lambda: c2.execute(
            "alter user 'root' identified by 'x'")))
        c2.close()
        out.append(_answer(lambda: root.execute(
            "rename user 'pw1' to 'pw2'")))
        out += [_login(srv, "pw2", "third"), _login(srv, "pw1", "third")]
        root.close()
        return out
    port, ref = servers
    got = [script(port), script(ref)]
    assert got[0] == got[1]
    out = got[0]
    assert out[2][0] != "ok" and out[3] == ("ok", True)
    assert out[5][0] == "error" and out[5][1] == 1227
    assert out[7] == ("ok", True) and out[8][0] != "ok"


def test_create_user_real_auth(servers):
    def script(srv):
        root = _connect(srv)
        out = [_answer(lambda: root.execute(
            "CREATE USER 'bob' IDENTIFIED BY 's3cret'")),
            _answer(lambda: root.execute(
                "GRANT SELECT, INSERT ON test.* TO 'bob'"))]
        bob = _connect(srv, user="bob", password="s3cret")
        out.append(bob.ping())
        bob.close()
        out += [_login(srv, "bob", "wrong"), _login(srv, "bob", "")]
        root.close()
        return out
    port, ref = servers
    got = [script(port), script(ref)]
    assert got[0] == got[1]
    assert got[0][2] is True
    assert got[0][3][0] != "ok" and got[0][4][0] != "ok"


def test_privilege_enforcement(servers):
    def script(srv):
        root = _connect(srv)
        root.execute("create table pt (id int primary key, v int)")
        root.execute("insert into pt values (1, 10)")
        root.execute("CREATE USER 'carol' IDENTIFIED BY 'pw'")
        root.execute("GRANT SELECT ON test.pt TO 'carol'")
        carol = _connect(srv, user="carol", password="pw")
        out = [_answer(lambda: carol.query("select v from pt")),
               _answer(lambda: carol.execute("insert into pt values (2, 20)")),
               _answer(lambda: carol.execute("drop table pt")),
               _answer(lambda: carol.execute("CREATE USER 'dave'")),
               _answer(lambda: carol.query(
                   "SELECT table_name FROM information_schema.tables "
                   "WHERE table_schema = 'test' AND table_name = 'pt'"))]
        carol.close()
        root.execute("REVOKE SELECT ON test.pt FROM 'carol'")
        carol2 = _connect(srv, user="carol", password="pw")
        out.append(_answer(lambda: carol2.query("select v from pt")))
        carol2.close()
        root.close()
        return out
    port, ref = servers
    got = [script(port), script(ref)]
    assert got[0] == got[1]
    out = got[0]
    assert out[0] == ("ok", [("10",)])
    assert out[1][:2] == ("error", 1142)
    assert out[2][0] == "error" and out[3][0] == "error"
    assert out[4] == ("ok", [("pt",)])
    assert out[5][:2] == ("error", 1142)


def test_show_grants(servers):
    def script(srv):
        root = _connect(srv)
        root.execute("CREATE USER 'erin' IDENTIFIED BY 'x'")
        root.execute("GRANT SELECT ON test.* TO 'erin'")
        rows = root.query("SHOW GRANTS FOR 'erin'")
        root.close()
        return rows
    port, ref = servers
    got = [script(port), script(ref)]
    assert got[0] == got[1] == [("GRANT SELECT ON test.* TO 'erin'@'%'",)]


def test_users_survive_restart(tmp_path):
    sides = {"port": (Storage, lambda st: Session(st, device="cpu"),
                      lambda st: Server(st, port=0, device="cpu",
                                        allow_unknown_users=False)),
             "ref": (RefStorage, RefSession,
                     lambda st: RefServer(st, port=0,
                                          allow_unknown_users=False))}
    got = {}
    for name, (Store, new_session, new_server) in sides.items():
        p = str(tmp_path / name / "db")
        st = Store(p)
        s = new_session(st)
        s.execute("CREATE USER 'frank' IDENTIFIED BY 'pw9'")
        s.execute("GRANT ALL ON test.* TO 'frank'")
        st.close()
        st2 = Store(p)
        srv = new_server(st2)
        srv.start()
        try:
            c = _connect(srv, user="frank", password="pw9")
            out = [_answer(lambda: c.execute(
                "create table ft (id int primary key)"))]
            c.close()
            out.append(_login(srv, "frank", "bad"))
        finally:
            _close(srv)
            st2.close()
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][0][0] == "ok" and got["port"][1][0] != "ok"


def test_unqualified_grant_scopes_to_current_db():
    root = Twin()
    root.execute("CREATE DATABASE d1")
    root.execute("CREATE DATABASE d2")
    root.execute("CREATE TABLE d1.t (a INT)")
    root.execute("CREATE TABLE d2.t (a INT)")
    root.execute("CREATE USER 'u1'")
    root.set("current_db", "d1")
    root.execute("GRANT SELECT ON t TO 'u1'")
    assert root.both(lambda s: s.storage.privileges.check(
        "u1", "SELECT", "d1", "t"))
    assert not root.both(lambda s: s.storage.privileges.check(
        "u1", "SELECT", "d2", "t"))


def test_set_global_needs_super():
    root = Twin()
    root.execute("CREATE USER 'low'")
    low = root.sibling(user="low")
    with pytest.raises(Exception, match="SUPER") as ei:
        low.execute("SET GLOBAL max_connections = 1")
    assert ei.value.errno == 1227
    low.execute("SET max_execution_time = 3")
    with pytest.raises(Exception, match="SUPER"):
        low.execute("SET GLOBAL tidb_custom_knob = 1")


def test_dml_subquery_needs_select_not_write():
    root = Twin()
    root.execute("CREATE TABLE tgt (a INT PRIMARY KEY)")
    root.execute("CREATE TABLE src (a INT PRIMARY KEY)")
    root.execute("INSERT INTO tgt VALUES (1), (2)")
    root.execute("INSERT INTO src VALUES (1)")
    root.execute("CREATE USER 'w'")
    root.execute("GRANT DELETE ON test.tgt TO 'w'")
    root.execute("GRANT SELECT ON test.src TO 'w'")
    w = root.sibling(user="w")
    parse = {w.port: parse_one, w.ref: ref_parse_one}
    for s in w.sessions:
        p = parse[s]
        s._check_privileges(p(
            "DELETE FROM tgt WHERE a IN (SELECT a FROM src)"))
        with pytest.raises(Exception, match="DELETE command denied") as ei:
            s._check_privileges(p(
                "DELETE FROM src WHERE a IN (SELECT a FROM tgt)"))
        assert ei.value.errno == 1142
    # and through the statement path, where the reference answers too
    w.execute("DELETE FROM tgt WHERE a = 2")
    assert root.query("SELECT a FROM tgt") == [(1,)]


def test_unknown_privilege_rejected():
    root = Twin()
    root.execute("CREATE USER 'z'")
    with pytest.raises(Exception, match="unknown privilege"):
        root.execute("GRANT SLECT ON *.* TO 'z'")
    root.execute("GRANT USAGE ON *.* TO 'z'")


# ==================== a TPC-H reader over the wire ====================

def test_tpch_reader_with_column_grant_and_role():
    """The part of the card script that runs over the wire as a non-root
    user, at SF0.01 on each package's server."""
    port, ref = _servers(users={"root": ""}, allow_unknown_users=False)
    try:
        TD.load_tpch(Session(port.storage, device="cpu"), sf=0.01, seed=7,
                     tables=["lineitem", "orders"])
        RTD.load_tpch(RefSession(ref.storage), sf=0.01, seed=7,
                      tables=["lineitem", "orders"])
        got = []
        for srv in (port, ref):
            root = _connect(srv)
            for sql in ("create user 'k3'",
                        "grant select (l_quantity, l_extendedprice, "
                        "l_discount, l_shipdate) on lineitem to 'k3'",
                        "create role 'k3_orders'",
                        "grant select on test.orders to 'k3_orders'",
                        "grant 'k3_orders' to 'k3'"):
                root.execute(sql)
            k3 = _connect(srv, user="k3")
            out = [_answer(lambda: k3.query(TPCH_QUERIES["q6"])),
                   _answer(lambda: k3.query(
                       "select l_comment from lineitem limit 1")),
                   _answer(lambda: k3.query("select count(*) from orders")),
                   _answer(lambda: k3.execute("set role 'k3_orders'")),
                   _answer(lambda: k3.query("select count(*) from orders")),
                   _answer(lambda: k3.execute(
                       "update lineitem set l_quantity = 1 "
                       "where l_orderkey = 1"))]
            k3.close()
            for sql in ("drop user 'k3'", "drop role 'k3_orders'"):
                root.execute(sql)
            out.append(_login(srv, "k3", ""))
            root.close()
            got.append(out)
        assert got[0] == got[1]
        out = got[0]
        assert out[0][0] == "ok" and out[0][1][0][0] is not None
        assert out[1][:2] == ("error", 1142) and "l_comment" in out[1][2]
        assert out[2][:2] == ("error", 1142)
        assert out[4] == ("ok", [("15000",)])
        assert out[5][:2] == ("error", 1142)
        assert out[6][0] != "ok"
    finally:
        _close(port, ref)
