"""The function registry and the session functions of the port, held to
the reference statement for statement.

Every case of tests/test_functions.py and tests/test_functions_ext.py (the
parametrised `CASES` under the same ids) runs through a `Twin`: one
`Session` of each package (the port's with `device="cpu"`), each over its
own store. After every statement the outcomes must be equal: rows (a
Decimal by its unscaled integer and scale, a float by its exact hex form),
column names, affected count, or the error's class, errno and message;
and so must the warnings and the engine tags. The reference test's own
assertions then run on the port's answer.

Beyond those: the two `REGISTRY`s agree name for name and field for field,
and every builtin gives the same value (or the same exception) in both on
seeded arguments of its domain, NULLs included; the clock functions with
`time.time` and `time.strftime` patched to one instant; `@@time_zone` over
two wire connections of each package's server (one worker thread, so a
leaked zone would show); GET_LOCK across two wire connections and its
release at connection close; `SELECT SLEEP(20)` ended by KILL QUERY from a
second connection; the dictionary and the row-wise registry paths with
equal `REGISTRY_ROW_EVALS` per function; and the EXPLAIN text of a filter
with a registry call. Tolerance: none.
"""

from __future__ import annotations

import datetime
import decimal
import math
import random
import re
import threading
import time

import pytest

from mysql_client import MiniClient, MySQLError
from test_functions_ext import CASES
from test_torch_server import _close, _servers
from tidb_tpu import obs as ref_obs
from tidb_tpu.copr import funcs as ref_funcs
from tidb_tpu.session import Session as RefSession
from tidb_tpu_torch import obs
from tidb_tpu_torch.copr import funcs
from tidb_tpu_torch.session import Session


def cells(rows: list) -> list:
    """Session rows -> comparable tuples across the two packages."""
    def cell(v):
        if type(v).__name__ == "Decimal" and hasattr(v, "unscaled"):
            return ("dec", v.unscaled, v.scale)
        if isinstance(v, float):
            return ("float", v.hex())
        return v
    return [tuple(cell(v) for v in r) for r in rows]


def outcome(kind: str, v) -> tuple:
    if kind == "error":
        return ("error", type(v).__name__, getattr(v, "errno", None),
                str(v))
    return (v.affected, v.column_names, cells(v.rows))


class Twin:
    """One session of each package; every statement goes to both, the
    outcomes, warnings and engine tags must be equal, and the port's
    result is returned (or its error raised)."""

    def __init__(self, port=None, ref=None) -> None:
        self.port = port if port is not None else Session(device="cpu")
        self.ref = ref if ref is not None else RefSession()

    @property
    def sessions(self) -> tuple:
        return self.port, self.ref

    def sibling(self, user=None) -> "Twin":
        """A second session of each package over the same two stores,
        optionally as `user` (checked like a wire login without roles)."""
        t = Twin(Session(self.port.storage, device="cpu"),
                 RefSession(self.ref.storage))
        for s in t.sessions:
            s.execute("use test")
            s.user = user
        return t

    def set(self, attr: str, value) -> None:
        for s in self.sessions:
            setattr(s, attr, value)

    def both(self, fn):
        """fn on each package's session; the two answers must agree."""
        got = [fn(s) for s in self.sessions]
        assert got[0] == got[1]
        return got[0]

    def execute(self, sql: str):
        out = []
        for s in self.sessions:
            try:
                out.append(("ok", s.execute(sql)))
            except Exception as e:  # the session error, compared below
                out.append(("error", e))
        assert outcome(*out[0]) == outcome(*out[1]), sql
        assert self.port.warnings == self.ref.warnings, sql
        if out[0][0] == "error":
            raise out[0][1]
        assert self.port.last_engines == self.ref.last_engines, sql
        return out[0][1]

    def query(self, sql: str) -> list:
        return self.execute(sql).rows

    must_exec = execute
    must_query = query


# ==================== tests/test_functions.py ====================

@pytest.fixture()
def tk():
    k = Twin()
    k.must_exec("create table t (id int primary key, s varchar(20), "
                "d decimal(8,2), f double, dt date, ts datetime)")
    k.must_exec("insert into t values (1, 'Hello World', 123.45, 2.5, "
                "'2024-02-15', '2024-02-15 13:45:30'), "
                "(2, NULL, -7.89, 0.0, '2023-12-31', "
                "'2023-12-31 23:59:59')")
    return k


def _one(tk, sql):
    return tk.must_query(sql + " from t where id = 1")[0]


def test_string_functions(tk):
    assert _one(tk, "select upper(s), lower(s), reverse(s)") == \
        ("HELLO WORLD", "hello world", "dlroW olleH")
    assert _one(tk, "select length(s), char_length(s), ascii(s)") == \
        (11, 11, 72)
    assert _one(tk, "select concat(s, '!', id), "
                    "concat_ws('-', 'a', s, 'z')") == \
        ("Hello World!1", "a-Hello World-z")
    assert _one(tk, "select left(s, 5), right(s, 5), repeat('ab', 3)") == \
        ("Hello", "World", "ababab")
    assert _one(tk, "select replace(s, 'World', 'There'), "
                    "trim('  x  '), ltrim('  x'), rtrim('x  ')") == \
        ("Hello There", "x", "x", "x")
    assert _one(tk, "select lpad('5', 3, '0'), rpad('ab', 5, 'xy')") == \
        ("005", "abxyx")
    assert _one(tk, "select locate('World', s), instr(s, 'World'), "
                    "locate('zz', s)") == (7, 7, 0)


def test_string_null_propagation(tk):
    assert tk.must_query(
        "select concat(s, 'x'), concat_ws(',', 'a', s, 'b') "
        "from t where id = 2") == [(None, "a,b")]
    assert tk.must_query(
        "select upper(s) from t where id = 2") == [(None,)]


def test_math_functions(tk):
    r = _one(tk, "select round(d), round(d, 1), truncate(d, 1), "
                 "floor(d), ceil(d)")
    assert (str(r[0]), str(r[1]), str(r[2]), r[3], r[4]) == \
        ("123", "123.5", "123.4", 123, 124)
    r = tk.must_query("select round(d, 1), floor(d), ceil(d) from t "
                      "where id = 2")[0]
    assert (str(r[0]), r[1], r[2]) == ("-7.9", -8, -7)
    assert str(_one(tk, "select round(2.5)")[0]) == "3"
    r = _one(tk, "select sqrt(16), pow(2, 10), exp(0), sign(-3), "
                 "sign(0), sign(9)")
    assert r == (4.0, 1024.0, 1.0, -1, 0, 1)
    r = _one(tk, "select log2(8), log10(1000), log(3, 81), ln(1)")
    assert r == (3.0, 3.0, 4.0, 0.0)
    assert _one(tk, "select sqrt(0 - 1), ln(0)") == (None, None)
    assert _one(tk, "select round(f, 2), floor(f), ceil(f)") == \
        (2.5, 2.0, 3.0)
    assert abs(_one(tk, "select pi()")[0] - 3.14159265) < 1e-6


def test_greatest_least_nullif(tk):
    assert _one(tk, "select greatest(1, 5, 3), least(1, 5, 3)") == (5, 1)
    assert cells([_one(tk, "select greatest(1.5, d, 2)")]) == \
        cells([_one(tk, "select d")])
    assert _one(tk, "select greatest(1, s is null, 3), least(id, 0)") == \
        (3, 0)
    assert tk.must_query("select greatest(1, s is not null, 3) "
                         "from t where id = 1") == [(3,)]
    assert _one(tk, "select nullif(id, 1), nullif(id, 9)") == (None, 1)


def test_date_functions(tk):
    assert _one(tk, "select dayofweek(dt), weekday(dt), dayofyear(dt), "
                    "quarter(dt)") == (5, 3, 46, 1)
    assert _one(tk, "select hour(ts), minute(ts), second(ts)") == \
        (13, 45, 30)
    r = _one(tk, "select date(ts), last_day(dt), "
                 "datediff(dt, '2024-01-01')")
    assert (str(r[0]), str(r[1]), r[2]) == \
        ("2024-02-15", "2024-02-29", 45)
    assert tk.must_query(
        "select id from t where quarter(dt) = 4") == [(2,)]


# one fixed instant for the clock functions: 2024-02-15 13:45:30 local
_INSTANT = time.mktime((2024, 2, 15, 13, 45, 30, 0, 0, -1))


@pytest.fixture()
def fixed_clock(monkeypatch):
    """`time.time` and `time.strftime` (no tuple) at `_INSTANT`, for both
    packages' session modules alike (they read the `time` module)."""
    real_strftime = time.strftime
    fixed = time.localtime(_INSTANT)
    monkeypatch.setattr(time, "time", lambda: _INSTANT)
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, t=None: real_strftime(
                            fmt, fixed if t is None else t))
    return _INSTANT


def test_session_functions(tk, fixed_clock):
    """The reference test's session functions; the clock is patched in
    both packages, so NOW() and CURDATE() are exact. NOW() keeps the
    statement out of the plan cache in both."""
    r = tk.must_query("select version(), database(), user()")[0]
    assert "TiDB" in r[0] and r[1] == "test" and "@" in r[2]
    now = tk.must_query("select now(), curdate(), current_date")[0]
    assert now[0][:4] == now[1][:4]
    assert now == ("2024-02-15 13:45:30", "2024-02-15", "2024-02-15")
    h = tk.both(lambda s: s.plan_cache_hits)
    tk.must_query("select now()")
    tk.must_query("select now()")
    assert tk.both(lambda s: s.plan_cache_hits) == h


def test_review_edge_cases(tk):
    assert _one(tk, "select greatest(s, 'Zz'), least(s, 'Aa')") == \
        ("Zz", "Aa")
    assert _one(tk, "select round(d, null)") == (None,)
    assert tk.must_query(
        "select dayofweek('2024-02-15'), last_day('2024-02-15'), "
        "hour('26:30:00')")[0][0:1] == (5,)
    r = tk.must_query("select hour('26:30:00'), hour('-01:30:00')")[0]
    assert r == (26, 1)
    assert tk.must_query("select lpad('hi', 0-1, 'x')") == [(None,)]


def test_ci_collation_string_functions():
    tk2 = Twin()
    tk2.must_exec("create table ci (s varchar(30) collate "
                  "utf8mb4_general_ci)")
    tk2.must_exec("insert into ci values ('Hello World')")
    assert tk2.must_query(
        "select locate('hello', s), instr(s, 'WORLD') from ci") == \
        [(1, 7)]
    assert tk2.must_query(
        "select replace(s, 'WORLD', 'x') from ci") == [("Hello x",)]


def test_functions_in_group_by_and_order(tk):
    tk.must_exec("create table g (w varchar(10), v int)")
    tk.must_exec("insert into g values ('aa',1),('AA',2),('bb',3)")
    rows = tk.must_query(
        "select upper(w), sum(v) from g group by upper(w) "
        "order by upper(w)")
    assert cells(rows) == cells([("AA", 3), ("BB", 3)])
    rows = tk.must_query("select w from g order by lower(w), v")
    assert rows == [("aa",), ("AA",), ("bb",)]


# ==================== tests/test_functions_ext.py ====================

@pytest.fixture(scope="module")
def session():
    return Twin()


@pytest.mark.parametrize("sql,want", CASES, ids=[c[0][:60] for c in CASES])
def test_registry_function(session, sql, want):
    got = session.query(sql)[0][0]
    if want is None:
        assert got is None, f"{sql}: expected NULL, got {got!r}"
    else:
        assert str(got) == want, f"{sql}: got {got!r}, want {want!r}"


def test_from_unixtime_session_time_zone(session):
    s = session
    try:
        s.execute("set time_zone = '+05:30'")
        assert s.query("select from_unixtime(0)")[0][0] == \
            "1970-01-01 05:30:00"
        # between statements the thread's zone is the one before the
        # statement's frame, in both packages
        assert (funcs.session_time_zone(),
                ref_funcs.session_time_zone()) == ("SYSTEM", "SYSTEM")
        s.execute("set time_zone = '-03:00'")
        assert s.query(
            "select from_unixtime(86400, '%Y-%m-%d %H:%i:%s')")[0][0] == \
            "1970-01-01 21:00:00"
        s.execute("set time_zone = 'UTC'")
        assert s.query("select from_unixtime(86400)")[0][0] == \
            "1970-01-02 00:00:00"
        s.execute("set time_zone = '+01:00'")
        assert s.query(
            "select from_unixtime(0, '%c/%e %k:%i')")[0][0] == "1/1 1:00"
    finally:
        s.execute("set time_zone = 'SYSTEM'")
    assert s.query("select from_unixtime(0)")[0][0] == \
        "1970-01-01 00:00:00"


def test_float_functions(session):
    q = session.query(
        "select sin(0), round(degrees(pi()), 0), round(atan2(1, 1), 4), "
        "round(cot(1), 4), radians(180)")[0]
    assert float(q[0]) == 0.0
    assert float(q[1]) == 180.0
    assert abs(float(q[2]) - 0.7854) < 1e-9
    assert abs(float(q[3]) - 0.6421) < 1e-4
    assert abs(float(q[4]) - math.pi) < 1e-12


def test_session_info_functions(session):
    s = session
    s.execute("drop table if exists sif")
    s.execute("create table sif (id bigint primary key auto_increment, "
              "v int)")
    s.execute("insert into sif (v) values (10), (20)")
    first = s.query("select last_insert_id()")[0][0]
    assert first >= 1
    s.query("select * from sif")
    assert s.query("select found_rows()") == [(2,)]
    s.execute("update sif set v = v + 1")
    assert s.query("select row_count()") == [(2,)]
    s.query("select 1")
    assert s.query("select row_count()") == [(-1,)]
    assert s.query("select get_lock('lk', 0)") == [(1,)]
    assert s.query("select is_free_lock('lk')") == [(0,)]
    assert s.query("select release_lock('lk')") == [(1,)]
    assert s.query("select is_free_lock('lk')") == [(1,)]
    assert s.query("select release_lock('lk')") == [(None,)]
    assert s.query("select current_role()") == [("NONE",)]


def test_user_locks_block_across_sessions(session):
    s2 = session.sibling()
    s2.set("conn_id", 424242)
    session.execute("select get_lock('contended', 0)")
    assert s2.execute("select get_lock('contended', 0)").rows == [(0,)]
    session.execute("select release_lock('contended')")
    assert s2.execute("select get_lock('contended', 0)").rows == [(1,)]
    for s in s2.sessions:
        s.rollback_if_active()  # connection teardown frees its locks
    assert session.execute(
        "select is_free_lock('contended')").rows == [(1,)]


def test_json_aggregates(session):
    s = session
    s.execute("drop table if exists ja")
    s.execute("create table ja (g int, k varchar(10), v int, "
              "d decimal(6,2), doc json)")
    s.execute("insert into ja values "
              "(1,'a',10,1.50,'{\"x\": 1}'), (1,'b',20,2.50,'[2]'), "
              "(2,'c',30,3.25,'3'), (2,NULL,NULL,NULL,NULL)")
    assert s.query("select g, json_arrayagg(v) from ja group by g "
                   "order by g") == \
        [(1, "[10, 20]"), (2, "[30, null]")]
    assert s.query("select json_objectagg(k, v) from ja "
                   "where k is not null") == \
        [('{"a": 10, "b": 20, "c": 30}',)]
    assert s.query("select json_arrayagg(doc) from ja where g = 1") == \
        [('[{"x": 1}, [2]]',)]
    assert s.query("select json_arrayagg(d) from ja where g = 1") == \
        [("[1.50, 2.50]",)]
    s.execute("drop table if exists jb")
    s.execute("create table jb (d decimal(18,6))")
    s.execute("insert into jb values (123456789012.345678)")
    assert s.query("select json_arrayagg(d) from jb") == \
        [("[123456789012.345678]",)]
    with pytest.raises(Exception) as ei:
        s.query("select json_objectagg(k, v) from ja")
    assert getattr(ei.value, "errno", None) == 3158


def test_vectorized_over_rows(session):
    s = session
    s.execute("drop table if exists fxt")
    s.execute("create table fxt (id bigint, s varchar(40), d date)")
    s.execute("insert into fxt values "
              "(1, 'a.b.c', '2020-01-05'), (2, 'x.y', '2021-12-31'), "
              "(3, NULL, NULL)")
    rows = s.query("select id, substring_index(s, '.', 1), md5(s), "
                   "dayname(d) from fxt order by id")
    assert rows[0][1] == "a"
    assert rows[1][1] == "x"
    assert rows[2][1] is None
    assert rows[0][2] == __import__("hashlib").md5(b"a.b.c").hexdigest()
    assert rows[0][3] == "Sunday"
    assert rows[2][3] is None
    got = s.query("select id from fxt where regexp_like(s, '^a') = 1")
    assert [r[0] for r in got] == [1]


def test_new_aggregates(session):
    s = session
    s.execute("drop table if exists aggx")
    s.execute("create table aggx (g bigint, v bigint, s varchar(10))")
    s.execute("insert into aggx values (1,1,'x'),(1,2,'y'),(1,3,NULL),"
              "(2,10,'z'),(2,30,'w')")
    r = s.query("select g, stddev_pop(v), var_samp(v), bit_and(v), "
                "bit_or(v), bit_xor(v), any_value(v) from aggx "
                "group by g order by g")
    assert abs(float(r[0][1]) - 0.816496580927726) < 1e-9
    assert abs(float(r[0][2]) - 1.0) < 1e-9
    assert (r[0][3], r[0][4], r[0][5]) == (0, 3, 0)
    assert abs(float(r[1][1]) - 10.0) < 1e-9
    assert (r[1][3], r[1][4], r[1][5]) == (10, 30, 20)
    r2 = s.query("select g, group_concat(s) from aggx group by g "
                 "order by g")
    assert r2 == [(1, "x,y"), (2, "z,w")]
    r3 = s.query("select variance(v), stddev_samp(v), bit_or(v) from aggx")
    vals = [1, 2, 3, 10, 30]
    mean = sum(vals) / 5
    var_pop = sum((x - mean) ** 2 for x in vals) / 5
    assert abs(float(r3[0][0]) - var_pop) < 1e-9
    assert abs(float(r3[0][1]) - math.sqrt(var_pop * 5 / 4)) < 1e-9
    assert r3[0][2] == 31


def test_breadth_layer_decimal_exactness():
    s = Twin()
    s.execute("create table dexact (a decimal(18,6), b decimal(18,6))")
    s.execute("insert into dexact values (999999999999.123457, 7.000003)")
    assert s.query("select format(a, 4) from dexact")[0][0] == \
        "999,999,999,999.1235"
    got = s.query("select mod(a, b) from dexact")[0][0]
    want = decimal.Decimal("999999999999.123457") % \
        decimal.Decimal("7.000003")
    assert str(got) == str(want)
    s.execute("insert into dexact values (-10.000001, 3.000000)")
    got2 = s.query("select mod(a, b) from dexact where a < 0")[0][0]
    assert str(got2) == "-1.000001"


# ==================== the registries ====================

def test_registries_agree_field_by_field():
    assert sorted(funcs.REGISTRY) == sorted(ref_funcs.REGISTRY)
    assert len(funcs.REGISTRY) == 123
    for name, fd in funcs.REGISTRY.items():
        rd = ref_funcs.REGISTRY[name]
        assert (fd.name, fd.min_args, fd.max_args, fd.ret, fd.null_prop,
                fd.dict_vec) == (rd.name, rd.min_args, rd.max_args, rd.ret,
                                 rd.null_prop, rd.dict_vec), name
        assert funcs.lookup(name.lower()) is fd


_DEC = [decimal.Decimal(x) for x in ("0", "1.50", "-7.89", "123.456789",
                                     "999999999999.123457", "0.000001")]
_INTS = [0, 1, -1, 2, 7, 12, 255, 86400, 200801, 733321, 167773449,
         2 ** 40 + 3, -7200]
_FLOATS = [0.0, 0.5, -0.25, 1.0, 3.75, 1e-3, 123.456]
_WORDS = ["", "a", "Robert", "www.mysql.com", "Hello World", "abc def ghi",
          "ff", "4142", "YWJj", "x.y.z", "Ünïcødé", "it's", "10", "-3"]
_DATES = [0, 1, 10957, 14000, 19768, -1, 2932896]  # day numbers
_DATE_STRS = ["2024-02-15", "2008-02-20", "1987-01-01", "2024-01-02 01:00:00",
              "2024-02-30", "1970-01-01 00:00:00"]
_TIMES = ["01:01:01", "-02:00:00", "10:00:00", "13:05:09", "26:30:00",
          "2024-01-01 23:30:00", "bad"]
_FMTS = ["%Y-%m-%d", "%W %M %Y", "%d.%m.%Y", "%h:%i %p", "%c/%e %k:%i",
         "%j %U %u %a %b %T %%", "%d,%c,%Y"]
_TZS = ["+00:00", "+05:30", "-03:00", "UTC", "SYSTEM", "Europe/Berlin"]
_JSON = ['{"a": 1, "b": [1, 2, 3], "c": {"d": "x"}}', "[1, 2]", "[true]",
         '{"x": "abc", "y": ["abc"]}', "3", '"s"', "null", "{bad"]
_PATHS = ["$", "$.a", "$.b[0]", "$.c", "$.c.d", "$.z", "$[1]", "$.b[*]"]
_IPS = ["10.0.5.9", "::1", "fe80::1", "::ffff:10.0.0.1", "::10.0.0.1",
        "300.1.1.1", "x"]
_REGEX = ["^a", "[a-z]+", "b", "dog", "(", ".*"]


def _pool(name: str, i: int) -> list:
    """The argument pool of position `i` of builtin `name`: values of its
    domain, plus a few strangers and NULL."""
    num = _INTS + _FLOATS + _DEC
    if name.startswith("JSON_"):
        if i == 0 or name in ("JSON_MERGE", "JSON_MERGE_PATCH",
                              "JSON_MERGE_PRESERVE", "JSON_OVERLAPS"):
            return _JSON
        if name in ("JSON_CONTAINS_PATH", "JSON_SEARCH") and i == 1:
            return ["one", "all", "some"]
        if name == "JSON_SEARCH" and i == 2:
            return ["abc", "x", "%b%"]
        if name == "JSON_CONTAINS" and i == 1:
            return _JSON + ["2", "9", "true"]
        if name in ("JSON_SET", "JSON_INSERT", "JSON_REPLACE",
                    "JSON_ARRAY_APPEND") and i % 2 == 0:
            return [5, "v", 1.5, None]
        return _PATHS
    if name in ("DATE_FORMAT", "TIME_FORMAT", "STR_TO_DATE",
                "FROM_UNIXTIME") and i == 1:
        return _FMTS
    if name in ("DATE_FORMAT", "DAYNAME", "MONTHNAME", "WEEK", "WEEKOFYEAR",
                "YEARWEEK", "TO_DAYS", "ADDDATE", "SUBDATE",
                "TIMESTAMPDIFF_DAYS", "UNIX_TIMESTAMP") and (
                    i == 0 or name == "TIMESTAMPDIFF_DAYS"):
        return _DATES + _DATE_STRS
    if name == "STR_TO_DATE":
        return ["01,5,2013", "2024-02-15", "13:05:09", "x"]
    if name in ("ADDTIME", "SUBTIME", "TIMEDIFF", "TIME", "TIME_TO_SEC",
                "TIME_FORMAT"):
        return _TIMES
    if name == "CONVERT_TZ":
        return _DATE_STRS if i == 0 else _TZS
    if name.startswith(("INET", "IS_IP")):
        return _IPS + [167773449, 0]
    if name.startswith("REGEXP_"):
        if i == 1:
            return _REGEX
        if i >= 2 and name != "REGEXP_REPLACE":
            return [1, 2, 5, 0, -1]
        return _WORDS if i == 0 else ["X", "", "\\1"] + [1, 2]
    if name in ("CONV",):
        return ["ff", "255", "-10", "zz", 255] if i == 0 else [2, 10, 16, 36,
                                                                -10, 1]
    if name in ("SLEEP", "BENCHMARK"):
        return [0, 0.01, None]
    if name in ("RANDOM_BYTES", "SPACE"):
        return [0, 1, 16, 2000, -1]
    if name == "SHA2" and i == 1:
        return [0, 224, 256, 384, 512, 1]
    if name in ("MAKEDATE", "MAKETIME", "PERIOD_ADD", "PERIOD_DIFF",
                "FROM_DAYS", "SEC_TO_TIME", "BIT_COUNT", "INET_NTOA",
                "EXPORT_SET", "MAKE_SET", "ELT", "CHAR", "FORMAT_BYTES",
                "TIDB_PARSE_TSO") or name in (
                    "ACOS", "ASIN", "ATAN", "ATAN2", "CBRT", "COS", "COSH",
                    "COT", "DEGREES", "RADIANS", "SIN", "SINH", "TAN",
                    "TANH", "MOD", "FORMAT", "BIN", "OCT", "HEX"):
        if name in ("EXPORT_SET", "MAKE_SET", "ELT") and i > 0:
            return _WORDS[:6] + [4, ","]
        return num + ["12", "x"]
    return _WORDS + [7, 1.5, decimal.Decimal("2.50")]


def _draw(name: str, fd, rng: random.Random) -> list:
    hi = min(fd.max_args, fd.min_args + 3)
    args = []
    for i in range(rng.randint(fd.min_args, hi)):
        pool = _pool(name, i)
        args.append(None if rng.random() < 0.08 else rng.choice(pool))
    return args


def _call(fd, args):
    if fd.null_prop and any(a is None for a in args):
        return ("null",)  # the evaluator short-circuits before fd.fn
    try:
        r = fd.fn(*args)
    except Exception as e:  # compared by class and text
        return ("raise", type(e).__name__, str(e))
    return ("value", type(r).__name__, repr(r))


# builtins whose value is random by design: compared by kind and shape
_RANDOM = {"RAND", "UUID", "UUID_SHORT", "RANDOM_BYTES"}


@pytest.mark.parametrize("name", sorted(ref_funcs.REGISTRY))
def test_registry_fn_on_seeded_arguments(name):
    fd, rd = funcs.REGISTRY[name], ref_funcs.REGISTRY[name]
    rng = random.Random(f"registry:{name}")
    for _ in range(40):
        args = _draw(name, fd, rng)
        got, want = _call(fd, args), _call(rd, args)
        if name in _RANDOM and got[0] == "value":
            assert got[:2] == want[:2], (name, args)
            if name == "UUID":
                assert re.fullmatch(r"[0-9a-f]{8}(-[0-9a-f]{4}){3}-"
                                    r"[0-9a-f]{12}", eval(got[2]))
            elif name == "RANDOM_BYTES" and got[1] == "str":
                assert len(eval(got[2])) == len(eval(want[2]))
            continue
        assert got == want, (name, args)


# ==================== the clock ====================

def test_clock_functions_with_time_patched(fixed_clock):
    k = Twin()
    rows = k.query("select now(), current_timestamp(), sysdate(), "
                   "localtime, localtimestamp, curdate(), current_date, "
                   "curtime(), current_time, unix_timestamp()")
    day, clock = "2024-02-15", "13:45:30"
    assert rows == [(f"{day} {clock}",) * 5 + (day, day, clock, clock,
                                               int(fixed_clock))]
    # bound per statement: a filter over the clock plans like a constant
    k.execute("create table ck (d date, v int)")
    k.execute("insert into ck values ('2024-02-15', 1), ('2024-02-14', 2)")
    assert k.query("select v from ck where d = curdate()") == [(1,)]
    assert k.query("select datediff(curdate(), d) from ck order by v") \
        == [(0,), (1,)]


# ==================== over the wire ====================

def _conn_id(c: MiniClient) -> int:
    return int(c.query("select connection_id()")[0][0])


def test_time_zone_does_not_leak_across_connections():
    """One worker thread serves both connections of each server: the
    first's SET time_zone must not reach the second's statements."""
    port, ref = _servers(conn_workers=1)
    try:
        got = []
        for srv in (port, ref):
            a = MiniClient("127.0.0.1", srv.port)
            b = MiniClient("127.0.0.1", srv.port)
            a.execute("set time_zone = '+08:00'")
            got.append((a.query("select from_unixtime(0)"),
                        b.query("select from_unixtime(0)"),
                        a.query("select @@time_zone"),
                        b.query("select from_unixtime(0, '%H:%i')")))
            a.close()
            b.close()
        assert got[0] == got[1]
        assert got[0] == ([("1970-01-01 08:00:00",)],
                          [("1970-01-01 00:00:00",)], [("+08:00",)],
                          [("00:00",)])
    finally:
        _close(port, ref)


def test_get_lock_across_wire_connections_and_close():
    port, ref = _servers()
    try:
        got = []
        for srv in (port, ref):
            a = MiniClient("127.0.0.1", srv.port)
            b = MiniClient("127.0.0.1", srv.port)
            ida = _conn_id(a)
            out = [a.query("select get_lock('w', 0), get_lock('w', 0)"),
                   b.query("select get_lock('w', 0), is_free_lock('w')"),
                   b.query("select is_used_lock('w') = connection_id()"),
                   b.query("select release_lock('w')"),
                   a.query("select release_lock('w')")]
            assert int(b.query("select is_used_lock('w')")[0][0]) == ida
            a.close()  # connection close releases what it still holds
            deadline = time.monotonic() + 5.0
            while srv.storage.user_locks.holder("w") is not None:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            out.append(b.query("select get_lock('w', 0)"))
            out.append(b.query("select release_all_locks()"))
            b.close()
            got.append(out)
        assert got[0] == got[1]
        assert got[0] == [[("1", "1")], [("0", "0")], [("0",)], [("0",)],
                          [("1",)], [("1",)], [("1",)]]
    finally:
        _close(port, ref)


def test_sleep_ended_by_kill_query():
    """KILL QUERY from a second connection ends SELECT SLEEP(20) with
    errno 1317 on both servers, and the connection answers next."""
    port, ref = _servers()
    try:
        got = []
        for srv in (port, ref):
            a = MiniClient("127.0.0.1", srv.port)
            b = MiniClient("127.0.0.1", srv.port)
            ida = _conn_id(a)
            a.execute("create table if not exists sl (v int)")
            a.execute("insert into sl values (1), (2)")
            box = {}

            def sleeper():
                t0 = time.monotonic()
                try:
                    box["rows"] = a.query("select sleep(20)")
                except MySQLError as e:
                    box["err"] = (e.code, str(e))
                box["s"] = time.monotonic() - t0

            th = threading.Thread(target=sleeper)
            th.start()
            time.sleep(0.3)
            t0 = time.monotonic()
            b.execute(f"kill query {ida}")
            th.join(timeout=10)
            assert not th.is_alive()
            assert time.monotonic() - t0 < 2.0
            got.append((box.get("err"), a.query("select sum(v) from sl")))
            a.close()
            b.close()
        assert got[0] == got[1]
        assert got[0][0][0] == 1317
        assert got[0][1] == [("3",)]
    finally:
        _close(port, ref)


def test_sleep_interrupted_in_process_leaves_session_usable():
    k = Twin()
    k.execute("create table su (a int, s varchar(8))")
    k.execute("insert into su values (1, 'x'), (2, 'y')")
    for s in k.sessions:
        timer = threading.Timer(0.2, s.killed.set)
        timer.start()
        with pytest.raises(Exception) as ei:
            s.execute("select a, sleep(5) from su where a > 0")
        timer.join()
        assert getattr(ei.value, "errno", None) == 1317
    assert k.query("select sum(a), max(s) from su") == [(3, "y")]


# ==================== the two registry paths ====================

def _row_evals(fn: str) -> tuple:
    return (obs.REGISTRY_ROW_EVALS.get(func=fn),
            ref_obs.REGISTRY_ROW_EVALS.get(func=fn))


@pytest.mark.parametrize("sql,fn,path", [
    ("select substring_index(m, 'A', 1) k, count(*) from rp group by k "
     "order by k", "SUBSTRING_INDEX", "dict"),
    ("select count(*) from rp where regexp_like(m, '^[RT]') = 1",
     "REGEXP_LIKE", "dict"),
    ("select count(*) from rp where soundex(m) = 'M400' and q < 30",
     "SOUNDEX", "rows"),
    ("select date_format(d, '%Y-%m') mo, sum(q) from rp "
     "where d < '1995-01-01' group by mo order by mo", "DATE_FORMAT",
     "rows"),
    ("select sha2(m, 256) from rp order by id limit 3", "SHA2", "rows"),
    # fewer rows than dictionary values: per row is cheaper
    ("select substring_index(m, 'A', 1) from rp where id < 3 order by id",
     "SUBSTRING_INDEX", "rows"),
])
def test_registry_paths_count_alike(sql, fn, path):
    k = Twin()
    k.execute("create table rp (id int primary key, m varchar(10), "
              "q int, d date)")
    modes = ["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "REG AIR", "FOB"]
    day0 = datetime.date(1993, 1, 1)
    vals = ", ".join(
        f"({i}, '{modes[i * 5 % 7]}', {i % 50}, "
        f"'{day0 + datetime.timedelta(days=i * 11)}')"
        for i in range(200))
    k.execute(f"insert into rp values {vals}")
    before = _row_evals(fn)
    k.query(sql)
    after = _row_evals(fn)
    port_rows, ref_rows = after[0] - before[0], after[1] - before[1]
    assert port_rows == ref_rows
    assert (port_rows == 0) == (path == "dict")


def test_registry_filter_stays_in_the_root_selection():
    k = Twin()
    k.execute("create table ex (a int, m varchar(10), d date)")
    k.execute("insert into ex values (1, 'MAIL', '1995-03-01')")
    plan = k.query("explain select count(*) from ex where "
                   "soundex(m) = 'M400' and a < 10")
    text = "\n".join(r[0] for r in plan)
    assert "Selection: [eq(fx:SOUNDEX(" in text
    assert plan[-1][0].lstrip().startswith("TableRead[TiTPU]: scan(")
    assert k.query("select count(*) from ex where soundex(m) = 'M400' "
                   "and a < 10") == [(1,)]
    assert k.port.last_engines == ["device"]
