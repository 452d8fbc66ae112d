"""The port's Session surface on small hand-made tables, against the
reference.

Both sessions run the same statements in the same order: CREATE TABLE
with a primary key, a unique column and a secondary index, then a bulk
load of the same rows (NULLs included), then SELECTs with a scalar
subquery, an IN subquery, UNION and UNION ALL, window functions, joins,
grouping and an index-ranged scan. Rows (exact: a Decimal by its unscaled
integer and scale), column names, engine tags and EXPLAIN text must be the
reference's. ANALYZE TABLE builds the reference's statistics, on the host
path and on the coprocessor's device path alike, and an error of the
device pass is not caught. The statements of the statement plane (INTO
OUTFILE, TRACE, LOAD DATA, EXPLAIN ANALYZE, bindings) and SHOW
PROCESSLIST answer as the reference does, times excluded; a
`Session()` without CUDA raises at its first statement that needs the
coprocessor and never moves to the CPU.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from tidb_tpu.session import Session as RefSession
from tidb_tpu_torch import NotInSlice
from tidb_tpu_torch.chunk.column import _encode_scalar
from tidb_tpu_torch.session import Session

from test_torch_sql_tpch import norm_rows

DDL = [
    "create table dept (id int primary key, dname varchar(20) unique, "
    "budget decimal(12,2))",
    "create table emp (id bigint primary key, name varchar(20) not null, "
    "dept int, salary decimal(10,2), hired date, key kdept (dept))",
]
DEPT = [(1, "Engineering", "900000.00"), (2, "Sales", "350000.50"),
        (3, "Ops", None), (4, "Empty", "1.00")]
NAMES = ["ann", "bob", "cy", "dee", "eve", "fay", "gus", "hal"]


def _emp_rows(n=200, seed=3):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(1, n + 1):
        dept = None if i % 17 == 0 else int(rng.integers(1, 4))
        sal = None if i % 13 == 0 else f"{int(rng.integers(3000, 9000))}." \
            f"{int(rng.integers(0, 100)):02d}"
        day = f"20{int(rng.integers(10, 24))}-0{int(rng.integers(1, 10))}-1" \
            f"{int(rng.integers(0, 10))}"
        rows.append((i, f"{NAMES[i % 8]}{i % 11}", dept, sal, day))
    return rows


def bulk_load(session, table, rows):
    """Encode python rows with the table's own dictionaries and bulk-load
    them (NULL -> invalid)."""
    info = session.catalog.table(session.current_db, table)
    store = session.storage.table_store(info.id)
    cols, valids = [], []
    for c in info.columns:
        vals = [r[c.offset] for r in rows]
        valid = np.array([v is not None for v in vals])
        d = store.dictionaries[c.offset]
        data = [_encode_scalar(c.ftype, v, d) if v is not None else 0
                for v in vals]
        cols.append(np.array(data, dtype=c.ftype.np_dtype))
        valids.append(None if valid.all() else valid)
    store.bulk_load(cols, valids)


@pytest.fixture()
def both():
    ref, port = RefSession(), Session(device="cpu")
    for s in (ref, port):
        for stmt in DDL:
            s.execute(stmt)
        bulk_load(s, "dept", DEPT)
        bulk_load(s, "emp", _emp_rows())
    return ref, port


QUERIES = {
    "scalar_subquery":
        "select id, name, salary from emp "
        "where salary > (select avg(salary) from emp) order by id",
    "in_subquery":
        "select name, dept from emp where dept in "
        "(select id from dept where dname like '%s%') order by id",
    "not_in_subquery":
        "select count(*) from emp where dept not in (select id from dept "
        "where budget > 1000)",
    "union":
        "select dept from emp union select id from dept order by dept",
    "union_all":
        "select name from emp where id < 5 union all "
        "select dname from dept order by name",
    "window":
        "select id, dept, salary, rank() over (partition by dept "
        "order by salary desc) as r, sum(salary) over (partition by dept) "
        "from emp order by id",
    "join_group":
        "select d.dname, count(*), sum(e.salary), avg(e.salary), "
        "min(e.hired) from emp e join dept d on e.dept = d.id "
        "group by d.dname order by d.dname",
    "left_join":
        "select d.dname, count(e.id) from dept d left join emp e "
        "on e.dept = d.id group by d.dname order by d.dname",
    "index_range":
        "select id, name from emp where dept = 2 and id < 40 order by id",
    "topn":
        "select id, salary from emp order by salary desc, id limit 7",
    "having_distinct":
        "select dept, count(distinct name) as n from emp group by dept "
        "having n > 3 order by dept",
    "dual":
        "select 1 + 2, 'x'",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_select_matches_reference(both, name):
    ref, port = both
    sql = QUERIES[name]
    want = ref.execute(sql)
    want_engines = list(ref.last_engines)
    got = port.execute(sql)
    assert got.column_names == want.column_names
    assert port.last_engines == want_engines
    ordered = "order by" in sql
    assert norm_rows(got.rows, ordered) == norm_rows(want.rows, ordered)
    if name != "dual":
        assert got.rows


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_explain_matches_reference(both, name):
    ref, port = both
    sql = "explain " + QUERIES[name]
    assert port.query(sql) == ref.query(sql)


def _stats(session, table):
    info = session.catalog.table(session.current_db, table)
    ts = session.storage.stats.table_stats(info.id)
    return ts.row_count, {off: (cs.null_count, cs.ndv)
                          for off, cs in sorted(ts.columns.items())}


@pytest.mark.parametrize("device_pass", [False, True])
def test_analyze_table_matches_reference(both, device_pass):
    ref, port = both
    lo = 0 if device_pass else 2_000_000
    with mock.patch.object(type(ref.storage.stats), "DEVICE_ANALYZE_MIN",
                           lo), \
            mock.patch.object(type(port.storage.stats),
                              "DEVICE_ANALYZE_MIN", lo):
        ref.execute("analyze table emp, dept")
        port.execute("analyze table emp, dept")
    for t in ("emp", "dept"):
        assert _stats(port, t) == _stats(ref, t)
    sql = "explain " + QUERIES["join_group"]
    assert port.query(sql) == ref.query(sql)


def test_analyze_device_error_is_not_caught(both):
    _, port = both
    with mock.patch.object(type(port.storage.stats), "DEVICE_ANALYZE_MIN",
                           0), \
            mock.patch("tidb_tpu_torch.copr.analyze.device_column_stats",
                       side_effect=RuntimeError("device pass failed")):
        with pytest.raises(RuntimeError, match="device pass failed"):
            port.execute("analyze table emp")


@pytest.mark.parametrize("sql,kind", [
    ("select id from emp into outfile 'x.csv'", "INTO OUTFILE"),
    ("trace select id from emp", "TraceStmt"),
    ("show processlist", "SHOW PROCESSLIST"),
    ("load data infile 'x.csv' into table emp", "LoadDataStmt"),
    ("explain analyze select id from emp", "EXPLAIN ANALYZE"),
    ("create binding for select id from emp using select id from emp",
     "CreateBindingStmt"),
])
def test_statements_outside_the_slice_raise(both, sql, kind, tmp_path,
                                            monkeypatch):
    """A kind whose plane is ported (IN_SLICE_SINCE) answers as the
    reference does in its own directory (OUTFILE's relative path), times
    excluded; the others raise `NotInSlice` by name."""
    ref, port = both
    if kind in IN_SLICE_SINCE:
        got = []
        for name, s in (("ref", ref), ("port", port)):
            (tmp_path / name).mkdir()
            monkeypatch.chdir(tmp_path / name)
            try:
                got.append(_untimed(s.execute(sql)))
            except Exception as e:  # compared below, class and errno
                got.append((type(e).__name__, getattr(e, "errno", None),
                            str(e)))
        assert got[0] == got[1], sql
    else:
        with pytest.raises(NotInSlice) as e:
            port.execute(sql)
        assert e.value.reason == kind
    assert port.query("select count(*) from emp") == [(200,)]


# the statement plane's kinds, which answer since their port, and SHOW
# PROCESSLIST since the server process's
IN_SLICE_SINCE = {"INTO OUTFILE", "TraceStmt", "LoadDataStmt",
                  "EXPLAIN ANALYZE", "CreateBindingStmt", "SHOW PROCESSLIST"}
# columns that hold times (EXPLAIN ANALYZE, TRACE)
_TIMED = {"time_ms", "stages", "start_ms", "duration_ms"}


def _untimed(rs) -> tuple:
    """A result without its time columns and without the spans of the
    first compile or of staging uploads (a JAX first call compiles; the
    port stages nothing for a bare scan)."""
    keep = [i for i, c in enumerate(rs.column_names) if c not in _TIMED]
    rows = [tuple(r[i] for i in keep) for r in rs.rows]
    rows = [r for r in rows if not (isinstance(r[0], str) and r[0].strip()
                                    in ("transfer", "xla.compile"))]
    return rs.affected, [rs.column_names[i] for i in keep], rows


def test_database_and_drop_table(both):
    ref, port = both
    for s in (ref, port):
        s.execute("create database if not exists shop")
        s.execute("use shop")
        s.execute("create table t (a int primary key, b varchar(4))")
        bulk_load(s, "t", [(1, "x"), (2, None)])
    assert port.query("select b, a from t order by a") == \
        ref.query("select b, a from t order by a") == [("x", 1), (None, 2)]
    for s in (ref, port):
        s.execute("drop table t")
        s.execute("drop table if exists t")
        s.execute("use test")
    assert port.catalog.try_table("shop", "t") is None
    assert port.catalog.table("test", "emp").id == \
        ref.catalog.table("test", "emp").id


def test_session_without_cuda_raises_at_the_coprocessor():
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        s = Session()
        s.execute("create table t (a int primary key)")
        [(plan,)] = s.query("explain select a from t")
        assert plan.startswith("TableRead[TiTPU]: scan(")
        assert s._cop is None
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            s.query("select a from t")
        assert s._cop is None
