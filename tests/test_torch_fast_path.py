"""The point fast path (`plan/fastpath.py`) against the reference.

* `try_plan` decides as the reference's over a corpus of point and
  non-point statements: the same kind, handle, unique index, key values,
  residual conjuncts, output columns, limit, assignments and insert rows
  where it recognizes one, None where it rejects (non-key WHERE, ranges,
  ORs, NULL keys, float/decimal keys, expressions the slow path owns,
  joins, ORDER BY, FOR UPDATE, unique secondary indexes on INSERT, key
  rewrites, unknown tables).
* Executed through a Session, each statement gives the reference's rows,
  affected counts, errnos and the engine tag `point` (and only then), and
  the store ends equal to the reference's.
* A `Session()` with CUDA absent answers point statements without ever
  building its coprocessor client, and raises at its first coprocessor
  read: nothing moves to the CPU on its own.
"""

from unittest import mock

import pytest
import torch

from tidb_tpu.plan import fastpath as ref_fastpath
from tidb_tpu.session import Session as RefSession
from tidb_tpu.sql.parser import parse_sql as ref_parse_sql
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.plan import fastpath
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.sql.parser import parse_sql

from test_torch_sql_tpch import tree
from test_torch_store_writes import store_state

DDL = [
    "create table kv (id bigint primary key, k int, c varchar(20), "
    "f double, d decimal(8,2))",
    "create table u (a int, b varchar(10), n int, unique key ub (b), "
    "unique key uan (a, n))",
    "create table nopk (x int, y int)",
    "insert into kv values (1, 10, 'one', 1.5, 1.25), (2, 20, 'two', null, "
    "2.50), (3, 30, null, 3.5, null)",
    "insert into u values (1, 'p', 1), (2, 'q', 2), (3, null, 3)",
    "insert into nopk values (1, 2)",
]

CORPUS = [
    # recognized
    "select id, k, c from kv where id = 2",
    "select * from kv where id = 3",
    "select c, k from kv where 1 = id",
    "select k from kv where id = 2 and k = 20",
    "select k from kv where id = 2 and c = 'two'",
    "select k from kv where id = 2 and k = 21",
    "select id from kv where id = 99",
    "select k from kv where id = 1 limit 1",
    "select kv.k from kv where kv.id = 1",
    "select n from u where b = 'q'",
    "select a, b from u where a = 3 and n = 3",
    "select n from u where b = 'absent'",
    "update kv set k = k + 1 where id = 1",
    "update kv set k = k * 2 - 3, f = f + 1 where id = 2",
    "update kv set c = 'lit', d = 9.99 where id = 3",
    "update kv set k = null where id = 1",
    "update kv set k = 5 where id = 42",
    "delete from kv where id = 3",
    "delete from kv where id = 3",
    "delete from u where a = 2 and n = 2",
    "insert into kv values (7, 70, 'seven', 7.5, 7.75)",
    "insert into kv (id, k) values (8, 80), (9, 90)",
    "insert into kv values (1, 1, 'dup', 1, 1)",
    "insert into nopk values (3, 4), (5, 6)",
    "insert into kv (k) values (100)",
    # rejected: the planned path answers
    "select k from kv where id > 1",
    "select k from kv where id = 1 or id = 2",
    "select k from kv where id = null",
    "select k from kv where id = 1.0",
    "select k from kv where f = 1.5",
    "select k + 1 from kv where id = 1",
    "select count(*) from kv where id = 1",
    "select k from kv where id = 1 order by k",
    "select k from kv where id = 1 for update",
    "select k from kv where id = 1 limit 0",
    "select k from kv where k = 10",
    "select kv.k from kv, nopk where kv.id = 1",
    "select b from u where a = 1",
    "select n from u where b = 1",
    "update kv set id = 5 where id = 1",
    "update kv set c = concat(c, 'x') where id = 1",
    "update kv set k = k / 2 where id = 1",
    "update kv set k = 1 where k = 10",
    "update u set b = 'z' where a = 1 and n = 1",
    "update u set n = n + 1 where b = 'p'",
    "delete from kv where id in (1, 2)",
    "delete from nopk where x = 1",
    "insert into u values (9, 'r', 9)",
    "insert into kv select * from kv where id = 1",
    "replace into kv values (1, 1, 'r', 1, 1)",
    "insert into kv values (11, 1 + 1, 'e', 1, 1)",
    "insert into kv values (12, 1, 'a', 1, 1) on duplicate key update k = 2",
    "select k from nosuch where id = 1",
    "select k from information_schema.tables where id = 1",
]


def _plan_fields(fp):
    if fp is None:
        return None
    return (fp.kind, fp.info.name, fp.handle,
            None if fp.index is None else fp.index.name, fp.key_values,
            fp.residual, fp.select_offsets, fp.names,
            [f.kind.name for f in fp.ftypes], fp.limit,
            [(o, tree(e)) for o, e in fp.assigns],
            TR.sql_cells(fp.insert_rows), fp.col_order)


@pytest.fixture(scope="module")
def sessions():
    ref, port = RefSession(), Session(device="cpu")
    for s in (ref, port):
        for sql in DDL:
            s.execute(sql)
    return ref, port


@pytest.mark.parametrize("sql", CORPUS)
def test_try_plan_decides_as_the_reference(sessions, sql):
    ref, port = sessions
    got = fastpath.try_plan(port, parse_sql(sql)[0])
    want = ref_fastpath.try_plan(ref, ref_parse_sql(sql)[0])
    assert _plan_fields(got) == _plan_fields(want)


def test_corpus_recognizes_and_rejects(sessions):
    ref, port = sessions
    seen = [fastpath.try_plan(port, parse_sql(sql)[0]) is not None
            for sql in CORPUS]
    assert seen == [True] * 25 + [False] * (len(CORPUS) - 25)


def _outcome(s, sql):
    try:
        rs = s.execute(sql)
    except Exception as e:  # the session error, by its errno
        return ("error", getattr(e, "errno", None), list(s.last_engines))
    return (rs.affected, TR.sql_cells(rs.rows), list(s.last_engines))


def test_statements_execute_as_the_reference():
    ref, port = RefSession(), Session(device="cpu")
    for s in (ref, port):
        for sql in DDL:
            s.execute(sql)
    for sql in CORPUS:
        if "information_schema" in sql:
            continue  # the reference materializes it; no port yet
        got, want = _outcome(port, sql), _outcome(ref, sql)
        assert got == want, sql
        recognized = fastpath.try_plan(port, parse_sql(sql)[0]) is not None
        assert (got[-1] == ["point"]) == recognized or got[0] == "error", \
            sql
    for name in ("kv", "u", "nopk"):
        assert store_state(port.storage.table_store(
            port.catalog.table("test", name).id)) == store_state(
            ref.storage.table_store(ref.catalog.table("test", name).id))


def test_fast_path_is_off_in_explicit_txns_and_when_disabled():
    tags = []
    for s in (Session(device="cpu"), RefSession()):
        for sql in DDL[:1] + DDL[3:4]:
            s.execute(sql)
        seen = []
        for sql in ("select k from kv where id = 1", "begin",
                    "select k from kv where id = 1", "commit",
                    "set tidb_enable_fast_path = 0",
                    "select k from kv where id = 1"):
            s.execute(sql)
            seen.append(list(s.last_engines))
        tags.append(seen)
    assert tags[0] == tags[1]
    assert tags[0][0] == ["point"]
    assert ["point"] not in tags[0][1:]


def test_point_statements_need_no_cuda():
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        s = Session()
        for sql in DDL[:1] + DDL[3:4]:
            s.execute(sql)
        assert s.query("select c from kv where id = 2") == [("two",)]
        assert s.execute("update kv set k = k + 1 where id = 2").affected == 1
        assert s.execute("delete from kv where id = 1").affected == 1
        assert s.query("select k from kv where id = 2") == [(21,)]
        assert s._cop is None  # the client was never built
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            s.query("select sum(k) from kv")
        assert s._cop is None
