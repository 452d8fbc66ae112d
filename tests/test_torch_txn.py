"""Transactions of two sessions over one Storage, port against reference.

Each scenario runs once on two reference sessions over one reference
`Storage()` and once on two port sessions over one port `Storage()`, with
the same statements in the same order (a second thread where a session
must block), and records every statement's outcome: affected count and
rows, or the errno. The two records must be equal, and so must the rows
the table ends with.

* optimistic: the later committer of a conflicting explicit txn gets 9007;
  an autocommit statement that loses the race is retried at a fresh
  start_ts (`tidb_retry_limit`), and with the limit at 0 it fails;
* PESSIMISTIC: a writer waits on a row lock and resumes after the holder
  commits; a short `innodb_lock_wait_timeout` gives 1205; two txns that
  lock in opposite orders give 1213 to the one that closes the cycle;
* SELECT ... FOR UPDATE: locks rows in a pessimistic txn (a concurrent
  writer waits for the commit), takes no lock in an optimistic one.
"""

import threading
import time

import pytest

from tidb_tpu.session import Session as RefSession
from tidb_tpu.store import Storage as RefStorage
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

SIDES = {"port": (Session, Storage, {"device": "cpu"}),
         "ref": (RefSession, RefStorage, {})}


class Side:
    def __init__(self, name: str) -> None:
        sess, storage, kw = SIDES[name]
        self.storage = storage()
        self.s1 = sess(self.storage, **kw)
        self.s2 = sess(self.storage, **kw)
        self.log: list = []
        self.s1.execute("create table t (id int primary key, v int, "
                        "w varchar(8))")
        self.s1.execute("insert into t values (1, 100, 'a'), (2, 200, 'b'),"
                        " (3, 300, 'c')")

    def run(self, s, sql: str):
        try:
            rs = s.execute(sql)
            out = (rs.affected, TR.sql_cells(rs.rows))
        except Exception as e:  # the session error, by its errno
            out = ("error", getattr(e, "errno", None))
        self.log.append((sql, out))
        return out

    def rows(self):
        return TR.sql_cells(self.s1.query("select * from t order by id"))


def _same(scenario):
    logs = []
    for name in ("port", "ref"):
        side = Side(name)
        scenario(side)
        logs.append((side.log, side.rows()))
    assert logs[0] == logs[1]
    return logs[0]


def _thread(fn):
    th = threading.Thread(target=fn)
    th.start()
    return th


def test_optimistic_conflict_fails_the_later_commit():
    def sc(x):
        x.run(x.s1, "begin")
        x.run(x.s1, "update t set v = v + 1 where id = 1")
        x.run(x.s1, "select v from t where id = 1")
        x.run(x.s2, "update t set v = v + 10 where id = 1")
        x.run(x.s1, "commit")
        x.run(x.s1, "select v from t where id = 1")
    log, rows = _same(sc)
    assert log[4][1] == ("error", 9007)
    assert rows[0] == (1, 110, "a")


@pytest.mark.parametrize("retry_limit", [10, 0])
def test_autocommit_retry_after_a_lost_race(retry_limit):
    """A sibling commits the same row between the autocommit statement's
    start and its commit (injected once, in the storage's commit)."""
    def sc(x):
        x.run(x.s1, f"set tidb_retry_limit = {retry_limit}")
        real = x.storage.commit
        raced = []

        def commit(txn):
            if not raced and txn.memdb.mutations():
                raced.append(1)
                x.run(x.s2, "update t set v = v + 10 where id = 2")
            return real(txn)

        x.storage.commit = commit
        x.run(x.s1, "update t set v = v * 2 where id = 2 or id = 3")
        x.storage.commit = real
    log, rows = _same(sc)
    if retry_limit:
        assert log[2][1] == (2, []) and rows[1] == (2, 420, "b")
    else:
        assert log[2][1] == ("error", 9007) and rows[1] == (2, 210, "b")


def test_pessimistic_writer_waits_for_the_holder():
    def sc(x):
        x.run(x.s1, "begin pessimistic")
        x.run(x.s1, "update t set v = v + 1 where id = 1")
        x.run(x.s2, "begin pessimistic")
        th = _thread(lambda: x.run(x.s2,
                                   "update t set v = v * 3 where id = 1"))
        time.sleep(0.3)
        assert th.is_alive()  # blocked on s1's row lock
        x.run(x.s1, "commit")
        th.join(30)
        x.run(x.s2, "select v from t where id = 1")
        x.run(x.s2, "commit")
    log, rows = _same(sc)
    outs = dict(log)
    assert outs["update t set v = v * 3 where id = 1"] == (1, [])
    assert outs["select v from t where id = 1"] == (0, [(303,)])
    assert rows[0] == (1, 303, "a")


def test_pessimistic_lock_wait_timeout_1205():
    def sc(x):
        x.run(x.s2, "set innodb_lock_wait_timeout = 1")
        x.run(x.s1, "begin pessimistic")
        x.run(x.s1, "delete from t where id = 3")
        x.run(x.s2, "begin pessimistic")
        x.run(x.s2, "update t set v = 0 where id >= 2")
        x.run(x.s2, "update t set v = 0 where id = 1")
        x.run(x.s2, "commit")
        x.run(x.s1, "commit")
    log, rows = _same(sc)
    assert log[4][1] == ("error", 1205)
    assert rows == [(1, 0, "a"), (2, 200, "b")]


def test_pessimistic_deadlock_1213():
    def sc(x):
        x.run(x.s1, "begin pessimistic")
        x.run(x.s2, "begin pessimistic")
        x.run(x.s1, "update t set w = 'x1' where id = 1")
        x.run(x.s2, "update t set w = 'y2' where id = 2")
        th = _thread(lambda: x.run(x.s1,
                                   "update t set w = 'x2' where id = 2"))
        time.sleep(0.3)  # s1 now waits for s2
        x.run(x.s2, "update t set w = 'y1' where id = 1")
        x.run(x.s2, "rollback")
        th.join(30)
        x.run(x.s1, "commit")
    log, rows = _same(sc)
    outs = dict((sql, o) for sql, o in log)
    assert outs["update t set w = 'y1' where id = 1"] == ("error", 1213)
    assert outs["update t set w = 'x2' where id = 2"] == (1, [])
    assert rows[:2] == [(1, 100, "x1"), (2, 200, "x2")]


@pytest.mark.parametrize("mode", ["pessimistic", "optimistic"])
def test_select_for_update(mode):
    def sc(x):
        x.run(x.s1, f"begin {mode}")
        x.run(x.s1, "select v from t where id = 1 for update")
        th = _thread(lambda: x.run(x.s2,
                                   "update t set v = v + 10 where id = 1"))
        time.sleep(0.3)
        x.run(x.s1, "update t set v = v + 1 where id = 1")
        x.run(x.s1, "commit")
        th.join(30)
    log, rows = _same(sc)
    outs = dict(log)
    assert outs["select v from t where id = 1 for update"] == (0, [(100,)])
    if mode == "pessimistic":
        # the autocommit writer waited for the commit, then retried past
        # its write conflict
        assert outs["update t set v = v + 10 where id = 1"] == (1, [])
        assert rows[0] == (1, 111, "a")
    else:
        # no lock: the writer committed first, the txn's commit conflicts
        assert log[-1][1] == ("error", 9007)
        assert rows[0] == (1, 110, "a")
