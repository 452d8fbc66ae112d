"""DML, SET and TRUNCATE through the port's Session against the reference.

The same statements, in the same order, go to a reference
`Session(Storage())` and a port `Session(device="cpu")`. Each statement
gives the reference's affected count, errno (on error), rows (exactly: a
Decimal by unscaled integer and scale, a float by its hex form) and
engine tags (`point` for the fast path, `device...`/`host(...)` for the
coprocessor's reads). After the corpus the stores are equal table by
table: the epoch (handles, columns, valids), the dictionaries, and the
deltas as (handle, row) in commit order.

The corpus: INSERT with all columns, a column list, defaults,
auto_increment, several rows, INSERT ... SELECT, REPLACE, ON DUPLICATE KEY
UPDATE (VALUES() and expressions), a 1062 duplicate on the handle and on a
unique index, a 1048 NULL, the 1136 count mismatch, and INSERT IGNORE
(which the reference's parser refuses: 1064 on both); UPDATE that grows a
string column's dictionary, sets NULLs, scales decimals, moves dates and
changes the primary key; DELETE by point and by range; SET of session,
global and user variables (unknown and read-only ones too), and reads of
them; LAST_INSERT_ID() and ROW_COUNT(); TRUNCATE. Then 10,000 rows by
500-row INSERTs and an UPDATE of a seventh of them, so that commits pass
the 8,192-delta compaction threshold, with reads after each step.
"""

import pytest

from tidb_tpu.session import Session as RefSession
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.session import Session

from test_torch_store_writes import store_state

DDL = [
    "create table acct (id bigint primary key auto_increment, "
    "name varchar(20) unique, bal decimal(12,2), opened date, "
    "tier int default 1)",
    "create table note (id int primary key, body varchar(30), amt double)",
    "create table big (k int, v varchar(10), d decimal(8,3))",
]

CORPUS = [
    "insert into acct values (1, 'ann', 10.50, '2020-01-01', 2)",
    "insert into acct (name, bal, opened) values ('bob', 3.25, '2021-02-03')",
    "select last_insert_id(), row_count()",
    "insert into acct (name, bal) values ('cy', null), ('dee', -7.10)",
    "select last_insert_id(), row_count(), found_rows()",
    "insert into acct values (1, 'zed', 1, '2020-01-01', 1)",
    "insert into acct (name) values ('ann')",
    "insert into acct (id, name, tier) values (20, 'eve', null)",
    "insert into acct (id) values (1, 2)",
    "insert ignore into acct (name) values ('ann')",
    "insert into acct values (1, 'ann2', 0, '2020-01-01', 3) "
    "on duplicate key update bal = bal + values(bal), tier = values(tier)",
    "insert into acct (name, bal) values ('bob', 1) "
    "on duplicate key update bal = bal * 2",
    "insert into acct (name, bal) values ('bob', 1) "
    "on duplicate key update bal = bal",
    "replace into acct (id, name, bal) values (3, 'cy', 99.99)",
    "replace into acct (id, name, bal) values (30, 'fay', 1.5)",
    "select * from acct order by id",
    "update acct set name = concat(name, '-x'), bal = bal * 1.5 "
    "where tier = 1",
    "update acct set opened = '1999-12-31', bal = null where id = 2",
    "update acct set tier = tier + 10 where id = 3",
    "update acct set name = 'ann' where id = 2",
    "update acct set id = 40 where name = 'fay'",
    "update acct set bal = 0 where id = 999",
    "select id, name, bal, opened, tier, row_count() from acct order by id",
    "select row_count()",
    "insert into note select id, name, bal from acct where bal is not null",
    "insert into note values (100, 'x', 1e300), (101, null, -0.0)",
    "select * from note order by id",
    "delete from note where id = 100",
    "delete from note where amt < 10",
    "select count(*), sum(amt) from note",
    "select * from note where id = 101",
    "set @a = 5, @b = 'txt'",
    "select @a + 1, @b, @undefined",
    "set tidb_retry_limit = 3",
    "select @@tidb_retry_limit, @@session.tidb_retry_limit",
    "set global tidb_retry_limit = 7",
    "select @@global.tidb_retry_limit, @@tidb_retry_limit",
    "set no_such_variable = 1",
    "set global version = '9'",
    "set tidb_made_up_knob = 4",
    "select @@tidb_made_up_knob",
    "set names utf8mb4",
    "select database(), version(), user(), connection_id()",
    "delete from acct where id > 20",
    "select * from acct order by id",
    "truncate table note",
    "select count(*) from note",
    "insert into note values (1, 'after', 2)",
    "select * from note",
]


def _outcome(s, sql):
    try:
        rs = s.execute(sql)
    except Exception as e:  # the session error, by its errno
        return ("error", getattr(e, "errno", None), list(s.last_engines))
    return (rs.affected, TR.sql_cells(rs.rows), list(s.last_engines),
            list(rs.column_names))


def _stores(s):
    return {name: store_state(s.storage.table_store(
        s.catalog.table("test", name).id))
        for name in ("acct", "note", "big")}


@pytest.fixture(scope="module")
def sessions():
    ref, port = RefSession(), Session(device="cpu")
    for s in (ref, port):
        for sql in DDL:
            s.execute(sql)
    return ref, port


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_statement_matches_reference(sessions, i):
    ref, port = sessions
    sql = CORPUS[i]
    got, want = _outcome(port, sql), _outcome(ref, sql)
    assert got == want, sql


def test_corpus_errnos(sessions):
    """The typed errors the corpus must raise (on both sides)."""
    ref, port = sessions
    for sql, errno in [
            ("insert into acct values (1, 'q', 1, '2020-01-01', 1)", 1062),
            ("insert into acct (name) values ('ann')", 1062),
            ("insert into acct (id) values (1, 2)", 1136),
            ("insert ignore into acct (name) values ('q')", 1064),
            ("set no_such_variable = 1", 1193)]:
        got = _outcome(port, sql)
        assert got == _outcome(ref, sql), sql
        assert got[:2] == ("error", errno), sql


def test_stores_after_corpus_match(sessions):
    ref, port = sessions
    assert _stores(port) == _stores(ref)


def test_compaction_through_sql(sessions):
    ref, port = sessions
    stmts = [
        "insert into big values " + ",".join(
            f"({k}, 'v{k % 37}', {k % 1000}.{k % 7:03d})"
            for k in range(lo, lo + 500))
        for lo in range(0, 10_000, 500)]
    reads = ["select count(*), sum(k), sum(d) from big",
             "select v, count(*) from big group by v order by v limit 5"]
    for sql in stmts[:8] + reads + stmts[8:] + reads + [
            "update big set v = concat(v, 'z'), d = d + 1 "
            "where k % 7 = 0"] + reads + [
            "delete from big where k < 100"] + reads:
        assert _outcome(port, sql) == _outcome(ref, sql), sql[:60]
    st = _stores(port)["big"]
    assert st == _stores(ref)["big"]
    # 8,500 deltas at the 17th INSERT's commit: the fold takes all but
    # that statement's own 500 (its start_ts pins the safepoint)
    assert st["handles"] == list(range(1, 8001))
    assert 0 < len(st["deltas"]) < 8192


def test_device_caches_follow_the_live_epoch(sessions):
    """After the compaction above: the client's staged columns and
    visibility masks belong to live epochs only (`_evict_stale` freed the
    folded epoch's), and each (epoch, bucket) keeps one visibility mask,
    the current digest's."""
    _, port = sessions
    cop = port.cop
    live = {st.epoch.epoch_id for st in port.storage.tables.values()}

    def epoch_of(k):
        return k[1] if k[0] == "tile" else k[0]

    for cache in (cop._col_cache, cop._mask_cache):
        assert cache and {epoch_of(k) for k in cache} <= live
    masks = [k[:2] for k in cop._mask_cache if k[0] != "tile"]
    assert len(masks) == len(set(masks))
