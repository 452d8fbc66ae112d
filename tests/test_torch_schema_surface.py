"""The schema surface of the port, held to the reference.

Views (the cases of tests/test_views.py), sequences, foreign-key metadata
and owner election (the cases of tests/test_sequence_fk_owner.py that
belong to this slice), every SHOW kind the port serves, every
information_schema table it serves, CHECKSUM TABLE (the crc must equal the
reference's) and ADMIN CHECK TABLE: each statement through both packages'
`Session` (`test_torch_ddl.Pair`: outcomes and catalog, store and job
state equal after every statement). The information_schema tables the
observability planes serve (`OBS_SERVED`: their rows are timings and
process telemetry, which differ between two packages' processes) are
held to the reference's columns here and to its rows in the planes' own
tests (tests/test_torch_topsql.py and its siblings), as are
metrics_schema and SHOW PROFILES, PROFILE and METRICS. SHOW PROCESSLIST
and information_schema.processlist (the reading session's own row in an
embedded store) are held to the reference's rows. The SHOW kinds and
information_schema tables of planes the port does not have yet raise
`NotInSlice` with their names. Tolerance: none.
"""

from __future__ import annotations

import threading
import time

import pytest

from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.catalog import infoschema as I
from tidb_tpu_torch.errors import NotInSlice
from tidb_tpu_torch.owner import (FileLockOwnerManager, MockOwnerManager,
                                  owner_manager)
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

from test_torch_ddl import Pair, _error

VIEW_SETUP = ["create table t (id bigint primary key, v bigint, g bigint)",
              "insert into t values (1,10,1),(2,20,1),(3,30,2)"]

# tests/test_views.py and the sequence, FK and round() cases of
# tests/test_sequence_fk_owner.py, statement for statement
CASES = {
    "view_basics": VIEW_SETUP + [
        "create view vs as select g, sum(v) total from t group by g",
        "select * from vs order by g", "select total from vs where g = 2"],
    "view_column_list_and_join": VIEW_SETUP + [
        "create view v2 (grp, tot) as select g, sum(v) from t group by g",
        "select t.id, v2.tot from t, v2 where t.g = v2.grp order by t.id"],
    "view_tracks_dml_and_nesting": VIEW_SETUP + [
        "create view v1 as select g, sum(v) tot from t group by g",
        "create view v3 as select g, tot from v1 where tot > 25",
        "insert into t values (4, 40, 2)",
        "select g, tot from v3 order by g"],
    "view_replace_drop_errors": VIEW_SETUP + [
        "create view w as select id from t",
        "create view w as select v from t",
        "create or replace view w as select v from t",
        "select count(*) from w", "drop view w", "select * from w",
        "drop view if exists w", "drop view w"],
    "view_name_collision_and_validation": VIEW_SETUP + [
        "create view t as select 1",
        "create view bad as select nosuch from t",
        "create view bad (a, b) as select id from t"],
    "sequence_basics": [
        "create sequence sq start with 10 increment by 2",
        "select nextval(sq), nextval(sq)", "select lastval(sq)",
        "select setval(sq, 100)", "select nextval(sq)",
        "select sequence_name, start_value, increment from "
        "information_schema.sequences",
        "create sequence sq", "create sequence if not exists sq",
        "drop sequence sq", "select nextval(sq)"],
    "sequence_in_insert": [
        "create sequence ids",
        "create table st (id int primary key, v varchar(8))",
        "insert into st values (nextval(ids), 'a')",
        "insert into st values (nextval(ids), 'b')",
        "select id, v from st order by id"],
    "sequence_exhaustion_and_cycle": [
        "create sequence small maxvalue 2", "select nextval(small)",
        "select nextval(small)", "select nextval(small)",
        "create sequence cyc maxvalue 2 cycle"] + [
        "select nextval(cyc)"] * 5,
    "sequence_per_row_contexts_rejected": [
        "create sequence pr", "create table src (x int)",
        "insert into src values (1), (2)",
        "create table dst (id int, x int)",
        "insert into dst select nextval(pr), x from src",
        "update src set x = nextval(pr)",
        "insert into dst values (nextval(pr), 1), (nextval(pr), 2)",
        "select id from dst order by id"],
    "fk_metadata_and_show": [
        "create table p (id int primary key, u varchar(10))",
        "create table c (id int primary key, pid int, uu varchar(10), "
        "constraint fk_c foreign key (pid) references p (id) "
        "on delete cascade on update set null, "
        "foreign key (uu) references p (u))",
        "show create table c", "insert into c values (1, 999, 'zz')",
        "select constraint_name, referenced_table_name, delete_rule "
        "from information_schema.referential_constraints "
        "order by constraint_name",
        "select column_name, referenced_column_name from "
        "information_schema.key_column_usage "
        "where constraint_name = 'fk_c'"],
    "fk_column_shorthand": [
        "create table p2 (id int primary key)",
        "create table c2 (id int primary key, pid int references p2(id))",
        "show create table c2"],
    "round_negative_digits": [
        "create table rn (d decimal(6,1), i int)",
        "insert into rn values (44.5, 45), (55.0, 55)",
        "select round(d, 0-1), round(i, 0-1) from rn order by d"],
}

# the reference's own asserts, on the last statement of that text
EXPECT = {
    "view_basics": {"select * from vs order by g": [(1, 30), (2, 30)],
                    "select total from vs where g = 2": [(30,)]},
    "view_column_list_and_join": {
        "select t.id, v2.tot from t, v2 where t.g = v2.grp order by t.id":
            [(1, 30), (2, 30), (3, 30)]},
    "view_tracks_dml_and_nesting": {
        "select g, tot from v3 order by g": [(1, 30), (2, 70)]},
    "view_replace_drop_errors": {
        "create view w as select v from t": "already exists",
        "select count(*) from w": [(3,)],
        "drop view w": "Unknown view"},
    "view_name_collision_and_validation": {
        "create view t as select 1": "already exists",
        "create view bad (a, b) as select id from t": "mismatch"},
    "sequence_basics": {
        "select lastval(sq)": [(12,)],
        "select sequence_name, start_value, increment from "
        "information_schema.sequences": [("sq", 10, 2)],
        "create sequence sq": "exists",
        "select nextval(sq)": "unknown sequence"},
    "sequence_in_insert": {
        "select id, v from st order by id": [(1, "a"), (2, "b")]},
    "sequence_exhaustion_and_cycle": {"select nextval(cyc)": [(1,)]},
    "sequence_per_row_contexts_rejected": {
        "insert into dst select nextval(pr), x from src": "per-row",
        "update src set x = nextval(pr)": "UPDATE",
        "select id from dst order by id": [(1,), (2,)]},
    "fk_metadata_and_show": {
        "select column_name, referenced_column_name from "
        "information_schema.key_column_usage "
        "where constraint_name = 'fk_c'": [("pid", "id")]},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schema_case_matches_reference(case):
    from tidb_tpu_torch.bench import tpch_requests as TR

    pair = Pair()
    stmts = CASES[case]
    outs = pair.run(stmts)
    for sql, want in EXPECT.get(case, {}).items():
        out = outs[len(stmts) - 1 - stmts[::-1].index(sql)]
        if isinstance(want, list):
            assert out[2] == TR.sql_cells(want), (case, sql)
        else:
            assert want in _error(out)[1], (case, sql)


def test_sequence_cycle_values():
    pair = Pair(["create sequence cyc maxvalue 2 cycle"])
    vals = [pair.one("select nextval(cyc)")[2][0][0] for _ in range(5)]
    assert vals == [1, 2, 1, 2, 1]


def test_fk_show_create_text():
    pair = Pair(CASES["fk_metadata_and_show"][:2])
    ddl = pair.one("show create table c")[2][0][1]
    assert "FOREIGN KEY (`pid`) REFERENCES `p` (`id`)" in ddl
    assert "ON DELETE CASCADE" in ddl
    info = pair.port.st.catalog.table("test", "c")
    assert [fk.name for fk in info.foreign_keys] == ["fk_c", "fk_c_2"]


# ---------------- SHOW, information_schema, CHECKSUM, ADMIN ----------------

SURFACE_SETUP = [
    "create database shop",
    "create table t (id int primary key, a int, b varchar(10), "
    "d decimal(10,2) default 1.50, key ka (a))",
    "insert into t values (1, 10, 'x', 2.25), (2, 20, null, null), "
    "(3, 30, 'z', 3.00)",
    "create unique index ub on t (b)",
    "create table u (k bigint, s varchar(4) not null default 'q')",
    "insert into u (k) values (5), (6)",
    "create view vt as select id, a from t where a > 10",
    "create sequence sq start with 3",
    "analyze table t",
]

SHOWS = [
    "show tables", "show full tables", "show tables like 't%'",
    "show databases", "show schemas",
    "show create table t", "show create table u", "show create table nope",
    "show create database shop", "show create database nope",
    "show create view vt", "show create view t",
    "show columns from t", "show fields from u like 's'",
    "show index from t", "show keys from u",
    "show table status", "show table status like 'u'",
    "show variables like 'tidb_retry%'",
    "show global variables like 'wait_timeout'",
    "show status", "show status like 'Uptime'",
    "show grants", "show privileges", "show charset",
    "show character set like 'utf8%'", "show collation", "show engines",
    "set no_such_var = 1", "show warnings",
]


@pytest.fixture(scope="module")
def surface():
    return Pair(SURFACE_SETUP)


@pytest.mark.parametrize("sql", SHOWS)
def test_show_matches_reference(surface, sql):
    surface.one(sql)


def test_show_create_table_text(surface):
    rows = surface.one("show create table t")[2]
    assert rows == [("t", "CREATE TABLE `t` (\n  `id` int NOT NULL,\n"
                          "  `a` int,\n  `b` varchar(10),\n"
                          "  `d` decimal(10,2)\n)")]


# (statements_summary and slow_query hold times: their digests, counts
# and rows are held to the reference in test_torch_statement_plane.py)
# served tables whose rows are the observability planes' (timings,
# process telemetry): their columns are compared below, their rows in
# the planes' own tests (the cluster_* fan-outs in
# test_torch_cluster_obs.py)
OBS_SERVED = frozenset({
    "statements_summary", "slow_query", "tidb_top_sql", "tidb_wait_profile",
    "tidb_events", "statements_summary_history", "tidb_plan_history",
    "inspection_result", "inspection_summary", "metrics_summary",
    "profiling", "tidb_hot_ranges"}
    | {t for t in I.SERVED if t.startswith("cluster_")})


@pytest.mark.parametrize("table", sorted(I.SERVED - OBS_SERVED))
def test_infoschema_table_matches_reference(surface, table):
    out = surface.one(f"select * from information_schema.{table}")
    if table in ("schemata", "tables", "columns", "engines",
                 "collations", "character_sets"):
        assert out[2], table


@pytest.mark.parametrize("table", sorted(OBS_SERVED))
def test_obs_infoschema_columns_match_reference(table):
    """Fresh stores of each package: the same columns."""
    from tidb_tpu.session import Session as RefSession

    sql = f"select * from information_schema.{table}"
    got = Session(device="cpu").execute(sql).column_names
    assert got == RefSession().execute(sql).column_names


def test_infoschema_filtered_reads(surface):
    for sql in [
            "select table_name, column_name, ordinal_position, data_type, "
            "column_key from information_schema.columns "
            "where table_schema = 'test' order by table_name, "
            "ordinal_position",
            "select table_name, table_type, table_rows from "
            "information_schema.tables where table_schema = 'test' "
            "order by table_name",
            "select index_name, column_name, non_unique from "
            "information_schema.statistics where table_schema = 'test' "
            "order by index_name, seq_in_index",
            "select count(*) from information_schema.columns c, "
            "information_schema.tables t where c.table_name = t.table_name "
            "and t.table_schema = 'test'",
            "use information_schema", "show tables", "use test"]:
        surface.one(sql, stores=False)
    surface.check_state()


def test_checksum_and_admin_check(surface):
    a = surface.one("checksum table t, u")
    surface.one("insert into t values (4, 40, 'w', 9.99)")
    b = surface.one("checksum table t")
    assert a[2][0] != b[2][0] and a[2][0][0] == "test.t"
    surface.one("admin check table t, u")
    surface.one("delete from t where id = 4")
    assert surface.one("checksum table t")[2][0] == a[2][0]


def test_checksum_equal_across_compaction():
    pair = Pair(["create table c (id int primary key, s varchar(8), "
                 "f double)",
                 "insert into c values (1, 'ab', 1.5), (2, 'c', null), "
                 "(3, null, -2.0)",
                 "delete from c where id = 2"])
    before = pair.one("checksum table c")[2]
    for side in pair.sides:
        side.st.flush()
    pair.check_state()
    assert pair.one("checksum table c")[2] == before


def test_tidb_is_ddl_owner(surface):
    assert surface.one("select tidb_is_ddl_owner()")[2] == [(0,)]


SHOW_NOT_IN_SLICE = {
    "show bindings": "SHOW BINDINGS", "show processlist": "SHOW PROCESSLIST",
    "show profiles": "SHOW PROFILES", "show profile": "SHOW PROFILE",
    "show slow queries": "SHOW SLOW", "show metrics": "SHOW METRICS",
}
# obs-backed surfaces served since the statement plane's port, the
# observability planes' and the server process's (the processlist)
SHOW_IN_SLICE_SINCE = {"show bindings", "show slow queries",
                       "show profiles", "show profile", "show metrics",
                       "show processlist"}
INFOSCHEMA_IN_SLICE_SINCE = OBS_SERVED


@pytest.mark.parametrize("sql", sorted(SHOW_NOT_IN_SLICE))
def test_obs_backed_show_is_not_in_slice(surface, sql):
    """The SHOW kinds of unported planes raise by name; SHOW BINDINGS,
    SLOW QUERIES, PROFILES, PROFILE, METRICS and PROCESSLIST answer with
    the reference's columns."""
    if sql in SHOW_IN_SLICE_SINCE:
        got = [side.s.execute(sql).column_names
               for side in (surface.ref, surface.port)]
        assert got[0] == got[1]
        return
    with pytest.raises(NotInSlice) as e:
        surface.port.s.execute(sql)
    assert e.value.reason == SHOW_NOT_IN_SLICE[sql]


@pytest.mark.parametrize(
    "table", sorted(set(I._DEFS) - I.SERVED | INFOSCHEMA_IN_SLICE_SINCE))
def test_obs_backed_infoschema_is_not_in_slice(surface, table):
    """The obs-backed tables of unported planes raise by name; those of
    the statement plane and the observability planes are served."""
    sql = f"select count(*) from information_schema.{table}"
    if table in I.SERVED:
        assert surface.port.s.query(sql)[0][0] >= 0
        return
    with pytest.raises(NotInSlice) as e:
        surface.port.s.execute(sql)
    assert e.value.reason == table


def test_metrics_schema_is_not_in_slice(surface):
    """metrics_schema is served since the observability planes' port: USE
    works, and a family that does not exist is the reference's unknown
    table."""
    from tidb_tpu.session import Session as RefSession

    sides = (Session(device="cpu"), RefSession())
    for s in sides:
        s.execute("use metrics_schema")
    got = []
    for s in sides:
        with pytest.raises(Exception) as e:
            s.execute("select * from metrics_schema.tidb_qps")
        got.append((type(e.value).__name__,
                    getattr(e.value, "errno", None), str(e.value)))
    assert got[0] == got[1]


# ---------------- owner election ----------------

def test_mock_owner_serializes_threads():
    m = MockOwnerManager()
    order = []

    def work(tag):
        with m:
            order.append(f"{tag}-in")
            time.sleep(0.05)
            order.append(f"{tag}-out")

    ts = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for i in range(0, 6, 2):
        assert order[i].endswith("-in") and order[i + 1].endswith("-out")
        assert order[i].split("-")[0] == order[i + 1].split("-")[0]


def test_file_lock_owner_mutual_exclusion(tmp_path):
    a = FileLockOwnerManager(str(tmp_path), "ddl")
    b = FileLockOwnerManager(str(tmp_path), "ddl")
    assert a.try_campaign()
    assert not b.try_campaign()  # held by a
    assert b.owner_pid() is not None
    a.resign()
    assert b.try_campaign()
    b.resign()
    a.close()
    b.close()
    assert isinstance(owner_manager(None), MockOwnerManager)
    assert isinstance(owner_manager(str(tmp_path)), FileLockOwnerManager)


def test_ddl_runs_under_owner(tmp_path):
    """ALTER on a durable store takes the flock owner; a foreign holder
    of the lock makes the statement wait for it."""
    pair = Pair(storages=(Storage(str(tmp_path / "port")),
                          RefStorage(str(tmp_path / "ref"))))
    pair.run(["create table d (a int primary key, b int)",
              "insert into d values (1, 1)",
              "alter table d add index ib (b)"])
    assert isinstance(pair.port.st.ddl_owner, FileLockOwnerManager)
    other = FileLockOwnerManager(str(tmp_path / "port"), "ddl")
    assert other.try_campaign()
    done = threading.Event()
    t = threading.Thread(target=lambda: (pair.port.s.execute(
        "alter table d add index ib2 (b)"), done.set()))
    t.start()
    time.sleep(0.3)
    assert not done.is_set()  # waits for the owner
    other.resign()
    other.close()
    t.join(timeout=10)
    assert done.is_set()
    pair.ref.s.execute("alter table d add index ib2 (b)")
    pair.check_state()
    for side in pair.sides:
        side.st.close()


def test_small_sequence_clean_restart_wastes_nothing(tmp_path):
    path = str(tmp_path / "store")
    st = Storage(path)
    s = Session(st, device="cpu")
    s.execute("create sequence sm maxvalue 10")
    assert s.execute("select nextval(sm)").rows == [(1,)]
    st.close()  # checkpoint writes the exact cursor
    st2 = Storage(path)
    s2 = Session(st2, device="cpu")
    assert s2.execute("select nextval(sm)").rows == [(2,)]
    for v in range(3, 11):
        assert s2.execute("select nextval(sm)").rows == [(v,)]
    with pytest.raises(Exception, match="run out"):
        s2.execute("select nextval(sm)")
    st2.close()
