"""Partitioned tables of the port, held to the reference statement for
statement.

Every case of tests/test_partition.py runs through both packages'
`Session` (the port's with `device="cpu"`), each over its own store: after
each statement the outcomes must be equal (rows, or error class, errno
and message), and so must the engine tags of the statement and every
physical table store, keyed by table and partition NAME (the two catalogs
may allocate different ids): epoch, dictionaries, deltas, handles, and
whether the partition shares the first partition's dictionaries.

Then the partition cases of planes already ported (the point fast path,
APPROX_COUNT_DISTINCT, CHECKSUM), TPC-H Q6, Q1, Q18 and Q18's inner block
at SF0.01 over HASH- and RANGE-partitioned lineitem (loaded by
`bench/tpch_data.load_table_partitioned`), the loader's numpy router
against `PartitionInfo.route` row for row, a new dictionary value inserted
into one partition and read through LIKE and IN from the others, and the
partition stores across a crash. Tolerance: none.
"""

from __future__ import annotations

import gc
import random

import numpy as np
import pytest

from tidb_tpu.bench import tpch_data as RTD
from tidb_tpu.catalog.schema import PartitionDef as RefPartitionDef
from tidb_tpu.catalog.schema import PartitionInfo as RefPartitionInfo
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.catalog.schema import PartitionDef, PartitionInfo
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

from test_torch_store_writes import store_state

# tests/test_approx.py's bound: 256 registers, ~6.5% standard error
REL_TOL = 0.15

SIDES = {
    "port": (Storage, lambda st: Session(st, device="cpu")),
    "ref": (RefStorage, RefSession),
}


def part_stores(st) -> dict:
    """Every physical store of the user schemas as plain values, keyed by
    (schema, table, partition name or None)."""
    out = {}
    for sname, schema in sorted(st.catalog.schemas.items()):
        if sname == "information_schema":
            continue
        for info in schema.tables.values():
            part = getattr(info, "partition", None)
            if part is None:
                out[(sname, info.name, None)] = store_state(
                    st.table_store(info.id))
                continue
            first = st.table_store(part.defs[0].id)
            for d in part.defs:
                store = st.table_store(d.id)
                state = store_state(store)
                state["name"] = store.table.name
                state["shares_dicts"] = \
                    store.dictionaries is first.dictionaries
                out[(sname, info.name, d.name)] = state
    return out


class Side:
    """One package's store (in memory, or durable under `path`) and a
    session over it."""

    def __init__(self, name: str, path=None) -> None:
        self.name = name
        self.StorageCls, self.new_session = SIDES[name]
        self.path = path
        self.open()

    def open(self) -> None:
        self.st = self.StorageCls(self.path) if self.path is not None \
            else self.StorageCls()
        self.s = self.new_session(self.st)

    def outcome(self, sql: str):
        try:
            rs = self.s.execute(sql)
        except Exception as e:  # the session error: class, errno, message
            return ("error", type(e).__name__, getattr(e, "errno", None),
                    str(e))
        return (rs.affected, rs.column_names, TR.sql_cells(rs.rows))


class Pair:
    """The same statements through the port and the reference."""

    def __init__(self, root=None) -> None:
        self.sides = [Side(n, None if root is None else str(root / n))
                      for n in ("port", "ref")]

    @property
    def port(self) -> Side:
        return self.sides[0]

    def run(self, sql: str):
        got = [side.outcome(sql) for side in self.sides]
        assert got[0] == got[1], sql
        if got[0][0] != "error":
            tags = [list(side.s.last_engines) for side in self.sides]
            assert tags[0] == tags[1], sql
        self.check_stores()
        return got[0]

    def check_stores(self) -> None:
        assert part_stores(self.sides[0].st) == part_stores(
            self.sides[1].st)

    def rows(self, sql: str) -> list:
        out = self.run(sql)
        assert out[0] != "error", out
        return out[2]

    def check(self, sql: str, want: list, ordered: bool = True) -> None:
        got = self.rows(sql)
        want = TR.sql_cells(want)
        if not ordered:
            got, want = sorted(got, key=repr), sorted(want, key=repr)
        assert got == want, sql

    def error(self, sql: str) -> str:
        out = self.run(sql)
        assert out[0] == "error", sql
        return out[3]

    def tags(self) -> list:
        return list(self.port.s.last_engines)

    def close(self) -> None:
        for side in self.sides:
            side.st.close()

    def restart(self, crash: bool = False) -> None:
        """Close both stores (or "crash" them: the KV engine's files
        released without a checkpoint) and reopen them."""
        for side in self.sides:
            if crash:
                side.st.kv.kv.close()
            else:
                side.st.close()
            side.open()
        self.check_stores()


@pytest.fixture()
def pair():
    return Pair()


def _hash_table(p, n=40):
    p.run("create table h (id int primary key, v int) "
          "partition by hash(id) partitions 4")
    p.run("insert into h values " + ",".join(
        f"({i},{i * 10})" for i in range(n)))


def _range_table(p):
    p.run("create table r (d int, amt int) partition by range (d) ("
          "partition p0 values less than (10), "
          "partition p1 values less than (20), "
          "partition pmax values less than maxvalue)")
    p.run("insert into r values (1,1),(5,2),(12,3),(18,4),(25,5),(100,6)")


def _explain(p, sql: str) -> str:
    return "\n".join(r[0] for r in p.rows("explain " + sql))


# ---- the cases of tests/test_partition.py ----------------------------------

def test_hash_partition_dml_roundtrip(pair):
    _hash_table(pair)
    pair.check("select count(*) from h", [(40,)])
    pair.check("select v from h where id = 7", [(70,)])
    pair.check("select id, v from h order by id limit 3",
               [(0, 0), (1, 10), (2, 20)])
    pair.run("update h set v = v + 1 where id < 5")
    pair.check("select sum(v) from h where id < 5", [(105,)])
    pair.run("delete from h where id >= 30")
    pair.check("select count(*) from h", [(30,)])
    pair.check("select sum(v) from h",
               [(sum(i * 10 for i in range(30)) + 5,)])


def test_range_partition_pruning_plan(pair):
    _range_table(pair)
    assert _explain(pair, "select sum(amt) from r where d < 10"
                    ).count("TableRead") == 1
    assert _explain(pair, "select sum(amt) from r where d >= 12 and d < 20"
                    ).count("TableRead") == 1
    assert _explain(pair, "select sum(amt) from r").count("TableRead") == 3
    pair.check("select sum(amt) from r where d < 10", [(3,)])
    assert pair.tags() == ["device"]
    pair.check("select sum(amt) from r where d >= 12 and d < 20", [(7,)])
    pair.check("select sum(amt) from r", [(21,)])
    assert pair.tags() == ["device"] * 3


def test_hash_partition_point_route(pair):
    _hash_table(pair)
    plan = _explain(pair, "select v from h where id = 7")
    assert plan.count("PointGet") + plan.count("TableRead") == 1
    pair.check("select v from h where id in (3, 8)", [(30,), (80,)],
               ordered=False)


def test_partition_column_update_moves_row(pair):
    _range_table(pair)
    pair.run("update r set d = 15 where d = 1")
    pair.check("select sum(amt) from r where d >= 10 and d < 20", [(8,)])
    pair.check("select count(*) from r where d < 10", [(1,)])
    pair.check("select count(*) from r", [(6,)])


def test_drop_and_truncate_partition(pair):
    _range_table(pair)
    pair.run("alter table r drop partition p0")
    pair.check("select count(*) from r", [(4,)])
    pair.run("alter table r truncate partition p1")
    pair.check("select count(*) from r", [(2,)])
    _hash_table(pair, 4)
    assert "RANGE" in pair.error("alter table h drop partition p0")
    assert "unknown partition" in pair.error(
        "alter table r truncate partition nope")
    pair.run("create table plain (a int)")
    assert "not partitioned" in pair.error(
        "alter table plain drop partition p0")
    assert "on partitioned tables is unsupported" in pair.error(
        "alter table r add column z int")


def test_partition_information_schema(pair):
    _range_table(pair)
    rows = pair.rows(
        "select partition_name, partition_method, partition_description, "
        "table_rows from information_schema.partitions "
        "where table_name = 'r' order by partition_ordinal_position")
    assert [r[0] for r in rows] == ["p0", "p1", "pmax"]
    assert rows[0][1] == "RANGE" and rows[0][2] == "10"
    assert rows[2][2] == "MAXVALUE"
    assert sum(r[3] for r in rows) == 6
    # tables.table_rows sums the partitions; unpartitioned tables list
    # one NULL partition row
    pair.run("create table plain (a int)")
    pair.run("insert into plain values (1), (2)")
    pair.run("delete from r where d = 5")
    assert pair.rows("select table_name, table_rows from "
                     "information_schema.tables where table_schema = "
                     "'test' order by table_name") == [("plain", 2),
                                                       ("r", 5)]
    assert pair.rows("select partition_name, table_rows from "
                     "information_schema.partitions where table_name = "
                     "'plain'") == [(None, 2)]
    status = pair.rows("show table status")
    assert [(r[0], r[4], r[16]) for r in status] == [
        ("plain", 2, ""), ("r", 5, "partitioned")]


def test_partition_constraints(pair):
    assert "UNIQUE INDEX must include" in pair.error(
        "create table bad (a int, b int, unique key (b)) "
        "partition by hash(a) partitions 2")
    assert "PRIMARY KEY must include" in pair.error(
        "create table bad2 (a int primary key, b int) "
        "partition by hash(b) partitions 2")
    assert "strictly increasing" in pair.error(
        "create table bad3 (a int) partition by range (a) ("
        "partition p0 values less than (10), "
        "partition p1 values less than (5))")
    assert "MAXVALUE must be the last" in pair.error(
        "create table bad4 (a int) partition by range (a) ("
        "partition p0 values less than maxvalue, "
        "partition p1 values less than (5))")
    assert "duplicate partition name" in pair.error(
        "create table bad5 (a int) partition by range (a) ("
        "partition p0 values less than (5), "
        "partition p0 values less than (9))")
    assert "integer or DATE" in pair.error(
        "create table bad6 (a varchar(8)) partition by hash(a) "
        "partitions 2")
    assert "unknown partition column" in pair.error(
        "create table bad7 (a int) partition by hash(b) partitions 2")
    pair.run("create table nr (a int) partition by range (a) ("
             "partition p0 values less than (10))")
    assert "no partition" in pair.error("insert into nr values (50)")
    # a DATE partition column routes by its day number
    pair.run("create table dt (d date, v int) partition by range (d) ("
             "partition p0 values less than (10000), "
             "partition p1 values less than maxvalue)")
    pair.run("insert into dt values ('1990-01-01', 1), ('2020-01-01', 2)")
    pair.check("select sum(v) from dt", [(3,)])


def test_partition_duplicate_detection(pair):
    _hash_table(pair, 10)
    assert "Duplicate entry" in pair.error("insert into h values (3, 999)")
    pair.run("replace into h values (3, 999)")
    pair.check("select v from h where id = 3", [(999,)])
    pair.run("insert into h values (3, 1) on duplicate key update v = 5")
    pair.check("select v from h where id = 3", [(5,)])


def test_partition_group_by_across_partitions(pair):
    pair.run("create table g (k int, grp int, v int) "
             "partition by hash(k) partitions 3")
    rng = np.random.default_rng(3)
    rows = [(i, int(g), int(v)) for i, (g, v) in enumerate(
        zip(rng.integers(0, 5, 300), rng.integers(0, 100, 300)))]
    pair.run("insert into g values " + ",".join(
        f"({a},{b},{c})" for a, b, c in rows))
    want: dict = {}
    for _, g, v in rows:
        want[g] = want.get(g, 0) + v
    pair.check("select grp, sum(v) from g group by grp order by grp",
               sorted(want.items()))


def test_partition_join(pair):
    _hash_table(pair, 20)
    pair.run("create table dim (id int primary key, tag varchar(8))")
    pair.run("insert into dim values " + ",".join(
        f"({i},'t{i % 3}')" for i in range(20)))
    want: dict = {}
    for i in range(20):
        want[f"t{i % 3}"] = want.get(f"t{i % 3}", 0) + i * 10
    pair.check("select dim.tag, sum(h.v) from h join dim on h.id = dim.id "
               "group by dim.tag order by dim.tag", sorted(want.items()))


def test_move_into_occupied_slot_raises_duplicate(pair):
    pair.run("create table m (d int primary key, v int) "
             "partition by range (d) ("
             "partition p0 values less than (10), "
             "partition p1 values less than (20))")
    pair.run("insert into m values (1, 1), (15, 2)")
    assert "Duplicate entry" in pair.error("update m set d = 15 where d = 1")
    pair.check("select d, v from m order by d", [(1, 1), (15, 2)])


def test_no_cross_partition_halloween(pair):
    pair.run("create table hw (d int, v int) partition by range (d) ("
             "partition p0 values less than (10), "
             "partition p1 values less than (20), "
             "partition pmax values less than maxvalue)")
    pair.run("insert into hw values (1, 1), (11, 2), (25, 3)")
    assert pair.run("update hw set d = d + 10")[0] == 3
    pair.check("select d, v from hw order by v",
               [(11, 1), (21, 2), (35, 3)])


def test_allocator_survives_partition_ddl(pair):
    pair.run("create table ta (d int, v int) partition by range (d) ("
             "partition p0 values less than (10), "
             "partition p1 values less than (20), "
             "partition pmax values less than maxvalue)")
    pair.run("insert into ta values (1,1),(12,2),(25,3)")
    pair.run("alter table ta truncate partition p0")
    pair.run("insert into ta values (13, 4), (14, 5)")
    pair.check("select count(*) from ta", [(4,)])
    pair.check("select v from ta where d >= 10 and d < 20 order by v",
               [(2,), (4,), (5,)])
    pair.run("alter table ta drop partition p0")
    pair.run("insert into ta values (15, 6)")
    pair.check("select count(*) from ta", [(5,)])
    pair.check("select v from ta order by v",
               [(2,), (3,), (4,), (5,), (6,)])


@pytest.mark.parametrize("crash", [False, True], ids=["close", "crash"])
def test_allocator_restart_covers_all_partitions(tmp_path, crash):
    """Values 1 and 3 hash to partition 1 of 2: partition 0 (the
    allocator) holds no rows, so only the max-fold at recovery protects
    its counter. The reference closes its store cleanly; the crash case
    reopens from the KV alone."""
    p = Pair(tmp_path)
    p.run("create table al (a int) partition by hash(a) partitions 2")
    p.run("insert into al values (1), (3)")
    p.restart(crash=crash)
    p.run("insert into al values (5)")
    p.check("select a from al", [(1,), (3,), (5,)], ordered=False)
    handles = [set(p.port.st.table_store(d.id).epoch.handles.tolist())
               | {h for _, h, _ in p.port.st.table_store(d.id).deltas}
               for d in p.port.st.catalog.table("test", "al").partition.defs]
    assert not handles[0] & handles[1]
    p.close()


def test_float_bound_does_not_overprune(pair):
    pair.run("create table fb (d int, v int) partition by range (d) ("
             "partition p0 values less than (10), "
             "partition p1 values less than (20))")
    pair.run("insert into fb values (9, 1), (10, 2), (11, 3)")
    pair.check("select sum(v) from fb where d < 10.5", [(3,)])
    pair.check("select sum(v) from fb where d > 9.5", [(5,)])


@pytest.mark.parametrize("crash", [False, True], ids=["close", "crash"])
def test_partitioned_survive_restart(tmp_path, crash):
    p = Pair(tmp_path)
    p.run("create table p (id int primary key, v int) "
          "partition by hash(id) partitions 3")
    p.run("insert into p values (1,10),(2,20),(3,30),(4,40)")
    p.run("update p set v = 99 where id = 2")
    p.restart(crash=crash)
    p.check("select id, v from p order by id",
            [(1, 10), (2, 99), (3, 30), (4, 40)])
    p.run("insert into p values (5, 50)")
    p.check("select count(*) from p", [(5,)])
    p.close()


def test_partition_analyze(pair):
    _hash_table(pair, 100)
    pair.run("analyze table h")
    for side in pair.sides:
        info = side.st.catalog.table("test", "h")
        for d in info.partition.defs:
            assert side.st.stats.table_stats(d.id) is not None
    # the partitions' statistics agree, partition by partition
    stats = []
    for side in pair.sides:
        info = side.st.catalog.table("test", "h")
        stats.append([(side.st.stats.table_stats(d.id).row_count,
                       side.st.stats.table_stats(d.id).version)
                      for d in info.partition.defs])
    assert stats[0] == stats[1]


# ---- the partition cases of planes already ported --------------------------

def test_partitioned_table_not_bypassed(pair):
    """tests/test_fast_path.py: a point read of a partitioned table keeps
    the planned path (partition routing), never `point`."""
    pair.run("create table pt (id bigint primary key, v bigint) "
             "partition by hash(id) partitions 4")
    pair.run("insert into pt values (1, 7)")
    assert "point" not in pair.tags()
    pair.check("select v from pt where id = 1", [(7,)])
    assert "point" not in pair.tags()


def test_partitioned_matches_unpartitioned_bitwise(pair):
    """tests/test_approx.py: per-partition sketches merge by register max,
    equal to the single table's."""
    rng = random.Random(5)
    vals = [rng.randrange(3000) for _ in range(6000)]
    pair.run("create table apx1 (k int, v int)")
    pair.run("create table apx2 (k int, v int) "
             "partition by hash(k) partitions 4")
    rows = ",".join(f"({i},{v})" for i, v in enumerate(vals))
    pair.run("insert into apx1 values " + rows)
    pair.run("insert into apx2 values " + rows)
    one = pair.rows("select approx_count_distinct(v) from apx1")
    part = pair.rows("select approx_count_distinct(v) from apx2")
    assert one == part
    exact = len(set(vals))
    assert abs(one[0][0] - exact) <= REL_TOL * exact


def test_mixed_width_partitions_agree(pair):
    pair.run("create table mw (k int, v bigint) "
             "partition by hash(k) partitions 2")
    rows = [(0, -5), (1, -5), (2, 1 << 40), (4, (1 << 40) + 1)]
    rows += [(2 * i, i) for i in range(5, 100)]
    pair.run("insert into mw values " +
             ",".join(f"({k},{v})" for k, v in rows))
    exact = pair.rows("select count(distinct v) from mw")[0][0]
    approx = pair.rows("select approx_count_distinct(v) from mw")[0][0]
    assert abs(approx - exact) <= max(2, REL_TOL * exact)


def test_partitioned_checksum(pair):
    """tests/test_compat.py: a partitioned table's checksum is stable and
    follows its content; so is ADMIN CHECK's verdict."""
    pair.run("create table ckp (k int, v int) "
             "partition by hash(k) partitions 3")
    pair.run("insert into ckp values (1, 10), (2, 20), (3, 30)")
    p1 = pair.rows("checksum table ckp")
    assert p1 == pair.rows("checksum table ckp")
    pair.run("insert into ckp values (4, 40)")
    assert pair.rows("checksum table ckp") != p1
    pair.run("admin check table ckp")


def test_admin_check_finds_row_in_wrong_partition(pair):
    """A row bulk-loaded into the wrong partition's store fails ADMIN
    CHECK with the reference's message, on both packages."""
    pair.run("create table wp (d int, v int) partition by range (d) ("
             "partition p0 values less than (10), "
             "partition p1 values less than maxvalue)")
    pair.run("insert into wp values (1, 1), (12, 2)")
    pair.run("admin check table wp")
    for side in pair.sides:
        part = side.st.catalog.table("test", "wp").partition
        side.st.table_store(part.defs[0].id).bulk_load(
            [np.array([15], np.int64), np.array([3], np.int64)])
    msg = pair.error("admin check table wp")
    assert "stored in wrong partition wp#p0" in msg


def test_auto_analyze_visits_partitions(pair):
    _hash_table(pair, 200)
    names = [side.st.stats.auto_analyze(side.st, side.st.catalog)
             for side in pair.sides]
    assert names[0] == names[1] == ["h"] * 4
    for side in pair.sides:
        info = side.st.catalog.table("test", "h")
        assert all(side.st.stats.table_stats(d.id) is not None
                   for d in info.partition.defs)


def test_for_update_and_pessimistic_dml_over_partitions(pair):
    _hash_table(pair, 12)
    for sql in ("begin pessimistic",
                "select id, v from h where id < 6 for update",
                "update h set id = id + 100 where id < 3",
                "delete from h where id = 7",
                "insert into h values (50, 1)",
                "commit"):
        pair.run(sql)
    pair.check("select id from h order by id",
               [(i,) for i in [3, 4, 5, 6, 8, 9, 10, 11, 50, 100, 101,
                               102]])


def test_drop_and_truncate_table_over_partitions(tmp_path):
    p = Pair(tmp_path)
    _range_table(p)
    p.run("truncate table r")
    p.check("select count(*) from r", [(0,)])
    p.run("insert into r values (3, 1), (30, 2)")
    p.restart(crash=True)
    p.check("select d, amt from r order by d", [(3, 1), (30, 2)])
    p.run("drop table r")
    p.restart(crash=True)
    assert p.error("select * from r")
    p.close()


def test_truncate_and_drop_first_partition_survive_crash(tmp_path):
    """TRUNCATE PARTITION's fresh store is wired into the epoch files
    (bulk-loaded rows land in its epoch file), and a DROP of the first
    partition hands the allocator to the next: both hold across a
    crash."""
    p = Pair(tmp_path)
    _range_table(p)
    p.run("alter table r truncate partition p1")
    for side in p.sides:
        part = side.st.catalog.table("test", "r").partition
        store = side.st.table_store(part.defs[1].id)
        store._next_handle = 1000
        store.bulk_load([np.array([11, 14], np.int64),
                         np.array([7, 8], np.int64)])
    p.check_stores()
    p.restart(crash=True)
    p.check("select d, amt from r order by d",
            [(1, 1), (5, 2), (11, 7), (14, 8), (25, 5), (100, 6)])
    p.run("alter table r drop partition p0")
    p.run("insert into r values (15, 9)")
    p.restart(crash=True)
    p.run("insert into r values (16, 10)")
    p.check("select d, amt from r order by d",
            [(11, 7), (14, 8), (15, 9), (16, 10), (25, 5), (100, 6)])
    p.close()


def test_new_string_after_reopen(tmp_path):
    """A fault of the reference that the port carries, so that the stores
    stay equal: at a reopen each partition loads its dictionaries from its
    own epoch file, so the partitions no longer share them. An INSERT
    encodes its row with the first partition's dictionaries, and a new
    string routed to another partition no longer decodes there: both
    packages fail the statement with the schema-changed error (8028),
    and a string known to every partition still goes in."""
    p = Pair(tmp_path)
    p.run("create table ns (id int primary key, t varchar(8)) "
          "partition by hash(id) partitions 2")
    p.run("insert into ns values (1, 'a'), (2, 'b')")
    p.restart()
    for side in p.sides:
        part = side.st.catalog.table("test", "ns").partition
        a, b = (side.st.table_store(d.id) for d in part.defs)
        assert a.dictionaries is not b.dictionaries
    msg = p.error("insert into ns values (3, 'c')")
    assert "Information schema is changed" in msg
    p.run("insert into ns values (4, 'd'), (5, 'a')")
    p.check("select id, t from ns order by id",
            [(1, "a"), (2, "b"), (4, "d"), (5, "a")])
    p.close()


def test_split_dictionaries_after_reopen_misread_a_string(tmp_path):
    """The same fault, read silently: after the reopen an UPDATE grows the
    second partition's own dictionary ('q' at code 2); an INSERT of 'c'
    into that partition is encoded with the first partition's dictionary
    (code 2) and decoded with the second's, so the KV truth and the epoch
    both hold 'q'. Both packages store the same wrong row (ROADMAP queue
    3): the port keeps the reference's stores."""
    p = Pair(tmp_path)
    p.run("create table sd (id int primary key, t varchar(8)) "
          "partition by hash(id) partitions 2")
    p.run("insert into sd values (2, 'a'), (1, 'b')")
    p.restart()
    p.run("update sd set t = 'q' where id = 1")
    p.run("insert into sd values (3, 'c')")
    p.check("select id, t from sd order by id",
            [(1, "q"), (2, "a"), (3, "q")])
    p.restart(crash=True)
    p.check("select id, t from sd order by id",
            [(1, "q"), (2, "a"), (3, "q")])
    p.close()


# ---- TPC-H over partitioned lineitem -----------------------------------------

SF, SEED = 0.01, 42
PARTITIONINGS = {
    "hash4": "partition by hash(l_orderkey) partitions 4",
    "range5": "partition by range (l_orderkey) ("
              "partition p0 values less than (4000), "
              "partition p1 values less than (8000), "
              "partition p2 values less than (11000), "
              "partition p3 values less than (14000), "
              "partition pmax values less than maxvalue)",
}
Q18_INNER = ("select l_orderkey, sum(l_quantity) from lineitem "
             "group by l_orderkey having sum(l_quantity) > 300")


def tpch_pair(by: str) -> tuple:
    data = TD.generate_tpch(SF, SEED)
    p = Pair()
    for side in p.sides:
        loader = TD if side.name == "port" else RTD
        for name in ("orders", "customer"):
            loader.load_table(side.s, name, data[name])
        # the port's loader, on either package's session (attribute
        # access only): the same rows in the same partition stores
        TD.load_table_partitioned(side.s, "lineitem", data["lineitem"],
                                  PARTITIONINGS[by])
    p.check_stores()
    p.run("analyze table lineitem, orders, customer")
    return p, data


@pytest.mark.parametrize("by", sorted(PARTITIONINGS))
def test_tpch_over_partitioned_lineitem(by):
    p, data = tpch_pair(by)
    nparts = len(p.port.st.catalog.table("test", "lineitem").partition.defs)
    for q in ("q6", "q1", "q18"):
        got = p.rows(TPCH_QUERIES[q])
        assert got == TR.sql_oracle(q, data), q
        if q != "q18":
            assert p.tags() == ["device"] * nparts, q
    inner = p.rows(Q18_INNER)
    want = [(k, ("dec", s, 2)) for k, s, _ in
            TR.q18_inner_oracle(data["lineitem"])]
    assert sorted(inner) == want
    assert p.tags() == ["device"] * nparts
    # a point read prunes to one partition
    k = int(data["lineitem"]["l_orderkey"][7])
    p.rows(f"select count(*), sum(l_quantity) from lineitem "
           f"where l_orderkey = {k}")
    assert len(p.tags()) == 1


def test_new_dictionary_value_in_one_partition():
    """A new l_shipmode value inserted into one partition grows the
    dictionary every partition shares (no partition's epoch changes);
    LIKE and IN over l_shipmode then read the other partitions, before and
    after the insert, through the same client caches."""
    p, data = tpch_pair("range5")
    reads = [
        "select count(*) from lineitem where l_shipmode like 'HOV%'",
        "select count(*) from lineitem where l_shipmode like '%AIL' "
        "and l_orderkey < 8000",
        "select l_shipmode, count(*) from lineitem where l_shipmode in "
        "('HOVERCRAFT', 'MAIL', 'SHIP') and l_orderkey < 11000 "
        "group by l_shipmode order by l_shipmode",
        "select count(*) from lineitem where l_shipmode <> 'HOVERCRAFT'",
        "select l_shipmode, count(*) from lineitem where l_shipmode in "
        "('HOVERCRAFT', 'MAIL') group by l_shipmode order by l_shipmode",
    ]
    before = [p.rows(sql) for sql in reads]
    row = ", ".join(["14999", "1", "1", "1", "1.00", "2.00", "0.05",
                     "0.01", "'N'", "'O'", "'1995-01-01'", "'1995-01-02'",
                     "'1995-01-03'", "'NONE'", "'HOVERCRAFT'", "'new'"])
    p.run(f"insert into lineitem values ({row})")
    after = [p.rows(sql) for sql in reads]
    assert before[0] == [(0,)] and after[0] == [(1,)]
    assert after[1] == before[1]
    assert after[2] == before[2]
    assert after[3] == before[3]
    assert after[4] == [("HOVERCRAFT", 1)] + before[4]
    vocab, codes = data["lineitem"]["l_shipmode"]
    assert before[3] == [(len(codes),)]
    assert before[2] == [(m, int(np.sum(
        (codes == vocab.index(m)) & (data["lineitem"]["l_orderkey"] < 11000))))
        for m in ("MAIL", "SHIP")]


# ---- the loader's router against PartitionInfo.route -------------------------

def _parts(kind: str, bounds, pkg: str):
    Def, Info = (PartitionDef, PartitionInfo) if pkg == "port" else (
        RefPartitionDef, RefPartitionInfo)
    defs = [Def(f"p{i}", 100 + i, b) for i, b in enumerate(bounds)]
    return Info(kind, 0, defs)


@pytest.mark.parametrize("kind,bounds", [
    ("hash", [None] * 4),
    ("hash", [None] * 7),
    ("range", [-100, 0, 10, 5000, None]),
    ("range", [-5, 3, 1 << 40]),
])
def test_router_equals_route(kind, bounds):
    rng = np.random.default_rng(11)
    keys = np.concatenate([
        rng.integers(-10_000, 10_000, 3000),
        rng.integers(-(1 << 50), 1 << 50, 500),
        np.array([0, -1, 1, -100, -101, 9, 10, 4999, 5000, -5, 3])])
    valid = rng.random(len(keys)) > 0.05
    port, ref = _parts(kind, bounds, "port"), _parts(kind, bounds, "ref")
    if kind == "range" and bounds[-1] is not None:
        # keys at or above the last bound have no partition: route raises
        # for each, the router for the first
        over = valid & (keys >= bounds[-1])
        with pytest.raises(ValueError, match="no partition"):
            TD.route_partitions(port, keys, valid)
        keys, valid = keys[~over], valid[~over]
        k = int(bounds[-1])
        with pytest.raises(ValueError, match=f"value {k}"):
            TD.route_partitions(port, np.array([k]))
        with pytest.raises(ValueError, match=f"value {k}"):
            ref.route(k)
    got = TD.route_partitions(port, keys, valid)
    ids = [d.id for d in port.defs]
    for info in (port, ref):
        want = [ids.index(info.route(int(k) if ok else None).id)
                for k, ok in zip(keys, valid)]
        assert got.tolist() == want


def test_drop_and_truncate_free_the_clients_tensors(pair):
    """DROP and TRUNCATE PARTITION free what the session's client cached
    for the partition: a dropped id never stages a newer epoch, so the
    client's epoch eviction would never reach it."""
    _range_table(pair)
    for side in pair.sides:
        side.st.flush()  # the rows into each partition's epoch
    # a filter puts a device program on each partition's scan
    pair.check("select sum(amt) from r where amt > 0", [(21,)])
    cop = pair.port.s.cop
    part = pair.port.st.catalog.table("test", "r").partition
    ids = [d.id for d in part.defs]
    epochs = [pair.port.st.table_store(t).epoch.epoch_id for t in ids]

    def cached(epoch_id) -> int:
        return sum(1 for cache in (cop._col_cache, cop._mask_cache)
                   for k in cache
                   if k[0] == epoch_id or (k[0] == "tile"
                                           and k[1] == epoch_id))

    assert all(cached(e) for e in epochs)
    pair.run("alter table r drop partition p0")
    assert not cached(epochs[0]) and ids[0] not in cop._live_epochs
    pair.run("alter table r truncate partition p1")
    assert not cached(epochs[1]) and cached(epochs[2])
    pair.check("select sum(amt) from r where amt > 0", [(11,)])


@pytest.mark.parametrize("ddl", ["alter table r drop partition p0",
                                 "alter table r truncate partition p0",
                                 "truncate table r", "drop table r"])
def test_ddl_frees_every_sessions_tensors(ddl):
    """Two sessions on one storage, as two wire connections are, each
    with its own client: partition or table DDL in one frees what the
    other's client cached for the dropped ids. A session that is gone
    leaves no client behind in the storage's registry."""
    st = Storage()
    a, b = Session(st, device="cpu"), Session(st, device="cpu")
    a.execute("create table r (d int, amt int) partition by range (d) ("
              "partition p0 values less than (10), "
              "partition p1 values less than (20), "
              "partition pmax values less than maxvalue)")
    a.execute("insert into r values (1,1),(5,2),(12,3),(18,4),(25,5)")
    st.flush()
    ids = [d.id for d in st.catalog.table("test", "r").partition.defs]
    for s in (a, b):
        assert s.query("select sum(amt) from r where amt > 0") == [(15,)]
        assert set(ids) <= set(s.cop._live_epochs)
    a.execute(ddl)
    gone = ids[:1] if "partition" in ddl else ids
    for s in (a, b):
        assert not set(gone) & set(s.cop._live_epochs), ddl
        assert set(ids) - set(gone) <= set(s.cop._live_epochs), ddl
    del s, b
    gc.collect()
    assert list(st._cache_clients) == [a.cop]
