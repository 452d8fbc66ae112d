"""Online DDL of the port, held to the reference statement for statement.

Every case of tests/test_ddl.py runs through both packages' `Session` (the
port's with `device="cpu"`), each over its own in-memory store: after each
statement the outcomes must be equal (rows, or errno and message), and so
must the state both sides hold (`Pair.state`): the catalog version and id
allocator, every table's schema (columns, types, defaults, indexes and
their visibility), every table store (`store_state`: epoch, dictionaries,
deltas, handles) and the DDL job queue and history (`ADMIN SHOW DDL JOBS`
rows with each job's reorg checkpoint). Job ids come from a counter of
each package's own, so they are compared as offsets from each side's
first job.

The reorg cases (the checkpoint resume, the duplicate across batches, the
deleted row at a batch boundary, DML during write reorg) drive both
packages' `DDL.step` in lockstep, as the reference's tests drive it.

Then the risk of a rescaled column: TPC-H Q1, Q6 and Q18 at SF0.01 after
`MODIFY COLUMN l_quantity DECIMAL(18,4)` (every stored value times 100)
and after ADD/DROP COLUMN, against the reference's rows and engine tags.
Tolerance: none.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from tidb_tpu.bench import tpch_data as RTD
from tidb_tpu.ddl import DDL as RefDDL
from tidb_tpu.ddl import ddl as ref_ddl_mod
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.ddl import DDL
from tidb_tpu_torch.ddl import ddl as port_ddl_mod
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

from test_torch_store_writes import store_state

SIDES = {
    "port": (Storage, lambda st: Session(st, device="cpu"), DDL,
             port_ddl_mod),
    "ref": (RefStorage, RefSession, RefDDL, ref_ddl_mod),
}


def _cell(v):
    """A default or key value of either package as plain data."""
    return None if v is None else str(v)


def table_meta(info) -> tuple:
    """A TableInfo of either package as plain values."""
    return (
        info.id, info.name, info.pk_handle_offset,
        [(c.id, c.name, repr(c.ftype), c.ftype.nullable, c.offset,
          _cell(c.default), c.is_primary, c.auto_increment)
         for c in info.columns],
        [(ix.id, ix.name, list(ix.col_offsets), ix.unique, ix.primary,
          ix.visible) for ix in info.indices],
        [(fk.name, list(fk.col_offsets), fk.ref_db, fk.ref_table,
          list(fk.ref_cols), fk.on_delete, fk.on_update)
         for fk in getattr(info, "foreign_keys", []) or []])


class Side:
    """One package's storage and sessions."""

    def __init__(self, name: str, storage=None) -> None:
        self.name = name
        (self.StorageCls, self.new_session, self.DDL,
         self.ddl_mod) = SIDES[name]
        self.st = storage if storage is not None else self.StorageCls()
        self.s = self.new_session(self.st)
        # the id the next job of this package gets (the counter's repr is
        # "count(N)"): the base of the masked job ids
        self.job_base = int(repr(self.ddl_mod._job_ids)[6:-1])

    def session(self):
        return self.new_session(self.st)

    def mask_jobs(self, rows) -> list:
        return [(r[0] - self.job_base,) + tuple(r[1:]) for r in rows]

    def outcome(self, sql: str, s=None):
        s = s if s is not None else self.s
        try:
            rs = s.execute(sql)
        except Exception as e:  # the session error: errno and message
            return ("error", type(e).__name__, getattr(e, "errno", None),
                    str(e))
        rows = rs.rows
        if sql.lower().startswith("admin show ddl jobs"):
            rows = self.mask_jobs(rows)
        return (rs.affected, rs.column_names, TR.sql_cells(rows))

    def jobs(self) -> list:
        jobs = list(self.st.ddl_jobs) + list(self.st.ddl_history)
        return [self.mask_jobs([j.row()])[0] + (j.reorg_pos,)
                for j in jobs]

    def state(self, stores: bool = True) -> dict:
        cat = self.st.catalog
        tables = {}
        for sname, schema in sorted(cat.schemas.items()):
            for info in schema.tables.values():
                tables[(sname, info.name)] = (
                    table_meta(info),
                    store_state(self.st.table_store(info.id))
                    if stores else None)
        return {
            "version": cat.version, "next_id": cat._next_id,
            "tables": tables,
            "views": {k: sorted((v.name, v.sql, tuple(v.columns))
                                for v in getattr(s, "views", {}).values())
                      for k, s in cat.schemas.items()},
            "sequences": {k: sorted(
                (q.id, q.name, q.start, q.increment, q.min_value,
                 q.max_value, q.cycle, q.next_value)
                for q in (getattr(s, "sequences", {}) or {}).values())
                for k, s in cat.schemas.items()},
            "jobs": self.jobs(),
        }


class Pair:
    """The same statements through the port and the reference."""

    def __init__(self, stmts=(), storages=(None, None)) -> None:
        self.port = Side("port", storages[0])
        self.ref = Side("ref", storages[1])
        self.run(stmts)

    @property
    def sides(self):
        return (self.port, self.ref)

    def check_state(self, stores: bool = True) -> None:
        assert self.port.state(stores) == self.ref.state(stores)

    def one(self, sql: str, stores: bool = True, sessions=None):
        """One statement on both sides (on `sessions` = (port, ref) if
        given); outcomes equal, then the states."""
        ss = sessions or (None, None)
        got = self.port.outcome(sql, ss[0])
        want = self.ref.outcome(sql, ss[1])
        assert got == want, sql
        self.check_state(stores)
        return got

    def run(self, stmts, stores: bool = True) -> list:
        return [self.one(sql, stores) for sql in stmts]


def _error(out) -> tuple:
    assert out[0] == "error", out
    return out[2], out[3]


SETUP = ["CREATE TABLE t (id INT PRIMARY KEY, a INT, b VARCHAR(10))",
         "INSERT INTO t VALUES (1,10,'x'),(2,20,'y'),(3,30,'z')"]

# the session-level cases of tests/test_ddl.py, each over the `se`
# fixture's table t (or its own tables where the reference's case makes
# them); every statement is compared on both sides
CASES = {
    "create_index_and_use": SETUP + [
        "CREATE INDEX ka ON t (a)", "ANALYZE TABLE t",
        "SELECT id FROM t WHERE a = 20",
        "EXPLAIN SELECT id FROM t WHERE a = 20"],
    "create_unique_index_validates": SETUP + [
        "INSERT INTO t VALUES (4,10,'w')",
        "CREATE UNIQUE INDEX ua ON t (a)", "ADMIN SHOW DDL JOBS"],
    "unique_index_then_enforced": SETUP + [
        "ALTER TABLE t ADD UNIQUE KEY ua (a)",
        "INSERT INTO t VALUES (9,10,'q')", "INSERT INTO t VALUES (9,11,'q')"],
    "drop_index": SETUP + [
        "CREATE INDEX ka ON t (a)", "DROP INDEX ka ON t",
        "DROP INDEX ka ON t"],
    "add_column_with_default": SETUP + [
        "ALTER TABLE t ADD COLUMN c INT DEFAULT 7",
        "SELECT c FROM t ORDER BY id",
        "INSERT INTO t (id, a, b) VALUES (4, 40, 'w')",
        "SELECT c FROM t WHERE id = 4",
        "INSERT INTO t VALUES (5, 50, 'v', 99)",
        "SELECT c FROM t WHERE id = 5"],
    "add_column_nullable": SETUP + [
        "ALTER TABLE t ADD COLUMN n VARCHAR(5)",
        "SELECT n FROM t WHERE id = 1",
        "UPDATE t SET n = 'hi' WHERE id = 1",
        "SELECT n FROM t WHERE id = 1"],
    "add_column_string_default": SETUP + [
        "ALTER TABLE t ADD COLUMN s VARCHAR(5) DEFAULT 'dd'",
        "SELECT s FROM t WHERE id = 2",
        "SELECT COUNT(*) FROM t WHERE s = 'dd'"],
    "drop_column": SETUP + [
        "ALTER TABLE t DROP COLUMN a", "SELECT * FROM t WHERE id = 1",
        "SELECT a FROM t", "INSERT INTO t VALUES (4, 'w')",
        "SELECT b FROM t WHERE id = 4"],
    "drop_column_drops_covering_index": SETUP + [
        "CREATE INDEX ka ON t (a)", "ALTER TABLE t DROP COLUMN a",
        "SELECT id FROM t WHERE b = 'y'"],
    "drop_column_guards": SETUP + ["ALTER TABLE t DROP COLUMN id"],
    "modify_column_widen": SETUP + [
        "ALTER TABLE t MODIFY COLUMN a BIGINT",
        "SELECT a FROM t WHERE id = 3"],
    "modify_column_to_decimal": SETUP + [
        "ALTER TABLE t MODIFY COLUMN a DECIMAL(10,2)",
        "SELECT a FROM t ORDER BY id", "SELECT SUM(a) FROM t"],
    "modify_column_narrow_out_of_range": SETUP + [
        "UPDATE t SET a = 300 WHERE id = 1",
        "ALTER TABLE t MODIFY COLUMN a TINYINT",
        "SELECT a FROM t WHERE id = 1"],
    "rename_table": SETUP + [
        "RENAME TABLE t TO t2", "SELECT COUNT(*) FROM t2",
        "SELECT * FROM t", "ALTER TABLE t2 RENAME TO t3",
        "SELECT COUNT(*) FROM t3"],
    "ddl_job_states_recorded": SETUP + [
        "CREATE INDEX ka ON t (a)", "ADMIN SHOW DDL JOBS"],
    "modify_column_large_int_exact": [
        "CREATE TABLE li (id INT PRIMARY KEY, v BIGINT)",
        "INSERT INTO li VALUES (1, 4611686018427387905)",
        "ALTER TABLE li MODIFY COLUMN v BIGINT NOT NULL",
        "SELECT v FROM li"],
    "multi_spec_alter": SETUP + [
        "ALTER TABLE t ADD COLUMN c INT DEFAULT 1, ADD KEY kc (c)",
        "ADMIN SHOW DDL JOBS"],
    "modify_column_lossy_on_unique_rejected": [
        "CREATE TABLE lm (id INT PRIMARY KEY, d DECIMAL(5,2))",
        "CREATE UNIQUE INDEX ud ON lm (d)",
        "INSERT INTO lm VALUES (1, 0.90), (2, 1.10)",
        "ALTER TABLE lm MODIFY COLUMN d INT",
        "CREATE TABLE lm2 (id INT PRIMARY KEY, d DECIMAL(5,2))",
        "INSERT INTO lm2 VALUES (1, 0.90), (2, 1.10)",
        "ALTER TABLE lm2 MODIFY COLUMN d INT",
        "SELECT d FROM lm2 ORDER BY id"],
    "modify_column_lossless_on_unique_allowed": [
        "CREATE TABLE lw (id INT PRIMARY KEY, a INT)",
        "CREATE UNIQUE INDEX ua ON lw (a)",
        "INSERT INTO lw VALUES (1, 7), (2, 9)",
        "ALTER TABLE lw MODIFY COLUMN a BIGINT",
        "SELECT a FROM lw WHERE a = 9",
        "CREATE TABLE lw2 (id INT PRIMARY KEY, a INT)",
        "CREATE UNIQUE INDEX ua2 ON lw2 (a)",
        "INSERT INTO lw2 VALUES (1, 7)",
        "ALTER TABLE lw2 MODIFY COLUMN a DECIMAL(12,2)",
        "SELECT id FROM lw2 WHERE a = 7"],
    "modify_column_swaps_type_and_data_atomically": [
        "CREATE TABLE at2 (id INT PRIMARY KEY, d DECIMAL(10,2))",
        "INSERT INTO at2 VALUES (1, 12.34)",
        "ALTER TABLE at2 MODIFY COLUMN d DECIMAL(10,4)",
        "SELECT d FROM at2"],
}

# what the reference's own asserts say of a case's statements (the last
# one of that text), checked here on the port's outcome (both sides are
# equal by then): rows, an errno, or a part of the error message
EXPECT = {
    "create_index_and_use": {"SELECT id FROM t WHERE a = 20": [(2,)]},
    "create_unique_index_validates": {
        "CREATE UNIQUE INDEX ua ON t (a)": "Duplicate entry '10'"},
    "unique_index_then_enforced": {"INSERT INTO t VALUES (9,10,'q')": 1062},
    "drop_index": {"DROP INDEX ka ON t": "exists"},
    "add_column_with_default": {
        "SELECT c FROM t ORDER BY id": [(7,), (7,), (7,)],
        "SELECT c FROM t WHERE id = 4": [(7,)],
        "SELECT c FROM t WHERE id = 5": [(99,)]},
    "add_column_nullable": {"SELECT n FROM t WHERE id = 1": [("hi",)]},
    "add_column_string_default": {
        "SELECT s FROM t WHERE id = 2": [("dd",)],
        "SELECT COUNT(*) FROM t WHERE s = 'dd'": [(3,)]},
    "drop_column": {"SELECT * FROM t WHERE id = 1": [(1, "x")],
                    "SELECT a FROM t": 1054,
                    "SELECT b FROM t WHERE id = 4": [("w",)]},
    "drop_column_drops_covering_index": {
        "SELECT id FROM t WHERE b = 'y'": [(2,)]},
    "drop_column_guards": {"ALTER TABLE t DROP COLUMN id": "primary key"},
    "modify_column_widen": {"SELECT a FROM t WHERE id = 3": [(30,)]},
    "modify_column_narrow_out_of_range": {
        "ALTER TABLE t MODIFY COLUMN a TINYINT": "truncated",
        "SELECT a FROM t WHERE id = 1": [(300,)]},
    "rename_table": {"SELECT COUNT(*) FROM t2": [(3,)],
                     "SELECT * FROM t": 1146,
                     "SELECT COUNT(*) FROM t3": [(3,)]},
    "modify_column_large_int_exact": {
        "SELECT v FROM li": [(4611686018427387905,)]},
    "modify_column_lossy_on_unique_rejected": {
        "ALTER TABLE lm MODIFY COLUMN d INT": "lossy",
        "SELECT d FROM lm2 ORDER BY id": [(1,), (1,)]},
    "modify_column_lossless_on_unique_allowed": {
        "SELECT a FROM lw WHERE a = 9": [(9,)],
        "SELECT id FROM lw2 WHERE a = 7": [(1,)]},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ddl_case_matches_reference(case):
    pair = Pair()
    stmts = CASES[case]
    outs = pair.run(stmts)
    for sql, want in EXPECT.get(case, {}).items():
        out = outs[len(stmts) - 1 - stmts[::-1].index(sql)]
        if isinstance(want, list):
            assert out[2] == TR.sql_cells(want), (case, sql)
        elif isinstance(want, int):
            assert _error(out)[0] == want, (case, sql)
        else:
            assert want in _error(out)[1], (case, sql)


def test_unique_validation_failure_leaves_no_index():
    pair = Pair(SETUP + ["INSERT INTO t VALUES (4,10,'w')"])
    out = pair.one("CREATE UNIQUE INDEX ua ON t (a)")
    # the reference re-raises the rolled-back job's error by its text
    # alone (`DDL._run_job_steps`), so the statement's errno is 1105, not
    # the validation's 1062; the port gives the same
    assert _error(out) == (1105, "Duplicate entry '10' for key 'ua'")
    info = pair.port.st.catalog.table("test", "t")
    assert not any(ix.name == "ua" for ix in info.indices)
    jobs = pair.one("ADMIN SHOW DDL JOBS")[2]
    assert jobs[0][0] == 0 and jobs[0][5] == "rolled back"


def test_decimal_rescale_reads_at_the_new_scale():
    pair = Pair(["CREATE TABLE d (id INT PRIMARY KEY, q DECIMAL(15,2))",
                 "INSERT INTO d VALUES (1, 1.25), (2, 300.50), (3, NULL)"])
    for side in pair.sides:
        side.st.flush()  # the rows into the epoch: cast_column's array path
    pair.one("INSERT INTO d VALUES (4, 2.00)")  # and one delta row
    pair.one("ALTER TABLE d MODIFY COLUMN q DECIMAL(18,4)")
    st = pair.port.st.table_store(pair.port.st.catalog.table(
        "test", "d").id)
    assert st.epoch.columns[1].tolist()[:2] == [12500, 3005000]
    assert st.deltas[0][2][1] == 20000
    out = pair.one("SELECT sum(q), max(q), count(q) FROM d")
    assert [tuple(map(str, r)) for r in pair.port.s.query(
        "SELECT sum(q), max(q), count(q) FROM d")] == \
        [("303.7500", "300.5000", "3")]
    assert out[0] == 0


# ---------------- the reorg cases, through DDL.step ----------------

def _bulk_table(pair, name: str, vals: np.ndarray):
    pair.run([f"CREATE TABLE {name} (id INT PRIMARY KEY, v INT)"])
    for side in pair.sides:
        info = side.st.catalog.table("test", name)
        side.st.table_store(info.id).bulk_load(
            [np.arange(len(vals), dtype=np.int64), vals.copy()])
    pair.check_state()


def _submit(pair, name: str, args: dict) -> list:
    """The same job on both sides -> [(DDL, job)] (port, ref)."""
    out = []
    for side in pair.sides:
        info = side.st.catalog.table("test", name)
        ddl = side.DDL(side.st, side.st.catalog)
        out.append((ddl, ddl.submit("add_index", "test", info,
                                    copy.deepcopy(args))))
    pair.check_state()
    return out


def _job_fields(job) -> tuple:
    return (job.state, job.schema_state, job.reorg_pos, job.error,
            job.kind, job.table_name)


def _step_both(pair, jobs) -> bool:
    done = [ddl.step(job) for ddl, job in jobs]
    assert done[0] == done[1]
    assert _job_fields(jobs[0][1]) == _job_fields(jobs[1][1])
    pair.check_state()
    return done[0]


def test_reorg_checkpoint_resume():
    """Worker 'crash' mid-validation: a new worker resumes from the
    checkpoint, not from scratch (reference: ddl/reorg.go:627)."""
    pair = Pair()
    n = 100_000
    _bulk_table(pair, "big", np.arange(n, dtype=np.int64))
    jobs = _submit(pair, "big", {"name": "uv", "columns": ["v"],
                                 "unique": True})
    for _ in range(5):
        assert not _step_both(pair, jobs)
    job = jobs[0][1]
    assert job.schema_state == "write reorg" and job.reorg_pos == 40_000
    # a new worker (owner failover) resumes the same queued job
    for side, (_, j) in zip(pair.sides, jobs):
        assert side.st.ddl_jobs == [j]
        side.DDL(side.st, side.st.catalog).resume_pending()
        assert j.state == "done" and j.reorg_pos == n
    pair.check_state()
    ix = next(ix for ix in pair.port.st.catalog.table("test", "big").indices
              if ix.name == "uv")
    assert ix.visible and ix.unique
    assert _error(pair.one("INSERT INTO big VALUES (200000, 5)"))[0] == 1062


def test_reorg_detects_duplicates_across_batches():
    pair = Pair()
    n = 50_000
    vals = np.arange(n, dtype=np.int64)
    vals[-1] = 0  # duplicate of first value, far away in the permutation
    _bulk_table(pair, "big", vals)
    jobs = _submit(pair, "big", {"name": "uv", "columns": ["v"],
                                 "unique": True})
    while not _step_both(pair, jobs):
        pass
    for _, job in jobs:
        assert job.state == "rolled back"
        assert job.error == "Duplicate entry '0' for key 'uv'"


def test_unique_validation_deleted_row_at_batch_boundary():
    """Duplicates straddling a reorg batch with a deleted row at the
    boundary must still be caught."""
    pair = Pair()
    n = 40_005
    vals = np.arange(n, dtype=np.int64)
    vals[19999] = 19998
    vals[20000] = 19998
    _bulk_table(pair, "bb", vals)
    pair.run(["DELETE FROM bb WHERE id = 19999"])
    for side in pair.sides:
        side.st.flush()
    pair.check_state()
    jobs = _submit(pair, "bb", {"name": "uv", "columns": ["v"],
                                "unique": True})
    while not _step_both(pair, jobs):
        pass
    assert jobs[0][1].error == "Duplicate entry '19998' for key 'uv'"


def test_dml_during_write_reorg():
    """Writes during the reorg phase are unique-checked by the invisible
    index (write-only semantics of the F1 protocol)."""
    pair = Pair(["CREATE TABLE wr (id INT PRIMARY KEY, v INT)",
                 "INSERT INTO wr VALUES (1, 100), (2, 200)"])
    jobs = _submit(pair, "wr", {"name": "uv", "columns": ["v"],
                                "unique": True})
    _step_both(pair, jobs)  # none -> delete only (registered, invisible)
    _step_both(pair, jobs)  # -> write only
    assert _error(pair.one("INSERT INTO wr VALUES (3, 100)"))[0] == 1062
    pair.one("INSERT INTO wr VALUES (3, 300)")
    plan = pair.one("EXPLAIN SELECT id FROM wr WHERE v = 100")[2]
    text = "\n".join(r[0] for r in plan)
    assert "index:" not in text and "PointGet" not in text
    while not _step_both(pair, jobs):
        pass
    plan = pair.one("EXPLAIN SELECT id FROM wr WHERE v = 100")[2]
    assert "PointGet" in "\n".join(r[0] for r in plan)


def test_txn_fenced_by_concurrent_ddl():
    """A txn that buffered rows under the old layout must abort when DDL
    rewrites the table before it commits."""
    pair = Pair(["CREATE TABLE f (id INT PRIMARY KEY, a INT, b VARCHAR(5))",
                 "INSERT INTO f VALUES (1, 10, 'x')", "BEGIN",
                 "INSERT INTO f VALUES (2, 20, 'y')"])
    s2 = (pair.port.session(), pair.ref.session())
    pair.one("ALTER TABLE f DROP COLUMN a", sessions=s2)
    out = pair.one("COMMIT")
    assert _error(out)[1].startswith("Information schema is changed")
    assert pair.one("SELECT * FROM f", sessions=s2)[2] == [(1, "x")]
    pair.one("INSERT INTO f VALUES (3, 'z')", sessions=s2)
    assert pair.one("SELECT COUNT(*) FROM f", sessions=s2)[2] == [(2,)]


def test_old_snapshot_keeps_old_layout():
    """A snapshot taken before a DROP COLUMN keeps the old TableInfo and
    epoch; the next statement plans against the new layout and reads the
    new epoch, never a tile the coprocessor staged from the old one under
    a shifted column offset (its caches are keyed by epoch id and
    offset)."""
    pair = Pair(["CREATE TABLE o (id INT PRIMARY KEY, a INT, b INT)",
                 "INSERT INTO o VALUES (1, 10, 100), (2, 20, 200)"])
    for side in pair.sides:
        side.st.flush()
    assert pair.one("SELECT sum(b) FROM o")[2] == [(300,)]
    old = []
    for side in pair.sides:
        txn = side.st.begin()
        old.append((txn, txn.snapshot(side.st.catalog.table("test", "o").id)))
    pair.one("ALTER TABLE o DROP COLUMN a")
    for txn, snap in old:
        assert [c.name for c in snap.table.columns] == ["id", "a", "b"]
        assert snap.epoch.columns[1].tolist() == [10, 20]
        txn.rollback()
    assert pair.one("SELECT sum(b) FROM o")[2] == [(300,)]
    assert pair.one("SELECT * FROM o ORDER BY id")[2] == \
        [(1, 100), (2, 200)]


# ---------------- TPC-H reads after column DDL ----------------

@pytest.fixture(scope="module")
def tpch_pair():
    data = TD.generate_tpch(0.01, 42)
    pair = Pair()
    for name in ("lineitem", "orders", "customer"):
        TD.load_table(pair.port.s, name, data[name])
        RTD.load_table(pair.ref.s, name, data[name])
    pair.run(["ANALYZE TABLE lineitem, orders, customer"], stores=False)
    return pair


READS = ("q1", "q6", "q18")


def _reads_equal(pair) -> dict:
    tags = {}
    for q in READS:
        sql = TPCH_QUERIES[q]
        got = pair.port.s.query(sql)
        want = pair.ref.s.query(sql)
        assert TR.sql_cells(got) == TR.sql_cells(want), q
        assert pair.port.s.last_engines == pair.ref.s.last_engines, q
        tags[q] = list(pair.port.s.last_engines)
    return tags


def test_tpch_reads_after_column_ddl(tpch_pair):
    pair = tpch_pair
    before = _reads_equal(pair)
    pair.one("ALTER TABLE lineitem MODIFY COLUMN l_quantity DECIMAL(18,4)")
    after = _reads_equal(pair)
    pair.one("ALTER TABLE lineitem ADD COLUMN l_tag INT DEFAULT 7")
    n = pair.one("SELECT sum(l_tag), count(*) FROM lineitem",
                 stores=False)[2]
    assert n[0][0] == 7 * n[0][1]
    _reads_equal(pair)
    pair.run(["ANALYZE TABLE lineitem"], stores=False)
    _reads_equal(pair)
    pair.one("ALTER TABLE lineitem DROP COLUMN l_tag")
    _reads_equal(pair)
    pair.run(["ADMIN CHECK TABLE lineitem, orders", "CHECKSUM TABLE orders",
              "ADMIN SHOW DDL JOBS"], stores=False)
    assert set(before) == set(after)
