"""Durability and restart recovery of the port, held to the reference.

The cases of tests/test_durability.py, the pending DDL job among them,
and two more: a DDL job "crashed" by the `ddl/before-step` failpoint in
the middle of its reorg batches, and a sequence across a clean and a
crashed restart. Each runs the same statements through both packages'
`Session(Storage(path))` in a directory of its own, "crashes" both the
way that file's `crash()` does (the KV engine's files released without a
checkpoint), reopens both, and compares what the two recovered: rows,
errnos, the table stores (epochs, dictionaries, deltas, handles), the
indexes and the DDL job history (a pending job resumes at the reopen).

The two packages' directories are not interchangeable (the catalog and
the statistics are pickles of each package's own classes): the
recovered states are compared, never a directory opened by the other
package. The KV files alone are shared: tests/test_torch_native_kv.py.
"""

import os
import pickle

import numpy as np
import pytest

from tidb_tpu.bench import tpch_data as RTD
from tidb_tpu.ddl import DDL as RefDDL
from tidb_tpu.util import failpoint as ref_failpoint
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.ddl import DDL
from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.mvcc import OP_PUT, Mutation
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage
from tidb_tpu_torch.util import failpoint

from test_torch_store_writes import store_state

SIDES = {
    "port": (Storage, lambda st: Session(st, device="cpu")),
    "ref": (RefStorage, RefSession),
}
DDLS = {"port": (DDL, failpoint), "ref": (RefDDL, ref_failpoint)}


def crash(storage):
    """Simulate process death: release file handles WITHOUT checkpointing."""
    storage.kv.kv.close()


class Side:
    """One package's durable store in its own directory."""

    def __init__(self, name: str, root) -> None:
        self.name = name
        self.StorageCls, self.new_session = SIDES[name]
        self.path = str(root / name)
        self.open()

    def open(self, **kw) -> None:
        self.st = self.StorageCls(self.path, **kw)
        self.s = self.new_session(self.st)

    def reopen(self, **kw) -> None:
        crash(self.st)
        self.open(**kw)

    def outcome(self, sql: str):
        try:
            rs = self.s.execute(sql)
        except Exception as e:  # the session error, by its errno
            return ("error", getattr(e, "errno", None))
        return (rs.affected, TR.sql_cells(rs.rows))

    def stores(self) -> dict:
        out = {}
        for schema in self.st.catalog.schemas.values():
            for info in schema.tables.values():
                out[info.name] = store_state(self.st.table_store(info.id))
        return out


@pytest.fixture()
def sides(tmp_path):
    both = [Side("port", tmp_path), Side("ref", tmp_path)]
    yield both
    for side in both:
        side.st.kv.kv.close()


def _run(sides, stmts) -> list:
    """The statements through both sides; their outcomes must agree."""
    out = []
    for sql in stmts:
        got = [side.outcome(sql) for side in sides]
        assert got[0] == got[1], sql
        out.append(got[0])
    return out


def _reopen_and_compare(sides, reads, **kw) -> list:
    for side in sides:
        side.reopen(**kw)
    assert sides[0].stores() == sides[1].stores()
    return _run(sides, reads)


def test_rows_schema_survive_crash(sides):
    _run(sides, [
        "CREATE TABLE t (id INT PRIMARY KEY, v INT, name VARCHAR(20))",
        "INSERT INTO t VALUES (1, 10, 'alpha'), (2, 20, 'beta')",
        "UPDATE t SET v = 25 WHERE id = 2",
        "INSERT INTO t VALUES (3, 30, NULL)",
        "DELETE FROM t WHERE id = 1"])
    got = _reopen_and_compare(sides, [
        "SELECT id, v, name FROM t ORDER BY id",
        "INSERT INTO t VALUES (4, 40, 'gamma')",
        "SELECT COUNT(*) FROM t",
        "SELECT nope FROM t"])
    assert got[0] == (0, [(2, 25, "beta"), (3, 30, None)])
    assert got[2][1] == [(3,)]
    assert got[3] == ("error", 1054)


def test_duplicate_key_still_enforced_after_reopen(sides):
    _run(sides, [
        "CREATE TABLE u (id INT PRIMARY KEY, email VARCHAR(40) UNIQUE)",
        "INSERT INTO u VALUES (1, 'a@x.com')"])
    got = _reopen_and_compare(sides, [
        "INSERT INTO u VALUES (2, 'a@x.com')",
        "INSERT INTO u VALUES (1, 'b@x.com')"])
    assert got == [("error", 1062)] * 2


def test_bulk_load_and_compaction_epochs_survive(sides, monkeypatch):
    """A bulk-loaded epoch (persisted at load), then compacting commits
    (their epochs marked dirty, not written): recovery loads the epoch
    file and refolds the rest from the KV."""
    data = TD.generate_tpch(0.002, 17)
    for side in sides:
        (TD if side.name == "port" else RTD).load_table(
            side.s, "lineitem", data["lineitem"])
        store = side.st.table_store(
            side.st.catalog.table("test", "lineitem").id)
        assert not store.epoch_dirty
        monkeypatch.setattr(type(store), "COMPACT_THRESHOLD", 64)
    stmts = [f"UPDATE lineitem SET l_quantity = l_quantity + 1 "
             f"WHERE l_orderkey = {k}" for k in range(1, 200, 3)]
    stmts += [f"DELETE FROM lineitem WHERE l_orderkey = {k}"
              for k in range(2, 90, 7)]
    _run(sides, stmts)
    assert all(side.st.table_store(side.st.catalog.table(
        "test", "lineitem").id).epoch_dirty for side in sides)
    reads = [TPCH_QUERIES["q6"], TPCH_QUERIES["q1"],
             "SELECT COUNT(*) FROM lineitem"]
    want = _run(sides, reads)
    assert _reopen_and_compare(sides, reads) == want


def test_auto_increment_does_not_collide_after_reopen(sides):
    _run(sides, [
        "CREATE TABLE a (id INT PRIMARY KEY AUTO_INCREMENT, v INT)",
        "INSERT INTO a (v) VALUES (1), (2), (3)"])
    got = _reopen_and_compare(sides, [
        "INSERT INTO a (v) VALUES (4)", "SELECT id FROM a ORDER BY id"])
    ids = [r[0] for r in got[1][1]]
    assert len(ids) == len(set(ids)) == 4


def test_drop_and_truncate_do_not_resurrect(sides):
    _run(sides, [
        "CREATE TABLE d1 (id INT PRIMARY KEY, v INT)",
        "INSERT INTO d1 VALUES (1, 1)",
        "CREATE TABLE d2 (id INT PRIMARY KEY, v INT)",
        "INSERT INTO d2 VALUES (7, 7)",
        "DROP TABLE d1",
        "TRUNCATE TABLE d2",
        "INSERT INTO d2 VALUES (8, 8)"])
    got = _reopen_and_compare(sides, ["SELECT * FROM d2",
                                      "SELECT * FROM d1"])
    assert got == [(0, [(8, 8)]), ("error", 1146)]


def test_uncommitted_txn_lost_orphan_locks_resolved(sides):
    _run(sides, ["CREATE TABLE t (id INT PRIMARY KEY, v INT)",
                 "INSERT INTO t VALUES (1, 1)",
                 "BEGIN",
                 "INSERT INTO t VALUES (2, 2)"])
    # crash with the txn open (its writes only buffered: lost), and a
    # dangling prewrite lock left behind to prove orphan resolution
    for side in sides:
        tid = side.st.catalog.table("test", "t").id
        key = tablecodec.record_key(tid, 99)
        side.st.kv.prewrite(
            [Mutation(OP_PUT, key, b"\x03" + b"\x80" + b"\x00" * 7)],
            key, side.st.tso.next_ts())
        assert len(side.st.kv.all_locks()) == 1
    got = _reopen_and_compare(sides, ["SELECT id FROM t ORDER BY id"])
    assert got == [(0, [(1,)])]
    assert all(side.st.kv.all_locks() == [] for side in sides)


def test_checkpoint_then_reopen_via_snapshot(sides):
    _run(sides, ["CREATE TABLE c (id INT PRIMARY KEY, v VARCHAR(8))",
                 "INSERT INTO c VALUES (1, 'x')"])
    for side in sides:
        side.st.close()  # checkpoint: snapshot written, WAL truncated
        assert os.path.getsize(os.path.join(side.path, "kv",
                                            "wal.log")) == 0
        side.open()
    _run(sides, ["INSERT INTO c VALUES (2, 'y')"])  # lands in a fresh WAL
    got = _reopen_and_compare(sides, ["SELECT id, v FROM c ORDER BY id"])
    assert got == [(0, [(1, "x"), (2, "y")])]


def test_stats_survive_restart(sides):
    _run(sides, ["CREATE TABLE st1 (id INT PRIMARY KEY, v INT)",
                 "INSERT INTO st1 VALUES " + ",".join(
                     f"({i}, {i % 10})" for i in range(100)),
                 "ANALYZE TABLE st1"])
    _reopen_and_compare(sides, [])
    got = []
    for side in sides:
        tid = side.st.catalog.table("test", "st1").id
        ts = side.st.stats.table_stats(tid)
        assert ts is not None
        got.append((ts.row_count, side.st.stats._analyzed_at_modify[tid]))
    assert got[0] == got[1] and got[0][0] == 100
    # the plans built over the reloaded statistics agree
    _run(sides, ["EXPLAIN SELECT v FROM st1 WHERE v = 3"])


def test_global_sysvars_survive_restart(sides):
    _run(sides, ["SET GLOBAL tidb_retry_limit = 7",
                 "SET GLOBAL wait_timeout = 120"])
    got = _reopen_and_compare(sides, ["SELECT @@global.tidb_retry_limit",
                                      "SELECT @@global.wait_timeout"])
    assert [g[1] for g in got] == [[(7,)], [(120,)]]


def test_tso_monotonic_across_restart(sides):
    _run(sides, ["CREATE TABLE m (id INT PRIMARY KEY)",
                 "INSERT INTO m VALUES (1)"])
    last = [side.st.tso.current() for side in sides]
    for side in sides:
        side.reopen()
    for side, ts in zip(sides, last):
        assert side.st.tso.next_ts() > ts


def test_tso_floor_from_the_kv_without_a_lease(sides):
    _run(sides, ["CREATE TABLE m (id INT PRIMARY KEY)",
                 "INSERT INTO m VALUES (1)"])
    for side in sides:
        top = side.st.kv.max_commit_ts()
        crash(side.st)
        os.remove(os.path.join(side.path, "tso.lease"))
        side.open()
        assert side.st.tso.next_ts() > top
    _run(sides, ["INSERT INTO m VALUES (2)", "SELECT id FROM m"])


def test_recovery_idempotent_checkpoint_crash_loop(tmp_path):
    """checkpoint() -> crash (reopen from disk) in a loop, with writes
    interleaved between crashes: the port equals an uncrashed in-memory
    port store and the crashed reference after every round (the stores
    too)."""
    import random

    rng = random.Random(20260804)
    sides = [Side("port", tmp_path), Side("ref", tmp_path)]
    oracle = Session(Storage(), device="cpu")
    ddl = "CREATE TABLE t (id INT PRIMARY KEY, v INT, s VARCHAR(16))"
    _run(sides, [ddl])
    oracle.execute(ddl)
    live: set[int] = set()
    next_id = 0
    for round_no in range(4):
        stmts = []
        for _ in range(25):
            op = rng.random()
            if op < 0.55 or not live:
                next_id += 1
                live.add(next_id)
                stmts.append(f"INSERT INTO t VALUES ({next_id}, "
                             f"{rng.randrange(1000)}, 'r{round_no}')")
            elif op < 0.8:
                victim = rng.choice(sorted(live))
                stmts.append(f"UPDATE t SET v = {rng.randrange(1000)} "
                             f"WHERE id = {victim}")
            else:
                victim = rng.choice(sorted(live))
                live.discard(victim)
                stmts.append(f"DELETE FROM t WHERE id = {victim}")
        _run(sides, stmts)
        for sql in stmts:
            oracle.execute(sql)
        if round_no % 2 == 0:
            for side in sides:
                side.st.checkpoint()  # epochs + folded WAL on even rounds
        q = "SELECT id, v, s FROM t ORDER BY id"
        got = _reopen_and_compare(sides, [q])
        assert got[0][1] == TR.sql_cells(oracle.query(q)), \
            f"diverged from the oracle after crash round {round_no}"
    for side in sides:
        side.st.close()


def test_sync_log_interval_group_commit(sides):
    for side in sides:
        side.reopen(sync_log="interval", sync_interval_ms=50)
    _run(sides, ["CREATE TABLE g (id INT PRIMARY KEY)"] + [
        f"INSERT INTO g VALUES ({i})" for i in range(10)])
    assert _reopen_and_compare(sides, ["SELECT COUNT(*) FROM g"]) == \
        [(0, [(10,)])]


def test_sync_log_validation():
    for cls in (Storage, RefStorage):
        with pytest.raises(ValueError, match="sync_log"):
            cls(sync_log="sometimes")


def test_corrupt_epoch_refolds_from_the_kv(sides):
    """An unreadable epoch snapshot degrades to a full refold from the KV
    truth (and is dropped), never to a failed open."""
    _run(sides, ["CREATE TABLE e (id INT PRIMARY KEY, v VARCHAR(8))",
                 "INSERT INTO e VALUES (1, 'a'), (2, 'b')",
                 "DELETE FROM e WHERE id = 1"])
    for side in sides:
        side.st.checkpoint()
        tid = side.st.catalog.table("test", "e").id
        with open(side.st._epoch_file(tid), "wb") as f:
            f.write(b"not an npz")
    got = _reopen_and_compare(sides, ["SELECT id, v FROM e ORDER BY id"])
    assert got == [(0, [(2, "b")])]
    for side in sides:
        tid = side.st.catalog.table("test", "e").id
        assert not os.path.exists(side.st._epoch_file(tid))


def _ddl_state(side) -> tuple:
    """The side's DDL job history (ids as offsets from its first job) and
    its tables' indexes."""
    jobs = list(side.st.ddl_jobs) + list(side.st.ddl_history)
    base = min((j.id for j in jobs), default=0)
    idx = {info.name: [(ix.name, list(ix.col_offsets), ix.unique,
                        ix.visible) for ix in info.indices]
           for info in side.st.catalog.schemas["test"].tables.values()}
    return ([(j.id - base,) + j.row()[1:] for j in jobs],
            [j.state for j in side.st.ddl_jobs], idx,
            side.st.catalog.version)


def test_pending_ddl_resumes_after_crash(sides):
    """A job left queued in delete-only by a dead worker: recovery resumes
    it to completion at the reopen (the reference's case of
    tests/test_durability.py)."""
    _run(sides, ["CREATE TABLE r (id INT PRIMARY KEY, v INT)",
                 "INSERT INTO r VALUES (1, 5), (2, 6), (3, 7)"])
    for side in sides:
        info = side.st.catalog.table("test", "r")
        ddl = DDLS[side.name][0](side.st, side.st.catalog)
        job = ddl.submit("add_index", "test", info, {
            "name": "iv", "columns": ["v"], "unique": True})
        ddl.step(job)  # delete-only — then the worker "dies"
    got = _reopen_and_compare(sides, ["INSERT INTO r VALUES (9, 5)",
                                      "SELECT id FROM r ORDER BY id"])
    assert got[0] == ("error", 1062)
    assert _ddl_state(sides[0]) == _ddl_state(sides[1])
    assert sides[0].st.ddl_jobs == []
    ix = next(x for x in sides[0].st.catalog.table("test", "r").indices
              if x.name == "iv")
    assert ix.visible and ix.unique


class Crash(Exception):
    """The worker's death at a failpoint."""


def test_ddl_crashed_mid_reorg_resumes(sides, monkeypatch):
    """CREATE UNIQUE INDEX dies at `ddl/before-step` after two persisted
    reorg batches: the persisted job holds its checkpoint, and the reopen
    resumes the job (the reopened epoch has a new id, so the validation
    scan starts over on it) to the same index, rows and job history as
    the reference's."""
    _run(sides, ["CREATE TABLE r (id INT PRIMARY KEY, v INT)"] + [
        "INSERT INTO r VALUES " + ",".join(
            f"({i}, {i * 7})" for i in range(lo, lo + 500))
        for lo in range(0, 2500, 500)])
    hits = {}
    for side in sides:
        side.st.flush()  # the rows into the epoch the batches walk
        cls, fp = DDLS[side.name]
        monkeypatch.setattr(cls, "REORG_BATCH", 500)
        hits[side.name] = 0

        def crash_at(name=side.name):
            hits[name] += 1
            if hits[name] == 6:  # 3 state steps, 2 batches, then death
                raise Crash()

        with fp.failpoint("ddl/before-step", crash_at):
            assert side.outcome("CREATE UNIQUE INDEX iv ON r (v)") == \
                ("error", None)
    persisted = [pickle.loads(side.st.get_meta(b"ddl:jobs"))
                 for side in sides]
    assert [[(j.schema_state, j.reorg_pos) for j in p] for p in persisted] \
        == [[("write reorg", 1000)]] * 2
    got = _reopen_and_compare(sides, ["INSERT INTO r VALUES (9999, 7)",
                                      "SELECT count(*) FROM r"])
    assert got == [("error", 1062), (0, [(2500,)])]
    assert _ddl_state(sides[0]) == _ddl_state(sides[1])
    assert _ddl_state(sides[0])[0][-1][4:6] == ("public", "done")


def test_column_ddl_then_crash(sides):
    """Rows written before an ADD COLUMN refold from the KV padded with
    the new columns' defaults. The KV rows keep the layout and encoding
    they were written in, so after a crash both packages read a MODIFY'd
    column's pre-DDL values at the new scale (10 -> 0.10), and a DROP of a
    middle column shifts the later ones: faults of the reference, carried
    (ROADMAP queue 3). The two recover the same rows and stores."""
    _run(sides, ["CREATE TABLE c (id INT PRIMARY KEY, a INT, b VARCHAR(5))",
                 "INSERT INTO c VALUES (1, 10, 'x'), (2, 20, 'y')",
                 "ALTER TABLE c ADD COLUMN d INT DEFAULT 4",
                 "ALTER TABLE c ADD COLUMN e VARCHAR(4) DEFAULT 'ee'",
                 "INSERT INTO c VALUES (3, 30, 'z', 5, 'f')",
                 "ALTER TABLE c MODIFY COLUMN a DECIMAL(12,2)"])
    got = _reopen_and_compare(sides, ["SELECT id, b, d, e FROM c ORDER BY id",
                                      "SELECT a FROM c ORDER BY id"])
    assert got[0] == (0, [(1, "x", 4, "ee"), (2, "y", 4, "ee"),
                          (3, "z", 5, "f")])
    assert got[1][1] == [(("dec", 10, 2),), (("dec", 20, 2),),
                         (("dec", 30, 2),)]
    _run(sides, ["ALTER TABLE c DROP COLUMN b"])
    _reopen_and_compare(sides, ["SELECT * FROM c ORDER BY id"])


CHILD = """
import sys
if sys.argv[1] == "port":
    from tidb_tpu_torch.ddl import DDL
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import Storage
    new_session = lambda st: Session(st, device="cpu")
else:
    from tidb_tpu.ddl import DDL
    from tidb_tpu.session import Session as new_session
    from tidb_tpu.store.storage import Storage
DDL.REORG_BATCH = 500
new_session(Storage(sys.argv[2])).execute("CREATE UNIQUE INDEX iv ON r (v)")
"""


def test_ddl_child_killed_mid_reorg_resumes(sides):
    """A child process runs CREATE UNIQUE INDEX on the closed store with
    `TIDB_TPU_FAILPOINTS=ddl/before-step=exit(9)@6` (each package parses
    the variable at import) and dies after two persisted reorg batches;
    the reopen resumes the job, as in the reference."""
    import subprocess
    import sys

    _run(sides, ["CREATE TABLE r (id INT PRIMARY KEY, v INT)"] + [
        "INSERT INTO r VALUES " + ",".join(
            f"({i}, {i * 3})" for i in range(lo, lo + 500))
        for lo in range(0, 2500, 500)])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, TIDB_TPU_FAILPOINTS="ddl/before-step=exit(9)@6")
    for side in sides:
        side.st.flush()
        side.st.close()
        rc = subprocess.run([sys.executable, "-c", CHILD, side.name,
                             side.path], cwd=root, env=env,
                            timeout=120).returncode
        assert rc == 9
        side.open()
    assert _ddl_state(sides[0]) == _ddl_state(sides[1])
    assert _ddl_state(sides[0])[0][-1][3:6] == ("add_index", "public",
                                                 "done")
    got = _run(sides, ["INSERT INTO r VALUES (9999, 3)"])
    assert got == [("error", 1062)]
    assert sides[0].stores() == sides[1].stores()


def test_sequence_survives_restart(sides):
    """Clean restart: the exact cursor (no value re-issued, none
    skipped); crash: the persisted high-water a cache batch ahead (the
    reference's case of tests/test_sequence_fk_owner.py, and its crash
    twin)."""
    _run(sides, ["create sequence rs"] + ["select nextval(rs)"] * 3)
    for side in sides:
        side.st.close()
        side.open()
    assert _run(sides, ["select nextval(rs)"]) == [(0, [(4,)])]
    got = _reopen_and_compare(sides, ["select nextval(rs)"])
    assert got[0][1][0][0] > 4


def test_tpch_differential_against_reopened_store(tmp_path):
    """The mini TPC-H corpus answers identically before and after a
    restart, on both packages, and the port's answers equal the
    reference's."""
    data = TD.generate_tpch(0.002, 17)
    sides = [Side("port", tmp_path), Side("ref", tmp_path)]
    for side in sides:
        for tname in TD.TPCH_DDL:
            (TD if side.name == "port" else RTD).load_table(
                side.s, tname, data[tname])
    reads = [TPCH_QUERIES[q] for q in ("q1", "q3", "q6", "q12")]
    want = _run(sides, reads)
    assert _reopen_and_compare(sides, reads) == want
    assert all(np.isfinite(float(c)) for _, rows in want for r in rows
               for c in r if isinstance(c, (int, float)))
    for side in sides:
        side.st.close()
