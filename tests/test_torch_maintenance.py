"""The port's maintenance worker and version GC against the reference's.

tests/test_maintenance.py's daemon cases run on both packages, each over
its own store, with the same statements: the failpoint registry's hit
counts, `parse_duration`, expired-lock resolution (an uncommitted orphan
rolled back, the row read as before), GC that protects a held snapshot
and never drops a key's newest version, auto-analyze by tick, and the
thread's lifecycle. After each GC the two stores are compared key by key:
every user key of the table with its versions (kind and value, newest
first; the timestamps are each process's own). `MVCCStore.gc` alone, on
one seeded history of puts, deletes, lock and rollback markers, removes
the same count and leaves the same versions. A child of each package
killed at `daemon/before-gc` (its first tick) reopens with every version
still there, and the next tick then reclaims the same versions on both.
Then the port's own rule: the loop goes on past a wounded pass (a KV or
transaction error), and any other exception, such as a torch error, ends
it and is re-raised by `stop()` and by `Storage.close()`, which still
closes the store. Tolerance: none.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from tidb_tpu.kv import mvcc as RMV
from tidb_tpu.kv import tablecodec as RTC
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store import daemon as RD
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu.util import failpoint as rfp
from tidb_tpu_torch.kv import mvcc as PMV
from tidb_tpu_torch.kv import tablecodec as PTC
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store import daemon as PD
from tidb_tpu_torch.store.storage import Storage
from tidb_tpu_torch.util import failpoint as pfp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Side:
    """One package: its store, a session, its MVCC and tablecodec."""

    def __init__(self, name: str, path=None) -> None:
        self.name = name
        if name == "port":
            self.st = Storage(path, sync_log="commit") if path else Storage()
            self.s = Session(self.st, device="cpu")
            self.mv, self.tc = PMV, PTC
        else:
            self.st = RefStorage(path, sync_log="commit") if path \
                else RefStorage()
            self.s = RefSession(self.st)
            self.mv, self.tc = RMV, RTC

    def q(self, sql: str) -> list:
        return self.s.execute(sql).rows

    def versions(self, table: str) -> dict:
        """user key -> [(kind, value), ...] newest first, for every
        record of `table`."""
        tid = self.s.catalog.table("test", table).id
        lo, hi = self.tc.record_range(tid)
        return _versions(self.mv, self.st.kv, lo, hi)


def _versions(mv, store, lo: bytes, hi: bytes) -> dict:
    out: dict = {}
    for wk, wv in store.kv.scan(mv.CF_WRITE, b"", b""):
        key, _ = mv._split_vkey(wk)
        if not lo <= key < hi:
            continue
        start_ts, kind = mv._write_dec(wv)
        val = store.kv.get(mv.CF_DATA, mv._dkey(key, start_ts)) \
            if kind == mv.OP_PUT else None
        out.setdefault(key, []).append((kind, val))
    return out


def _sides(path=None):
    return [Side("ref", path and f"{path}/ref"),
            Side("port", path and f"{path}/port")]


def _both(sides, sql: str) -> list:
    got = [side.q(sql) for side in sides]
    assert got[0] == got[1], sql
    return got[0]


@pytest.fixture(autouse=True)
def _clean_failpoints():
    yield
    rfp.disable_all()
    pfp.disable_all()


def test_failpoint_registry_basics():
    class CrashError(Exception):
        pass

    for fp in (rfp, pfp):
        assert fp.inject("nope") is None
        fp.enable("p1", 42)
        assert fp.inject("p1") == 42
        assert fp.hits("p1") == 1
        fp.disable("p1")
        assert fp.inject("p1") is None
        with fp.failpoint("p2", CrashError("boom")):
            with pytest.raises(CrashError):
                fp.inject("p2")
        calls = []
        fp.enable("p3", lambda: calls.append(1))
        fp.inject("p3")
        assert calls == [1]
        fp.disable("p3")
    assert pfp.snapshot() == rfp.snapshot()
    assert pfp.snapshot()["p1"] == {"armed": False, "value": "None",
                                    "hits": 1}


@pytest.mark.parametrize("spec,default", [
    ("10m0s", 600), ("1h30m", 600), ("500ms", 600), ("600", 600),
    ("", 123), ("junk", 99), ("2d1s", 1), (None, 7), (" 45s ", 1),
    ("1.5m", 1),
])
def test_parse_duration(spec, default):
    assert PD.parse_duration(spec, default) == \
        RD.parse_duration(spec, default)


def test_mvcc_gc_equal_on_a_seeded_history():
    """The same history of puts, deletes, lock and rollback markers in
    both MVCC stores; gc at several safepoints removes the same count
    and keeps the same versions (the newest visible one of each key)."""
    rng = np.random.default_rng(7)
    stores = [RMV.MVCCStore(), PMV.MVCCStore()]
    mods = [RMV, PMV]
    ts = 10
    for step in range(400):
        key = b"k%03d" % int(rng.integers(0, 40))
        op = int(rng.integers(0, 10))
        start, commit = ts, ts + 1
        ts += 2
        for st, mv in zip(stores, mods):
            if op < 6:
                m = mv.Mutation(mv.OP_PUT, key, b"v%d" % step)
            elif op < 8:
                m = mv.Mutation(mv.OP_DEL, key, b"")
            else:
                m = mv.Mutation(mv.OP_LOCK, key, b"")
            st.prewrite([m], key, start, ttl=3000)
            if op == 9:
                st.rollback([key], start)
            else:
                st.commit([key], start, commit)
    for sp in (200, 201, 500, 803, 10_000):
        removed = [st.gc(sp) for st in stores]
        assert removed[0] == removed[1], sp
        views = [_versions(mv, st, b"", b"\xff")
                 for st, mv in zip(stores, mods)]
        assert views[0] == views[1], sp
        for st, mv in zip(stores, mods):
            assert st.get(b"k001", sp) == stores[0].get(b"k001", sp)


def test_maintenance_resolves_expired_locks():
    sides = _sides()
    for side in sides:
        side.q("create table t (a int primary key, b int)")
        side.q("insert into t values (1, 10), (2, 20)")
        info = side.s.catalog.table("test", "t")
        key = side.tc.record_key(info.id, 1)
        from importlib import import_module
        codec = import_module(side.tc.__name__.replace("tablecodec",
                                                       "codec"))
        start = side.st.tso.next_ts()
        side.st.kv.prewrite(
            [side.mv.Mutation(side.mv.OP_PUT, key,
                              codec.encode_key([1, 99]))],
            key, start, ttl=0)
        assert len(side.st.kv.all_locks()) == 1
        assert side.st.maintenance.resolve_expired_locks() == 1
        assert side.st.kv.all_locks() == []
        assert side.st.maintenance.locks_resolved_total == 1
    # the uncommitted write must NOT be visible
    assert _both(sides, "select b from t where a = 1") == [(10,)]
    assert sides[0].versions("t") == sides[1].versions("t")


def test_gc_reclaims_versions_protects_active_snapshots():
    sides = _sides()
    held = {}
    for side in sides:
        side.q("create table g (a int primary key, b int)")
        side.q("insert into g values (1, 0)")
        # hold a snapshot over the first version
        txn = side.st.begin()
        key = side.tc.record_key(side.s.catalog.table("test", "g").id, 1)
        held[side.name] = (txn, key, side.st.kv.get(key, txn.start_ts))
        assert held[side.name][2] is not None
        for i in range(1, 6):
            side.q(f"update g set b = {i} where a = 1")
        side.q("set global tidb_gc_life_time = '0s'")
    removed = [side.st.maintenance.run_gc() for side in sides]
    assert removed[0] == removed[1]
    for side in sides:
        txn, key, v0 = held[side.name]
        # versions newer than the held snapshot are protected; the held
        # snapshot still reads its version
        assert side.st.kv.get(key, txn.start_ts) == v0
    assert sides[0].versions("g") == sides[1].versions("g")
    assert _both(sides, "select b from g where a = 1") == [(5,)]
    for side in sides:
        held[side.name][0].rollback()  # releases the snapshot ts
    removed2 = [side.st.maintenance.run_gc() for side in sides]
    assert removed2[0] == removed2[1]
    assert removed[1] + removed2[1] >= 4
    assert sides[0].versions("g") == sides[1].versions("g")
    assert len(sides[1].versions("g")) == 1
    assert _both(sides, "select b from g where a = 1") == [(5,)]


def test_gc_never_drops_newest_version():
    sides = _sides()
    outs = []
    for side in sides:
        side.q("create table n (a int primary key, b int)")
        side.q("insert into n values (1, 1), (2, 2)")
        side.q("delete from n where a = 2")
        side.q("set global tidb_gc_life_time = '0s'")
        outs.append(side.st.maintenance.tick())
    assert outs[0] == outs[1]
    assert sides[0].versions("n") == sides[1].versions("n")
    assert _both(sides, "select a, b from n order by a") == [(1, 1)]
    # deleted key's tombstone history is fully reclaimable
    for side in sides:
        side.q("insert into n values (2, 22)")
    assert _both(sides, "select b from n where a = 2") == [(22,)]
    assert sides[0].versions("n") == sides[1].versions("n")


def test_auto_analyze_via_maintenance_tick():
    sides = _sides()
    rows = ",".join(f"({i},{i % 7})" for i in range(2000))
    outs = []
    for side in sides:
        side.q("create table aa (a int, b int)")
        side.q(f"insert into aa values {rows}")
        outs.append(side.st.maintenance.tick())
        st = side.st.stats.table_stats(
            side.s.catalog.table("test", "aa").id)
        assert st is not None and st.row_count == 2000
    assert outs[0] == outs[1]
    assert "aa" in outs[1]["auto_analyzed"]
    # the stats lease paces the next pass (performance.stats-lease).
    # The last pass is set one lease back on the monotonic clock: a
    # fresh worker's is 0.0, the clock's own zero (boot on Linux), so
    # without it the paced pass would run only on a host up for more
    # than an hour (test_first_paced_analyze_counts_from_the_clocks_zero)
    for side in sides:
        side.st.maintenance.stats_lease_s = 3600.0
        side.st.maintenance._last_analyze = time.monotonic() - 3600.0
        side.q(f"insert into aa values {rows}")
        assert side.st.maintenance.run_auto_analyze() == ["aa"]
        side.q(f"insert into aa values {rows}")
        assert side.st.maintenance.run_auto_analyze() == []
    assert _both(sides, "select count(*), sum(b) from aa") == \
        [(6000, 17985)]


@pytest.mark.parametrize("clock_s", [828.0, 7200.0],
                         ids=["below the lease", "above the lease"])
def test_first_paced_analyze_counts_from_the_clocks_zero(clock_s,
                                                         monkeypatch):
    """Both packages' workers start with `_last_analyze = 0.0` and pace
    auto-analyze on `time.monotonic()`, which counts from boot: with
    the clock below the stats lease the first paced pass is skipped,
    above it the pass runs (the reference's behaviour, carried)."""
    clock = types.SimpleNamespace(monotonic=lambda: clock_s)
    for mod in (RD, PD):
        monkeypatch.setattr(mod, "time", clock)
    sides = _sides()
    outs = []
    for side in sides:
        side.q("create table fp (a int, b int)")
        side.q("insert into fp values " + ",".join(
            f"({i},{i % 5})" for i in range(1000)))
        side.st.maintenance.stats_lease_s = 3600.0
        outs.append(side.st.maintenance.run_auto_analyze())
    assert outs[0] == outs[1] == ([] if clock_s < 3600.0 else ["fp"])


def test_maintenance_thread_lifecycle():
    for side in _sides():
        worker = side.st.maintenance
        worker.start(interval_s=0.05)
        side.q("create table z (a int primary key, b int)")
        side.q("insert into z values (1, 1)")
        time.sleep(0.2)
        worker.stop()
        assert worker._thread is None
        assert not [t for t in threading.enumerate()
                    if t.name == "titpu-maint" and t.is_alive()]
        assert side.q("select a, b from z") == [(1, 1)]


def test_gc_owner_is_released(tmp_path):
    """The GC owner: a durable store's is an flock on its directory,
    campaigned for by each tick and closed by Storage.close."""
    side = Side("port", str(tmp_path / "p"))
    from tidb_tpu_torch.owner import FileLockOwnerManager

    assert isinstance(side.st.gc_owner, FileLockOwnerManager)
    assert side.st.maintenance.tick()["gc_removed"] == 0
    assert side.st.gc_owner.try_campaign()
    side.st.gc_owner.resign()
    side.st.close()
    reopened = Storage(str(tmp_path / "p"))
    assert reopened.gc_owner.try_campaign()
    reopened.gc_owner.resign()
    reopened.close()


CHILD = """
import sys
pkg, path = sys.argv[1:3]
if pkg == "port":
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import Storage
    new_session = lambda st: Session(st, device="cpu")
else:
    from tidb_tpu.session import Session as new_session
    from tidb_tpu.store.storage import Storage
st = Storage(path, sync_log="commit")
s = new_session(st)
s.execute("create table v (a int primary key, b int)")
s.execute("insert into v values " + ", ".join(
    f"({i}, 0)" for i in range(20)))
for r in range(5):
    s.execute(f"update v set b = {r + 1} where a < 10")
s.execute("set global tidb_gc_life_time = '0s'")
print("UPDATED", flush=True)
st.maintenance.tick()
print("DONE", flush=True)
"""


def test_child_killed_before_gc_loses_nothing(tmp_path):
    """A kill at `daemon/before-gc` (the safepoint taken, no version
    dropped): both reopened stores hold every version; the next tick
    reclaims the same ones on both."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               TIDB_TPU_FAILPOINTS="daemon/before-gc=exit(9)@1")
    opened = []
    for side_name in ("ref", "port"):
        path = str(tmp_path / side_name)
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, side_name, path], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=120)
        lines = proc.stdout.splitlines()
        assert proc.returncode == 9 and "UPDATED" in lines and \
            "DONE" not in lines, (side_name, proc.stderr[-2000:])
        opened.append(Side(side_name, path))
    try:
        before = [side.versions("v") for side in opened]
        assert before[0] == before[1]
        assert sum(len(v) for v in before[1].values()) == 20 + 5 * 10
        outs = [side.st.maintenance.tick() for side in opened]
        assert outs[0] == outs[1] and outs[1]["gc_removed"] == 50
        after = [side.versions("v") for side in opened]
        assert after[0] == after[1]
        assert all(len(v) == 1 for v in after[1].values())
        assert _both(opened, "select sum(b), count(*) from v") == \
            [(50, 20)]
    finally:
        for side in opened:
            side.st.close()


def _failing_tick(error: BaseException):
    calls = []

    def tick():
        calls.append(1)
        raise error
    return tick, calls


def test_wounded_pass_keeps_the_loop():
    """A KV or transaction error is a wounded pass: the loop goes on and
    stop() raises nothing."""
    st = Storage()
    worker = st.maintenance
    tick, calls = _failing_tick(PMV.WriteConflictError(b"k", 1, 2))
    worker.tick = tick
    worker.start(interval_s=0.01)
    deadline = time.monotonic() + 5
    while len(calls) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(calls) >= 3
    worker.stop()
    st.close()


def test_torch_error_in_a_tick_is_raised_by_stop(tmp_path):
    """Any other error ends the loop and is kept: stop() re-raises it,
    and so does Storage.close(), after the store is closed."""
    st = Storage(str(tmp_path / "d"), sync_log="commit")
    Session(st, device="cpu").execute("create table e (a int)")
    worker = st.maintenance
    err = torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
    tick, calls = _failing_tick(err)
    worker.tick = tick
    worker.start(interval_s=0.01)
    deadline = time.monotonic() + 5
    while worker._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(calls) == 1 and not worker._thread.is_alive()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        worker.stop()
    worker.stop()  # raised once, then clean

    worker.start(interval_s=0.01)
    deadline = time.monotonic() + 5
    while worker._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        st.close()
    # the store was closed all the same: its owner lock is free and its
    # directory reopens
    again = Storage(str(tmp_path / "d"))
    assert again.gc_owner.try_campaign()
    again.gc_owner.resign()
    assert Session(again, device="cpu").execute(
        "select count(*) from e").rows == [(0,)]
    again.close()


def test_stop_waits_out_a_slow_tick(tmp_path):
    """A tick still running when the store closes is joined, however long
    it takes, before the close checkpoints; the error it raises after
    stop() was called is re-raised, not lost."""
    st = Storage(str(tmp_path / "d"), sync_log="commit")
    worker = st.maintenance
    started, order = threading.Event(), []

    def slow_tick():
        started.set()
        time.sleep(0.5)
        order.append("tick ended")
        raise RuntimeError("a slow tick failed")

    checkpoint = st.checkpoint

    def recorded_checkpoint(*args, **kw):
        order.append("checkpoint")
        return checkpoint(*args, **kw)

    worker.tick = slow_tick
    st.checkpoint = recorded_checkpoint
    worker.start(interval_s=0.01)
    assert started.wait(5)
    with pytest.raises(RuntimeError, match="a slow tick failed"):
        st.close()
    assert order == ["tick ended", "checkpoint"]
    assert worker._thread is None
    again = Storage(str(tmp_path / "d"))
    assert again.gc_owner.try_campaign()
    again.gc_owner.resign()
    again.close()
