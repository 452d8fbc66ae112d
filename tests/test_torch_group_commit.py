"""The port's group commit against the reference's: the SyncPolicy
rendezvous, the storage-level amortization and the sync-log=commit
contract (the cases of tests/test_group_commit.py).

Every assertion is on counts, never on wall time: each injected fsync
blocks until the committers it should cover are waiting (or a generous
timeout passes), so the batches do not depend on how busy the machine is.
The same script runs through both packages' SyncPolicy and must give the
same fsync counts and batches.
"""

import threading
import time

import pytest

from tidb_tpu.kv.mvcc import SyncPolicy as RefSyncPolicy
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch.kv.mvcc import SyncPolicy
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

POLICIES = {"port": SyncPolicy, "reference": RefSyncPolicy}


def _group_policy(cls, fsync):
    sp = cls("commit", 100, fsync)
    sp.defer_commit = True
    return sp


def _wait_for(cond, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.001)


def _rendezvous(cls) -> tuple[int, list]:
    """32 committers; the first fsync holds until the other 31 wait on
    it, so they share the next one: 2 fsyncs, batches [1, 31]."""
    calls = []
    sp = None
    entered = threading.Event()

    def fsync():
        if not calls:
            entered.set()
            _wait_for(lambda: sp._waiters == 31)
        calls.append(1)

    sp = _group_policy(cls, fsync)
    batches = []
    sp.on_batch = batches.append

    def commit(i: int) -> None:
        if i:
            entered.wait()  # the leader's fsync has started
        sp.mark_dirty()
        sp.commit_sync()

    threads = [threading.Thread(target=commit, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return len(calls), sorted(batches)


@pytest.mark.parametrize("pkg", sorted(POLICIES))
def test_rendezvous_amortizes_concurrent_commits(pkg):
    assert _rendezvous(POLICIES[pkg]) == (2, [1, 31])


def test_rendezvous_port_equals_reference():
    assert _rendezvous(SyncPolicy) == _rendezvous(RefSyncPolicy)


@pytest.mark.parametrize("pkg", sorted(POLICIES))
def test_boundary_defers_but_commit_sync_is_required(pkg):
    calls = []
    sp = _group_policy(POLICIES[pkg], lambda: calls.append(1))
    sp.mark_dirty()
    sp.boundary()          # deferred: no fsync inside the section
    assert calls == []
    sp.commit_sync()       # the ack path pays it
    assert calls == [1]
    sp.commit_sync()       # already covered: no second fsync
    assert calls == [1]


@pytest.mark.parametrize("pkg", sorted(POLICIES))
def test_non_deferred_commit_policy_unchanged(pkg):
    """A bare SyncPolicy (defer_commit False) fsyncs at every boundary."""
    calls = []
    sp = POLICIES[pkg]("commit", 100, lambda: calls.append(1))
    sp.mark_dirty()
    sp.boundary()
    assert calls == [1]
    sp.commit_sync()  # boundary already covered this write generation
    assert calls == [1]


def _flaky(cls) -> tuple[int, int]:
    """4 committers; the first fsync waits until the other 3 are
    stranded behind it, then fails: its leader alone sees the error, and
    one stranded waiter's retry covers the other two."""
    ok_calls = []
    failed = []
    sp = None
    entered = threading.Event()

    def flaky():
        if not failed:
            entered.set()
            _wait_for(lambda: sp._waiters == 3)
            failed.append(1)
            raise OSError("disk gone")
        ok_calls.append(1)

    sp = _group_policy(cls, flaky)
    errs = []

    def commit(i: int) -> None:
        if i:
            entered.wait()  # the leader's fsync has started
        sp.mark_dirty()
        try:
            sp.commit_sync()
        except OSError as e:
            errs.append(e)

    threads = [threading.Thread(target=commit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sp.mark_dirty()
    sp.commit_sync()  # and the policy stays usable
    return len(errs), len(ok_calls)


@pytest.mark.parametrize("pkg", sorted(POLICIES))
def test_fsync_failure_propagates_and_stranded_waiters_retry(pkg):
    # one retry fsync for the 3 stranded waiters, one for the last commit
    assert _flaky(POLICIES[pkg]) == (1, 2)


@pytest.mark.parametrize("pkg", sorted(POLICIES))
def test_leader_gather_window_and_max_batch(pkg, monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    calls = []
    sp = _group_policy(POLICIES[pkg], lambda: calls.append(1))
    sp.group_max_wait_us = 20000
    sp.group_max_batch = 2
    sp.mark_dirty()
    sp.commit_sync()          # alone, below max-batch: it gathers
    assert slept == [0.02] and calls == [1]
    sp.group_max_batch = 1    # max-batch aboard already: no gather
    sp.mark_dirty()
    sp.commit_sync()
    assert slept == [0.02] and calls == [1, 1]


@pytest.mark.parametrize("pkg", sorted(POLICIES))
def test_interval_policy_covers_tail_burst(pkg):
    """interval mode: the first boundary syncs, one inside the window
    defers to the one-shot flush timer, which then syncs."""
    synced = []
    sp = POLICIES[pkg]("interval", 50, lambda: synced.append(1))
    try:
        sp.mark_dirty()
        sp.boundary()
        assert len(synced) == 1
        sp.mark_dirty()
        sp.boundary()
        assert len(synced) == 1
        _wait_for(lambda: len(synced) == 2)
        assert len(synced) == 2, "tail burst never flushed"
    finally:
        sp.close()


# ---------------------------------------------------------------------------
# storage level, through both packages
# ---------------------------------------------------------------------------

def _open(pkg: str, path, **kw):
    if pkg == "port":
        st = Storage(str(path), **kw)
        return st, lambda: Session(st, device="cpu")
    st = RefStorage(str(path), **kw)
    return st, lambda: RefSession(st)


def _gated_fsync(st, calls: list, want_waiters: int = 1,
                 timeout: float = 0.5) -> None:
    """Count the engine's WAL fsyncs; each one first waits (up to
    `timeout`) until `want_waiters` other committers wait on it."""
    syncer = st.kv.kv._syncer
    inner = syncer._fsync

    def gated():
        _wait_for(lambda: syncer._waiters >= want_waiters, timeout)
        calls.append(1)
        inner()

    syncer._fsync = gated


def _concurrent_updates(new_session, n_threads: int, per: int,
                        ids: int) -> None:
    errs = []

    def work(wi: int) -> None:
        try:
            s = new_session()
            for j in range(per):
                s.execute(f"update g set v = v + 1 "
                          f"where id = {(wi * per + j) % ids}")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_concurrent_commits_share_fsyncs(tmp_path, pkg):
    st, new_session = _open(pkg, tmp_path / "db", sync_log="commit")
    s0 = new_session()
    s0.execute("create table g (id bigint primary key, v bigint)")
    for i in range(48):
        s0.execute(f"insert into g values ({i}, 0)")
    calls = []
    _gated_fsync(st, calls)
    _, sum0, n0 = st.obs.group_commit_batch.snapshot()
    _concurrent_updates(new_session, 8, 6, 48)
    commits = 48
    assert len(calls) < commits, \
        f"{commits} durable commits cost {len(calls)} fsyncs"
    _, sum1, n1 = st.obs.group_commit_batch.snapshot()
    assert sum1 - sum0 >= commits  # every commit counted into a batch
    assert n1 - n0 <= len(calls)
    assert new_session().query("select sum(v) from g")[0][0] == commits
    st.close()


def test_durability_parity_after_crash(tmp_path):
    """Every acknowledged commit survives a process crash (the engine
    closed without a checkpoint), in both packages, with equal rows."""
    got = {}
    for pkg in ("port", "reference"):
        st, new_session = _open(pkg, tmp_path / pkg, sync_log="commit")
        s = new_session()
        s.execute("create table d (id bigint primary key, v bigint)")
        for i in range(20):
            s.execute(f"insert into d values ({i}, {i})")
        st.kv.kv.close()
        st2, new_session = _open(pkg, tmp_path / pkg)
        got[pkg] = new_session().query("select id, v from d order by id")
        st2.close()
    assert got["port"] == got["reference"] == [(i, i) for i in range(20)]


def test_group_commit_knobs(tmp_path):
    st = Storage(str(tmp_path / "db"), sync_log="commit")
    st.configure_group_commit(max_batch=16, max_wait_us=500)
    syncer = st.kv.kv._syncer
    assert syncer.group_max_batch == 16
    assert syncer.group_max_wait_us == 500
    st.configure_group_commit(max_batch=0, max_wait_us=-5)
    assert (syncer.group_max_batch, syncer.group_max_wait_us) == (1, 0)
    st._note_group_commit(4)
    st._note_group_commit(300)
    counts, total, n = st.obs.group_commit_batch.snapshot()
    assert (total, n) == (304.0, 2)
    assert counts[2] == 1 and counts[-1] == 1  # bucket "<= 4", past 256
    assert st.obs.group_commit_batch.name == "tidb_group_commit_batch_size"
    st.close()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_off_mode_never_fsyncs_at_commit(tmp_path, pkg):
    st, new_session = _open(pkg, tmp_path / "db", sync_log="off")
    calls = []
    _gated_fsync(st, calls, want_waiters=0)
    s = new_session()
    s.execute("create table o (id bigint primary key)")
    for i in range(5):
        s.execute(f"insert into o values ({i})")
    assert calls == []
    st.close()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_amortization_factor_grows_with_writers(tmp_path, pkg):
    """The commits-per-fsync factor: exactly 1 for one writer, above 1.3
    at 8 writers (each fsync waits for a second committer to join)."""
    st, new_session = _open(pkg, tmp_path / "db", sync_log="commit")
    s0 = new_session()
    s0.execute("create table g (id bigint primary key, v bigint)")
    for i in range(128):
        s0.execute(f"insert into g values ({i}, 0)")
    calls = []

    def factor(conc: int, per: int = 8) -> float:
        _, sum0, n0 = st.obs.group_commit_batch.snapshot()
        _concurrent_updates(new_session, conc, per, 128)
        _, sum1, n1 = st.obs.group_commit_batch.snapshot()
        return (sum1 - sum0) / max(n1 - n0, 1)

    assert factor(1) == 1.0
    _gated_fsync(st, calls, want_waiters=1)
    f8 = factor(8)
    assert f8 > 1.3, f"no fsync amortization at 8 writers ({f8:.2f})"
    st.close()
