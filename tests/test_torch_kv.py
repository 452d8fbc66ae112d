"""The port's KV layer against the reference's, byte for byte.

* `kv/codec.py` and `kv/tablecodec.py`: the memcomparable encodings of a
  hypothesis corpus (ints at the int64 edges, floats with signed zeros
  and infinities, unicode strings, bytes with every pad length, NULLs),
  the record, index and meta keys, and their decodings, equal bytes.
* `kv/memdb.py`: seeded sequences of set/delete/staging/release/cleanup
  leave the reference's state after every step.
* `kv/mvcc.py`, `kv/region.py`, `kv/twopc.py`: seeded sequences of
  percolator operations (prewrite, commit, rollback, pessimistic locks,
  reads at a ts, scans, lock resolution, range destruction) through
  the 2PC committer and the region tier give the reference's results,
  typed errors and the same three column families, key for key. TSO
  values differ between the two oracles, so both sides run on the same
  hand-fed timestamps.
* `kv/backoff.py`: the same budgets and exhaustion.
"""

import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tidb_tpu.kv import backoff as ref_backoff
from tidb_tpu.kv import codec as ref_codec
from tidb_tpu.kv import memdb as ref_memdb
from tidb_tpu.kv import mvcc as ref_mvcc
from tidb_tpu.kv import region as ref_region
from tidb_tpu.kv import tablecodec as ref_tablecodec
from tidb_tpu.kv import twopc as ref_twopc
from tidb_tpu_torch.kv import backoff, codec, memdb, mvcc, region, tablecodec
from tidb_tpu_torch.kv import twopc
from tidb_tpu_torch.kv.tso import TimestampOracle

INT64 = st.integers(-(1 << 63), (1 << 63) - 1)
VALUE = st.one_of(
    st.none(), INT64, st.booleans(),
    st.floats(allow_nan=False), st.sampled_from([0.0, -0.0]),
    st.text(max_size=40), st.binary(max_size=40))


@settings(max_examples=300, deadline=None)
@given(st.lists(VALUE, max_size=8))
def test_codec_bytes_equal_the_reference(values):
    got = codec.encode_key(values)
    assert got == ref_codec.encode_key(values)
    assert codec.decode_key(got) == ref_codec.decode_key(got)
    for v in values:
        if isinstance(v, int) and not isinstance(v, bool):
            assert codec.encode_uint_desc(v & 0xFFFFFFFFFFFFFFFF) == \
                ref_codec.encode_uint_desc(v & 0xFFFFFFFFFFFFFFFF)


@settings(max_examples=200, deadline=None)
@given(INT64, INT64, st.integers(1, 1 << 40),
       st.lists(st.one_of(st.none(), INT64, st.text(max_size=12)),
                max_size=4),
       st.one_of(st.none(), INT64), st.binary(max_size=20))
def test_tablecodec_keys_equal_the_reference(tid, handle, index_id, vals,
                                             ih, name):
    assert tablecodec.record_key(tid, handle) == \
        ref_tablecodec.record_key(tid, handle)
    assert tablecodec.decode_record_key(
        tablecodec.record_key(tid, handle)) == (tid, handle)
    assert tablecodec.index_key(tid, index_id, vals, ih) == \
        ref_tablecodec.index_key(tid, index_id, vals, ih)
    assert tablecodec.meta_key(name) == ref_tablecodec.meta_key(name)
    for fn in ("table_prefix", "record_prefix", "table_range",
               "record_range"):
        assert getattr(tablecodec, fn)(tid) == \
            getattr(ref_tablecodec, fn)(tid)


def _memdb_state(db, mod):
    return ([(m.key, "T" if m.value is mod.TOMBSTONE else m.value)
             for m in db._log],
            {k: ("T" if v is mod.TOMBSTONE else v)
             for k, v in db.mutations().items()},
            len(db), db.is_empty)


@pytest.mark.parametrize("seed", range(6))
def test_memdb_staging_sequences_match(seed):
    rng = random.Random(seed)
    dbs = [(memdb.MemDB(), memdb), (ref_memdb.MemDB(), ref_memdb)]
    stages = []
    for _ in range(200):
        op = rng.choice(["set", "set", "delete", "stage", "release",
                         "cleanup"])
        key = (rng.randint(1, 3), rng.randint(1, 12))
        val = (rng.randint(0, 99), key[1])
        if op in ("release", "cleanup") and not stages:
            op = "stage"
        for db, mod in dbs:
            if op == "set":
                db.set(key, val)
            elif op == "delete":
                db.delete(key)
        if op == "stage":
            hs = [db.staging() for db, _ in dbs]
            assert hs[0] == hs[1]
            stages.append(hs[0])
        elif op in ("release", "cleanup"):
            h = stages.pop()
            for db, _ in dbs:
                getattr(db, op)(h)
        a, b = (_memdb_state(db, mod) for db, mod in dbs)
        assert a == b
        t = rng.randint(1, 3)
        got = [(h, "T" if v is memdb.TOMBSTONE else v)
               for h, v in dbs[0][0].iter_table(t)]
        want = [(h, "T" if v is ref_memdb.TOMBSTONE else v)
                for h, v in dbs[1][0].iter_table(t)]
        assert got == want


class FedTSO:
    """Timestamps handed out from a shared counter, so that the port and
    the reference run on equal ts values."""

    def __init__(self, start: int = 100 << 18) -> None:
        self.now = start

    def ts(self) -> int:
        self.now += 1
        return self.now

    next_ts = ts

    def current(self) -> int:
        return self.now


def _kv_state(store):
    return [list(sorted(m.items())) for m in store.kv._maps]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the typed error, by class name and message
        return ("err", type(e).__name__, str(e))


class Pair:
    """The same MVCC store, region tier and committer on both sides."""

    def __init__(self) -> None:
        self.sides = []
        for mv, rg, tp in ((mvcc, region, twopc),
                           (ref_mvcc, ref_region, ref_twopc)):
            store = mv.MVCCStore(engine=mv.PyOrderedKV())
            rm = rg.RegionManager(store)
            rm.split(b"t\x80")  # two regions
            tso = FedTSO()
            self.sides.append((mv, rm, tso, tp.TwoPhaseCommitter(
                rm, tso, lock_wait_timeout_s=0.05)))

    def both(self, fn):
        a, b = (_outcome(lambda s=s: fn(*s)) for s in self.sides)
        assert a == b
        assert _kv_state(self.sides[0][1].store) == \
            _kv_state(self.sides[1][1].store)
        return a


KEYS = [b"m" + bytes([i]) for i in range(4)] + \
    [b"t\x80" + bytes([i]) for i in range(4)]


@pytest.mark.parametrize("seed", range(8))
def test_percolator_sequences_match(seed):
    rng = random.Random(seed)
    pair = Pair()
    open_txns = []  # (start_ts, [keys])
    for _ in range(80):
        op = rng.choice(["txn", "txn", "prewrite", "commit", "rollback",
                         "get", "scan", "plock", "prollback", "resolve",
                         "status"])
        ks = rng.sample(KEYS, rng.randint(1, 3))
        now = pair.sides[0][2].now
        for s in pair.sides:
            s[2].now = now
        if op == "txn":
            def run(mv, rm, tso, c, ks=ks, vals=[rng.randint(0, 9)
                                                 for _ in ks]):
                muts = [mv.Mutation(mv.OP_DEL if v == 0 else mv.OP_PUT, k,
                                    bytes([v])) for k, v in zip(ks, vals)]
                return c.commit(muts, tso.ts())
            pair.both(run)
        elif op == "prewrite":
            start = now + 1
            vals = [rng.randint(1, 9) for _ in ks]
            ttl = rng.choice([0, 3000])
            r = pair.both(lambda mv, rm, tso, c: rm.store.prewrite(
                [mv.Mutation(mv.OP_PUT, k, bytes([v]))
                 for k, v in zip(ks, vals)], ks[0], tso.ts(), ttl=ttl))
            if r[0] == "ok":
                open_txns.append((start, ks))
        elif op in ("commit", "rollback") and open_txns:
            start, tks = open_txns.pop(rng.randrange(len(open_txns)))
            if op == "commit":
                pair.both(lambda mv, rm, tso, c: rm.store.commit(
                    tks, start, tso.ts()))
            else:
                pair.both(lambda mv, rm, tso, c: rm.store.rollback(
                    tks, start))
        elif op == "get":
            at = rng.choice([now, now - 3])
            pair.both(lambda mv, rm, tso, c: rm.store.get(ks[0], at))
        elif op == "scan":
            limit = rng.choice([-1, 2])
            pair.both(lambda mv, rm, tso, c: rm.store.scan(
                b"", b"", now, limit=limit))
        elif op == "plock":
            start = now + 1
            ttl = rng.choice([0, 20000])
            r = pair.both(lambda mv, rm, tso, c: rm.store.pessimistic_lock(
                ks, ks[0], tso.ts(), start, ttl=ttl))
            if r[0] == "ok":
                open_txns.append((start, ks))
        elif op == "prollback" and open_txns:
            start, tks = open_txns.pop(rng.randrange(len(open_txns)))
            pair.both(lambda mv, rm, tso, c: rm.store.pessimistic_rollback(
                tks, start))
        elif op == "resolve":
            def res(mv, rm, tso, c):
                locks = rm.store.all_locks()
                tp = twopc if mv is mvcc else ref_twopc
                return [tp.LockResolver(rm, tso).resolve(lk)
                        for lk in locks]
            pair.both(res)
        elif op == "status" and open_txns:
            start, tks = open_txns[0]
            pair.both(lambda mv, rm, tso, c: rm.store.check_txn_status(
                tks[0], start, tso.ts() + (1 << 40)))
    pair.both(lambda mv, rm, tso, c: rm.store.unsafe_destroy_range(
        b"t", b"u"))


def test_lock_resolver_rolls_forward_and_back():
    for mv, rm, tso, c in Pair().sides:
        tp = twopc if mv is mvcc else ref_twopc
        # a committed primary with a secondary left locked: forward
        s1 = tso.ts()
        rm.store.prewrite([mv.Mutation(mv.OP_PUT, b"a", b"1"),
                           mv.Mutation(mv.OP_PUT, b"b", b"2")], b"a", s1)
        rm.store.commit([b"a"], s1, tso.ts())
        [lk] = rm.store.all_locks()
        assert tp.LockResolver(rm, tso).resolve(lk)
        assert rm.store.get(b"b", tso.ts()) == b"2"
        # an abandoned txn whose TTL expired: back
        s2 = tso.ts()
        rm.store.prewrite([mv.Mutation(mv.OP_PUT, b"c", b"3")], b"c", s2,
                          ttl=0)
        tso.now += 1 << 20
        [lk] = rm.store.all_locks()
        assert tp.LockResolver(rm, tso).resolve(lk)
        assert rm.store.get(b"c", tso.ts()) is None
        # a live lock stays: the resolver reports it, the reader waits
        s3 = tso.ts()
        rm.store.prewrite([mv.Mutation(mv.OP_PUT, b"d", b"4")], b"d", s3,
                          ttl=1 << 30)
        [lk] = rm.store.all_locks()
        assert not tp.LockResolver(rm, tso).resolve(lk)
        with pytest.raises(mv.KeyIsLockedError):
            rm.store.get(b"d", tso.ts())
        snap = tp.Snapshot(rm, tso, tso.ts())
        with pytest.raises(tp.CommitError, match="kept hitting locks"):
            snap.get(b"d")
        # a conflicting committer times out with 1205
        with pytest.raises(tp.CommitError) as e:
            c.commit([mv.Mutation(mv.OP_PUT, b"d", b"5")], tso.ts())
        assert e.value.errno == 1205
        # write conflict: a commit newer than the prewriter's start_ts
        old = tso.ts()
        c.commit([mv.Mutation(mv.OP_PUT, b"e", b"6")], tso.ts())
        with pytest.raises(mv.WriteConflictError):
            c.commit([mv.Mutation(mv.OP_PUT, b"e", b"7")], old)


def test_region_split_and_group_by_region():
    for rg, mv in ((region, mvcc), (ref_region, ref_mvcc)):
        rm = rg.RegionManager(mv.MVCCStore())
        rm.split(b"k")
        rm.split(b"t")
        groups = rg.group_by_region(rm, [b"a", b"k1", b"z", b"b"])
        assert [(r.start_key, r.end_key, ks)
                for r, ks in groups.values()] == [
            (b"", b"k", [b"a", b"b"]), (b"k", b"t", [b"k1"]),
            (b"t", b"", [b"z"])]
        r = rm.locate(b"k1")
        rm.split(b"m")
        with pytest.raises(rg.RegionError):
            rm.check_context(r.id, r.epoch, [b"k1"])


def test_timestamp_oracle_is_monotonic_and_observes():
    tso = TimestampOracle(floor=5 << 18)
    seen = [tso.next_ts() for _ in range(1000)]
    assert seen == sorted(set(seen)) and seen[0] > 5 << 18
    tso.observe(seen[-1] + (1 << 30))
    assert tso.ts() > seen[-1] + (1 << 30)
    assert tso.current() >= seen[-1]


def test_backoff_budget_matches_the_reference():
    for mod in (backoff, ref_backoff):
        bo = mod.Backoffer(budget_ms=5)
        with pytest.raises(mod.BackoffExhausted) as e:
            for _ in range(100):
                bo.sleep(mod.BO_TXN_CONFLICT)
        assert e.value.errno == 9001
        assert "txnConflictx" in str(e.value)
        bo = mod.Backoffer(budget_ms=10)
        bo.charge(mod.BO_TXN_LOCK, 0.004)
        with pytest.raises(mod.BackoffExhausted):
            bo.charge(mod.BO_TXN_LOCK, 0.007)
