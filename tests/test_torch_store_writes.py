"""The port's transactional Storage and TableStore against the reference.

The cases of `tests/test_store.py` (`TestMVCC`), each run on a reference
`Storage()` and a port `Storage()` with the same calls: read-your-writes,
snapshot isolation, an update that overrides a base row, delete, the
optimistic write conflict, compaction that keeps visibility, and
compaction that respects an active snapshot. Each case checks what the
reference's test checks, on both sides, and then that the two stores are
equal: the epoch (handles, columns, valids), the dictionaries, and the
deltas as (handle, row) in commit order. Commit timestamps differ between
the two processes' oracles, so only their order is compared.
"""

import numpy as np
import pytest

from tidb_tpu.catalog import ColumnInfo as RefColumnInfo
from tidb_tpu.catalog import TableInfo as RefTableInfo
from tidb_tpu.kv import TOMBSTONE as REF_TOMBSTONE
from tidb_tpu.store import Storage as RefStorage
from tidb_tpu.store import WriteConflictError as RefWriteConflictError
from tidb_tpu.types import bigint_type as ref_bigint
from tidb_tpu.types import decimal_type as ref_decimal
from tidb_tpu.types import varchar_type as ref_varchar
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.catalog.schema import ColumnInfo, TableInfo
from tidb_tpu_torch.kv import TOMBSTONE
from tidb_tpu_torch.store.storage import Storage, WriteConflictError
from tidb_tpu_torch.types import bigint_type, decimal_type, varchar_type

SIDES = {
    "port": (Storage, ColumnInfo, TableInfo, bigint_type, varchar_type,
             decimal_type, WriteConflictError),
    "ref": (RefStorage, RefColumnInfo, RefTableInfo, ref_bigint,
            ref_varchar, ref_decimal, RefWriteConflictError),
}


def _row(row):
    if row is TOMBSTONE or row is REF_TOMBSTONE:
        return "TOMBSTONE"
    return tuple(None if v is None else int(v) if isinstance(
        v, (int, np.integer)) else v for v in row)


def store_state(store) -> dict:
    """A TableStore of either package as plain values: its epoch, its
    dictionaries, and its deltas as (handle, row) with the commit
    timestamps replaced by their rank."""
    ep = store.epoch
    ranks = {ts: i for i, ts in enumerate(sorted({d[0]
                                                  for d in store.deltas}))}
    return {
        "handles": ep.handles.tolist(),
        "fold_ts_set": ep.fold_ts > 0,
        "columns": [c.tolist() for c in ep.columns],
        "dtypes": [str(c.dtype) for c in ep.columns],
        "valids": [None if v is None else v.tolist() for v in ep.valids],
        "dicts": [None if d is None else list(d.values)
                  for d in store.dictionaries],
        "deltas": [(ranks[ts], h, _row(r)) for ts, h, r in store.deltas],
        "next_handle": store._next_handle,
        "modify_count": store.modify_count,
    }


class Side:
    def __init__(self, name: str) -> None:
        (self.Storage, self.ColumnInfo, self.TableInfo, self.bigint,
         self.varchar, self.decimal, self.Conflict) = SIDES[name]
        self.storage = self.Storage()

    def make_table(self, name="t"):
        cat = self.storage.catalog
        info = self.TableInfo(
            id=cat.alloc_id(), name=name,
            columns=[
                self.ColumnInfo(cat.alloc_id(), "a", self.bigint(), 0),
                self.ColumnInfo(cat.alloc_id(), "b", self.varchar(), 1),
                self.ColumnInfo(cat.alloc_id(), "c", self.decimal(10, 2), 2),
            ])
        cat.add_table("test", info)
        self.storage.register_table(info)
        return info

    def insert_rows(self, info, rows):
        store = self.storage.table_store(info.id)
        txn = self.storage.begin()
        for r in rows:
            h = store.alloc_handle()
            txn.set_row(info.id, h, store.encode_row(list(r)))
        return txn.commit()


def _both(case):
    """Run `case(side)` on both packages; -> the two store states."""
    states = []
    for name in ("port", "ref"):
        side = Side(name)
        info = case(side)
        states.append(store_state(side.storage.table_store(info.id)))
    assert states[0] == states[1]
    return states[0]


def _visible(snap):
    return [c.to_pylist() for c in (snap.column(i) for i in range(3))]


def test_insert_then_read():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(1, "x", "1.50"), (2, "y", None)])
        txn = s.storage.begin()
        snap = txn.snapshot(info.id)
        assert snap.num_visible_rows == 2
        assert sorted(snap.column(0).to_pylist()) == [1, 2]
        assert snap.column(2).to_pylist()[1] is None
        txn.rollback()
        return info
    assert len(_both(case)["deltas"]) == 2


def test_snapshot_isolation():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(1, "x", "1.00")])
        reader = s.storage.begin()
        s.insert_rows(info, [(2, "y", "2.00")])
        assert reader.snapshot(info.id).num_visible_rows == 1
        late = s.storage.begin()
        assert late.snapshot(info.id).num_visible_rows == 2
        reader.rollback()
        late.rollback()
        return info
    _both(case)


def test_read_your_writes():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(1, "x", "1.00")])
        store = s.storage.table_store(info.id)
        txn = s.storage.begin()
        h = store.alloc_handle()
        txn.set_row(info.id, h, store.encode_row([2, "mine", "9.99"]))
        snap = txn.snapshot(info.id)
        assert snap.num_visible_rows == 2
        assert _visible(snap)[1] == ["x", "mine"]
        other = s.storage.begin()
        assert other.snapshot(info.id).num_visible_rows == 1
        txn.commit()
        other.rollback()
        return info
    assert _both(case)["dicts"][1] == ["x", "mine"]


def test_update_overrides_base_row():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(1, "x", "1.00")])
        s.storage.flush()  # row now lives in the base epoch
        store = s.storage.table_store(info.id)
        t0 = s.storage.begin()
        handle = int(t0.snapshot(info.id).handles()[0])
        t0.rollback()
        txn = s.storage.begin()
        txn.set_row(info.id, handle,
                    store.encode_row([1, "updated", "2.00"]))
        txn.commit()
        t1 = s.storage.begin()
        snap = t1.snapshot(info.id)
        assert snap.num_visible_rows == 1
        assert snap.column(1).to_pylist() == ["updated"]
        assert not snap.base_visible[0]
        t1.rollback()
        return info
    st = _both(case)
    assert st["handles"] == [1] and len(st["deltas"]) == 1


def test_delete_row():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(1, "x", "1.00"), (2, "y", "2.00")])
        t0 = s.storage.begin()
        handles = t0.snapshot(info.id).handles()
        t0.rollback()
        txn = s.storage.begin()
        txn.delete_row(info.id, int(handles[0]))
        txn.commit()
        t1 = s.storage.begin()
        assert t1.snapshot(info.id).num_visible_rows == 1
        t1.rollback()
        return info
    assert _both(case)["deltas"][-1][2] == "TOMBSTONE"


def test_write_conflict():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(1, "x", "1.00")])
        t0 = s.storage.begin()
        handle = int(t0.snapshot(info.id).handles()[0])
        t0.rollback()
        a = s.storage.begin()
        b = s.storage.begin()
        store = s.storage.table_store(info.id)
        a.set_row(info.id, handle, store.encode_row([1, "a", "1.00"]))
        b.set_row(info.id, handle, store.encode_row([1, "b", "1.00"]))
        a.commit()
        with pytest.raises(s.Conflict) as e:
            b.commit()
        assert e.value.errno == 9007
        return info
    _both(case)


def test_compaction_preserves_visibility():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(i, f"s{i % 5}", f"{i}.00")
                             for i in range(100)])
        s.storage.flush()
        epoch1 = s.storage.table_store(info.id).epoch
        assert epoch1.num_rows == 100
        s.insert_rows(info, [(100, "new", "0.50")])
        txn = s.storage.begin()
        snap = txn.snapshot(info.id)
        assert snap.num_visible_rows == 101
        assert snap.epoch.epoch_id == epoch1.epoch_id  # overlay, not refold
        txn.rollback()
        s.storage.flush()
        assert s.storage.table_store(info.id).epoch.num_rows == 101
        return info
    st = _both(case)
    assert st["deltas"] == [] and st["handles"] == list(range(1, 102))


def test_compaction_respects_active_snapshot():
    def case(s):
        info = s.make_table()
        s.insert_rows(info, [(1, "x", "1.00")])
        reader = s.storage.begin()
        s.insert_rows(info, [(2, "y", "2.00")])
        s.storage.flush()  # must NOT fold row 2 past reader's snapshot
        assert s.storage.table_store(info.id).epoch.num_rows == 1
        assert reader.snapshot(info.id).num_visible_rows == 1
        reader.rollback()
        s.storage.flush()
        assert s.storage.table_store(info.id).epoch.num_rows == 2
        return info
    _both(case)


@pytest.mark.parametrize("seed", range(4))
def test_threshold_compaction_on_commit(seed):
    """Commits past COMPACT_THRESHOLD deltas fold at min(safe_ts,
    commit_ts - 1): updates, deletes and inserts over a bulk-loaded base
    leave equal epochs and equal tails of deltas."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1000, 300)
    ops = [(int(rng.integers(0, 3)), int(rng.integers(1, 360)),
            int(rng.integers(0, 50))) for _ in range(400)]

    def case(s):
        info = s.make_table()
        store = s.storage.table_store(info.id)
        store.COMPACT_THRESHOLD = 64
        d = store.dictionaries[1]
        store.bulk_load([base, np.array([d.encode(f"v{v % 7}")
                                         for v in base], np.int64),
                         base * 100],
                        [None, None, base % 11 != 0])
        reader = None
        for i, (kind, h, v) in enumerate(ops):
            txn = s.storage.begin()
            if kind == 0:
                txn.set_row(info.id, h, store.encode_row(
                    [v, f"u{v}", f"{v}.25"]))
            elif kind == 1:
                txn.delete_row(info.id, h)
            else:
                store.note_handle(h)
                txn.set_row(info.id, store.alloc_handle(),
                            store.encode_row([v, None, None]))
            txn.commit()
            if i == 150:
                reader = s.storage.begin()  # pins the safepoint
            if i == 250:
                reader.rollback()
        txn = s.storage.begin()
        snap = txn.snapshot(info.id)
        out = sorted(TR.sql_cells(zip(snap.handles().tolist(),
                                      *_visible(snap))), key=repr)
        txn.rollback()
        s.visible = out
        return info

    states, seen = [], []
    for name in ("port", "ref"):
        side = Side(name)
        info = case(side)
        states.append(store_state(side.storage.table_store(info.id)))
        seen.append(side.visible)
    assert states[0] == states[1]
    assert seen[0] == seen[1]
    assert 0 < len(states[0]["deltas"]) < 64 + 1
    assert states[0]["fold_ts_set"]
