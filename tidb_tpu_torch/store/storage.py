"""Storage: the tables of one process, read-only over bulk-loaded epochs.

The read half of the reference's `tidb_tpu/store/storage.py`: the catalog,
one `TableStore` per table (`register_table`, `table_store`), the
statistics handle, the global system variables, and transactions that
read (`begin`, `Transaction.snapshot`). A snapshot is the table's base
epoch with every row visible: bulk loads are the only writes, and they
bypass transactions as the reference's loader does. The write path
(the KV layer, deltas, the fold, 2PC, persistence, raft, group commit and
shared storage) is a later slice: a transaction's writes raise
`NotInSlice("writes")`.
"""

from __future__ import annotations

import itertools

from ..catalog.schema import Catalog, TableInfo
from ..errors import NotInSlice
from ..stats.handle import StatsHandle
from .table_store import TableSnapshot, TableStore


class Storage:
    def __init__(self) -> None:
        from ..session.sysvars import SysVarManager

        self.catalog = Catalog()
        self.tables: dict[int, TableStore] = {}
        self.stats = StatsHandle()
        self.sysvars = SysVarManager(self)
        # start timestamps: monotonic, one per transaction (the
        # reference's TSO); every snapshot reads the bulk-loaded epoch
        self._ts = itertools.count(1)

    def register_table(self, info: TableInfo) -> TableStore:
        if getattr(info, "partition", None) is not None:
            raise NotInSlice("partitioned table")
        store = TableStore(info)
        self.tables[info.id] = store
        return store

    def unregister_table(self, table_id: int) -> None:
        self.tables.pop(table_id, None)

    def table_store(self, table_id: int) -> TableStore:
        return self.tables[table_id]

    def begin(self) -> "Transaction":
        return Transaction(self, next(self._ts))

    # ---- meta keyspace (global sysvars persist here in the reference) ----
    def get_meta(self, name: bytes):
        return None  # nothing is persisted

    def put_meta(self, name: bytes, value: bytes) -> None:
        raise NotInSlice("writes")


class Transaction:
    """A read-only snapshot transaction."""

    def __init__(self, storage: Storage, start_ts: int) -> None:
        self.storage = storage
        self.start_ts = start_ts
        self._finished = False

    def set_row(self, table_id: int, handle: int, row: tuple) -> None:
        raise NotInSlice("writes")

    def delete_row(self, table_id: int, handle: int) -> None:
        raise NotInSlice("writes")

    def snapshot(self, table_id: int) -> TableSnapshot:
        """Every row of the table's bulk-loaded epoch."""
        return self.storage.table_store(table_id).snapshot()

    def commit(self) -> int:
        """Ends the transaction; it holds no writes to commit."""
        assert not self._finished, "transaction already finished"
        self._finished = True
        return self.start_ts

    def rollback(self) -> None:
        self._finished = True
