"""Transaction staging buffer with statement-level staging/rollback.

Counterpart of the reference's red-black-tree arena memdb (reference:
kv/memdb.go — `Staging()`, `Release()`, `Cleanup()` checkpoints used by
session/txn.go:52-87 for per-statement rollback). TPU-first difference:
keys are logical `(table_id, handle)` pairs and values are row tuples, not
byte-encoded KV — the columnar store consumes mutations directly; the
byte-level codec lives only at the (later) persistence boundary.

Port of `tidb_tpu/kv/memdb.py`, whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Optional


class _Tombstone:
    __slots__ = ()

    def __repr__(self) -> str:
        return "TOMBSTONE"


TOMBSTONE = _Tombstone()

Key = tuple[int, int]  # (table_id, handle)


@dataclass
class Mutation:
    key: Key
    # row values tuple (physical encoding per column), or TOMBSTONE
    value: Any


class MemDB:
    """Ordered-by-insertion mutation buffer with nested staging points.

    Supports: Set/Delete/Get, snapshot-merged iteration (union with the
    store happens in the union reader, not here), staging handles for
    statement rollback, and flush-to-commit draining.
    """

    def __init__(self) -> None:
        # full history of (key, value) writes, append-only; staging rollback
        # truncates the log and rebuilds the index
        self._log: list[Mutation] = []
        self._index: dict[Key, Any] = {}
        self._stages: list[int] = []

    def __len__(self) -> int:
        return len(self._index)

    @property
    def is_empty(self) -> bool:
        return not self._index

    # ---- writes ------------------------------------------------------------
    def set(self, key: Key, value: Any) -> None:
        self._log.append(Mutation(key, value))
        self._index[key] = value

    def delete(self, key: Key) -> None:
        self.set(key, TOMBSTONE)

    # ---- reads -------------------------------------------------------------
    def get(self, key: Key) -> Optional[Any]:
        """Latest staged value: row tuple, TOMBSTONE, or None (not buffered)."""
        return self._index.get(key)

    def iter_table(self, table_id: int) -> Iterator[tuple[int, Any]]:
        """(handle, value) for all buffered mutations of one table."""
        for (tid, handle), value in self._index.items():
            if tid == table_id:
                yield handle, value

    # ---- staging (statement rollback) --------------------------------------
    def staging(self) -> int:
        """Open a staging point; returns a handle for release/cleanup.
        Mirrors kv/memdb.go Staging()."""
        self._stages.append(len(self._log))
        return len(self._stages)

    def release(self, handle: int) -> None:
        """Commit the staging buffer into the parent (keep writes)."""
        assert handle == len(self._stages), "staging handles must nest"
        self._stages.pop()

    def cleanup(self, handle: int) -> None:
        """Discard all writes since the staging point (statement rollback)."""
        assert handle == len(self._stages), "staging handles must nest"
        mark = self._stages.pop()
        if mark >= len(self._log):
            return
        del self._log[mark:]
        self._index = {}
        for m in self._log:
            self._index[m.key] = m.value

    # ---- commit drain ------------------------------------------------------
    def mutations(self) -> dict[Key, Any]:
        """Final state of every touched key (last write wins)."""
        return dict(self._index)
