"""Memory quota tracking + chunk spill for host operators.

Counterpart of the reference's memory governance (reference:
util/memory/tracker.go:42 hierarchical trackers with per-query quota;
action.go:28 pluggable on-exceed actions; util/chunk/row_container.go:63
disk-backed row container + :493 SortAndSpillDiskAction).

Design for the materialized host engine: operators are chunk-at-a-time,
so the tracker's job is (a) accounting the working set an operator is
about to materialize and (b) letting the operator pick a partitioned
on-disk strategy *before* allocating it. The quota bounds per-operator
transient working sets (hash tables, sort keys, join pair expansion) —
the final result chunk still materializes, exactly as the reference
materializes the outgoing wire chunks.

Actions on exceed (sysvar tidb_mem_oom_action):
  SPILL  — operators that can partition (hash join, hash agg, sort)
           switch to on-disk runs; others raise.
  CANCEL — raise QueryMemExceeded (errno 8175, "Out Of Memory Quota!").
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Iterator, Optional


class QueryMemExceeded(Exception):
    """Raised when a query's working set exceeds tidb_mem_quota_query and
    the operator cannot (or may not) spill."""

    errno = 8175  # ER_QUERY_MEM_EXCEEDED
    sqlstate = "HY000"

    def __init__(self, label: str, need: int, quota: int) -> None:
        super().__init__(
            f"Out Of Memory Quota![conn] operator {label} needs {need} "
            f"bytes, quota {quota} bytes")


class MemTracker:
    """Hierarchical byte tracker with a quota at the root.

    consume/release propagate to the parent; peak is recorded at every
    level. Quota is checked at the root (the per-query tracker); the
    reference attaches the quota the same way (tracker.go:42, one
    per-query root with operator children).
    """

    __slots__ = ("label", "quota", "parent", "consumed", "peak",
                 "action", "spill_count", "governor", "_gov_next",
                 "ledger", "ledger_peak")

    def __init__(self, label: str = "query", quota: int = 0,
                 parent: Optional["MemTracker"] = None,
                 action: str = "SPILL") -> None:
        self.label = label
        self.quota = quota  # 0 = unlimited
        self.parent = parent
        self.consumed = 0
        self.peak = 0
        self.action = action
        self.spill_count = 0
        # server-wide ledger hook: the governor sets itself on the ROOT
        # tracker at statement registration; consume()/account() then
        # re-evaluate server memory pressure every GOV_POLL_BYTES of
        # root growth (util/governor.py), so the kill policy runs
        # exactly where memory is being acquired, with no background
        # thread
        self.governor = None
        self._gov_next = 0
        # materialization ledger (ROOT only): working-set estimates the
        # operators admitted in memory (engine._overflow's fits-branch).
        # Kept SEPARATE from `consumed` so the per-operator quota/spill
        # decisions are untouched — this meter exists for the governor's
        # heaviest-statement choice and the MEM_MAX forensics columns.
        # ledger_peak is the COMBINED (consumed + ledger) high-water,
        # maintained by both consume() and account(): mem_max must never
        # report below the footprint the governor killed at.
        self.ledger = 0
        self.ledger_peak = 0

    def child(self, label: str) -> "MemTracker":
        return MemTracker(label, 0, self, self.action)

    def consume(self, n: int) -> None:
        t: MemTracker = self
        while True:
            t.consumed += n
            if t.consumed > t.peak:
                t.peak = t.consumed
            if t.parent is None:
                break
            t = t.parent
        combined = t.consumed + t.ledger
        if combined > t.ledger_peak:
            t.ledger_peak = combined
        g = t.governor
        if g is not None and combined >= t._gov_next:
            from .governor import GOV_POLL_BYTES
            t._gov_next = combined + GOV_POLL_BYTES
            g.check()

    def account(self, n: int) -> None:
        """Record `n` bytes of in-memory materialization on the ROOT's
        ledger (no quota effect — see the ledger comment above) and
        poll the governor at the same cadence as consume()."""
        root = self._root()
        root.ledger += n
        combined = root.consumed + root.ledger
        if combined > root.ledger_peak:
            root.ledger_peak = combined
        g = root.governor
        if g is not None and combined >= root._gov_next:
            from .governor import GOV_POLL_BYTES
            root._gov_next = combined + GOV_POLL_BYTES
            g.check()

    def footprint(self) -> int:
        """Best live working-set estimate of this statement: tracked
        transient consumption plus the materialization ledger (what the
        governor ranks statements by)."""
        root = self._root()
        return max(root.consumed, 0) + max(root.ledger, 0)

    def peak_footprint(self) -> int:
        """High-water of the combined footprint — what mem_max columns
        report, and by construction >= any footprint() the governor
        ever ranked this statement at."""
        root = self._root()
        return max(root.peak, root.ledger_peak)

    def release(self, n: int) -> None:
        self.consume(-n)

    def _root(self) -> "MemTracker":
        t = self
        while t.parent is not None:
            t = t.parent
        return t

    def available(self) -> int:
        """Bytes left under the root quota (a large number if unlimited)."""
        root = self._root()
        if root.quota <= 0:
            return 1 << 62
        return root.quota - root.consumed

    def over_budget(self, extra: int) -> bool:
        """Would consuming `extra` more bytes exceed the root quota?"""
        return extra > self.available()

    def check(self, extra: int, label: str) -> None:
        """Raise when `extra` cannot fit and the action is CANCEL."""
        if self.over_budget(extra) and self._root().action == "CANCEL":
            root = self._root()
            raise QueryMemExceeded(label, root.consumed + extra, root.quota)

    def note_spill(self) -> None:
        t: Optional[MemTracker] = self
        while t is not None:
            t.spill_count += 1
            t = t.parent


class SpillFile:
    """One spilled chunk partition on disk (pickle of Column buffers).

    Counterpart of the reference's ListInDisk chunk file
    (util/chunk/disk.go). String dictionaries are NOT serialized: they
    are shared table state already resident (the store holds them), so
    the file keeps only the int32 codes and the dictionary objects ride
    along in memory by reference — read() reattaches them, which also
    means Chunk.concat over partitions does no code remapping.
    """

    __slots__ = ("path", "rows", "nbytes", "_dicts")

    def __init__(self, path: str) -> None:
        self.path = path
        self.rows = 0
        self.nbytes = 0
        self._dicts: list = []

    def write(self, chunk) -> None:
        from ..chunk.chunk import Chunk
        from ..chunk.column import Column

        self.rows = chunk.num_rows
        self.nbytes = chunk.nbytes
        self._dicts = [c.dictionary for c in chunk.columns]
        stripped = Chunk([Column(c.ftype, c.data, c.valid, None)
                          for c in chunk.columns])
        with open(self.path, "wb") as f:
            pickle.dump(stripped, f, protocol=pickle.HIGHEST_PROTOCOL)

    def read(self):
        with open(self.path, "rb") as f:
            chunk = pickle.load(f)
        for c, d in zip(chunk.columns, self._dicts):
            c.dictionary = d
        return chunk


class SpillDir:
    """Temp directory owning a query's spill files; removed on close.

    The reference scopes spill files to a per-query temp dir under
    tmp-storage-path (util/disk/tempDir.go); same lifecycle here.
    """

    def __init__(self) -> None:
        self._dir: Optional[tempfile.TemporaryDirectory] = None
        self._seq = 0

    def new_file(self) -> SpillFile:
        if self._dir is None:
            self._dir = tempfile.TemporaryDirectory(prefix="titpu-spill-")
        self._seq += 1
        return SpillFile(os.path.join(self._dir.name, f"part{self._seq}.bin"))

    def spill(self, chunk) -> SpillFile:
        f = self.new_file()
        f.write(chunk)
        return f

    def close(self) -> None:
        if self._dir is not None:
            self._dir.cleanup()
            self._dir = None

    def __del__(self) -> None:  # best-effort; close() is the real path
        try:
            self.close()
        except Exception:
            pass


def iter_partitions(files: list[SpillFile]) -> Iterator:
    for f in files:
        yield f.read()


__all__ = ["MemTracker", "QueryMemExceeded", "SpillDir", "SpillFile",
           "iter_partitions"]
