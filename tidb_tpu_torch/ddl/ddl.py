"""Online DDL: job queue, F1 schema-state machine, resumable reorg.

Port of `tidb_tpu/ddl/ddl.py`, whole: `DDLJob`, `DDL.submit`, `run_job`,
`step` through the F1 states (none -> delete only -> write only -> write
reorg -> public), rollback, and the handlers of ADD/DROP INDEX, ADD/DROP/
MODIFY COLUMN and RENAME TABLE with their cast helpers. All of it is numpy
on the host, as in the reference:

* Indexes are sorted permutations computed lazily from the epoch
  (store/index.py), so ADD INDEX has no row-at-a-time backfill — the
  write-reorg phase is the *uniqueness validation* scan for UNIQUE
  indexes, done in checkpointed batches over the sorted permutation.
* ADD/DROP/MODIFY COLUMN rewrite the columnar epoch in one vectorized
  pass (TableStore.apply_schema / cast_column), with a new epoch id: the
  coprocessor's next read stages the new epoch.

Jobs live on the Storage (`ddl_jobs`, persisted to the meta keyspace as
`ddl:jobs` on a durable store): a worker that "crashes" mid-reorg leaves
the job queued with its reorg checkpoint, and the next worker (or the next
`Storage(path)`) resumes from it.

Each schema-state transition bumps the catalog version. While an index is
delete-only/write-only/write-reorg it is registered invisible: DML
maintains (and unique-checks) it, the planner will not read it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..catalog.schema import ColumnInfo, IndexInfo, TableInfo
from ..errno import (ER_DUP_ENTRY, ER_DUP_FIELDNAME, ER_DUP_KEYNAME,
                     CodedError)
from ..types.field_type import FieldType, TypeKind


class DDLError(CodedError):
    """Schema-change error; duplicate-identity sites attach 106x codes."""


# job states (reference: model.JobState)
QUEUEING = "queueing"
RUNNING = "running"
DONE = "done"
ROLLED_BACK = "rolled back"

# schema states (reference: model.SchemaState, F1 protocol)
S_NONE = "none"
S_DELETE_ONLY = "delete only"
S_WRITE_ONLY = "write only"
S_WRITE_REORG = "write reorg"
S_PUBLIC = "public"

_job_ids = itertools.count(1)


@dataclass
class DDLJob:
    id: int
    kind: str  # add_index | drop_index | add_column | drop_column |
    #            modify_column | rename_table
    db: str
    table_id: int
    table_name: str
    args: dict[str, Any]
    state: str = QUEUEING
    schema_state: str = S_NONE
    # reorg checkpoint: position in the validation scan (resumable)
    reorg_pos: int = 0
    error: str = ""

    def row(self) -> tuple:
        """ADMIN SHOW DDL JOBS row."""
        return (self.id, self.db, self.table_name, self.kind,
                self.schema_state, self.state, self.error)


class DDL:
    """DDL worker. Synchronous by default (run_job drives a job to
    completion); step() exposes single transitions so tests can interleave
    concurrent DML and simulate worker crash/takeover mid-reorg."""

    REORG_BATCH = 20_000  # validation rows per step (reorg granularity)

    def __init__(self, storage, catalog) -> None:
        self.storage = storage
        self.catalog = catalog

    # ---- job api -----------------------------------------------------------
    def submit(self, kind: str, db: str, info: TableInfo,
               args: dict[str, Any]) -> DDLJob:
        job = DDLJob(next(_job_ids), kind, db, info.id, info.name, args)
        self.storage.ddl_jobs.append(job)
        self.storage.persist_ddl_jobs()
        return job

    def run_job(self, job: DDLJob) -> None:
        """Drive one job to completion as the DDL owner (reference: the
        owner-gated worker loop, ddl_worker.go:419; ownership comes from
        the election manager — mock in-process, flock across processes
        sharing a durable dir)."""
        owner = getattr(self.storage, "ddl_owner", None)
        if owner is None:
            self._run_job_steps(job)
            return
        with owner:
            # fold any sibling's schema changes BEFORE applying ours:
            # two servers altering different tables otherwise each
            # persist a full-catalog snapshot built from the other's
            # stale pre-image — a lost update whose colliding version
            # numbers also suppress the sibling reload (the reference
            # serializes on one owner AND reloads the schema at job
            # start, ddl_worker.go:419 + domain Reload)
            refresh = getattr(self.storage, "refresh", None)
            if refresh is not None:
                refresh()
            self._run_job_steps(job)

    def _run_job_steps(self, job: DDLJob) -> None:
        while not self.step(job):
            pass
        if job.state == ROLLED_BACK:
            raise DDLError(job.error)

    def resume_pending(self) -> None:
        """Owner-takeover path: drive any queued jobs to completion
        (reference: a new DDL owner picks the queue up, ddl_worker.go:419)."""
        while self.storage.ddl_jobs:
            self.run_job(self.storage.ddl_jobs[0])

    # ---- state machine -----------------------------------------------------
    def step(self, job: DDLJob) -> bool:
        """One transition (or one reorg batch). Returns True when the job
        left the queue (done or rolled back)."""
        from ..util import failpoint
        # simulated owner crash between persisted transitions (reference
        # failpoint pattern in ddl_worker tests); job state on storage is
        # the recovery truth
        failpoint.inject("ddl/before-step")
        job.state = RUNNING
        try:
            handler = getattr(self, "_on_" + job.kind)
            finished = handler(job)
        except DDLError as e:
            job.state = ROLLED_BACK
            job.error = str(e)
            self._rollback(job)
            self._finish(job)
            return True
        if finished:
            job.state = DONE
            job.schema_state = S_PUBLIC
            self._finish(job)
            return True
        # reorg checkpoint (job.reorg_pos / schema_state) survives a crash;
        # catalog persistence rides the bump_version hook in the handlers
        self.storage.persist_ddl_jobs()
        return False

    def _rollback(self, job: DDLJob) -> None:
        """Undo partially-applied schema state (reference:
        ddl/rollingback.go). Column/rename jobs apply atomically in their
        final step, so only the staged index states need unwinding."""
        info = self.catalog.try_table(job.db, job.table_name)
        if info is None:
            return
        if job.kind == "add_index" and "index_id" in job.args:
            info.indices = [ix for ix in info.indices
                            if ix.id != job.args["index_id"]]
        elif job.kind == "drop_index":
            name = job.args["name"].lower()
            for ix in info.indices:
                if ix.name.lower() == name:
                    ix.visible = True

    def _finish(self, job: DDLJob) -> None:
        if job in self.storage.ddl_jobs:
            self.storage.ddl_jobs.remove(job)
        self.storage.ddl_history.append(job)
        self.storage.persist_ddl_jobs()
        self.catalog.bump_version()

    def _info(self, job: DDLJob) -> TableInfo:
        info = self.catalog.try_table(job.db, job.table_name)
        if info is None or info.id != job.table_id:
            raise DDLError(f"table {job.table_name} is gone")
        return info

    # ---- ADD INDEX ---------------------------------------------------------
    def _on_add_index(self, job: DDLJob) -> bool:
        info = self._info(job)
        store = self.storage.table_store(info.id)
        a = job.args
        if job.schema_state == S_NONE:
            if any(ix.name.lower() == a["name"].lower()
                   for ix in info.indices):
                raise DDLError(f"Duplicate key name '{a['name']}'",
                               errno=ER_DUP_KEYNAME)
            offs = []
            for cname in a["columns"]:
                c = info.column_by_name(cname)
                if c is None:
                    raise DDLError(f"key column {cname} doesn't exist")
                offs.append(c.offset)
            index = IndexInfo(self.catalog.alloc_id(), a["name"], offs,
                              a.get("unique", False), False, visible=False)
            info.indices.append(index)
            a["index_id"] = index.id
            job.schema_state = S_DELETE_ONLY
            self.catalog.bump_version()
            return False
        index = next(ix for ix in info.indices if ix.id == a["index_id"])
        if job.schema_state == S_DELETE_ONLY:
            job.schema_state = S_WRITE_ONLY
            self.catalog.bump_version()
            return False
        if job.schema_state == S_WRITE_ONLY:
            job.schema_state = S_WRITE_REORG
            self.catalog.bump_version()
            return False
        if job.schema_state == S_WRITE_REORG:
            if index.unique:
                done = self._validate_unique_batch(job, info, store, index)
                if not done:
                    return False
                # publish race: a txn that buffered rows BEFORE the index
                # was registered can commit between the last validation
                # snapshot and the token bump — it was never unique-checked.
                # Close the window under the commit lock: no commit can land
                # while we re-validate the overlay and bump the fence
                # (reference: schema-version sync gates publication,
                # ddl/util/syncer.go + domain/schema_validator.go).
                with self.storage._commit_lock:
                    txn = self.storage.begin()
                    try:
                        snap = txn.snapshot(info.id)
                        # an empty epoch needs no batched scan (and set no
                        # reorg_epoch); otherwise the epoch must still be
                        # the one the batches validated — a compaction in
                        # between folded unvalidated commits into a fresh
                        # epoch, so restart the scan on it
                        if snap.epoch.num_rows > 0 and \
                                snap.epoch.epoch_id != \
                                job.args.get("reorg_epoch"):
                            job.args["reorg_epoch"] = None
                            job.reorg_pos = 0
                            return False
                        self._validate_overlay(snap, index, info)
                    finally:
                        txn.rollback()
                    index.visible = True
                    store.schema_token += 1
                    # NOTE: no bump_version here — the durable on_change
                    # hook writes meta-KV under _commit_lock, which this
                    # block already holds; _finish bumps outside the lock
                return True
            index.visible = True
            # fence txns that buffered writes before the index existed —
            # they never unique-checked it (schema_validator analog)
            store.schema_token += 1
            return True
        raise DDLError(f"bad state {job.schema_state}")

    def _validate_unique_batch(self, job: DDLJob, info: TableInfo,
                               store, index: IndexInfo) -> bool:
        """One checkpointed batch of the unique-validation scan: walk the
        sorted permutation looking for adjacent equal keys (reference:
        backfill worker batches + reorg handle checkpoints,
        ddl/backfilling.go:139, reorg.go:263). New writes are already
        unique-checked by DML (index registered in write-only)."""
        from ..store.index import epoch_index_order

        txn = self.storage.begin()
        try:
            snap = txn.snapshot(info.id)
            epoch = snap.epoch
            n = epoch.num_rows
            if n == 0:
                self._validate_overlay(snap, index, info)
                return True
            order = epoch_index_order(store, epoch, index)
            # a compaction between batches replaces the epoch and reshuffles
            # the permutation — positions below the checkpoint would escape
            # validation; restart on the new epoch (reference re-runs reorg
            # from the persisted element on owner change, reorg.go:708)
            if job.args.get("reorg_epoch") != epoch.epoch_id:
                job.args["reorg_epoch"] = epoch.epoch_id
                job.reorg_pos = 0
            start = job.reorg_pos
            stop = min(start + self.REORG_BATCH, n)
            # overlap back to the nearest VISIBLE row before the batch so
            # cross-batch neighbors are compared even when deleted rows sit
            # at the boundary
            lo = start
            while lo > 0:
                lo -= 1
                if snap.base_visible[order[lo]]:
                    break
            rows = order[lo:stop]
            vis = snap.base_visible[rows]
            rows = rows[vis]
            if len(rows) > 1:
                dup = np.ones(len(rows) - 1, dtype=bool)
                for off in index.col_offsets:
                    data = epoch.columns[off][rows]
                    dup &= data[1:] == data[:-1]
                    valid = epoch.valids[off]
                    if valid is not None:
                        v = valid[rows]
                        dup &= v[1:] & v[:-1]  # NULL keys never collide
                if dup.any():
                    i = int(np.nonzero(dup)[0][0])
                    key = "-".join(
                        str(epoch.columns[off][rows[i + 1]])
                        for off in index.col_offsets)
                    raise DDLError(
                        f"Duplicate entry '{key}' for key '{index.name}'",
                        errno=ER_DUP_ENTRY)
            # overlay rows (small): checked against whole key space via the
            # DML-time unique checker; validate among themselves + epoch
            self._validate_overlay(snap, index, info)
            job.reorg_pos = stop
            return stop >= n
        finally:
            txn.rollback()

    def _validate_overlay(self, snap, index: IndexInfo,
                          info: TableInfo) -> None:
        from ..store.index import IndexSearcher

        m = len(snap.overlay_handles)
        if m == 0:
            return
        searcher = IndexSearcher(snap.store, snap, index)
        seen: dict[tuple, int] = {}
        for i in range(m):
            key = []
            ok = True
            for off in index.col_offsets:
                valid = snap.overlay_valids[off]
                if valid is not None and not valid[i]:
                    ok = False
                    break
                key.append(snap.overlay_columns[off][i].item())
            if not ok:
                continue
            key_t = tuple(key)
            h = int(snap.overlay_handles[i])
            if seen.get(key_t, h) != h:
                raise DDLError(
                    f"Duplicate entry '{'-'.join(map(str, key_t))}' "
                    f"for key '{index.name}'", errno=ER_DUP_ENTRY)
            seen[key_t] = h
            hits = [x for x in searcher.eq(key_t) if int(x) != h]
            if hits:
                raise DDLError(
                    f"Duplicate entry '{'-'.join(map(str, key_t))}' "
                    f"for key '{index.name}'", errno=ER_DUP_ENTRY)

    # ---- DROP INDEX --------------------------------------------------------
    def _on_drop_index(self, job: DDLJob) -> bool:
        info = self._info(job)
        name = job.args["name"].lower()
        hit = next((ix for ix in info.indices
                    if ix.name.lower() == name), None)
        if job.schema_state == S_NONE:
            if hit is None:
                raise DDLError(f"check that index {job.args['name']} exists")
            if hit.primary:
                raise DDLError("cannot drop primary key")
            hit.visible = False  # write-only: planner stops reading it
            job.schema_state = S_WRITE_ONLY
            self.catalog.bump_version()
            return False
        if job.schema_state == S_WRITE_ONLY:
            if hit is not None:
                info.indices.remove(hit)
            self.storage.table_store(info.id).schema_token += 1
            return True
        raise DDLError(f"bad state {job.schema_state}")

    # ---- ADD COLUMN --------------------------------------------------------
    def _on_add_column(self, job: DDLJob) -> bool:
        info = self._info(job)
        store = self.storage.table_store(info.id)
        a = job.args
        if info.column_by_name(a["name"]) is not None:
            raise DDLError(f"Duplicate column name '{a['name']}'",
                           errno=ER_DUP_FIELDNAME)
        ft: FieldType = a["ftype"]
        default = a.get("default")
        if default is None and not ft.nullable:
            raise DDLError(f"column {a['name']} needs a default or NULL")
        new_cols = [ColumnInfo(c.id, c.name, c.ftype, c.offset, c.default,
                               c.is_primary, c.auto_increment)
                    for c in info.columns]
        off = len(new_cols)
        new_cols.append(ColumnInfo(self.catalog.alloc_id(), a["name"], ft,
                                   off, default))
        new_info = TableInfo(info.id, info.name, new_cols,
                             list(info.indices), info.pk_handle_offset)
        column_map: list = list(range(len(info.columns))) + [None]
        phys = _phys_default(ft, a.get("phys_default", default))
        store.apply_schema(new_info, column_map,
                           {off: (phys, default is not None)})
        self.catalog.replace_table(job.db, info.name, new_info)
        self.storage.stats.drop_table(info.id)
        return True

    # ---- DROP COLUMN -------------------------------------------------------
    def _on_drop_column(self, job: DDLJob) -> bool:
        info = self._info(job)
        store = self.storage.table_store(info.id)
        c = info.column_by_name(job.args["name"])
        if c is None:
            raise DDLError(f"column {job.args['name']} doesn't exist")
        if info.pk_handle_offset == c.offset:
            raise DDLError("cannot drop the primary key column")
        if len(info.columns) == 1:
            raise DDLError("cannot drop the only column")
        old_off = c.offset
        new_cols = []
        column_map: list = []
        remap: dict[int, int] = {}
        for oc in info.columns:
            if oc.offset == old_off:
                continue
            remap[oc.offset] = len(new_cols)
            new_cols.append(ColumnInfo(oc.id, oc.name, oc.ftype,
                                       len(new_cols), oc.default,
                                       oc.is_primary, oc.auto_increment))
            column_map.append(oc.offset)
        # indexes covering the column are dropped (MySQL drops multi-col
        # index parts; single behavior kept simple: whole index goes)
        new_indices = []
        for ix in info.indices:
            if old_off in ix.col_offsets:
                continue
            new_indices.append(IndexInfo(
                ix.id, ix.name, [remap[o] for o in ix.col_offsets],
                ix.unique, ix.primary, ix.visible))
        pk = info.pk_handle_offset
        if pk is not None:
            pk = remap[pk]
        new_info = TableInfo(info.id, info.name, new_cols, new_indices, pk)
        store.apply_schema(new_info, column_map, {})
        self.catalog.replace_table(job.db, info.name, new_info)
        self.storage.stats.drop_table(info.id)
        return True

    # ---- MODIFY COLUMN -----------------------------------------------------
    def _on_modify_column(self, job: DDLJob) -> bool:
        info = self._info(job)
        store = self.storage.table_store(info.id)
        a = job.args
        c = info.column_by_name(a["name"])
        if c is None:
            raise DDLError(f"column {a['name']} doesn't exist")
        new_ft: FieldType = a["ftype"]
        old_ft = c.ftype
        cast_fn = _column_cast(old_ft, new_ft)
        if cast_fn is None:
            raise DDLError(
                f"unsupported column type change {old_ft!r} -> {new_ft!r}")
        if not _is_lossless_cast(old_ft, new_ft):
            # a narrowing cast can collapse distinct values (0.9 and 1.1
            # both round to 1), leaving duplicate keys in a unique index
            # with no error — the reference re-validates uniqueness during
            # modify-column reorg (ddl/column.go); until that scan exists
            # here, reject the lossy change on uniquely-keyed columns
            for ix in info.indices:
                if ix.unique and c.offset in ix.col_offsets:
                    raise DDLError(
                        f"unsupported lossy type change {old_ft!r} -> "
                        f"{new_ft!r} on column '{c.name}' covered by "
                        f"unique key '{ix.name}'")
            if info.pk_handle_offset == c.offset:
                raise DDLError(
                    f"unsupported lossy type change {old_ft!r} -> "
                    f"{new_ft!r} on primary key column '{c.name}'")
        new_cols = [ColumnInfo(oc.id, oc.name,
                               new_ft if oc.offset == c.offset else oc.ftype,
                               oc.offset, oc.default, oc.is_primary,
                               oc.auto_increment)
                    for oc in info.columns]
        new_info = TableInfo(info.id, info.name, new_cols,
                             list(info.indices), info.pk_handle_offset)
        # data rewrite + TableInfo swap are one atomic step under the store
        # lock: a snapshot must never pair rescaled values with the old type
        err = store.cast_column(c.offset, cast_fn, new_info)
        if err is not None:
            raise DDLError(f"data truncated: {err}")
        self.catalog.replace_table(job.db, info.name, new_info)
        self.storage.stats.drop_table(info.id)
        return True

    # ---- RENAME TABLE ------------------------------------------------------
    def _on_rename_table(self, job: DDLJob) -> bool:
        info = self._info(job)
        new_name = job.args["new_name"]
        new_db = job.args.get("new_db", job.db)
        if self.catalog.try_table(new_db, new_name) is not None:
            raise DDLError(f"table {new_name} already exists")
        old_name = info.name
        new_info = TableInfo(info.id, new_name, info.columns,
                             info.indices, info.pk_handle_offset)
        store = self.storage.table_store(info.id)
        store.table = new_info
        store.schema_token += 1
        schema = self.catalog.schema(job.db)
        schema.tables.pop(old_name.lower(), None)
        self.catalog.replace_table(new_db, new_name, new_info)
        return True


_INT_DIGITS = {TypeKind.TINYINT: 3, TypeKind.SMALLINT: 5, TypeKind.INT: 10,
               TypeKind.BIGINT: 19, TypeKind.BOOLEAN: 1, TypeKind.YEAR: 4}


def _is_lossless_cast(old: FieldType, new: FieldType) -> bool:
    """True when the MODIFY COLUMN conversion can never collapse two
    distinct stored values into one (safe on uniquely-indexed columns)."""
    if old.kind == new.kind and not old.is_decimal:
        return True
    if old.is_string and new.is_string:
        return True
    if old.is_integer and new.is_integer:
        return _INT_DIGITS.get(new.kind, 0) >= _INT_DIGITS.get(old.kind, 99)
    if old.is_integer and new.is_decimal:
        return (new.flen - new.scale) >= _INT_DIGITS.get(old.kind, 99)
    if old.is_decimal and new.is_decimal:
        # scale must not shrink (rounding collapses) and integer-digit
        # capacity must not shrink (conservative: overflow raises rather
        # than collapses, but keep the declared capacity honest)
        return (new.scale >= old.scale
                and (new.flen - new.scale) >= (old.flen - old.scale))
    # float targets round to ~15 digits; decimal/float -> int truncates —
    # all potentially value-collapsing
    return False


def _phys_default(ft: FieldType, default):
    """Physical fill value; string defaults stay raw — apply_schema encodes
    them into the column's fresh dictionary."""
    return 0 if default is None else default


def _column_cast(old: FieldType, new: FieldType):
    """cast_fn(data, valid) -> (data, valid) for supported MODIFY COLUMN
    conversions (numeric widening/narrowing with range check, decimal
    rescale, int<->decimal, ->double, varchar widen)."""
    if old.is_string and new.is_string:
        return lambda d, v: (d, v)  # dictionary codes unchanged
    if old.is_string or new.is_string:
        return None
    if old.is_temporal or new.is_temporal:
        if old.kind == new.kind:
            return lambda d, v: (d, v)
        return None

    def to_float(d, v):
        if old.is_decimal:
            return d.astype(np.float64) / (10 ** old.scale), v
        return d.astype(np.float64), v

    if new.kind == TypeKind.DOUBLE or new.kind == TypeKind.FLOAT:
        return to_float

    # int-family conversions stay in the int64 domain end-to-end — a
    # float64 round-trip would silently corrupt values above 2^53
    def to_int_like(d, v):
        if old.is_float:
            return _range_checked_float(np.round(d.astype(np.float64)), v,
                                        new)
        x = d.astype(np.int64)
        if old.is_decimal:
            x = _div_round_half_up(x, 10 ** old.scale)
        return _range_checked_int(x, v, new)

    def to_decimal(d, v):
        if old.is_float:
            return _range_checked_float(
                np.round(d.astype(np.float64) * 10 ** new.scale), v, new)
        x = d.astype(np.int64)
        if old.is_decimal:
            if new.scale >= old.scale:
                x = _mul_checked(x, v, 10 ** (new.scale - old.scale))
            else:
                x = _div_round_half_up(x, 10 ** (old.scale - new.scale))
        else:
            x = _mul_checked(x, v, 10 ** new.scale)
        return _range_checked_int(x, v, new)

    if new.is_decimal:
        return to_decimal
    return to_int_like


_INT_RANGES = {
    TypeKind.TINYINT: (-128, 127),
    TypeKind.SMALLINT: (-32768, 32767),
    TypeKind.INT: (-2**31, 2**31 - 1),
    TypeKind.BIGINT: (-2**63, 2**63 - 1),
    TypeKind.DECIMAL: (-2**63, 2**63 - 1),
    TypeKind.BOOLEAN: (0, 1),
    TypeKind.YEAR: (1901, 2155),
}


def _div_round_half_up(x: np.ndarray, f: int) -> np.ndarray:
    """Exact int64 division rounding half away from zero."""
    half = f // 2
    return np.where(x >= 0, (x + half) // f, -((-x + half) // f))


def _mul_checked(x: np.ndarray, valid: np.ndarray, f: int) -> np.ndarray:
    limit = (2**63 - 1) // f
    bad = valid & (np.abs(x) > limit)
    if bad.any():
        raise ValueError(f"value {x[bad][0]} overflows at scale factor {f}")
    return x * f


def _range_checked_int(vals: np.ndarray, valid: np.ndarray, ft: FieldType):
    lo, hi = _INT_RANGES.get(ft.kind, (-2**63, 2**63 - 1))
    bad = valid & ((vals < lo) | (vals > hi))
    if bad.any():
        raise ValueError(f"value {vals[bad][0]} out of range for {ft!r}")
    return vals, valid


def _range_checked_float(vals: np.ndarray, valid: np.ndarray, ft: FieldType):
    lo, hi = _INT_RANGES.get(ft.kind, (-2**63, 2**63 - 1))
    live = valid & np.isfinite(vals)
    # strict float compare is safe here: inputs came from float storage
    bad = live & ((vals < float(lo)) | (vals > float(hi)))
    if bad.any():
        raise ValueError(f"value {vals[bad][0]} out of range for {ft!r}")
    return vals.astype(np.int64), valid
