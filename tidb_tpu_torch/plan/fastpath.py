"""Point-plan fast path: the TryFastPlan bypass for high-QPS OLTP.

Counterpart of the reference's point-get fast plan (reference:
planner/core/point_get_plan.go:413 TryFastPlan + executor/point_get.go):
an autocommit SELECT/UPDATE/DELETE whose WHERE is a full PK (or unique
key) equality — and a literal-only INSERT VALUES — skips the whole
parse->plan->optimize->dispatch pipeline and executes directly against
the KV/MVCC layer:

* zero coprocessor involvement (the session's lazy `cop` property is
  never touched, so no device, no staging, no kernels);
* zero planner work on a plan-cache hit (the session LRU stores the
  recognized FastPlan under the same `_plan_cache_key` the physical
  plan cache uses, including the prepared-statement `#stmt{id}` keys);
* the row read is O(1): txn-visible deltas scanned newest-first, then
  the epoch's lazy HandleIndex — never a table-sized snapshot mask.

Recognition is deliberately conservative: anything it does not
understand (partitions, views, unique secondary indexes on INSERT,
expressions beyond simple row-local arithmetic, bindings in force)
returns None and the unchanged slow path answers.

Port of `tidb_tpu/plan/fastpath.py`. A point read that finds its row is
noted on the keyspace heatmap (`storage.heat.note_read`), as in the
reference. The reference also runs point reads under the execution
admission gate; the port's execution goes straight to the transaction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..chunk.column import _encode_scalar, decode_scalar
from ..kv.memdb import TOMBSTONE
from ..sql import ast

# schemas whose tables are virtual/refreshed views — never point-read
SYSTEM_SCHEMAS = frozenset({
    "information_schema", "performance_schema", "metrics_schema",
    "mysql",
})


@dataclass
class FastPlan:
    """A recognized point statement, bound to its literal values (the
    plan-cache key embeds the literals, so a cached FastPlan replays
    byte-identically)."""

    kind: str  # 'get' | 'update' | 'delete' | 'insert'
    info: Any  # TableInfo
    # point key: either the int-handle PK value...
    handle: Optional[int] = None
    # ...or a unique-key equality (host values, index lookup at exec)
    index: Any = None
    key_values: Optional[tuple] = None
    # extra `col = literal` conjuncts checked against the fetched row
    residual: list = field(default_factory=list)  # [(offset, host value)]
    # SELECT output
    select_offsets: list = field(default_factory=list)
    names: list = field(default_factory=list)
    ftypes: list = field(default_factory=list)
    limit: Optional[int] = None
    # UPDATE assignments: [(offset, expr AST)] evaluated row-locally
    assigns: list = field(default_factory=list)
    # INSERT: pre-extracted host value rows + target column offsets
    insert_rows: list = field(default_factory=list)
    col_order: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# recognition
# ---------------------------------------------------------------------------

def try_plan(session, stmt) -> Optional[FastPlan]:
    """Recognize a point statement; None routes to the slow path.
    Session-level eligibility (autocommit, no user, sysvar) is the
    caller's job — this is the pure statement-shape check."""
    try:
        if isinstance(stmt, ast.SelectStmt):
            return _plan_select(session, stmt)
        if isinstance(stmt, ast.UpdateStmt):
            return _plan_update(session, stmt)
        if isinstance(stmt, ast.DeleteStmt):
            return _plan_delete(session, stmt)
        if isinstance(stmt, ast.InsertStmt):
            return _plan_insert(session, stmt)
    except Exception:  # noqa: BLE001 — recognition must never fail the
        return None    # statement; anything odd just takes the slow path
    return None


def _table_info(session, tn) -> Optional[Any]:
    if not isinstance(tn, ast.TableName):
        return None
    db = (tn.db or session.current_db).lower()
    if db in SYSTEM_SCHEMAS:
        return None
    try:
        info = session.catalog.table(db, tn.name)
    except KeyError:
        return None  # unknown table OR a view: slow path explains
    if getattr(info, "partition", None) is not None:
        return None  # partition routing stays on the planned path
    return info


def _literal_value(e) -> tuple[bool, Any]:
    """(ok, host value) for a Literal node (NULL -> bail: a point key
    compared with NULL never matches and MySQL's type rules around it
    are the slow path's business)."""
    if not isinstance(e, ast.Literal):
        return False, None
    if e.value is None:
        return False, None
    return True, e.value


def _split_eq_conjuncts(where, tn) -> Optional[dict]:
    """WHERE as {column name -> literal host value}, or None when any
    conjunct is not a plain `col = literal` over this table."""
    out: dict[str, Any] = {}
    stack = [where]
    alias = (tn.alias or tn.name).lower()
    while stack:
        e = stack.pop()
        if isinstance(e, ast.BinaryOp) and e.op == "AND":
            stack.append(e.left)
            stack.append(e.right)
            continue
        if not (isinstance(e, ast.BinaryOp) and e.op == "="):
            return None
        col, lit = e.left, e.right
        if isinstance(lit, ast.ColumnRef):
            col, lit = lit, col
        if not isinstance(col, ast.ColumnRef):
            return None
        if col.table is not None and col.table.lower() != alias:
            return None
        ok, v = _literal_value(lit)
        if not ok:
            return None
        name = col.name.lower()
        if name in out and out[name] != v:
            return None  # contradictory duplicates: let the planner
        out[name] = v
    return out


def _extract_key(session, info, tn, where) -> Optional[tuple]:
    """(handle, index, key_values, residual) from a full-key equality
    WHERE, or None."""
    if where is None:
        return None
    eq = _split_eq_conjuncts(where, tn)
    if not eq:
        return None
    by_offset: dict[int, Any] = {}
    for name, v in eq.items():
        c = info.column_by_name(name)
        if c is None:
            return None
        by_offset[c.offset] = v
    pk_off = info.pk_handle_offset
    if pk_off is not None and pk_off in by_offset:
        v = by_offset.pop(pk_off)
        if isinstance(v, bool) or not isinstance(v, int):
            return None  # non-int handle literal: slow-path coercion
        residual = _residuals(info, by_offset)
        if residual is None:
            return None
        return int(v), None, None, residual
    for ix in info.indices:
        if not ((ix.unique or ix.primary) and ix.visible):
            continue
        if all(off in by_offset for off in ix.col_offsets):
            vals = tuple(by_offset[off] for off in ix.col_offsets)
            # exact-comparable key types only: the searcher probes
            # PHYSICAL values, and only ints (identity) and strings
            # (dictionary lookup) need no coercion — decimal/temporal/
            # float keys keep the slow path's conversion rules
            ok = all(
                (info.columns[off].ftype.is_integer
                 and isinstance(v, int) and not isinstance(v, bool))
                or (info.columns[off].ftype.is_string
                    and isinstance(v, str))
                for off, v in zip(ix.col_offsets, vals))
            if not ok:
                return None
            for off in ix.col_offsets:
                by_offset.pop(off)
            residual = _residuals(info, by_offset)
            if residual is None:
                return None
            return None, ix, vals, residual
    return None


def _residuals(info, by_offset: dict) -> Optional[list]:
    """Leftover equality conjuncts as decoded-row comparisons; only
    exact-comparable types (ints/strings) qualify — float/temporal
    equality keeps the slow path's coercion rules."""
    out = []
    for off, v in by_offset.items():
        ft = info.columns[off].ftype
        if ft.is_string and isinstance(v, str):
            out.append((off, v))
        elif ft.is_integer and isinstance(v, int) \
                and not isinstance(v, bool):
            out.append((off, v))
        else:
            return None
    return out


def _plan_select(session, stmt: ast.SelectStmt) -> Optional[FastPlan]:
    if (stmt.group_by or stmt.having is not None or stmt.order_by
            or stmt.distinct or stmt.for_update
            or stmt.into_outfile is not None or stmt.hints
            or stmt.offset):
        return None
    if stmt.limit is not None and stmt.limit < 1:
        return None
    info = _table_info(session, stmt.from_)
    if info is None:
        return None
    key = _extract_key(session, info, stmt.from_, stmt.where)
    if key is None:
        return None
    handle, index, key_values, residual = key
    offsets: list[int] = []
    names: list[str] = []
    alias = (stmt.from_.alias or stmt.from_.name).lower()
    for f in stmt.fields:
        if f.expr is None:
            if f.wildcard_table is not None and \
                    f.wildcard_table.lower() != alias:
                return None
            for c in info.columns:
                offsets.append(c.offset)
                names.append(c.name)
            continue
        if not isinstance(f.expr, ast.ColumnRef):
            return None
        if f.expr.table is not None and f.expr.table.lower() != alias:
            return None
        c = info.column_by_name(f.expr.name)
        if c is None:
            return None
        offsets.append(c.offset)
        names.append(f.alias or f.expr.name)
    if not offsets:
        return None
    return FastPlan(
        kind="get", info=info, handle=handle, index=index,
        key_values=key_values, residual=residual,
        select_offsets=offsets, names=names,
        ftypes=[info.columns[o].ftype for o in offsets],
        limit=stmt.limit)


# assignment RHS: literals, same-table column refs and +,-,* arithmetic
# over them (the sysbench `SET k = k + 1` shape); everything else —
# functions, subqueries, division's type rules — keeps the slow path
_ARITH_OPS = frozenset({"+", "-", "*"})


def _assign_expr_ok(info, e, depth: int = 0) -> bool:
    if depth > 4:
        return False
    if isinstance(e, ast.Literal):
        # inside arithmetic only numeric literals qualify — string/
        # temporal coercion ('1' + 1) is the slow path's business
        return e.value is None or (
            isinstance(e.value, (int, float))
            and not isinstance(e.value, bool))
    if isinstance(e, ast.ColumnRef):
        c = info.column_by_name(e.name)
        if c is None:
            return False
        return c.ftype.is_integer or c.ftype.is_float
    if isinstance(e, ast.BinaryOp) and e.op in _ARITH_OPS:
        return _assign_expr_ok(info, e.left, depth + 1) and \
            _assign_expr_ok(info, e.right, depth + 1)
    return False


def _eval_assign(info, e, row_host) -> Any:
    """Evaluate a recognized assignment expression against the fetched
    row's host values (SQL NULL propagates)."""
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.ColumnRef):
        return row_host[info.column_by_name(e.name).offset]
    left = _eval_assign(info, e.left, row_host)
    right = _eval_assign(info, e.right, row_host)
    if left is None or right is None:
        return None
    if e.op == "+":
        return left + right
    if e.op == "-":
        return left - right
    return left * right


def _unique_offsets(info) -> set:
    out = set()
    if info.pk_handle_offset is not None:
        out.add(info.pk_handle_offset)
    for ix in info.indices:
        if ix.unique or ix.primary:
            out.update(ix.col_offsets)
    return out


def _plan_update(session, stmt: ast.UpdateStmt) -> Optional[FastPlan]:
    info = _table_info(session, stmt.table)
    if info is None:
        return None
    key = _extract_key(session, info, stmt.table, stmt.where)
    if key is None:
        return None
    handle, index, key_values, residual = key
    uniq = _unique_offsets(info)
    assigns = []
    for a in stmt.assignments:
        c = info.column_by_name(a.column.name)
        if c is None or c.offset in uniq:
            return None  # key/unique rewrites need the constraint path
        if isinstance(a.value, ast.Literal):
            pass  # literal into ANY column type: encode coerces
        elif not _assign_expr_ok(info, a.value) or not (
                c.ftype.is_integer or c.ftype.is_float
                or c.ftype.is_decimal):
            # expression results flow only into numeric columns; the
            # slow path owns string/temporal coercion rules
            return None
        assigns.append((c.offset, a.value))
    if not assigns:
        return None
    return FastPlan(kind="update", info=info, handle=handle,
                    index=index, key_values=key_values,
                    residual=residual, assigns=assigns)


def _plan_delete(session, stmt: ast.DeleteStmt) -> Optional[FastPlan]:
    info = _table_info(session, stmt.table)
    if info is None:
        return None
    key = _extract_key(session, info, stmt.table, stmt.where)
    if key is None:
        return None
    handle, index, key_values, residual = key
    return FastPlan(kind="delete", info=info, handle=handle,
                    index=index, key_values=key_values,
                    residual=residual)


def _plan_insert(session, stmt: ast.InsertStmt) -> Optional[FastPlan]:
    if stmt.select is not None or stmt.is_replace or stmt.on_dup:
        return None
    if not stmt.rows:
        return None
    info = _table_info(session, stmt.table)
    if info is None:
        return None
    # unique SECONDARY indexes need the full _UniqueChecker/guard-key
    # machinery; the pk-handle dup check below covers handle-PK tables
    for ix in info.indices:
        if (ix.unique or ix.primary) and \
                list(ix.col_offsets) != [info.pk_handle_offset]:
            return None
    col_order = _insert_offsets(info, stmt.columns)
    if col_order is None:
        return None
    rows = []
    for value_row in stmt.rows:
        if len(value_row) != len(col_order):
            return None  # slow path raises the typed 1136
        vals = []
        for e in value_row:
            if not isinstance(e, ast.Literal):
                return None
            vals.append(e.value)
        rows.append(vals)
    return FastPlan(kind="insert", info=info, insert_rows=rows,
                    col_order=col_order)


def _insert_offsets(info, names) -> Optional[list]:
    if names is None:
        return list(range(info.num_columns))
    out = []
    for n in names:
        c = info.column_by_name(n)
        if c is None:
            return None
        out.append(c.offset)
    return out


# ---------------------------------------------------------------------------
# execution — straight against the KV/MVCC + columnar-delta layer
# ---------------------------------------------------------------------------

def execute(session, fp: FastPlan):
    """Run a FastPlan inside the session's normal autocommit txn
    machinery (same staging/retry/commit as the slow path — only the
    plan/dispatch pipeline is bypassed)."""
    if fp.kind == "get":
        return session._run_in_txn(lambda: _exec_get(session, fp))
    if fp.kind == "update":
        return session._run_in_txn(lambda: _exec_update(session, fp))
    if fp.kind == "delete":
        return session._run_in_txn(lambda: _exec_delete(session, fp))
    assert fp.kind == "insert"
    return session._run_in_txn(lambda: _exec_insert(session, fp))


def _point_row(storage, store, handle: int, ts: int):
    """Visible physical row tuple for `handle` at `ts`, or None.

    O(deltas tail + one HandleIndex probe) — never materializes a
    snapshot. Same fold-seqlock discipline as Transaction.snapshot: a
    read racing an active columnar fold falls back to the commit lock."""
    for _ in range(4):
        seq = storage._fold_seq
        if seq & 1:
            break  # fold active: serialize on the lock below
        row = _point_row_unfenced(store, handle, ts)
        if storage._fold_seq == seq:
            return row
    with storage._commit_lock:
        return _point_row_unfenced(store, handle, ts)


def _point_row_unfenced(store, handle: int, ts: int):
    with store._lock:
        # newest-first over the un-compacted tail: the first version at
        # or below ts wins (deltas are commit-ts ordered)
        for commit_ts, h, row in reversed(store.deltas):
            if h == handle and commit_ts <= ts:
                return None if row is TOMBSTONE else row
        epoch = store.epoch
    pos = epoch.handle_pos.get(handle)
    if pos is None:
        return None
    out = []
    for off in range(len(epoch.columns)):
        valid = epoch.valids[off]
        if valid is not None and not valid[pos]:
            out.append(None)
        else:
            v = epoch.columns[off][pos]
            out.append(v.item() if hasattr(v, "item") else v)
    return tuple(out)


def _lookup_row(session, fp: FastPlan, txn):
    """(handle, physical row) for the plan's key at the txn's read ts,
    or (None, None). Residual equality conjuncts are applied here."""
    storage = session.storage
    store = storage.table_store(fp.info.id)
    ts = txn.stmt_read_ts if txn.stmt_read_ts is not None \
        else txn.start_ts
    if fp.handle is not None:
        handle = fp.handle
        row = _point_row(storage, store, handle, ts)
    else:
        # unique-key point: one index probe over a snapshot (the
        # searcher path the slow point read uses); still host-only
        from ..store.index import IndexSearcher
        snap = txn.snapshot(fp.info.id)
        hits = IndexSearcher(store, snap, fp.index).eq(fp.key_values)
        if len(hits) == 0:
            return None, None
        handle = int(hits[0])
        row = _point_row(storage, store, handle, ts)
    if row is None:
        return None, None
    for off, want in fp.residual:
        ft = fp.info.columns[off].ftype
        got = decode_scalar(ft, row[off], store.dictionaries[off]) \
            if row[off] is not None else None
        if got != want:
            return None, None
    return handle, row


def _exec_get(session, fp: FastPlan):
    from ..session.session import ResultSet

    txn = session._ensure_txn()
    handle, row = _lookup_row(session, fp, txn)
    heat = getattr(session.storage, "heat", None)
    if heat is not None and heat.enabled and row is not None:
        # OLTP point reads land on the keyspace heatmap by record key
        # (bytes ~ column count: physical width is not rematerialized
        # on this path, and the heat plane wants relative skew)
        from ..kv import tablecodec
        heat.note_read(tablecodec.record_key(fp.info.id, int(handle)),
                       rows=1, nbytes=8 * fp.info.num_columns)
    rows: list[tuple] = []
    if row is not None:
        store = session.storage.table_store(fp.info.id)
        rows.append(tuple(
            decode_scalar(fp.info.columns[o].ftype, row[o],
                          store.dictionaries[o])
            if row[o] is not None else None
            for o in fp.select_offsets))
    session._found_rows = len(rows)
    return ResultSet(fp.names, rows, column_types=list(fp.ftypes))


def _exec_update(session, fp: FastPlan):
    from ..errno import ER_BAD_NULL
    from ..session.session import ResultSet, SQLError

    txn = session._ensure_txn()
    handle, row = _lookup_row(session, fp, txn)
    if row is None:
        return ResultSet([], [], affected=0)
    info = fp.info
    store = session.storage.table_store(info.id)
    # host view of the row for expression RHS (decoded lazily would
    # save little: assignment exprs touch few columns, tables are thin)
    row_host = [
        decode_scalar(info.columns[i].ftype, row[i],
                      store.dictionaries[i]) if row[i] is not None
        else None
        for i in range(info.num_columns)]
    new_phys = list(row)
    for off, expr in fp.assigns:
        col = info.columns[off]
        v = _eval_assign(info, expr, row_host)
        if v is None:
            if not col.ftype.nullable:
                raise SQLError(f"column {col.name} cannot be null",
                               errno=ER_BAD_NULL)
            new_phys[off] = None
        else:
            new_phys[off] = _encode_scalar(col.ftype, v,
                                           store.dictionaries[off])
    txn.set_row(info.id, handle, tuple(new_phys))
    return ResultSet([], [], affected=1)


def _exec_delete(session, fp: FastPlan):
    from ..session.session import ResultSet

    txn = session._ensure_txn()
    handle, row = _lookup_row(session, fp, txn)
    if row is None:
        return ResultSet([], [], affected=0)
    txn.delete_row(fp.info.id, handle)
    return ResultSet([], [], affected=1)


def _exec_insert(session, fp: FastPlan):
    from ..errno import ER_DUP_ENTRY
    from ..session.session import ResultSet, SQLError

    info = fp.info
    txn = session._ensure_txn()
    storage = session.storage
    store = storage.table_store(info.id)
    seen: set[int] = set()  # handles written by THIS statement
    count = 0
    for values in fp.insert_rows:
        full = session._complete_row(info, fp.col_order, list(values),
                                     store)
        handle = session._row_handle(info, full, store)
        enc = store.encode_row(full)
        if info.pk_handle_offset is not None:
            dup = handle in seen or _point_row(
                storage, store, handle, txn.start_ts) is not None
            if dup:
                raise SQLError(
                    f"Duplicate entry '{handle}' for key 'PRIMARY'",
                    errno=ER_DUP_ENTRY)
        txn.set_row(info.id, handle, enc)
        seen.add(handle)
        count += 1
    return ResultSet([], [], affected=count)
