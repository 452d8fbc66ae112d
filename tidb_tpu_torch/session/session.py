"""Session: statement lifecycle over the storage, the planner and the executor.

The read path of the reference's `tidb_tpu/session/session.py`: SQL text is
parsed (`sql/parser.py`), planned exactly as the reference plans it
(`plan/builder.py`, `plan/physical.optimize`), and run by the root executor
(`executor/engine.py`), which sends every `CopDAG` and `FragmentDAG` to the
port's coprocessor. The statements of this slice are CREATE DATABASE, USE,
CREATE TABLE (primary keys, indexes, unique columns), DROP TABLE, SELECT
(and UNION), EXPLAIN and ANALYZE TABLE. Tables are filled by bulk loads
(`bench/tpch_data.load_table`); every other statement kind, and every write,
raises `NotInSlice`.

Left out of the reference's statement path: the SQL-text plan cache (it
changes no answer), the point fast path, slow log, digests, profiler,
bindings, privileges, replica routing, governor admission, FOR UPDATE,
session variables and the session-dependent functions bound from them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from .. import obs
from ..catalog.schema import Catalog, ColumnInfo, FKInfo, IndexInfo, TableInfo
from ..copr.client import CopClient
from ..errno import ER_BAD_FIELD, ER_PARSE_ERROR, CodedError
from ..errno import wrap as err_wrap
from ..errors import NotInSlice
from ..executor.engine import ExecContext, run_physical
from ..plan.builder import PlanBuilder, PlanError, _literal_const
from ..plan.physical import explain_plan, optimize
from ..sql import ast
from ..sql.parser import ParseError, parse_sql
from ..store.storage import Storage, Transaction
from ..store.table_store import TableStore
from ..types.field_type import FieldType
from ..types.value import Decimal

# functions whose value depends on the session or the clock: the reference
# binds them to literals before planning, from session state not ported
_SESSION_FUNCS = frozenset({
    "NOW", "CURRENT_TIMESTAMP", "SYSDATE", "LOCALTIME", "LOCALTIMESTAMP",
    "CURDATE", "CURRENT_DATE", "CURTIME", "CURRENT_TIME",
    "VERSION", "DATABASE", "SCHEMA", "USER", "CURRENT_USER",
    "SESSION_USER", "SYSTEM_USER", "CONNECTION_ID", "UNIX_TIMESTAMP",
    "NEXTVAL", "LASTVAL", "SETVAL",
    "LAST_INSERT_ID", "FOUND_ROWS", "ROW_COUNT", "CURRENT_ROLE",
    "GET_LOCK", "RELEASE_LOCK", "RELEASE_ALL_LOCKS", "IS_FREE_LOCK",
    "IS_USED_LOCK", "TIDB_IS_DDL_OWNER",
})

# reserved words usable WITHOUT parentheses (MySQL niladic functions)
_NILADIC_FUNCS = frozenset({
    "CURRENT_DATE", "CURRENT_TIME", "CURRENT_TIMESTAMP", "CURRENT_USER",
    "LOCALTIME", "LOCALTIMESTAMP",
})


class SQLError(CodedError):
    """Session-layer error; raise sites attach specific errnos."""


@dataclass
class ResultSet:
    column_names: list[str]
    rows: list[tuple[Any, ...]]
    affected: int = 0
    # column field types when known (SELECT paths)
    column_types: Optional[list[FieldType]] = None

    def __repr__(self) -> str:
        return f"ResultSet({self.column_names}, {len(self.rows)} rows)"


class Session:
    def __init__(self, storage: Optional[Storage] = None, db: str = "test",
                 cop: Optional[CopClient] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.storage = storage if storage is not None else Storage()
        self.catalog: Catalog = self.storage.catalog
        self.current_db = db
        # the coprocessor client is built at the first statement that
        # needs it, on `device` (None: the card; no card is an error then)
        self._cop: Optional[CopClient] = cop
        self._device = device
        self.txn: Optional[Transaction] = None
        self._stmt_seq = 0
        # last statement's attribution: stage totals ('parse',
        # 'plan_build'), exclusive wall seconds per plan operator, and
        # the engine tag of each coprocessor read in call order
        self.last_stages: dict[str, float] = {}
        self.last_op_wall: dict[str, float] = {}
        self.last_engines: list[str] = []
        self._pending_parse_s = 0.0

    @property
    def cop(self) -> CopClient:
        """Coprocessor client, built on first use (the reference's
        `mesh.client_for`; the port has one device)."""
        if self._cop is None:
            self._cop = CopClient(self._device)
        return self._cop

    # ==================== public API ====================
    def execute(self, sql: str) -> ResultSet:
        """Execute one or more ;-separated statements; returns the last
        statement's result."""
        t_parse = time.perf_counter()
        try:
            stmts = parse_sql(sql)
        except ParseError as e:
            raise SQLError(f"parse error: {e}",
                           errno=getattr(e, 'errno', ER_PARSE_ERROR)) from None
        # parse happens before the per-statement recorder exists: the
        # first statement's recorder books it as its 'parse' stage
        self._pending_parse_s = time.perf_counter() - t_parse
        result = ResultSet([], [])
        for stmt in stmts:
            result = self._execute_observed(stmt)
        # delta-driven auto-analyze at statement boundaries (the
        # reference's stats owner loop, checked inline every 64
        # statements as the reference's single-process session does)
        self._stmt_seq += 1
        if self._stmt_seq % 64 == 0 and self.txn is None:
            self.storage.stats.auto_analyze(self.storage, self.catalog)
        return result

    def _execute_observed(self, stmt: ast.Stmt) -> ResultSet:
        """Run one statement under its own stage recorder; the recorder's
        totals, operator walls and engine tags become `last_stages`,
        `last_op_wall` and `last_engines`."""
        prev_rec = obs.active_stage_recorder()
        rec = obs.StageRecorder()
        if self._pending_parse_s:
            rec.add("parse", self._pending_parse_s)
            self._pending_parse_s = 0.0
        try:
            obs.install_stage_recorder(rec)
            return self._execute_stmt(stmt)
        finally:
            obs.install_stage_recorder(prev_rec)
            self.last_stages = rec.totals
            self.last_op_wall = rec.op_wall
            self.last_engines = rec.engines

    def query(self, sql: str) -> list[tuple[Any, ...]]:
        return self.execute(sql).rows

    def _execute_stmt(self, stmt: ast.Stmt) -> ResultSet:
        if isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt)):
            if getattr(stmt, "into_outfile", None) is not None:
                raise NotInSlice("INTO OUTFILE")
            return self._run_in_txn(lambda: self._exec_select(stmt))
        if isinstance(stmt, ast.CreateTableStmt):
            return self._exec_create_table(stmt)
        if isinstance(stmt, ast.DropTableStmt):
            return self._exec_drop_table(stmt)
        if isinstance(stmt, ast.CreateDatabaseStmt):
            self.catalog.create_schema(stmt.name, stmt.if_not_exists)
            return ResultSet([], [], affected=0)
        if isinstance(stmt, ast.UseStmt):
            self.catalog.schema(stmt.db)  # raises if unknown
            self.current_db = stmt.db
            return ResultSet([], [])
        if isinstance(stmt, ast.ExplainStmt):
            return self._exec_explain(stmt)
        if isinstance(stmt, ast.AnalyzeTableStmt):
            return self._exec_analyze(stmt)
        raise NotInSlice(type(stmt).__name__)

    # ==================== session state ====================
    @staticmethod
    def _has_var_reads(node) -> bool:
        """@var / @@var reads and session-dependent functions, which the
        reference binds to literals from session state before planning."""
        found = False

        def visit(n):
            nonlocal found
            if isinstance(n, (ast.SysVarExpr, ast.UserVarExpr)) or (
                    isinstance(n, ast.FuncCall) and
                    n.name in _SESSION_FUNCS) or (
                    isinstance(n, ast.ColumnRef) and n.table is None and
                    n.name.upper() in _NILADIC_FUNCS):
                found = True
                return False
            return None

        ast.walk(node, visit)
        return found

    # ==================== ANALYZE ====================
    def _exec_analyze(self, stmt: ast.AnalyzeTableStmt) -> ResultSet:
        """ANALYZE TABLE: statistics from a fresh snapshot; columns of
        tables from 2M rows up take the coprocessor's device pass."""
        self._commit_implicit()
        for tn in stmt.tables:
            info, store = self._table_for(tn)
            self.storage.stats.analyze_one(info, store, self.storage,
                                           cop=self.cop)
        return ResultSet([], [])

    # ==================== txn plumbing ====================
    def _ensure_txn(self) -> Transaction:
        if self.txn is None:
            self.txn = self.storage.begin()
        return self.txn

    def _run_in_txn(self, fn):
        """One autocommit statement in its own read transaction."""
        self._ensure_txn()
        try:
            result = fn()
        except Exception:
            self._finish_txn(commit=False)
            raise
        self._finish_txn(commit=True)
        return result

    def _commit_implicit(self) -> None:
        if self.txn is not None:
            self._finish_txn(commit=True)

    def _finish_txn(self, commit: bool) -> None:
        if self.txn is None:
            return
        txn, self.txn = self.txn, None
        if commit:
            txn.commit()
        else:
            txn.rollback()

    def _exec_ctx(self, stats=None) -> ExecContext:
        """ExecContext with the session's memory quota attached."""
        from ..util.memory import MemTracker

        sysvars = self.storage.sysvars
        quota = int(sysvars.get_global("tidb_mem_quota_query") or 0)
        action = str(sysvars.get_global("tidb_mem_oom_action") or "SPILL")
        mem = MemTracker("query", quota, action=action.upper())
        return ExecContext(self._ensure_txn(), self.cop, stats=stats,
                           mem=mem)

    # ==================== SELECT ====================
    def _exec_select(self, stmt: ast.SelectStmt) -> ResultSet:
        if self._has_var_reads(stmt):
            raise NotInSlice("session variables and functions")
        if getattr(stmt, "for_update", False):
            raise NotInSlice("FOR UPDATE")
        with obs.stage("plan_build"):
            plan = self._plan(stmt)
        ctx = self._exec_ctx()
        try:
            chunk = run_physical(plan, ctx)
        finally:
            ctx.close()
        names = [f.name for f in plan.schema.fields]
        ftypes = [f.ftype for f in plan.schema.fields]
        if not chunk.columns:
            return ResultSet(names, [], column_types=ftypes)
        return ResultSet(names, chunk.to_pylist(), column_types=ftypes)

    def _plan(self, stmt: ast.SelectStmt):
        try:
            logical = PlanBuilder(self.catalog, self.current_db).build_select(
                stmt)
            return optimize(logical, self.storage.stats)
        except PlanError as e:
            raise err_wrap(SQLError, e) from None

    # ==================== DDL ====================
    def _exec_create_table(self, stmt: ast.CreateTableStmt) -> ResultSet:
        if stmt.partition_by is not None:
            raise NotInSlice("PARTITION BY")
        db = stmt.table.db or self.current_db
        columns: list[ColumnInfo] = []
        pk_offsets: list[int] = []
        for off, cd in enumerate(stmt.columns):
            ft = cd.ftype
            if cd.not_null or cd.primary_key:
                ft = FieldType(ft.kind, ft.flen, ft.scale, nullable=False)
            default = None
            if cd.default is not None:
                c = _literal_const(cd.default)
                default = self._decode_default(c, ft)
            col = ColumnInfo(
                id=self.catalog.alloc_id(),
                name=cd.name,
                ftype=ft,
                offset=off,
                default=default,
                is_primary=cd.primary_key,
                auto_increment=cd.auto_increment,
            )
            columns.append(col)
            if cd.primary_key:
                pk_offsets.append(off)
        indices: list[IndexInfo] = []
        for off, cd in enumerate(stmt.columns):
            if getattr(cd, "unique", False) and not cd.primary_key:
                indices.append(IndexInfo(self.catalog.alloc_id(),
                                         cd.name, [off], True, False))
        for idef in stmt.indices:
            offs = []
            for name in idef.columns:
                hit = next((c for c in columns
                            if c.name.lower() == name.lower()), None)
                if hit is None:
                    raise SQLError(f"index column {name} not found")
                offs.append(hit.offset)
            if idef.primary:
                pk_offsets.extend(offs)
                for o in offs:
                    columns[o].is_primary = True
                    ftp = columns[o].ftype
                    columns[o].ftype = FieldType(ftp.kind, ftp.flen, ftp.scale,
                                                 nullable=False)
            indices.append(IndexInfo(self.catalog.alloc_id(),
                                     idef.name or f"idx_{len(indices)}",
                                     offs, idef.unique, idef.primary))
        pk_handle = None
        if len(pk_offsets) == 1 and columns[pk_offsets[0]].ftype.is_integer:
            pk_handle = pk_offsets[0]
        elif pk_offsets and not any(ix.primary for ix in indices):
            # non-handle pk (string/composite declared at column level):
            # enforce via a primary unique index
            indices.append(IndexInfo(self.catalog.alloc_id(), "PRIMARY",
                                     list(pk_offsets), True, True))
        # FK metadata: stored, not enforced (as the reference)
        fk_infos = []
        for i, fk in enumerate(getattr(stmt, "foreign_keys", []) or []):
            offs = []
            for cn in fk.columns:
                hit = next((c for c in columns
                            if c.name.lower() == cn.lower()), None)
                if hit is None:
                    raise SQLError(f"unknown column {cn} in foreign key",
                                   errno=ER_BAD_FIELD)
                offs.append(hit.offset)
            if len(offs) != len(fk.ref_columns):
                raise SQLError(
                    "foreign key column count mismatch")
            fk_infos.append(FKInfo(
                fk.name or f"fk_{stmt.table.name}_{i + 1}", offs,
                (fk.ref_table.db or db).lower(), fk.ref_table.name,
                list(fk.ref_columns), fk.on_delete, fk.on_update))
        info = TableInfo(
            id=self.catalog.alloc_id(),
            name=stmt.table.name,
            columns=columns,
            indices=indices,
            pk_handle_offset=pk_handle,
            foreign_keys=fk_infos,
        )
        try:
            created = self.catalog.add_table(db, info, stmt.if_not_exists)
        except KeyError as e:
            raise err_wrap(SQLError, e) from None
        if created:
            self.storage.register_table(info)
        return ResultSet([], [])

    def _decode_default(self, c, ft: FieldType) -> Any:
        if c.value is None:
            return None
        if ft.is_decimal and c.ftype.is_decimal:
            return Decimal(c.value, c.ftype.scale)
        return c.value

    def _exec_drop_table(self, stmt: ast.DropTableStmt) -> ResultSet:
        for tn in stmt.tables:
            db = tn.db or self.current_db
            try:
                info = self.catalog.drop_table(db, tn.name, stmt.if_exists)
            except KeyError as e:
                raise err_wrap(SQLError, e) from None
            if info is not None:
                self.storage.unregister_table(info.id)
                self.storage.stats.drop_table(info.id)
        return ResultSet([], [])

    # ==================== EXPLAIN ====================
    def _exec_explain(self, stmt: ast.ExplainStmt) -> ResultSet:
        if not isinstance(stmt.target, (ast.SelectStmt, ast.SetOpStmt)):
            raise SQLError("EXPLAIN supports SELECT only for now")
        if stmt.analyze:
            raise NotInSlice("EXPLAIN ANALYZE")
        if self._has_var_reads(stmt.target):
            raise NotInSlice("session variables and functions")
        plan = self._plan(stmt.target)
        return ResultSet(["plan"], [(line,) for line in explain_plan(plan)])

    def _table_for(self, tn: ast.TableName) -> tuple[TableInfo, TableStore]:
        db = tn.db or self.current_db
        try:
            info = self.catalog.table(db, tn.name)
        except KeyError as e:
            raise err_wrap(SQLError, e) from None
        return info, self.storage.table_store(info.id)
