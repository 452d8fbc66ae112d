"""Session: statement lifecycle over the storage, the planner and the executor.

Port of `tidb_tpu/session/session.py`. SQL text is parsed
(`sql/parser.py`), planned exactly as the reference plans it
(`plan/builder.py`, `plan/physical.optimize`), and run by the root executor
(`executor/engine.py`), which sends every `CopDAG` and `FragmentDAG` to the
port's coprocessor. Writes take the reference's transaction path: the
memdb buffer with statement staging, percolator 2PC at commit, the
columnar fold the coprocessor reads back (`store/storage.py`).

Txn model: autocommit by default, with the reference's retry of an
autocommit statement that loses an optimistic write conflict (up to
`tidb_retry_limit`); BEGIN opens an explicit optimistic or PESSIMISTIC
txn; statement-level staging gives per-statement rollback inside a txn.

Statements: CREATE/DROP DATABASE, USE (information_schema too),
CREATE/DROP/TRUNCATE TABLE (PARTITION BY HASH or RANGE too), SELECT
(and UNION, FOR UPDATE, INTO OUTFILE), INSERT
(VALUES, SELECT, REPLACE, ON DUPLICATE KEY UPDATE), LOAD DATA, UPDATE,
DELETE, BEGIN, COMMIT, ROLLBACK, SET, EXPLAIN and EXPLAIN ANALYZE, TRACE,
ANALYZE TABLE, KILL
[QUERY|CONNECTION] (routed through the storage to the wire server that
holds the connection); the schema changes, each an online DDL job
(`ddl/ddl.py`) with an implicit commit: ALTER TABLE (ADD/DROP INDEX,
ADD/DROP/MODIFY COLUMN, RENAME, several at once), CREATE/DROP INDEX,
RENAME TABLE, ALTER TABLE ... DROP/TRUNCATE PARTITION; CREATE/DROP
VIEW, CREATE/DROP SEQUENCE with NEXTVAL, LASTVAL and SETVAL (bound once
per statement); CREATE/DROP [GLOBAL|SESSION] BINDING (`bindinfo.py`);
SHOW (TABLES, DATABASES,
CREATE TABLE/DATABASE/VIEW, COLUMNS, INDEX, TABLE STATUS, VARIABLES,
STATUS, GRANTS, PRIVILEGES, CHARSET, COLLATION, ENGINES, WARNINGS,
BINDINGS, SLOW QUERIES, PROFILES, PROFILE, METRICS),
ADMIN SHOW DDL JOBS, ADMIN CHECK TABLE and CHECKSUM TABLE; SELECTs over
information_schema (`catalog/infoschema.py`) and metrics_schema
(`catalog/metrics_schema.py`), rebuilt before the statement reads them;
the server's prepared statements (`prepare`,
`execute_prepared`, `close_prepared`). Autocommit point statements take
the fast path (`plan/fastpath.py`) and never touch the coprocessor.

The observed statement (`_execute_observed`): per-statement counters on
the storage's `Observability`, the digest record (`statements_summary`)
of single statements, the slow log over `tidb_slow_log_threshold`, and
`@@max_execution_time`: a SELECT's deadline rides the KILL QUERY
interrupt plane and ends it with 3024. The SQL-text plan cache
(`_plan_cache`, a true LRU of `tidb_plan_cache_size` entries, on with
`tidb_enable_plan_cache`) holds physical plans and point FastPlans under
the statement's text or a prepared statement's `#stmt{id}:<params>` key,
stamped with the schema version, the statistics generation and the
bindings. EXPLAIN ANALYZE runs the plan under a `RuntimeStatsColl` (a
point SELECT shows its fast path and `plan_cache:hit|miss`); TRACE runs
a SELECT or DML under a `SpanCollector`.

The observability planes, each off until configured on the storage: the
statement feeds Top SQL (stages, operator walls and bytes, the shed and
killed flags), the wait profile (a `WaitLedger` is installed for the
statement only while it is on; EXPLAIN ANALYZE's `wait_profile` cell
prints it) and the workload history (digest, engine tags, stages), each
gated on `enabled` before any digest is hashed; @@profiling samples the
statement's thread (SHOW PROFILES, SHOW PROFILE,
information_schema.profiling). The storage's governor and admission gate
(`util/governor.py`): DML admits at the DML priority and a SELECT at its
plan's (`plan_priority`), INSERT ... SELECT once; a shed raises
`AdmissionTimeout` (9003); every statement's memory tracker registers
with the governor, whose kill answers 8175.

Accounts: CREATE/DROP/ALTER/RENAME USER, GRANT and REVOKE (column grants
too), CREATE/DROP ROLE, GRANT of a role, SET DEFAULT ROLE and SET ROLE,
each over the storage's `PrivilegeManager`. A session with a `user` (the
wire server sets it at login, with the account's default roles active)
has every statement checked before it runs (`_check_privileges`, ahead of
the fast path), its plan's leaf tables checked column by column
(`_check_column_privs`), and the column lists of its INSERTs and UPDATEs
(`_check_dml_columns`); LOAD DATA and INTO OUTFILE need FILE, and
`secure_file_priv` confines their paths.

Functions: the registry builtins (`copr/funcs.py`) evaluate on the root's
rows; the statement installs `@@time_zone` for them (FROM_UNIXTIME) and
restores the previous zone when it ends. The clock (NOW, CURDATE,
CURTIME, UNIX_TIMESTAMP()) binds to literals before planning, and the
GET_LOCK family takes the storage's named locks (`UserLocks`), released
when the connection closes (`rollback_if_active`).

SHOW PROCESSLIST reads the serving `Server`'s rows (`storage.processlist`)
behind the PROCESS gate, or this session's own row in an embedded store.

Raise `NotInSlice`: every other statement kind by its kind; the
information_schema tables of planes the port does not have by their
names (`catalog/infoschema.py`).

A partitioned table's DML loops over its partitions
(`_partition_children`): INSERT (and LOAD DATA) routes each row by the
partition column, UPDATE buffers rows that move to another partition
until every partition has been scanned, and DELETE, FOR UPDATE, ANALYZE,
CHECKSUM and ADMIN CHECK visit each partition's store.

An eligible autocommit SELECT of a session whose `tidb_replica_read` is
`follower` (or with `tidb_read_staleness` below 0, or the storage's
`prefer_follower`) is routed to a follower that covers its read ts
(`rpc/replica.py` `try_route`), after the privilege check and before
admission; any staleness, term or transport trouble falls back to the
local path with a Note. EXPLAIN ANALYZE of a routed read shows one row
per plan line with the engine `replica@host:port` on the first.

Left out of the reference's statement path, with its plane: the
shard-skew warnings of the mesh.
"""

from __future__ import annotations

import copy
import os
import re
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from .. import obs
from ..catalog.schema import Catalog, ColumnInfo, FKInfo, IndexInfo, TableInfo
from ..chunk.column import _encode_scalar
from ..copr import funcs
from ..copr.client import CopClient
from ..copr.npeval import NumpyEval, _truthy
from ..errno import (ER_BAD_FIELD, ER_BAD_NULL, ER_CANT_CREATE_FILE,
                     ER_DATA_INCONSISTENT, ER_DUP_ENTRY, ER_FILE_EXISTS,
                     ER_FILE_NOT_FOUND, ER_KILL_DENIED, ER_NO_SUCH_TABLE,
                     ER_NOT_SUPPORTED_YET, ER_OPTION_PREVENTS_STATEMENT,
                     ER_PARSE_ERROR, ER_QUERY_INTERRUPTED,
                     ER_QUERY_MEM_EXCEEDED, ER_QUERY_TIMEOUT,
                     ER_SPECIFIC_ACCESS_DENIED, ER_TABLE_EXISTS,
                     ER_TABLEACCESS_DENIED, ER_TEXTFILE_NOT_READABLE,
                     ER_TIKV_SERVER_BUSY, ER_TRUNCATED_WRONG_VALUE,
                     ER_UNKNOWN_SYSTEM_VARIABLE,
                     ER_VAR_READONLY, ER_WRONG_VALUE_COUNT_ON_ROW,
                     CodedError)
from ..errno import wrap as err_wrap
from ..errors import NotInSlice
from ..executor.engine import ExecContext, run_physical
from ..plan.builder import PlanBuilder, PlanError, _literal_const
from ..plan.physical import explain_plan, optimize
from ..sql import ast
from ..sql.parser import ParseError, Parser, parse_sql
from ..store.storage import (Storage, Transaction, TxnTooLargeError,
                             WriteConflictError)
from ..store.table_store import TableStore
from ..types.field_type import FieldType, TypeKind
from ..types.value import Decimal
from ..util import interrupt

# functions whose value depends on the session or the clock: bound to
# literals before planning
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

_DML = (ast.InsertStmt, ast.UpdateStmt, ast.DeleteStmt)
# statements whose affected count is ROW_COUNT()
_ROW_COUNT_STMTS = _DML + (ast.LoadDataStmt,)

_EXPLAIN_ANALYZE_COLS = ["plan", "actRows", "time_ms", "engine", "stages",
                         "mesh", "wait_profile"]


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
        if cop is not None:
            self.storage.add_cache_client(cop)
        self._device = device
        self.txn: Optional[Transaction] = None
        self.in_explicit_txn = False
        # authenticated account (None: the internal, unchecked session;
        # the wire server sets it for an account of the grant table)
        self.user: Optional[str] = None
        self.conn_id: Optional[int] = None
        # KILL QUERY / KILL CONNECTION flag, armed per statement; the
        # engine polls it between plan nodes (util/interrupt.py)
        self.killed = threading.Event()
        # server-side prepared statements: id -> (AST, n_params)
        self._prepared: dict[int, tuple] = {}
        self._next_stmt_id = 0
        # session-scope system variable overrides + user variables
        # (reference: sessionctx/variable/session.go SessionVars)
        self.vars: dict[str, Any] = {}
        self.user_vars: dict[str, Any] = {}
        self.active_roles: set[str] = set()
        self.warnings: list[tuple[str, int, str]] = []
        self._stmt_seq = 0
        self._stmt_auto_id: Optional[int] = None
        self._found_rows = 0
        self._row_count = -1
        self._seq_lastval: Optional[int] = None
        self._is_guard = None  # held infoschema viewer lock, if any
        # last statement's attribution: stage totals ('parse',
        # 'plan_build', 'fast_plan'), exclusive wall seconds per plan
        # operator, and the engine tag of each read in call order
        self.last_stages: dict[str, float] = {}
        self.last_op_wall: dict[str, float] = {}
        self.last_engines: list[str] = []
        self._pending_parse_s = 0.0
        # the statement's working-set peak and spills (digest table,
        # slow log)
        self.last_mem_peak = 0
        self.last_spill_count = 0
        # SQL-text plan cache: key -> (invalidation gen, plan), a true
        # LRU holding physical plans and point FastPlans under the same
        # keys, the prepared-statement #stmt{id} keys included
        self._plan_cache: OrderedDict = OrderedDict()
        self._plan_cache_key: Optional[str] = None
        # did the last statement's plan come from the cache? (EXPLAIN
        # ANALYZE's point row)
        self.last_plan_from_cache = False
        self.plan_cache_hits = 0
        # SESSION-scope plan bindings (digest -> record); GLOBAL ones
        # live on the storage (`bindinfo.BindingManager`)
        self.session_bindings: dict[str, dict] = {}
        self._binding_gen = 0
        self._binding_match_sql: Optional[str] = None
        self._lpfb_next = 0
        # the single statement's own text (EXPLAIN's binding match)
        self._raw_sql: Optional[str] = None
        # single top-level SELECT text, the only shape the replica-read
        # router may forward (rpc/replica.py)
        self._route_sql: Optional[str] = None
        # set by the @@max_execution_time timer before it interrupts
        self._deadline_expired = False
        # the last statement's operator stage split, operator transfer
        # bytes and typed waits (Top SQL's feed, readable by callers)
        self.last_op_stages: dict[str, dict[str, float]] = {}
        self.last_op_bytes: dict[str, int] = {}
        self.last_waits: dict[str, float] = {}
        # @@profiling ring: per-statement sampling profiles served by
        # SHOW PROFILES / SHOW PROFILE / information_schema.profiling
        self._profiles: list[dict] = []
        self._profile_seq = 0
        # server-wide overload protection (util/governor.py): the LIVE
        # per-statement tracker root while one is registered with the
        # memory governor, the governor-kill latch telling 8175 from a
        # plain KILL's 1317, and the admission re-entrancy depth
        # (INSERT..SELECT must not buy a second execution token and
        # deadlock itself at token-limit 1)
        self._live_mem = None
        # the running statement's text and start (the governor's kill
        # label, the admission shed's event, SHOW PROCESSLIST's Info and
        # Time columns)
        self.in_flight_sql: Optional[str] = None
        self.in_flight_since: Optional[float] = None
        self._governor_killed = False
        self._admission_depth = 0
        # serializes the governor's kill callback against the
        # statement's tracker install/uninstall, so a late callback
        # cannot flag the session's NEXT statement
        self._gov_lock = threading.Lock()

    @property
    def cop(self) -> CopClient:
        """Coprocessor client, built on first use (the reference's
        `mesh.client_for`; the port has one device)."""
        if self._cop is None:
            self._cop = CopClient(self._device)
            # the keyspace heat recorder: scans account per-range traffic
            self._cop.heat = getattr(self.storage, "heat", None)
            self.storage.add_cache_client(self._cop)
        return self._cop

    def add_warning(self, message: str, code: int = 1105,
                    level: str = "Warning") -> None:
        self.warnings.append((level, code, message))

    # ==================== public API ====================
    def execute(self, sql: str) -> ResultSet:
        """Execute one or more ;-separated statements; returns the last
        statement's result."""
        if self.storage.shared:
            # multi-process deployments: catch up with the other
            # servers' commits and schema changes before planning (the
            # per-statement domain reload; Storage.refresh)
            self.storage.refresh()
        t_parse = time.perf_counter()
        try:
            stmts = parse_sql(sql)
        except ParseError as e:
            self.storage.obs.query_errors.inc()
            raise SQLError(f"parse error: {e}",
                           errno=getattr(e, 'errno', ER_PARSE_ERROR)) from None
        # parse happens before the per-statement recorder exists: the
        # first statement's recorder books it as its 'parse' stage
        self._pending_parse_s = time.perf_counter() - t_parse
        result = ResultSet([], [])
        single = len(stmts) == 1
        for i, stmt in enumerate(stmts):
            label = sql if single else \
                f"[stmt {i + 1}/{len(stmts)}] {sql}"
            # a single statement's text keys the plan cache (SELECT) and
            # the point FastPlan cache (DML); bindings match SELECT text
            is_select = single and isinstance(
                stmt, (ast.SelectStmt, ast.SetOpStmt))
            self._plan_cache_key = sql if (
                is_select or (single and isinstance(stmt, _DML))) else None
            self._binding_match_sql = sql if is_select else None
            self._raw_sql = sql if single else None
            # the replica-read router forwards SQL TEXT, so it only
            # ever routes a statement that IS its own text: a single
            # top-level SELECT (INSERT..SELECT re-enters _exec_select
            # with this unset; prepared statements carry bound ASTs,
            # not reproducible text)
            self._route_sql = sql if is_select else None
            try:
                # batch members are not digested: the batch label is no
                # statement's own text
                result = self._execute_observed(
                    stmt, label, digest_sql=sql if single else None)
            finally:
                self._plan_cache_key = None
                self._binding_match_sql = None
                self._raw_sql = None
                self._route_sql = None
        # delta-driven auto-analyze at statement boundaries (the
        # reference's stats owner loop, checked inline every 64
        # statements as the reference's single-process session does)
        self._stmt_seq += 1
        if self._stmt_seq % 64 == 0 and self.txn is None:
            self.storage.stats.auto_analyze(self.storage, self.catalog)
        return result

    def _start_deadline(self, stmt: ast.Stmt) -> Optional[threading.Timer]:
        """@@max_execution_time: a SELECT's deadline (DML is exempt, 0
        disables it) on the same interrupt plane as KILL QUERY; the
        expired statement ends at its next checkpoint with 3024."""
        if not isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt)):
            return None
        try:
            max_ms = int(self._sysvar_value("max_execution_time") or 0)
        except (TypeError, ValueError, SQLError):
            max_ms = 0
        if max_ms <= 0:
            return None

        def expire() -> None:
            self._deadline_expired = True
            self.killed.set()

        timer = threading.Timer(max_ms / 1000.0, expire)
        timer.daemon = True
        timer.start()
        return timer

    def _execute_observed(self, stmt: ast.Stmt, sql: str,
                          digest_sql: Optional[str] = None) -> ResultSet:
        """Run one statement under its own stage recorder (and, while the
        wait profile is on, its own wait ledger), with the storage's
        statement counters, the digest record, the slow log and the
        planes that are on: Top SQL, the wait profile, the workload
        history and @@profiling. The recorder's totals, operator walls,
        stage splits, bytes and engine tags become `last_stages`,
        `last_op_wall`, `last_op_stages`, `last_op_bytes` and
        `last_engines`; the ledger's totals `last_waits`."""
        o = self.storage.obs
        t0 = time.perf_counter()
        o.queries.inc(type=type(stmt).__name__.removesuffix("Stmt"))
        failed = False
        shed = False
        rows_out = 0
        # arm the per-statement kill flag (KILL QUERY clears with the
        # statement; KILL CONNECTION leaves it set and the server drops
        # the socket)
        self.killed.clear()
        self._governor_killed = False
        self.last_plan_from_cache = False
        self.last_mem_peak = 0
        self.last_spill_count = 0
        interrupt.install(self.killed)
        self._deadline_expired = False
        deadline = self._start_deadline(stmt)
        prev_rec = obs.active_stage_recorder()
        rec = obs.StageRecorder()
        # the typed wait ledger exists ONLY while the wait profile is on:
        # off, the statement path never builds or touches one
        prev_led = obs.active_wait_ledger()
        led = obs.WaitLedger() if o.waitprofile.enabled else None
        if self._pending_parse_s:
            rec.add("parse", self._pending_parse_s)
            rec.add_op_stage("(session)", "parse", self._pending_parse_s)
            self._pending_parse_s = 0.0
        # warnings reset per statement — except SHOW WARNINGS and
        # table-less SELECTs (SELECT @@warning_count, SELECT 1), which
        # MySQL defines as reading the PREVIOUS statement's list
        preserves_warnings = (
            (isinstance(stmt, ast.ShowStmt) and stmt.kind == "WARNINGS")
            or (isinstance(stmt, ast.SelectStmt) and stmt.from_ is None
                and not self._collect_table_names(stmt)))
        if not preserves_warnings:
            self.warnings = []
        self.in_flight_sql = sql[:256]
        self.in_flight_since = time.time()
        self._stmt_auto_id = None
        # route @@time_zone to the scalar-function layer for the
        # statement's duration: FROM_UNIXTIME formats in the session
        # time zone like MySQL
        try:
            tz = str(self._sysvar_value("time_zone") or "SYSTEM")
        except (TypeError, ValueError, SQLError):
            tz = "SYSTEM"
        # the TLS frames (stage recorder, wait ledger, session time zone)
        # install INSIDE the protected region and restore in the finally,
        # or the frame leaks onto this worker thread for its next
        # statement. Restoring a never-installed time zone writes None,
        # which reads as SYSTEM.
        prev_tz = None
        prof = None
        try:
            obs.install_stage_recorder(rec)
            obs.install_wait_ledger(led)
            prev_tz = funcs.install_session_time_zone(tz)
            # @@profiling: sample THIS thread's stacks for the statement
            prof = self._maybe_start_profiler(stmt)
            if isinstance(stmt, _ROW_COUNT_STMTS):
                # DML admits at the top priority class: point writes must
                # not starve behind queued analytical scans (SELECTs
                # admit in _exec_select, with the planner's estimate)
                from ..util.governor import PRI_DML
                with self._admission(PRI_DML):
                    rs = self._execute_stmt(stmt)
            else:
                rs = self._execute_stmt(stmt)
            rows_out = len(rs.rows)
            if self._stmt_auto_id is not None:
                self.vars["last_insert_id"] = self._stmt_auto_id
            # ROW_COUNT(): affected rows of the last DML, -1 otherwise
            self._row_count = rs.affected if isinstance(
                stmt, _ROW_COUNT_STMTS) else -1
            return rs
        except interrupt.QueryInterrupted:
            failed = True
            o.query_errors.inc()
            if self._governor_killed:
                # the memory governor picked this statement as the
                # heaviest cancellable one: 8175, server-scoped message
                raise SQLError(
                    "Out Of Memory Quota! [server] statement cancelled "
                    "by the memory governor: tidb-server memory usage "
                    "crossed server-memory-limit and this was the "
                    "heaviest cancellable statement",
                    errno=ER_QUERY_MEM_EXCEEDED) from None
            if self._deadline_expired:
                raise SQLError(
                    "Query execution was interrupted, maximum statement "
                    "execution time exceeded",
                    errno=ER_QUERY_TIMEOUT) from None
            raise SQLError("Query execution was interrupted",
                           errno=ER_QUERY_INTERRUPTED) from None
        except Exception as e:
            failed = True
            from ..util.governor import AdmissionTimeout
            shed = isinstance(e, AdmissionTimeout)
            o.query_errors.inc()
            raise
        finally:
            if deadline is not None:
                deadline.cancel()
            self._deadline_expired = False
            interrupt.install(None)
            obs.install_stage_recorder(prev_rec)
            obs.install_wait_ledger(prev_led)
            funcs.install_session_time_zone(prev_tz)
            self.in_flight_sql = None
            if self._is_guard is not None:
                self._is_guard.release()
                self._is_guard = None
            dt = time.perf_counter() - t0
            if prof is not None:
                self._finish_profile(prof, sql, dt)
            o.query_seconds.observe(dt)
            self.last_stages = rec.totals
            self.last_op_wall = rec.op_wall
            self.last_op_stages = rec.ops
            self.last_op_bytes = rec.op_bytes
            self.last_engines = rec.engines
            self.last_waits = led.totals if led is not None else {}
            if digest_sql is not None:
                o.statements.record(digest_sql, self.current_db, dt,
                                    rows_out, failed,
                                    mem_peak=self.last_mem_peak,
                                    spill_count=self.last_spill_count)
            try:
                thresh = float(
                    self._sysvar_value("tidb_slow_log_threshold"))
            except (TypeError, ValueError, SQLError):
                thresh = obs.DEFAULT_SLOW_THRESHOLD_MS
            slow = dt * 1e3 >= thresh
            # the planes' feeds, each gated on `enabled` HERE so a plane
            # that is off costs no digest hash and no allocation
            topsql = o.topsql
            history = self.storage.history
            hist_on = history.enabled and digest_sql is not None
            wp_on = led is not None and led.totals \
                and digest_sql is not None
            top_on = topsql.enabled and digest_sql is not None
            if slow or hist_on or wp_on or top_on:
                # the digest the statements_summary uses, so slow-log,
                # Top SQL and history entries join against the digest
                # table
                digest, norm = obs.StatementsSummary.digest(
                    digest_sql or sql)
                if hist_on:
                    history.observe(
                        digest, norm[:512], self.current_db, dt,
                        engines=rec.engines, stages=rec.totals,
                        rows=rows_out, failed=failed)
                if wp_on:
                    o.waitprofile.record(digest, norm[:512],
                                         self.current_db, dt,
                                         led.totals)
                if top_on:
                    topsql.record(
                        digest, norm[:512], self.current_db, dt,
                        stages=rec.totals, op_wall=rec.op_wall,
                        op_stages=rec.ops, op_bytes=rec.op_bytes,
                        rows=rows_out, failed=failed, shed=shed,
                        killed=self._governor_killed,
                        waits=led.totals if led is not None else None)
                if slow:
                    o.record_slow(sql, self.current_db, dt,
                                  plan_digest=digest,
                                  stages=rec.snapshot(),
                                  mem_peak=self.last_mem_peak,
                                  spill_count=self.last_spill_count,
                                  op_wall=rec.op_wall,
                                  waits=dict(led.totals)
                                  if led is not None else None)

    # ==================== statement profiling ====================
    def _maybe_start_profiler(self, stmt: ast.Stmt):
        """Start a per-statement stack sampler when @@profiling is on.
        SET and SHOW PROFILE[S] are exempt (MySQL behaves the same:
        toggling or reading profiles must not clobber the ring)."""
        if isinstance(stmt, ast.SetStmt):
            return None
        if isinstance(stmt, ast.ShowStmt) and \
                stmt.kind in ("PROFILE", "PROFILES"):
            return None
        v = self._sysvar_value("profiling")
        if str(v).upper() not in ("1", "ON", "TRUE", "YES"):
            return None
        try:
            hz = float(self._sysvar_value("tidb_profiler_sample_hz") or 97)
        except (TypeError, ValueError):
            hz = 97.0
        return obs.SamplingProfiler(
            hz=hz, thread_ids={threading.get_ident()}).start()

    def _finish_profile(self, prof, sql: str, duration_s: float) -> None:
        profile = prof.stop()
        self._profile_seq += 1
        self._profiles.append({
            "query_id": self._profile_seq,
            "sql": sql[:512],
            "duration": duration_s,
            "profile": profile,
        })
        try:
            raw = self._sysvar_value("profiling_history_size")
            cap = 15 if raw is None or raw == "" else int(raw)
        except (TypeError, ValueError, SQLError):
            cap = 15
        if cap <= 0:  # MySQL: history size 0 retains nothing
            self._profiles.clear()
        else:
            del self._profiles[:max(len(self._profiles) - cap, 0)]

    def query(self, sql: str) -> list[tuple[Any, ...]]:
        return self.execute(sql).rows

    # ==================== prepared statements ====================
    def prepare(self, sql: str) -> tuple[int, int]:
        """Server-side prepare (reference: server/conn_stmt.go
        handleStmtPrepare + planner PrepareExec): parse once, count '?'
        markers; returns (stmt_id, n_params)."""
        try:
            parser = Parser(sql)
            stmts = parser.parse()
        except ParseError as e:
            raise SQLError(f"parse error: {e}",
                           errno=getattr(e, 'errno', ER_PARSE_ERROR)) from None
        if len(stmts) != 1:
            raise SQLError("prepared statement must be a single statement")
        self._next_stmt_id += 1
        sid = self._next_stmt_id
        self._prepared[sid] = (stmts[0], parser.param_count, sql)
        return sid, parser.param_count

    def execute_prepared(self, stmt_id: int, params: list) -> ResultSet:
        """Bind parameters and run (reference: server/conn_stmt.go
        handleStmtExecute). Binding substitutes literals into a copy of
        the AST; the plan caches per (statement, bound parameters)."""
        entry = self._prepared.get(stmt_id)
        if entry is None:
            raise SQLError(f"unknown prepared statement {stmt_id}")
        stmt, n_params, raw_sql = entry
        if len(params) != n_params:
            raise SQLError(
                f"expected {n_params} parameters, got {len(params)}")
        bound = copy.deepcopy(stmt)
        if n_params:
            bound = _bind_params(bound, params)
        if isinstance(bound, (ast.SelectStmt, ast.SetOpStmt) + _DML):
            self._plan_cache_key = f"#stmt{stmt_id}:{params!r}"
        if isinstance(bound, (ast.SelectStmt, ast.SetOpStmt)):
            # bindings match on the PREPARE text: its '?' markers line up
            # with the literal-normalized binding key
            self._binding_match_sql = raw_sql
        try:
            return self._execute_observed(bound, f"EXECUTE stmt#{stmt_id}")
        finally:
            self._plan_cache_key = None
            self._binding_match_sql = None

    def close_prepared(self, stmt_id: int) -> None:
        self._prepared.pop(stmt_id, None)

    def _execute_stmt(self, stmt: ast.Stmt) -> ResultSet:
        if self.user is not None:
            self._check_privileges(stmt)
        # OLTP fast path: autocommit point SELECT/UPDATE/DELETE and
        # literal INSERT VALUES bypass the whole plan/dispatch pipeline
        # (plan/fastpath.py). Anything the recognizer rejects falls
        # through to the paths below.
        rs = self._try_fast_path(stmt)
        if rs is not None:
            return rs
        if isinstance(stmt, (ast.AlterUserStmt, ast.RenameUserStmt,
                             ast.CreateUserStmt, ast.DropUserStmt,
                             ast.GrantStmt)):
            return self._exec_account_stmt(stmt)
        if isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt)):
            rs = self._run_in_txn(lambda: self._exec_select(stmt))
            outfile = getattr(stmt, "into_outfile", None)
            if outfile is not None:
                return self._write_outfile(rs, outfile)
            return rs
        if isinstance(stmt, _DML):
            stmt = self._maybe_bind_vars(stmt)
        if isinstance(stmt, ast.InsertStmt):
            return self._run_in_txn(lambda: self._exec_insert(stmt))
        if isinstance(stmt, ast.LoadDataStmt):
            return self._run_in_txn(lambda: self._exec_load_data(stmt))
        if isinstance(stmt, ast.UpdateStmt):
            return self._run_in_txn(lambda: self._exec_update(stmt))
        if isinstance(stmt, ast.DeleteStmt):
            return self._run_in_txn(lambda: self._exec_delete(stmt))
        if isinstance(stmt, ast.KillStmt):
            self._exec_kill(stmt)
            return ResultSet([], [])
        if isinstance(stmt, ast.CreateViewStmt):
            with self.storage.ddl_section():
                return self._exec_create_view(stmt)
        if isinstance(stmt, ast.DropViewStmt):
            with self.storage.ddl_section():
                return self._exec_drop_view(stmt)
        if isinstance(stmt, ast.CreateTableStmt):
            with self.storage.ddl_section():
                return self._exec_create_table(stmt)
        if isinstance(stmt, ast.DropTableStmt):
            with self.storage.ddl_section():
                return self._exec_drop_table(stmt)
        if isinstance(stmt, ast.CreateDatabaseStmt):
            with self.storage.ddl_section():
                self.catalog.create_schema(stmt.name, stmt.if_not_exists)
                return ResultSet([], [], affected=0)
        if isinstance(stmt, ast.DropDatabaseStmt):
            with self.storage.ddl_section():
                for info in self.catalog.drop_schema(stmt.name,
                                                     stmt.if_exists):
                    self.storage.unregister_table(info.id)
                    self.storage.destroy_table_data(info.id)
                return ResultSet([], [])
        if isinstance(stmt, ast.TruncateTableStmt):
            with self.storage.ddl_section():
                return self._exec_truncate(stmt)
        if isinstance(stmt, ast.CreateSequenceStmt):
            with self.storage.ddl_section():
                return self._exec_create_sequence(stmt)
        if isinstance(stmt, ast.DropSequenceStmt):
            with self.storage.ddl_section():
                return self._exec_drop_sequence(stmt)
        if isinstance(stmt, ast.UseStmt):
            from ..catalog import infoschema as I
            from ..catalog import metrics_schema as MS
            if stmt.db.lower() == I.DB_NAME:
                I.ensure_schema(self.storage)
            elif stmt.db.lower() == MS.DB_NAME:
                MS.ensure_schema(self.storage)
            self.catalog.schema(stmt.db)  # raises if unknown
            self.current_db = stmt.db
            return ResultSet([], [])
        if isinstance(stmt, ast.BeginStmt):
            self._commit_implicit()
            mode = stmt.mode or str(
                self._sysvar_value("tidb_txn_mode") or "")
            self.txn = self.storage.begin(
                pessimistic=mode.upper() == "PESSIMISTIC")
            self.in_explicit_txn = True
            return ResultSet([], [])
        if isinstance(stmt, ast.CommitStmt):
            self._finish_txn(commit=True)
            return ResultSet([], [])
        if isinstance(stmt, ast.RollbackStmt):
            self._finish_txn(commit=False)
            return ResultSet([], [])
        if isinstance(stmt, ast.ExplainStmt):
            return self._exec_explain(stmt)
        if isinstance(stmt, ast.TraceStmt):
            return self._exec_trace(stmt)
        if isinstance(stmt, ast.ShowStmt):
            return self._exec_show(stmt)
        if isinstance(stmt, ast.SetStmt):
            return self._exec_set(stmt)
        if isinstance(stmt, ast.AnalyzeTableStmt):
            return self._exec_analyze(stmt)
        if isinstance(stmt, ast.AlterTableStmt):
            return self._exec_alter(stmt)
        if isinstance(stmt, ast.CreateIndexStmt):
            return self._exec_ddl_job("add_index", stmt.table, {
                "name": stmt.name, "columns": stmt.columns,
                "unique": stmt.unique})
        if isinstance(stmt, ast.DropIndexStmt):
            return self._exec_ddl_job("drop_index", stmt.table,
                                      {"name": stmt.name})
        if isinstance(stmt, ast.RenameTableStmt):
            for old, new in stmt.renames:
                self._exec_ddl_job("rename_table", old, {
                    "new_name": new.name,
                    "new_db": new.db or old.db or self.current_db})
            return ResultSet([], [])
        if isinstance(stmt, ast.CreateBindingStmt):
            return self._exec_create_binding(stmt)
        if isinstance(stmt, ast.DropBindingStmt):
            return self._exec_drop_binding(stmt)
        if isinstance(stmt, (ast.CreateRoleStmt, ast.DropRoleStmt,
                             ast.GrantRoleStmt, ast.SetRoleStmt,
                             ast.SetDefaultRoleStmt)):
            return self._exec_role_stmt(stmt)
        if isinstance(stmt, ast.ChecksumTableStmt):
            return self._run_in_txn(lambda: self._exec_checksum(stmt))
        if isinstance(stmt, ast.AdminStmt):
            if stmt.kind == "SHOW_DDL_JOBS":
                jobs = (list(self.storage.ddl_jobs)
                        + list(reversed(self.storage.ddl_history)))
                return ResultSet(
                    ["JOB_ID", "DB_NAME", "TABLE_NAME", "JOB_TYPE",
                     "SCHEMA_STATE", "STATE", "ERROR"],
                    [j.row() for j in jobs[:32]])
            if stmt.kind == "CHECK_TABLE":
                return self._run_in_txn(
                    lambda: self._exec_admin_check(stmt))
            raise SQLError(f"unsupported ADMIN {stmt.kind}")
        raise NotInSlice(type(stmt).__name__)

    # ==================== system / user variables ====================
    def _exec_set(self, stmt: ast.SetStmt) -> ResultSet:
        """SET handling over the sysvar registry (reference:
        executor/set.go; registry in sessionctx/variable/sysvar.go)."""
        from .sysvars import SCOPE_GLOBAL, SCOPE_SESSION, SYSVARS

        for scope, name, expr in stmt.items:
            value = self._set_value(expr)
            if scope == "USERVAR":
                self.user_vars[name] = value
                continue
            if scope == "NAMES":
                for v in ("character_set_client", "character_set_connection",
                          "character_set_results"):
                    self.vars[v] = value
                continue
            sv = SYSVARS.get(name)
            if sv is None:
                # tolerate unknown tidb_/engine-prefixed knobs (forward
                # compat); reject arbitrary unknowns like MySQL does
                if name.startswith(("tidb_", "innodb_", "sql_")):
                    if scope == "GLOBAL":
                        self._require_super()
                        self.storage.sysvars.set_global(name, value)
                    else:
                        self.vars[name] = value
                    continue
                raise SQLError(f"Unknown system variable '{name}'",
                               errno=ER_UNKNOWN_SYSTEM_VARIABLE)
            if sv.read_only:
                raise SQLError(
                    f"Variable '{name}' is a read only variable",
                    errno=ER_VAR_READONLY)
            if isinstance(expr, ast.Literal) and expr.tag == "default":
                value = sv.default
            if scope == "GLOBAL":
                if not sv.scope & SCOPE_GLOBAL:
                    raise SQLError(
                        f"Variable '{name}' is a SESSION variable and "
                        "can't be used with SET GLOBAL")
                # cluster-wide durable state: superuser only (reference:
                # SUPER/SYSTEM_VARIABLES_ADMIN requirement)
                self._require_super()
                self.storage.sysvars.set_global(name, value)
            else:
                if not sv.scope & SCOPE_SESSION:
                    raise SQLError(
                        f"Variable '{name}' is a GLOBAL variable and "
                        "should be set with SET GLOBAL")
                self.vars[name] = value
        return ResultSet([], [])

    def _set_value(self, expr: ast.Expr) -> Any:
        if isinstance(expr, ast.Literal):
            if expr.tag == "decimal":
                return Decimal(expr.value.unscaled, expr.value.scale) \
                    if hasattr(expr.value, "unscaled") else expr.value
            return expr.value
        if isinstance(expr, ast.ColumnRef):
            return expr.name  # bare ident value (utf8mb4, ON, ...)
        if isinstance(expr, ast.SysVarExpr):
            return self._sysvar_value(expr.name, expr.scope)
        if isinstance(expr, ast.UserVarExpr):
            return self.user_vars.get(expr.name)
        if isinstance(expr, ast.UnaryOp) and isinstance(
                expr.operand, ast.Literal):
            v = expr.operand.value
            return -v if expr.op == "-" else v
        raise SQLError("unsupported SET value expression")

    def _sysvar_value(self, name: str, scope: str = "SESSION") -> Any:
        from .sysvars import SYSVARS

        if name == "warning_count" and scope != "GLOBAL":
            return len(self.warnings)
        if scope != "GLOBAL" and name in self.vars:
            return self.vars[name]
        v = self.storage.sysvars.get_global(name)
        if v is None and name not in SYSVARS:
            raise SQLError(f"Unknown system variable '{name}'",
                           errno=ER_UNKNOWN_SYSTEM_VARIABLE)
        return v

    def _bind_vars(self, node):
        """Substitute @@sysvar / @user_var reads with typed literals before
        planning (the planner sees plain constants)."""

        def lit(v):
            if v is None:
                return ast.Literal(None, "null")
            if isinstance(v, bool):
                return ast.Literal(int(v), "int")
            if isinstance(v, int):
                return ast.Literal(v, "int")
            if isinstance(v, float):
                return ast.Literal(v, "float")
            return ast.Literal(str(v), "string")

        def fn(n):
            if isinstance(n, ast.SysVarExpr):
                return lit(self._sysvar_value(n.name, n.scope))
            if isinstance(n, ast.UserVarExpr):
                return lit(self.user_vars.get(n.name))
            if isinstance(n, ast.FuncCall) and n.name in _SESSION_FUNCS:
                return lit(self._session_func_value(n))
            if isinstance(n, ast.ColumnRef) and n.table is None and \
                    n.name.upper() in _NILADIC_FUNCS:
                # bare CURRENT_DATE etc. — reserved niladic functions
                return lit(self._session_func_value(
                    ast.FuncCall(n.name.upper(), [])))
            return n

        return ast.transform(node, fn)

    def _session_func_value(self, n: ast.FuncCall) -> Any:
        """Session-dependent function -> value at statement-bind time
        (reference: expression/builtin_info.go + builtin_time.go
        nondeterministic set)."""
        name = n.name
        if name in ("NOW", "CURRENT_TIMESTAMP", "SYSDATE",
                    "LOCALTIME", "LOCALTIMESTAMP"):
            return time.strftime("%Y-%m-%d %H:%M:%S")
        if name in ("CURDATE", "CURRENT_DATE"):
            return time.strftime("%Y-%m-%d")
        if name in ("CURTIME", "CURRENT_TIME"):
            return time.strftime("%H:%M:%S")
        if name == "UNIX_TIMESTAMP" and not n.args:
            return int(time.time())
        if name == "VERSION":
            return str(self._sysvar_value("version"))
        if name in ("DATABASE", "SCHEMA"):
            return self.current_db
        if name in ("USER", "CURRENT_USER", "SESSION_USER", "SYSTEM_USER"):
            return f"{self.user or 'root'}@%"
        if name == "CONNECTION_ID":
            return self.conn_id or 0
        if name == "NEXTVAL":
            if len(n.args) != 1:
                raise SQLError("NEXTVAL takes a sequence name")
            seq = self._sequence_for(n.args[0])
            try:
                v = self.storage.sequence_next(seq)
            except ValueError as e:
                raise err_wrap(SQLError, e) from None
            self._seq_lastval = v
            return v
        if name == "LASTVAL":
            return self._seq_lastval
        if name == "SETVAL":
            if len(n.args) != 2 or not isinstance(n.args[1], ast.Literal):
                raise SQLError("SETVAL takes (sequence, constant)")
            seq = self._sequence_for(n.args[0])
            v = int(n.args[1].value)
            self.storage.sequence_set(seq, v)
            return v
        if name == "LAST_INSERT_ID":
            return int(self.vars.get("last_insert_id", 0) or 0)
        if name == "FOUND_ROWS":
            return int(self._found_rows)
        if name == "ROW_COUNT":
            return int(self._row_count)
        if name == "CURRENT_ROLE":
            return ", ".join(f"`{r}`@`%`"
                             for r in sorted(self.active_roles)) or "NONE"
        if name == "TIDB_IS_DDL_OWNER":
            owner = self.storage.ddl_owner
            return int(bool(getattr(owner, "is_owner", lambda: True)()))
        if name in ("GET_LOCK", "RELEASE_LOCK", "IS_FREE_LOCK",
                    "IS_USED_LOCK", "RELEASE_ALL_LOCKS"):
            return self._user_lock_func(n)
        raise SQLError(f"unsupported function {name}")

    def _user_lock_func(self, n: ast.FuncCall) -> Any:
        """User-level named locks (reference: builtin_miscellaneous.go
        GET_LOCK family; the lock table lives on the Storage so siblings
        in one process contend correctly)."""
        me = self.conn_id or id(self)
        if n.name == "RELEASE_ALL_LOCKS":
            return self.storage.user_locks.release_all(me)
        if not n.args:
            raise SQLError(f"{n.name} takes a lock name")
        name = str(self._eval_value(n.args[0]))
        if n.name == "GET_LOCK":
            timeout = 0.0
            if len(n.args) > 1:
                # constant expression (covers unary minus: -1 = forever)
                timeout = float(self._eval_value(n.args[1]))
            return int(self.storage.user_locks.acquire(name, me, timeout))
        if n.name == "RELEASE_LOCK":
            return self.storage.user_locks.release(name, me)
        if n.name == "IS_FREE_LOCK":
            return int(self.storage.user_locks.holder(name) is None)
        return self.storage.user_locks.holder(name)  # IS_USED_LOCK

    @staticmethod
    def _has_var_reads(node) -> bool:
        """@var / @@var reads and session-dependent functions, which bind
        to literals before planning."""
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

    def _maybe_bind_vars(self, stmt, has_vars: Optional[bool] = None):
        """@var / @@var reads bind in every expression-bearing statement
        (SELECT and DML alike). `has_vars` skips re-walking the AST when
        the caller already checked."""
        if has_vars is None:
            has_vars = self._has_var_reads(stmt)
        if has_vars:
            self._guard_per_row_sequences(stmt)
            return self._bind_vars(copy.deepcopy(stmt))
        return stmt

    def _guard_per_row_sequences(self, stmt) -> None:
        """NEXTVAL binds once per statement, so any per-row context
        would hand every row the same value — reject loudly instead of
        silently duplicating ids (VALUES lists are fine: each row's
        FuncCall node binds separately)."""
        def contains_seq(node) -> bool:
            hit = False

            def v(n):
                nonlocal hit
                if isinstance(n, ast.FuncCall) and \
                        n.name in ("NEXTVAL", "SETVAL"):
                    hit = True
                    return False
                return None

            ast.walk(node, v)
            return hit

        def visit(n):
            if isinstance(n, ast.SelectStmt) and n.from_ is not None \
                    and contains_seq(n):
                raise SQLError(
                    "NEXTVAL/SETVAL in per-row contexts (SELECT with "
                    "FROM, INSERT ... SELECT) is unsupported")
            if isinstance(n, ast.UpdateStmt) and (
                    any(contains_seq(a.value) for a in n.assignments)
                    or (n.where is not None and contains_seq(n.where))):
                raise SQLError(
                    "NEXTVAL/SETVAL in UPDATE statements is "
                    "unsupported")
            if isinstance(n, ast.DeleteStmt) and n.where is not None \
                    and contains_seq(n.where):
                raise SQLError(
                    "NEXTVAL/SETVAL in DELETE is unsupported")
            if isinstance(n, ast.InsertStmt) and any(
                    contains_seq(a.value)
                    for a in getattr(n, "on_dup", []) or []):
                raise SQLError(
                    "NEXTVAL/SETVAL in ON DUPLICATE KEY UPDATE is "
                    "unsupported")
            return None

        ast.walk(stmt, visit)

    # ==================== accounts and privileges ====================
    def _require_super(self) -> None:
        if self.user is not None and not self.storage.privileges.check(
                self.user, "ALL", "*", "*", roles=self.active_roles):
            raise SQLError(
                f"Access denied; you need SUPER privilege(s) "
                f"for this operation (user '{self.user}')",
                errno=ER_SPECIFIC_ACCESS_DENIED)

    def _exec_account_stmt(self, stmt: ast.Stmt) -> ResultSet:
        """CREATE/DROP/ALTER/RENAME USER and GRANT/REVOKE over the grant
        tables (reference: executor/simple.go; mysql.user analog)."""
        from .privileges import PrivilegeError
        pm = self.storage.privileges
        if isinstance(stmt, ast.AlterUserStmt):
            target = stmt.name or self.user or "root"
            if target != (self.user or "root"):
                self._require_super()  # changing OWN password needs none
            try:
                pm.set_password(target, stmt.password)
            except PrivilegeError as e:
                if stmt.if_exists:
                    return ResultSet([], [])
                raise err_wrap(SQLError, e) from None
            return ResultSet([], [])
        self._require_super()
        try:
            if isinstance(stmt, ast.RenameUserStmt):
                pm.rename_users(stmt.pairs)
            elif isinstance(stmt, ast.CreateUserStmt):
                pm.create_user(stmt.name, stmt.password, stmt.if_not_exists)
            elif isinstance(stmt, ast.DropUserStmt):
                pm.drop_user(stmt.name, stmt.if_exists)
            else:  # GrantStmt
                db = stmt.db if stmt.db else self.current_db
                fn = pm.revoke if stmt.revoke else pm.grant
                fn(stmt.privs, db, stmt.table, stmt.user,
                   stmt.priv_cols or None)
        except PrivilegeError as e:
            raise err_wrap(SQLError, e) from None
        return ResultSet([], [])

    def _exec_role_stmt(self, stmt) -> ResultSet:
        """Role management + activation (reference:
        privilege/privileges role graph, executor/set_role;
        tests: privileges_test.go TestRole*)."""
        from .privileges import PrivilegeError
        pm = self.storage.privileges
        try:
            if isinstance(stmt, ast.CreateRoleStmt):
                self._require_super()
                pm.create_role(stmt.names, stmt.if_not_exists)
            elif isinstance(stmt, ast.DropRoleStmt):
                self._require_super()
                pm.drop_role(stmt.names, stmt.if_exists)
            elif isinstance(stmt, ast.GrantRoleStmt):
                self._require_super()
                pm.grant_roles(stmt.roles, stmt.users, stmt.revoke)
            elif isinstance(stmt, ast.SetDefaultRoleStmt):
                # users may set their OWN default roles; SUPER for others
                if any(u != (self.user or "root") for u in stmt.users):
                    self._require_super()
                # validate every user (existence AND grantedness of the
                # listed roles) before mutating any — same atomicity
                # contract as the other role mutations
                for u in stmt.users:
                    if not pm.exists(u):
                        raise SQLError(f"unknown user '{u}'",
                                       errno=ER_SPECIFIC_ACCESS_DENIED)
                    if stmt.mode == "LIST":
                        granted = pm.roles_of(u)
                        for r in stmt.roles:
                            if r not in granted:
                                raise SQLError(
                                    f"role '{r}' is not granted to "
                                    f"'{u}'",
                                    errno=ER_SPECIFIC_ACCESS_DENIED)
                for u in stmt.users:
                    pm.set_default_roles(u, stmt.mode, stmt.roles)
            else:  # SetRoleStmt: activate for THIS session
                me = self.user or "root"
                granted = pm.roles_of(me)
                if stmt.mode == "ALL":
                    self.active_roles = set(granted)
                elif stmt.mode == "NONE":
                    self.active_roles = set()
                elif stmt.mode == "DEFAULT":
                    self.active_roles = pm.default_roles(me)
                else:
                    missing = [r for r in stmt.roles if r not in granted]
                    if missing:
                        raise SQLError(
                            f"Role '{missing[0]}' has not been granted "
                            f"to '{me}'", errno=ER_SPECIFIC_ACCESS_DENIED)
                    self.active_roles = set(stmt.roles)
        except PrivilegeError as e:
            raise err_wrap(SQLError, e) from None
        return ResultSet([], [])

    # ==================== SQL plan management (bindinfo) ==================
    def _exec_create_binding(self, stmt: ast.CreateBindingStmt
                             ) -> ResultSet:
        """CREATE [GLOBAL|SESSION] BINDING. The FOR and USING statements
        must normalize alike but for their hints."""
        from .bindinfo import (binding_digest, make_record,
                               normalize_binding_sql)
        norm_orig = normalize_binding_sql(stmt.orig_sql)
        if norm_orig != normalize_binding_sql(stmt.bind_sql):
            raise SQLError(
                "create binding only supports a USING statement that "
                "differs from the original by optimizer hints")
        bs = stmt.bind_stmt
        hints = list(getattr(bs, "hints", []) or (
            bs.selects[0].hints if isinstance(bs, ast.SetOpStmt) else []))
        if stmt.scope == "GLOBAL":
            self._require_super()
            self.storage.bindings.create(
                norm_orig, stmt.bind_sql, self.current_db, hints)
        else:
            self.session_bindings[
                binding_digest(norm_orig, self.current_db)] = make_record(
                norm_orig, stmt.bind_sql, self.current_db, hints)
        self._binding_gen += 1
        return ResultSet([], [])

    def _exec_drop_binding(self, stmt: ast.DropBindingStmt) -> ResultSet:
        from .bindinfo import binding_digest, normalize_binding_sql
        norm = normalize_binding_sql(stmt.orig_sql)
        if stmt.scope == "GLOBAL":
            self._require_super()
            self.storage.bindings.drop(norm, self.current_db)
        else:
            self.session_bindings.pop(
                binding_digest(norm, self.current_db), None)
        self._binding_gen += 1
        return ResultSet([], [])

    def _apply_binding(self, stmt):
        """Hint injection for a matched binding: SESSION bindings shadow
        GLOBAL ones; the user's literals stay and only the binding's hint
        set transfers. The new @@last_plan_from_binding lands when the
        statement has run (`_exec_select`)."""
        self._lpfb_next = 0
        sql = self._binding_match_sql
        if not sql or (not self.session_bindings
                       and not self.storage.bindings.has_any()):
            return stmt
        if not int(self._sysvar_value("tidb_use_plan_baselines") or 0):
            return stmt
        from .bindinfo import binding_digest, normalize_binding_sql
        norm = normalize_binding_sql(sql)
        rec = self.session_bindings.get(
            binding_digest(norm, self.current_db)) \
            or self.storage.bindings.match(norm, self.current_db)
        if not rec or rec.get("status") != "enabled":
            return stmt
        hints = [(h[0], list(h[1])) for h in rec.get("hints", [])]
        if isinstance(stmt, ast.SetOpStmt):
            stmt.selects[0].hints = hints
        else:
            stmt.hints = hints
        self._lpfb_next = 1
        return stmt

    # ==================== LOAD DATA / INTO OUTFILE ====================
    def _require_file_priv(self, path: str) -> None:
        """Server-side file access needs the global FILE privilege, and
        secure_file_priv (when set) confines paths to that directory."""
        if self.user is not None and not self.storage.privileges.check(
                self.user, "FILE", "*", "*", roles=self.active_roles):
            raise SQLError(
                "Access denied; you need (at least one of) the FILE "
                f"privilege(s) for this operation (user '{self.user}')",
                errno=ER_SPECIFIC_ACCESS_DENIED)
        self._confine_secure_path(path)

    def _confine_secure_path(self, path: str) -> None:
        """secure_file_priv confinement (when set), applied to every
        server-side file read or write, opted-in LOAD DATA LOCAL too
        (whose read is server-side here)."""
        base = str(self._sysvar_value("secure_file_priv") or "")
        if base and not os.path.realpath(path).startswith(
                os.path.realpath(base) + os.sep):
            raise SQLError(
                "The MySQL server is running with the "
                "--secure-file-priv option so it cannot execute this "
                "statement", errno=ER_OPTION_PREVENTS_STATEMENT)

    def _exec_load_data(self, stmt: ast.LoadDataStmt) -> ResultSet:
        """LOAD DATA INFILE: parse the file on the host, then feed the
        rows through the transactional insert path, so duplicate checks,
        partition routing and indexes all apply."""
        if stmt.local and not self._sysvar_value("local_infile"):
            # without the local_infile opt-in LOCAL keeps the typed
            # rejection: reading a SERVER-side path under the LOCAL
            # spelling would hand FILE-less users the server's files
            raise SQLError(
                "LOAD DATA LOCAL INFILE is not supported (enable the "
                "local_infile system variable / local-infile config to "
                "accept it); use server-side LOAD DATA INFILE",
                errno=ER_NOT_SUPPORTED_YET)
        info, _ = self._table_for(stmt.table)
        col_order = self._insert_columns(info, stmt.columns)
        path = stmt.fmt.path
        if not stmt.local:
            self._require_file_priv(path)
        else:
            # opted-in LOCAL reads a server-side path here, so an
            # authenticated user brings FILE or a configured
            # secure_file_priv confinement
            confined = bool(
                str(self._sysvar_value("secure_file_priv") or ""))
            if not confined and self.user is not None and \
                    not self.storage.privileges.check(
                        self.user, "FILE", "*", "*",
                        roles=self.active_roles):
                raise SQLError(
                    "LOAD DATA LOCAL INFILE reads a server-side path "
                    "on this server; grant FILE or set "
                    "secure_file_priv to confine it",
                    errno=ER_SPECIFIC_ACCESS_DENIED)
            self._confine_secure_path(path)
        if not os.path.isfile(path):
            raise SQLError(f"File '{path}' not found",
                           errno=ER_FILE_NOT_FOUND)
        try:
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                text = f.read()
        except OSError as e:
            raise SQLError(f"Can't read file '{path}': {e}",
                           errno=ER_TEXTFILE_NOT_READABLE) from None
        records = _parse_load_file(text, stmt.fmt)[stmt.ignore_lines:]
        ftypes = [info.columns[off].ftype for off in col_order]
        rows = [[_load_convert(ft, fields[i] if i < len(fields) else None)
                 for i, ft in enumerate(ftypes)] for fields in records]
        shim = ast.InsertStmt(stmt.table, stmt.columns,
                              is_replace=stmt.dup_mode == "replace")
        # LOCAL cannot abort a half-streamed file: duplicates degrade to
        # IGNORE unless REPLACE was given
        ignore = stmt.dup_mode == "ignore" or (
            stmt.local and stmt.dup_mode != "replace")
        return self._exec_insert(shim, rows_override=rows,
                                 load_ignore=ignore)

    def _write_outfile(self, rs: ResultSet, fmt) -> ResultSet:
        """SELECT ... INTO OUTFILE; refuses to overwrite, like MySQL."""
        self._require_file_priv(fmt.path)
        if os.path.exists(fmt.path):
            raise SQLError(f"File '{fmt.path}' already exists",
                           errno=ER_FILE_EXISTS)
        esc, enc = fmt.escaped, fmt.enclosed
        specials = {esc or "", enc or "",
                    fmt.field_term[:1], fmt.line_term[:1]}
        specials.discard("")

        def render(v) -> str:
            if v is None:
                return esc + "N" if esc else "NULL"
            s = _outfile_text(v)
            if esc:
                s = "".join(esc + c if c in specials else c for c in s)
            return enc + s + enc if enc else s

        lines = [fmt.field_term.join(render(v) for v in row)
                 for row in rs.rows]
        body = fmt.line_term.join(lines)
        if lines:
            body += fmt.line_term
        try:
            with open(fmt.path, "x", encoding="utf-8") as f:
                f.write(body)
        except OSError as e:
            raise SQLError(f"Can't create file '{fmt.path}': {e}",
                           errno=ER_CANT_CREATE_FILE) from None
        return ResultSet([], [], affected=len(rs.rows))

    @staticmethod
    def _collect_table_names(stmt) -> list[ast.TableName]:
        out: list[ast.TableName] = []

        def visit(n):
            if isinstance(n, ast.TableName):
                out.append(n)
                return False
            return None

        ast.walk(stmt, visit)
        return out

    _STMT_PRIV = {
        ast.InsertStmt: "INSERT", ast.UpdateStmt: "UPDATE",
        ast.DeleteStmt: "DELETE", ast.CreateTableStmt: "CREATE",
        ast.DropTableStmt: "DROP", ast.TruncateTableStmt: "DROP",
        ast.AlterTableStmt: "ALTER", ast.CreateIndexStmt: "INDEX",
        ast.DropIndexStmt: "INDEX", ast.RenameTableStmt: "ALTER",
        ast.CreateDatabaseStmt: "CREATE", ast.DropDatabaseStmt: "DROP",
        ast.CreateViewStmt: "CREATE", ast.DropViewStmt: "DROP",
        ast.LoadDataStmt: "INSERT",
    }

    def _check_column_privs(self, plan) -> None:
        """Column-scope SELECT enforcement (mysql.columns_priv analog):
        the physical plan's scan leaves carry the PRUNED column sets,
        i.e. exactly what the query touches per table (reference:
        privilege columns checked at resolution, planner visitInfo +
        privileges/cache.go columnsPriv)."""
        if self.user is None:
            return
        pm = self.storage.privileges
        if not pm.has_col_grants(self.user, self.active_roles):
            return  # hot path: no column-scoped grants anywhere
        from ..plan.fragment import PhysFragmentRead
        from ..plan.physical import (PhysIndexMerge, PhysPointGet,
                                     PhysTableRead)

        def leaf_tables(p):
            if isinstance(p, PhysTableRead) and p.table is not None:
                yield p.table, p.dag.scan.col_offsets
            elif isinstance(p, (PhysPointGet, PhysIndexMerge)):
                yield p.table, p.col_offsets
            elif isinstance(p, PhysFragmentRead):
                for t in p.frag.tables:
                    yield t.table, t.col_offsets
            for c in getattr(p, "children", ()) or ():
                yield from leaf_tables(c)

        def db_of(info) -> str:
            for s in self.catalog.schemas.values():
                t = s.tables.get(info.name.lower())
                if t is not None and t.id == info.id:
                    return s.name
            return self.current_db

        for info, offsets in leaf_tables(plan):
            names = [info.columns[o].name for o in offsets
                     if o < len(info.columns)]
            denied = pm.check_columns(self.user, "SELECT", db_of(info),
                                      info.name, names,
                                      roles=self.active_roles)
            if denied is not None:
                raise SQLError(
                    f"SELECT command denied to user '{self.user}' for "
                    f"column '{denied}' in table '{info.name}'",
                    errno=ER_TABLEACCESS_DENIED)

    def _check_dml_columns(self, tn: ast.TableName, info, priv: str,
                           names: list[str]) -> None:
        if self.user is None:
            return
        db = tn.db or self.current_db
        denied = self.storage.privileges.check_columns(
            self.user, priv, db, info.name, names,
            roles=self.active_roles)
        if denied is not None:
            raise SQLError(
                f"{priv} command denied to user '{self.user}' for "
                f"column '{denied}' in table '{info.name}'",
                errno=ER_TABLEACCESS_DENIED)

    def _check_privileges(self, stmt: ast.Stmt) -> None:
        """Statement-level grant checks before planning (reference:
        visitInfo checks at planner/optimize.go:246)."""
        pm = self.storage.privileges

        def deny(priv: str, obj: str):
            raise SQLError(
                f"{priv} command denied to user '{self.user}' "
                f"for table '{obj}'", errno=ER_TABLEACCESS_DENIED)

        if isinstance(stmt, ast.TraceStmt):
            # TRACE runs the target for real: same checks as running it
            self._check_privileges(stmt.target)
            return
        if isinstance(stmt, (ast.SelectStmt, ast.SetOpStmt,
                             ast.ExplainStmt, ast.AnalyzeTableStmt,
                             ast.ChecksumTableStmt)):
            # CHECKSUM fingerprints content: same SELECT requirement
            for tn in self._collect_table_names(stmt):
                db = tn.db or self.current_db
                if not pm.check(self.user, "SELECT", db, tn.name,
                                roles=self.active_roles):
                    deny("SELECT", f"{db}.{tn.name}")
            return
        priv = self._STMT_PRIV.get(type(stmt))
        if priv is None:
            return  # txn control, SET, SHOW, USE, admin: unchecked
        if isinstance(stmt, (ast.CreateDatabaseStmt, ast.DropDatabaseStmt)):
            if not pm.check(self.user, priv, stmt.name, "*",
                            roles=self.active_roles):
                deny(priv, stmt.name)
            return
        # the DML privilege applies to the statement's TARGET table;
        # every other referenced table (subqueries, INSERT..SELECT
        # sources) needs SELECT
        target = getattr(stmt, "table", None)
        for tn in self._collect_table_names(stmt):
            db = tn.db or self.current_db
            need = priv if (tn is target or target is None) else "SELECT"
            if not pm.check(self.user, need, db, tn.name,
                            roles=self.active_roles):
                deny(need, f"{db}.{tn.name}")

    # ==================== information_schema ====================
    # the served tables whose rows depend on the reader (the reference's
    # cluster_processlist is not served)
    _VIEWER_SENSITIVE_IS = frozenset({"processlist", "user_privileges",
                                      "profiling"})

    def _refresh_infoschema(self, stmt) -> None:
        """Rebuild any information_schema tables this statement touches
        from the live catalog (reference: infoschema memtables are served
        from the InfoSchema snapshot, executor/infoschema_reader.go).

        Viewer-sensitive tables (PROCESSLIST visibility, USER_PRIVILEGES
        scope) materialize per-viewer content into the SHARED store, so
        refresh+scan must be exclusive: another session's refresh
        between ours and our scan would serve us its view (or ours to
        it). The statement holds storage.infoschema_lock until it
        finishes (_execute_observed releases)."""
        from ..catalog import infoschema as I
        from ..catalog import metrics_schema as MS

        names: set[str] = set()
        ms_names: set[str] = set()
        for tn in self._collect_table_names(stmt):
            db = (tn.db or self.current_db).lower()
            if db == I.DB_NAME:
                names.add(tn.name.lower())
            elif db == MS.DB_NAME:
                ms_names.add(tn.name.lower())
        if ms_names:
            # the metric-family memtables (one per registered family;
            # not viewer-sensitive, so no infoschema lock)
            MS.refresh(self.storage, ms_names)
        if not names:
            return
        if names & self._VIEWER_SENSITIVE_IS and self._is_guard is None:
            # bounded: a statement stuck on row locks while holding this
            # would otherwise stall every sibling's read for its whole
            # duration
            lock = self.storage.infoschema_lock
            if not lock.acquire(timeout=10.0):
                raise SQLError(
                    "information_schema busy; try again",
                    errno=ER_TIKV_SERVER_BUSY)
            self._is_guard = lock
        I.refresh(self.storage, names, viewer=self)

    # ==================== ANALYZE ====================
    def _exec_analyze(self, stmt: ast.AnalyzeTableStmt) -> ResultSet:
        """ANALYZE TABLE: statistics from a fresh snapshot; columns of
        tables from 2M rows up take the coprocessor's device pass."""
        self._commit_implicit()
        for tn in stmt.tables:
            info, _ = self._table_for(tn)
            for child, store in self._partition_children(info):
                self.storage.stats.analyze_one(child, store, self.storage,
                                               cop=self.cop)
        return ResultSet([], [])

    # ==================== txn plumbing ====================
    def _ensure_txn(self) -> Transaction:
        if self.txn is None:
            self.txn = self.storage.begin()
        return self.txn

    def _run_in_txn(self, fn):
        """One statement in the session txn; autocommit statements that
        lose an optimistic write conflict re-execute at a fresh start_ts
        up to tidb_retry_limit times (reference: session.go:690
        retryable auto-commit retry — explicit txns never auto-retry)."""
        retries = 0
        if not self.in_explicit_txn and self.txn is None:
            try:
                retries = int(self._sysvar_value("tidb_retry_limit") or 0)
            except (TypeError, ValueError):
                retries = 0
        for attempt in range(retries + 1):
            txn = self._ensure_txn()
            stage = txn.memdb.staging()
            guards_before = set(txn.guard_keys)
            try:
                result = fn()
            except Exception:
                txn.memdb.cleanup(stage)
                # unwind unique-guard claims with the staged rows: a
                # failed statement must not leave LOCK markers on values
                # it never wrote
                txn.guard_keys = guards_before
                if not self.in_explicit_txn:
                    self._finish_txn(commit=False)
                raise
            txn.memdb.release(stage)
            if self.in_explicit_txn:
                return result
            try:
                self._finish_txn(commit=True)
            except SQLError as e:
                if attempt < retries and "write conflict" in str(e):
                    continue  # fresh ts, statement re-executes
                raise
            return result

    def _exec_kill(self, stmt) -> None:
        """Route KILL to the server that holds the connection (reference:
        server/server.go:548 Kill)."""
        storage = self.storage
        # ownership check (reference: server.go Kill — SuperPriv OR the
        # target belongs to the same user; MySQL types the refusal as
        # ER_KILL_DENIED 1095, not a generic privilege error)
        if self.user is not None and stmt.conn_id != self.conn_id \
                and not storage.privileges.check(
                    self.user, "ALL", "*", "*", roles=self.active_roles):
            owner_of = getattr(storage, "conn_owner", None)
            owner = owner_of(stmt.conn_id) if owner_of is not None \
                else None
            if owner != self.user:
                raise SQLError(
                    f"You are not owner of thread {stmt.conn_id}",
                    errno=ER_KILL_DENIED)
        coord = storage.coord
        if coord is not None:
            # a global id carries its server's node id: another
            # server's connection is killed through the mailbox
            nid, _local = coord.split_conn_id(stmt.conn_id)
            if nid != coord.node_id:
                coord.post_kill(stmt.conn_id, stmt.query_only)
                return
        router = getattr(storage, "kill_router", None)
        if router is None or not router(stmt.conn_id, stmt.query_only):
            raise SQLError(f"Unknown thread id: {stmt.conn_id}")

    def rollback_if_active(self) -> None:
        """Abandon any open transaction (connection teardown path).
        Also releases the session's GET_LOCK user locks (MySQL frees
        them on connection exit)."""
        if self.txn is not None:
            self._finish_txn(commit=False)
        self.storage.user_locks.release_all(self.conn_id or id(self))

    def _commit_implicit(self) -> None:
        if self.txn is not None and not self.in_explicit_txn:
            self._finish_txn(commit=True)

    def _finish_txn(self, commit: bool) -> None:
        if self.txn is None:
            self.in_explicit_txn = False
            return
        txn, self.txn = self.txn, None
        self.in_explicit_txn = False
        if commit:
            try:
                txn.commit()
            except (WriteConflictError, TxnTooLargeError) as e:
                raise err_wrap(SQLError, e) from None
        else:
            txn.rollback()

    def _exec_ctx(self, stats=None) -> ExecContext:
        """ExecContext with the session's memory quota attached. The
        root tracker also registers with the storage's memory governor
        for the statement's lifetime, so a server crossing its memory
        limit can pick (and kill) the heaviest statement;
        ExecContext.close() unregisters."""
        from ..util.memory import MemTracker

        quota = int(self._sysvar_value("tidb_mem_quota_query") or 0)
        action = str(self._sysvar_value("tidb_mem_oom_action") or "SPILL")
        mem = MemTracker("query", quota, action=action.upper())
        ctx = ExecContext(self._ensure_txn(), self.cop, stats=stats,
                          mem=mem)
        gov = self.storage.governor
        # install the tracker BEFORE registering: register() runs a
        # pressure check at once, and a kill it issues calls back into
        # _governor_kill, whose tracker-identity guard must see it
        with self._gov_lock:
            self._live_mem = mem
        token = gov.register(
            mem, kill=lambda: self._governor_kill(mem),
            label=(self.in_flight_sql or "")[:256],
            conn_id=self.conn_id or 0)

        def _release() -> None:
            gov.unregister(token)
            with self._gov_lock:
                if self._live_mem is mem:
                    self._live_mem = None

        ctx.on_close = _release
        return ctx

    def _governor_kill(self, mem) -> None:
        """Kill callback the memory governor invokes (from the thread
        that tripped the limit): flip the latch that types the error as
        8175 and set the statement's interrupt flag, which the engine
        polls between plan nodes, as KILL QUERY's. Guarded by tracker
        identity under the session's governor lock: a callback that
        arrives after the picked statement finished is a no-op."""
        with self._gov_lock:
            if self._live_mem is not mem:
                return  # the picked statement already completed
            self._governor_killed = True
            self.killed.set()

    @contextmanager
    def _admission(self, priority: int):
        """Hold an execution token for the duration (no-op when the gate
        is unlimited or this statement already holds one: INSERT ..
        SELECT re-enters through _exec_select and must not buy a second
        token). AdmissionTimeout (errno 9003) propagates to the client
        as the typed "server busy" shed."""
        if self._admission_depth > 0:
            yield
            return
        self._admission_depth += 1
        try:
            with self.storage.admission.admit(
                    priority, info={"conn_id": self.conn_id or 0,
                                    "sql": self.in_flight_sql or ""}):
                yield
        finally:
            self._admission_depth -= 1

    # ==================== SELECT ====================
    def _exec_select(self, stmt: ast.SelectStmt) -> ResultSet:
        # var reads must be detected BEFORE binding substitutes them with
        # literals, or the cache would freeze the first-seen values
        has_vars = self._has_var_reads(stmt)
        stmt = self._maybe_bind_vars(stmt, has_vars)
        stmt = self._apply_binding(stmt)
        self._refresh_infoschema(stmt)
        ctx = None
        try:
            from ..util.governor import PRI_DML, plan_priority
            # a locking read admits BEFORE taking row locks (locks then
            # queue would invert against DML's admit then lock); FOR
            # UPDATE is DML-class anyway
            outer = self._admission(PRI_DML) \
                if getattr(stmt, "for_update", False) else nullcontext()
            with outer:
                if getattr(stmt, "for_update", False):
                    self._lock_for_update(stmt)
                with obs.stage("plan_build",
                               span_name="planner.optimize"):
                    plan = self._plan_cached(stmt, uncacheable=has_vars)
                self._check_column_privs(plan)
                # follower read tier: an eligible snapshot read may be
                # served by a replica whose closed ts covers our
                # read_ts (rpc/replica.py). Routed BEFORE admission —
                # the gate bounds LOCAL execution, and an offloaded
                # read must not consume a leader token. Privileges were
                # checked above; on any staleness/term/transport
                # trouble try_route returns None and the unchanged
                # local path below answers.
                from ..rpc import replica as _replica
                routed = _replica.try_route(
                    self, stmt, self._route_sql, has_vars,
                    expect_cols=len(plan.schema.fields))
                if routed is not None:
                    names = [f.name for f in plan.schema.fields]
                    ftypes = [f.ftype for f in plan.schema.fields]
                    self._found_rows = len(routed.rows)
                    self.vars["last_plan_from_binding"] = self._lpfb_next
                    return ResultSet(names, routed.rows,
                                     column_types=ftypes)
                # execution admission: priority from the planner's
                # estimate; a no-op when already admitted above
                with self._admission(plan_priority(plan)):
                    ctx = self._exec_ctx()
                    try:
                        chunk = run_physical(plan, ctx)
                    finally:
                        ctx.close()
        finally:
            # always clear the per-statement read-ts override — a plan
            # error after FOR UPDATE locking must not leak for_update_ts
            # into later statements' snapshots
            if self.txn is not None:
                self.txn.stmt_read_ts = None
            if ctx is not None:
                self.last_mem_peak = ctx.mem.peak_footprint()
                self.last_spill_count = ctx.mem.spill_count
        # @@last_plan_from_binding describes the previous statement: it
        # lands when this one has run
        self.vars["last_plan_from_binding"] = self._lpfb_next
        self._found_rows = chunk.num_rows  # FOUND_ROWS()
        names = [f.name for f in plan.schema.fields]
        ftypes = [f.ftype for f in plan.schema.fields]
        if not chunk.columns:
            return ResultSet(names, [], column_types=ftypes)
        return ResultSet(names, chunk.to_pylist(), column_types=ftypes)

    def _lock_for_update(self, stmt: ast.SelectStmt) -> None:
        """SELECT ... FOR UPDATE row locks. Only pessimistic transactions
        take locks; optimistic ones keep commit-time conflict detection
        (the reference behaves the same)."""
        txn = self._ensure_txn()
        if not txn.pessimistic or stmt.from_ is None:
            return
        if not isinstance(stmt.from_, ast.TableName):
            raise SQLError(
                "FOR UPDATE supports single-table queries only")
        info, _ = self._table_for(stmt.from_)
        for child, _store in self._partition_children(info):
            self._pessimistic_scan(child, stmt.from_, stmt.where, txn)

    def _plan(self, stmt: ast.SelectStmt):
        try:
            logical = PlanBuilder(self.catalog, self.current_db).build_select(
                stmt)
            return optimize(logical, self.storage.stats)
        except PlanError as e:
            raise err_wrap(SQLError, e) from None

    # ==================== the plan cache ====================
    def _plan_cache_gen(self) -> tuple:
        """Invalidation generation every cache entry is stamped with: the
        schema version, the statistics generation, the database and both
        scopes' bindings."""
        return (self.catalog.version, self.storage.stats.generation,
                self.current_db, self._binding_gen,
                self.storage.bindings.fingerprint())

    def _plan_cache_enabled(self) -> bool:
        try:
            return bool(int(self._sysvar_value("tidb_enable_plan_cache")
                            or 0))
        except (TypeError, ValueError):
            return False

    def _plan_cache_hit(self, key: str) -> None:
        self._plan_cache.move_to_end(key)
        self.plan_cache_hits += 1
        self.last_plan_from_cache = True
        self.storage.obs.plan_cache_hits.inc()

    def _plan_cache_put(self, key: str, gen: tuple, plan) -> None:
        """Insert as most recent; evict the least recently used past
        `tidb_plan_cache_size`."""
        cache = self._plan_cache
        if key in cache:
            cache.move_to_end(key)
        cache[key] = (gen, plan)
        try:
            cap = int(self._sysvar_value("tidb_plan_cache_size") or 128)
        except (TypeError, ValueError):
            cap = 128
        evict = self.storage.obs.plan_cache_evictions
        while len(cache) > max(cap, 1):
            cache.popitem(last=False)
            evict.inc()

    def _plan_cached(self, stmt: ast.SelectStmt, uncacheable: bool = False):
        """Plan through the SQL-text plan cache when the statement is
        cache-safe (no @@var reads, no FOR UPDATE) and the cache is on."""
        from ..plan.fastpath import FastPlan

        key = self._plan_cache_key
        if (key is None or uncacheable or not self._plan_cache_enabled()
                or getattr(stmt, "for_update", False)):
            return self._plan(stmt)
        gen = self._plan_cache_gen()
        entry = self._plan_cache.get(key)
        if entry is not None and entry[0] == gen \
                and not isinstance(entry[1], FastPlan):
            # (a FastPlan under this key was cached by the point path;
            # replan physically rather than mis-execute)
            self._plan_cache_hit(key)
            return entry[1]
        self.storage.obs.plan_cache_misses.inc()
        plan = self._plan(stmt)
        self._plan_cache_put(key, gen, plan)
        return plan

    def _fast_plan_cached(self, stmt: ast.Stmt):
        """Recognize (or fetch the cached) FastPlan for this statement,
        in the same LRU and counters as the physical plans; the keys
        embed the literals, so a cached FastPlan replays exactly."""
        from ..plan import fastpath

        key = self._plan_cache_key
        use_cache = key is not None and self._plan_cache_enabled()
        gen = None
        if use_cache:
            gen = self._plan_cache_gen()
            entry = self._plan_cache.get(key)
            if entry is not None and entry[0] == gen and \
                    isinstance(entry[1], fastpath.FastPlan):
                self._plan_cache_hit(key)
                return entry[1]
        fp = fastpath.try_plan(self, stmt)
        if fp is not None and use_cache:
            self.storage.obs.plan_cache_misses.inc()
            # ad-hoc point writes embed their literals and would evict
            # the recurring SELECT plans: only prepared keys and SELECT
            # texts take a slot
            if key.startswith("#stmt") or isinstance(stmt, ast.SelectStmt):
                self._plan_cache_put(key, gen, fp)
        return fp

    # ==================== OLTP point fast path ====================
    def _fast_path_eligible(self, stmt: ast.Stmt) -> bool:
        """Session-state half of the TryFastPlan gate, shared by statement
        execution and EXPLAIN ANALYZE."""
        if self.in_explicit_txn or self.txn is not None:
            return False  # explicit txns keep the planned read/lock paths
        if self.user is not None:
            return False
        if not isinstance(stmt, (ast.SelectStmt, ast.InsertStmt,
                                 ast.UpdateStmt, ast.DeleteStmt)):
            return False
        if isinstance(stmt, ast.SelectStmt):
            if self.session_bindings or self.storage.bindings.has_any():
                return False  # a binding could redirect this exact text
            try:
                if str(self._sysvar_value("tidb_replica_read")
                       or "leader").lower() != "leader":
                    # the operator asked reads to offload to followers;
                    # routing preference beats the local bypass
                    return False
            except SQLError:
                pass
        try:
            return bool(int(
                self._sysvar_value("tidb_enable_fast_path") or 0))
        except (TypeError, ValueError):
            return False

    def _try_fast_path(self, stmt: ast.Stmt) -> Optional[ResultSet]:
        """TryFastPlan gate: point statements execute straight against
        the KV/MVCC layer — no planner, no ExecContext, no coprocessor.
        Returns None whenever the statement (or session state) is not
        point-shaped; the caller's slow path answers everything else."""
        if not self._fast_path_eligible(stmt):
            return None
        from ..plan import fastpath
        with obs.stage("fast_plan"):
            fp = self._fast_plan_cached(stmt)
        if fp is None:
            return None
        obs.note_engine("point")
        return fastpath.execute(self, fp)

    # ==================== DML ====================
    def _exec_insert(self, stmt: ast.InsertStmt,
                     rows_override: Optional[list[list[Any]]] = None,
                     load_ignore: bool = False) -> ResultSet:
        """INSERT (and LOAD DATA, whose parsed rows come in
        `rows_override`; `load_ignore` skips duplicates)."""
        info, store = self._table_for(stmt.table)
        col_order = self._insert_columns(info, stmt.columns)
        self._check_dml_columns(
            stmt.table, info, "INSERT",
            [info.columns[o].name for o in col_order])
        txn = self._ensure_txn()

        rows: list[list[Any]] = []
        if rows_override is not None:
            rows = rows_override
        elif stmt.select is not None:
            sub = self._exec_select(stmt.select)
            rows = [list(r) for r in sub.rows]
        else:
            for value_row in stmt.rows:
                if len(value_row) != len(col_order):
                    raise SQLError("column count doesn't match value count",
                                   errno=ER_WRONG_VALUE_COUNT_ON_ROW)
                rows.append([self._eval_value(e) for e in value_row])

        # pessimistic txns lock + duplicate-check at the latest committed
        # view (a concurrent INSERT of the same key surfaces as a
        # duplicate here instead of a conflict at commit)
        from ..kv import tablecodec

        if txn.pessimistic:
            txn.stmt_read_ts = txn.refresh_for_update_ts()
        timeout = float(
            self._sysvar_value("innodb_lock_wait_timeout") or 50)
        part = getattr(info, "partition", None)
        children = {c.id: (c, s) for c, s in
                    self._partition_children(info)}
        checkers: dict[int, _UniqueChecker] = {}

        def checker_for(tid: int) -> _UniqueChecker:
            if tid not in checkers:
                cinfo, cstore = children[tid]
                checkers[tid] = _UniqueChecker(cinfo, cstore, txn)
            return checkers[tid]

        try:
            count = 0
            for rv in rows:
                if len(rv) != len(col_order):
                    raise SQLError("column count doesn't match value count",
                                   errno=ER_WRONG_VALUE_COUNT_ON_ROW)
                full = self._complete_row(info, col_order, rv, store)
                handle = self._row_handle(info, full, store)
                enc = store.encode_row(full)
                if part is not None:
                    # route by partition column (reference:
                    # table/tables/partition.go locatePartition); unique
                    # keys include the partition column, so duplicate
                    # checks stay within the target partition
                    try:
                        tid = part.route(enc[part.col_offset]).id
                    except ValueError as e:
                        raise err_wrap(SQLError, e) from None
                else:
                    tid = info.id
                tinfo = children[tid][0]
                if txn.pessimistic:
                    # lock the new record key AND every unique-index key
                    # this row claims, so a concurrent insert of the same
                    # UNIQUE value serializes behind us; after any wait,
                    # re-check duplicates at a fresh view
                    from ..kv.backoff import (BO_TXN_CONFLICT, BO_TXN_LOCK,
                                              Backoffer, BackoffExhausted)
                    from ..kv.mvcc import WriteConflictError as KVConflict
                    lock_keys = [tablecodec.record_key(tid, handle)]
                    lock_keys += self._unique_lock_keys(tinfo, enc)
                    bo = Backoffer(budget_ms=int(timeout * 1000))
                    while True:
                        t0_lock = time.monotonic()
                        try:
                            waited = self.storage.pessimistic_lock_keys(
                                txn, lock_keys, timeout)
                        except KVConflict:
                            # a commit landed past our for_update_ts:
                            # EVERY cached checker's snapshot is stale
                            txn.stmt_read_ts = txn.refresh_for_update_ts()
                            checkers.clear()
                            try:
                                blocked = time.monotonic() - t0_lock
                                if blocked > 0.001:
                                    bo.charge(BO_TXN_LOCK, blocked)
                                bo.sleep(BO_TXN_CONFLICT)
                            except BackoffExhausted as e:
                                raise err_wrap(SQLError, e) from None
                            continue
                        except (Storage.DeadlockError,
                                Storage.LockWaitTimeout) as e:
                            raise err_wrap(SQLError, e) from None
                        if waited:
                            txn.stmt_read_ts = txn.refresh_for_update_ts()
                            checkers.clear()
                            blocked = time.monotonic() - t0_lock
                            if blocked > 0.001:
                                try:
                                    bo.charge(BO_TXN_LOCK, blocked)
                                except BackoffExhausted as e:
                                    raise err_wrap(SQLError, e) from None
                        checker = checker_for(tid)
                        conflicts = checker.conflicts(handle, enc)
                        # REPLACE deletes its victims and ON DUPLICATE
                        # updates the first one: both write rows they
                        # didn't insert, so those record keys need locks
                        if not (conflicts
                                and (stmt.is_replace or stmt.on_dup)):
                            break
                        victims = [tablecodec.record_key(tid, h)
                                   for h in conflicts
                                   if tablecodec.record_key(tid, h)
                                   not in txn.locked_keys]
                        if not victims:
                            break
                        lock_keys = victims  # lock them, then re-check
                        try:
                            bo.sleep(BO_TXN_CONFLICT)
                        except BackoffExhausted as e:
                            raise err_wrap(SQLError, e) from None
                else:
                    checker = checker_for(tid)
                    conflicts = checker.conflicts(handle, enc)
                if conflicts:
                    if load_ignore:
                        continue  # LOAD DATA IGNORE: skip the row
                    if stmt.on_dup:
                        count += self._apply_on_dup(
                            stmt, info, tinfo, tid, store, txn, checker,
                            conflicts[0], full)
                        continue  # the new row itself is not inserted
                    if not stmt.is_replace:
                        raise SQLError(
                            checker.dup_message(handle, enc, conflicts),
                            errno=ER_DUP_ENTRY)
                    for h in conflicts:
                        txn.delete_row(tid, h)
                        checker.note_delete(h)
                    count += len(conflicts)  # MySQL: replaced rows count 2x
                if not txn.pessimistic:
                    # claim the unique values as lock-only guard keys so
                    # a CONCURRENT optimistic insert of the same value
                    # collides at 2PC prewrite instead of both committing
                    txn.guard_keys.update(
                        self._unique_lock_keys(tinfo, enc))
                txn.set_row(tid, handle, enc)
                checker.note_insert(handle, enc)
                count += 1
            return ResultSet([], [], affected=count)
        finally:
            txn.stmt_read_ts = None

    def _apply_on_dup(self, stmt, info, tinfo, tid: int, store, txn,
                      checker, handle: int, full: list) -> int:
        """ON DUPLICATE KEY UPDATE: update the first conflicting row
        with the assignment list; VALUES(col) refers to the would-be
        inserted row (reference: executor/insert.go
        doDupRowUpdate + expression/builtin_other.go VALUES)."""
        handle = int(handle)
        snap = txn.snapshot(tid)
        gathered = snap.gather(np.array([handle], np.int64),
                               list(range(tinfo.num_columns)))
        existing: list[Any] = []
        for data, valid in gathered:
            existing.append(None if not valid[0]
                            else _np_scalar(data[0]))
        builder = PlanBuilder(self.catalog, self.current_db)
        scan = builder._build_scan(stmt.table)
        # 1-row evaluator over the existing row
        cols = []
        dicts = []
        for off in range(tinfo.num_columns):
            ft = tinfo.columns[off].ftype
            arr = np.zeros(1, ft.np_dtype)
            vl = np.ones(1, bool)
            if existing[off] is None:
                vl[0] = False
            else:
                arr[0] = existing[off]
            cols.append((arr, vl))
            dicts.append(store.dictionaries[off])
        ev = NumpyEval(cols, dicts, 1)
        col_by_name = {c.name.lower(): c for c in tinfo.columns}
        new_phys = list(existing)
        for a in stmt.on_dup:
            target = col_by_name.get(a.column.name.lower())
            if target is None:
                raise SQLError(f"unknown column {a.column.name}",
                               errno=ER_BAD_FIELD)
            ci = target.offset
            col_ft = target.ftype
            # col = VALUES(col2): direct host-value re-encode (keeps
            # temporal/decimal domains exact)
            av = a.value
            if isinstance(av, ast.FuncCall) and av.name == "VALUES":
                src = col_by_name.get(av.args[0].name.lower())
                if src is None:
                    raise SQLError(
                        f"unknown column {av.args[0].name} in VALUES()")
                v = full[src.offset]
                new_phys[ci] = None if v is None else _encode_scalar(
                    col_ft, v, store.dictionaries[ci])
            else:
                expr_ast = self._subst_values_refs(av, col_by_name, full)
                try:
                    pe = builder.resolve(expr_ast, scan.schema)
                except PlanError as e:
                    raise err_wrap(SQLError, e) from None
                if col_ft.is_string:
                    sv, svl = ev.eval_str(pe)
                    d = store.dictionaries[ci]
                    new_phys[ci] = d.encode(sv[0]) if svl[0] else None
                else:
                    vv = ev.eval(pe)
                    if pe.ftype.kind != col_ft.kind or (
                            col_ft.is_decimal
                            and pe.ftype.scale != col_ft.scale):
                        vv = ev._cast(vv, pe.ftype, col_ft)
                    v, vl = vv
                    new_phys[ci] = None if not np.asarray(vl)[0] \
                        else _np_scalar(np.asarray(v)[0])
            if new_phys[ci] is None and not col_ft.nullable:
                raise SQLError(
                    f"column {target.name} cannot be null")
        if info.pk_handle_offset is not None and \
                new_phys[info.pk_handle_offset] != \
                existing[info.pk_handle_offset]:
            raise SQLError(
                "changing the primary key in ON DUPLICATE KEY UPDATE "
                "is unsupported")
        if tuple(new_phys) == tuple(existing):
            return 0  # MySQL: unchanged row counts 0
        conf = checker.conflicts(handle, tuple(new_phys), exclude=handle)
        if conf:
            raise SQLError(
                checker.dup_message(handle, tuple(new_phys), conf))
        txn.set_row(tid, handle, tuple(new_phys))
        checker.note_delete(handle)
        checker.note_insert(handle, tuple(new_phys))
        return 2  # MySQL: an updated duplicate counts 2

    def _subst_values_refs(self, node, col_by_name, full: list):
        """Replace VALUES(col) with the new row's host value as a typed
        literal (non-temporal domains; plain `col = VALUES(col)` takes
        the exact re-encode path above). Transforms a COPY: the on_dup
        AST is shared across conflicting rows, and baking one row's
        values into it would replay them for every later conflict."""
        node = copy.deepcopy(node)

        def fn(n):
            if isinstance(n, ast.FuncCall) and n.name == "VALUES":
                src = col_by_name.get(n.args[0].name.lower())
                if src is None:
                    raise SQLError(
                        f"unknown column {n.args[0].name} in VALUES()")
                v = full[src.offset]
                if v is None:
                    return ast.Literal(None, "null")
                if isinstance(v, bool):
                    return ast.Literal(int(v), "int")
                if isinstance(v, int):
                    return ast.Literal(v, "int")
                if isinstance(v, float):
                    return ast.Literal(v, "float")
                if isinstance(v, Decimal):
                    return ast.Literal(v, "decimal")
                return ast.Literal(str(v), "string")
            return n

        return ast.transform(node, fn)

    def _exec_update(self, stmt: ast.UpdateStmt) -> ResultSet:
        info, alloc_store = self._table_for(stmt.table)
        self._check_dml_columns(
            stmt.table, info, "UPDATE",
            [a.column.name for a in stmt.assignments])
        # columns READ by the update (WHERE + assignment RHS) need
        # SELECT, or matched-row counts leak unreadable values (MySQL
        # requires the same)
        read_cols: list[str] = []

        def visit(n):
            if isinstance(n, ast.ColumnRef):
                read_cols.append(n.name)
            return None

        if stmt.where is not None:
            ast.walk(stmt.where, visit)
        for a in stmt.assignments:
            ast.walk(a.value, visit)
        if read_cols:
            self._check_dml_columns(stmt.table, info, "SELECT", read_cols)
        txn = self._ensure_txn()
        try:
            total = 0
            # rows moving across partitions are buffered and applied
            # AFTER every partition's snapshot-scan: writing them inline
            # would make them visible to later partitions' scans in the
            # same statement (the cross-partition Halloween problem)
            moves: list[tuple[int, int, tuple]] = []
            children = self._partition_children(info)
            for child, store in children:
                rs = self._exec_update_inner(stmt, child, store, txn,
                                             parent=info, moves=moves)
                total += rs.affected
            for target_id, new_handle, phys in moves:
                tinfo = next(c for c, _s in children if c.id == target_id)
                tstore = self.storage.table_store(target_id)
                checker = _UniqueChecker(tinfo, tstore, txn)
                conf = checker.conflicts(new_handle, phys)
                if conf:
                    raise SQLError(
                        checker.dup_message(new_handle, phys, conf),
                        errno=ER_DUP_ENTRY)
                tstore.note_handle(new_handle)
                # the shared allocator must never re-issue this handle
                alloc_store.note_handle(new_handle)
                txn.set_row(target_id, new_handle, phys)
            return ResultSet([], [], affected=total)
        finally:
            txn.stmt_read_ts = None

    def _exec_update_inner(self, stmt: ast.UpdateStmt, info, store,
                           txn, parent=None, moves=None) -> ResultSet:
        part = getattr(parent, "partition", None) if parent is not None \
            else None
        if txn.pessimistic:
            snap, mask, ev, handles = self._pessimistic_scan(
                info, stmt.table, stmt.where, txn)
        else:
            snap = txn.snapshot(info.id)
            mask, ev = self._where_mask(info, stmt.table, stmt.where, snap)
            handles = snap.handles()[mask]
        if len(handles) == 0:
            return ResultSet([], [], affected=0)
        # resolve assignments against the scan schema
        builder = PlanBuilder(self.catalog, self.current_db)
        scan = builder._build_scan(stmt.table)
        assigns: dict[int, Any] = {}
        for a in stmt.assignments:
            ci = scan.schema.resolve(a.column.name, a.column.table)
            if ci is None:
                raise SQLError(f"unknown column {a.column}",
                               errno=ER_BAD_FIELD)
            assigns[ci] = builder.resolve(a.value, scan.schema)
        # evaluate each assignment once over the whole snapshot, in the
        # column's own physical domain
        new_vals: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for ci, e in assigns.items():
            col_ft = info.columns[ci].ftype
            if col_ft.is_string:
                sv, svl = ev.eval_str(e)
                d = store.dictionaries[ci]
                assert d is not None
                data = np.fromiter(
                    (d.encode(s) if ok else 0 for s, ok in zip(sv, svl)),
                    dtype=np.int64, count=len(sv))
                new_vals[ci] = (data, np.asarray(svl))
            else:
                vv = ev.eval(e)
                v, vl = ev._cast(vv, e.ftype, col_ft) if (
                    e.ftype.kind != col_ft.kind or
                    (col_ft.is_decimal and e.ftype.scale != col_ft.scale)
                ) else vv
                new_vals[ci] = (np.asarray(v), np.asarray(vl))
        # constraint checks only when an assigned column is the handle pk
        # or part of a unique index
        pk_changed = info.pk_handle_offset in assigns
        touches_unique = pk_changed or any(
            off in assigns
            for ix in info.indices if ix.unique or ix.primary
            for off in ix.col_offsets
        )
        checker = _UniqueChecker(info, store, txn, snap=snap) \
            if touches_unique else None
        # hoist full-column materialization out of the per-row loop
        cols = [snap.column(c) for c in range(info.num_columns)]
        col_data = [c.data for c in cols]
        col_valid = [c.validity for c in cols]
        rows_idx = np.nonzero(mask)[0]
        count = 0
        for ri, handle in zip(rows_idx, handles):
            ri = int(ri)
            handle = int(handle)
            phys = [
                None if not col_valid[c][ri] else _np_scalar(col_data[c][ri])
                for c in range(info.num_columns)
            ]
            for ci in assigns:
                v, vl = new_vals[ci]
                phys[ci] = None if not vl[ri] else _np_scalar(v[ri])
            new_handle = handle
            if pk_changed:
                pv = phys[info.pk_handle_offset]
                if pv is None:
                    raise SQLError(
                        f"column {info.columns[info.pk_handle_offset].name} "
                        "cannot be null")
                new_handle = int(pv)
                store.note_handle(new_handle)
            if checker is not None:
                conf = checker.conflicts(new_handle, tuple(phys),
                                         exclude=handle)
                if conf:
                    raise SQLError(
                        checker.dup_message(new_handle, tuple(phys), conf))
                if not txn.pessimistic:
                    # optimistic unique-value claim (same guard as the
                    # insert path; see test_race_harness.py)
                    txn.guard_keys.update(
                        self._unique_lock_keys(info, tuple(phys)))
            target_id = info.id
            if part is not None:
                # a partition-column update may move the row
                # (reference: partition.go row movement on update)
                try:
                    target_id = part.route(phys[part.col_offset]).id
                except ValueError as e:
                    raise err_wrap(SQLError, e) from None
            if target_id != info.id:
                # cross-partition move: delete here, apply after every
                # partition scanned (uniqueness checked at apply time)
                txn.delete_row(info.id, handle)
                if checker is not None:
                    checker.note_delete(handle)
                assert moves is not None
                moves.append((target_id, new_handle, tuple(phys)))
                count += 1
                continue
            if new_handle != handle:
                txn.delete_row(info.id, handle)
                if checker is not None:
                    checker.note_delete(handle)
            txn.set_row(info.id, new_handle, tuple(phys))
            if checker is not None:
                checker.note_insert(new_handle, tuple(phys))
            count += 1
        return ResultSet([], [], affected=count)

    def _exec_delete(self, stmt: ast.DeleteStmt) -> ResultSet:
        info, _ = self._table_for(stmt.table)
        txn = self._ensure_txn()
        try:
            total = 0
            for child, _store in self._partition_children(info):
                if txn.pessimistic:
                    snap, mask, _, handles = self._pessimistic_scan(
                        child, stmt.table, stmt.where, txn)
                else:
                    snap = txn.snapshot(child.id)
                    mask, _ = self._where_mask(child, stmt.table,
                                               stmt.where, snap)
                    handles = snap.handles()[mask]
                for h in handles:
                    txn.delete_row(child.id, int(h))
                total += len(handles)
            return ResultSet([], [], affected=total)
        finally:
            txn.stmt_read_ts = None

    def _unique_lock_keys(self, info: TableInfo, enc: tuple) -> list[bytes]:
        """Lock-only keys representing the unique-index entries a new row
        would claim (NULL-bearing keys skipped — MySQL allows repeated
        NULLs in unique indexes). Physical values (dictionary codes) are
        per-store deterministic, so equal SQL values from any session
        encode to equal lock keys."""
        from ..kv import tablecodec

        keys: list[bytes] = []
        for ix in info.indices:
            if not (ix.unique or ix.primary):
                continue
            vals = [enc[off] for off in ix.col_offsets]
            if any(v is None for v in vals):
                continue
            keys.append(tablecodec.index_key(info.id, ix.id, vals))
        return keys

    def _pessimistic_scan(self, info: TableInfo, table: ast.TableName,
                          where: Optional[ast.Expr], txn):
        """Lock the matching rows at a fresh for_update_ts, retrying the
        scan whenever a newer commit invalidates it (reference:
        executor/adapter.go:533 handlePessimisticDML + :623 lock-error
        retry). Leaves txn.stmt_read_ts at the locked for_update_ts so
        every read this statement makes sees the locked versions; the
        caller clears it when the statement ends."""
        from ..kv import tablecodec
        from ..kv.backoff import (BO_TXN_CONFLICT, BO_TXN_LOCK, Backoffer,
                                  BackoffExhausted)
        from ..kv.mvcc import WriteConflictError as KVConflict

        timeout = float(
            self._sysvar_value("innodb_lock_wait_timeout") or 50)
        bo = Backoffer(budget_ms=int(timeout * 1000))
        while True:
            ts = txn.refresh_for_update_ts()
            txn.stmt_read_ts = ts
            snap = txn.snapshot(info.id)
            mask, ev = self._where_mask(info, table, where, snap)
            handles = snap.handles()[mask]
            keys = [tablecodec.record_key(info.id, int(h))
                    for h in handles]
            t0 = time.monotonic()
            try:
                self.storage.pessimistic_lock_keys(txn, keys, timeout)
                return snap, mask, ev, handles
            except KVConflict:
                try:
                    # time blocked on foreign locks counts against the
                    # SAME budget, or a contended statement could run
                    # far beyond innodb_lock_wait_timeout
                    waited = time.monotonic() - t0
                    if waited > 0.001:
                        bo.charge(BO_TXN_LOCK, waited)
                    bo.sleep(BO_TXN_CONFLICT)  # then rescan fresh
                except BackoffExhausted as e:
                    raise err_wrap(SQLError, e) from None
            except (Storage.DeadlockError,
                    Storage.LockWaitTimeout) as e:
                raise err_wrap(SQLError, e) from None

    def _where_mask(self, info: TableInfo, table: ast.TableName,
                    where: Optional[ast.Expr], snap):
        n = snap.num_visible_rows
        cols = []
        dicts = []
        for off in range(info.num_columns):
            col = snap.column(off)
            cols.append((col.data, col.validity))
            dicts.append(col.dictionary)
        ev = NumpyEval(cols, dicts, n)
        if where is None:
            return np.ones(n, dtype=bool), ev
        builder = PlanBuilder(self.catalog, self.current_db)
        scan = builder._build_scan(table)
        cond = builder.resolve(where, scan.schema)
        v, vl = ev.eval(cond)
        return _truthy(np.asarray(v)) & vl, ev

    def _eval_value(self, e: ast.Expr) -> Any:
        """Evaluate an INSERT VALUES expression (constants + simple arith)."""
        builder = PlanBuilder(self.catalog, self.current_db)
        from ..plan.schema import PlanSchema
        pe = builder.resolve(e, PlanSchema([]))
        from ..plan.expr import Const
        if not isinstance(pe, Const):
            raise SQLError("non-constant INSERT value")
        if pe.value is None:
            return None
        if pe.ftype.is_decimal:
            return Decimal(pe.value, pe.ftype.scale)
        if pe.ftype.kind == TypeKind.DATE:
            from ..types.value import decode_date
            return decode_date(pe.value)
        if pe.ftype.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
            from ..types.value import decode_datetime
            return decode_datetime(pe.value)
        return pe.value

    def _insert_columns(self, info: TableInfo,
                        names: Optional[list[str]]) -> list[int]:
        if names is None:
            return list(range(info.num_columns))
        out = []
        for n in names:
            c = info.column_by_name(n)
            if c is None:
                raise SQLError(f"unknown column {n}",
                               errno=ER_BAD_FIELD)
            out.append(c.offset)
        return out

    def _complete_row(self, info: TableInfo, col_order: list[int],
                      values: list[Any], store: TableStore) -> list[Any]:
        full: list[Any] = [None] * info.num_columns
        provided = set()
        for off, v in zip(col_order, values):
            full[off] = v
            provided.add(off)
        for c in info.columns:
            if c.offset in provided:
                continue
            if c.default is not None:
                full[c.offset] = c.default
            elif c.auto_increment:
                v = store.alloc_handle()
                full[c.offset] = v
                # LAST_INSERT_ID: first auto-generated value of the
                # statement (reference: builtin_info.go lastInsertID)
                if self._stmt_auto_id is None:
                    self._stmt_auto_id = v
            elif not c.nullable:
                raise SQLError(f"column {c.name} cannot be null",
                               errno=ER_BAD_NULL)
        for c in info.columns:
            if full[c.offset] is None and not c.nullable and \
                    not c.auto_increment:
                raise SQLError(f"column {c.name} cannot be null",
                               errno=ER_BAD_NULL)
        return full

    def _row_handle(self, info: TableInfo, row: list[Any],
                    store: TableStore) -> int:
        if info.pk_handle_offset is not None:
            v = row[info.pk_handle_offset]
            if v is None:
                v = store.alloc_handle()
                row[info.pk_handle_offset] = v
            handle = int(v)
            store.note_handle(handle)
            return handle
        return store.alloc_handle()

    def _exec_truncate(self, stmt: ast.TruncateTableStmt) -> ResultSet:
        info, _ = self._table_for(stmt.table)
        for tid in self._physical_ids(info):
            self.storage.unregister_table(tid)
            self.storage.stats.drop_table(tid)
            self.storage.destroy_table_data(tid)
        self.storage.register_table(info)
        return ResultSet([], [])

    # ==================== DDL ====================
    def _exec_create_table(self, stmt: ast.CreateTableStmt) -> ResultSet:
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
        partition = None
        if stmt.partition_by is not None:
            partition = self._build_partition_info(
                stmt.partition_by, columns, indices, pk_handle)
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
            partition=partition,
            foreign_keys=fk_infos,
        )
        try:
            created = self.catalog.add_table(db, info, stmt.if_not_exists)
        except KeyError as e:
            raise err_wrap(SQLError, e) from None
        if created:
            self.storage.register_table(info)
        return ResultSet([], [])

    def _build_partition_info(self, pb, columns, indices, pk_handle):
        """Validate + build PartitionInfo (reference: ddl/partition.go
        checkPartitionByHash/Range + checkPartitionKeysConstraint — every
        unique key must include the partition column)."""
        from ..catalog.schema import PartitionDef, PartitionInfo

        col = next((c for c in columns
                    if c.name.lower() == pb.column.lower()), None)
        if col is None:
            raise SQLError(f"unknown partition column {pb.column}")
        ft = col.ftype
        if not (ft.is_integer or ft.kind == TypeKind.DATE):
            raise SQLError(
                "partition column must be integer or DATE typed")
        for ix in indices:
            if (ix.unique or ix.primary) and \
                    col.offset not in ix.col_offsets:
                raise SQLError(
                    "A UNIQUE INDEX must include all columns in the "
                    "table's partitioning function")
        if pk_handle is not None and pk_handle != col.offset:
            raise SQLError(
                "A PRIMARY KEY must include all columns in the "
                "table's partitioning function")
        defs: list = []
        if pb.kind == "hash":
            for i in range(pb.count):
                defs.append(PartitionDef(f"p{i}", self.catalog.alloc_id()))
        else:
            prev = None
            for name, less_than in pb.ranges:
                if any(d.name.lower() == name.lower() for d in defs):
                    raise SQLError(f"duplicate partition name {name}")
                if prev is not None and prev[1] is None:
                    raise SQLError("MAXVALUE must be the last partition")
                if less_than is not None and prev is not None and \
                        prev[1] is not None and less_than <= prev[1]:
                    raise SQLError(
                        "VALUES LESS THAN must be strictly increasing")
                defs.append(PartitionDef(name, self.catalog.alloc_id(),
                                         less_than))
                prev = (name, less_than)
        return PartitionInfo(pb.kind, col.offset, defs)

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
                for tid in self._physical_ids(info):
                    self.storage.unregister_table(tid)
                    self.storage.stats.drop_table(tid)
                    self.storage.destroy_table_data(tid)
        return ResultSet([], [])

    # ==================== online DDL ====================
    def _ddl(self):
        from ..ddl import DDL

        return DDL(self.storage, self.catalog)

    def _exec_create_view(self, stmt: ast.CreateViewStmt) -> ResultSet:
        from ..catalog.schema import ViewInfo
        db = stmt.db or self.current_db
        schema = self.catalog.schema(db)
        key = stmt.name.lower()
        if not hasattr(schema, "views"):
            schema.views = {}
        if key in schema.tables:
            raise SQLError(f"Table '{stmt.name}' already exists")
        if key in schema.views and not stmt.or_replace:
            raise SQLError(f"Table '{stmt.name}' already exists")
        # validate the stored SELECT against the current catalog
        self._plan_view_select(db, stmt.select_sql, stmt.columns)
        schema.views[key] = ViewInfo(
            stmt.name, stmt.select_sql, tuple(stmt.columns),
            definer=f"{self.user or 'root'}@%")
        self.catalog.bump_version()
        return ResultSet([], [])

    def _exec_drop_view(self, stmt: ast.DropViewStmt) -> ResultSet:
        db = stmt.db or self.current_db
        schema = self.catalog.schema(db)
        views = getattr(schema, "views", {})
        if stmt.name.lower() not in views:
            if stmt.if_exists:
                return ResultSet([], [])
            raise SQLError(f"Unknown view '{stmt.name}'")
        del views[stmt.name.lower()]
        self.catalog.bump_version()
        return ResultSet([], [])

    def _plan_view_select(self, db: str, sql: str, columns) -> None:
        """Validate a view definition by building its plan now (the
        reference re-parses/validates at CreateView, ddl/ddl_api.go)."""
        try:
            stmts = parse_sql(sql)
            if len(stmts) != 1 or not isinstance(
                    stmts[0], (ast.SelectStmt, ast.SetOpStmt)):
                raise SQLError("view definition must be one SELECT")
            plan = PlanBuilder(self.catalog, db).build_select(stmts[0])
        except PlanError as e:
            raise err_wrap(SQLError, e) from None
        if columns and len(columns) != len(plan.schema.fields):
            raise SQLError("view column list length mismatch")

    def _exec_ddl_job(self, kind: str, tn: ast.TableName,
                      args: dict) -> ResultSet:
        from ..ddl import DDLError

        self._commit_implicit()  # DDL implicitly commits (MySQL semantics)
        # no ddl_section here: run_job takes the owner lock itself
        info, _ = self._table_for(tn)
        ddl = self._ddl()
        job = ddl.submit(kind, tn.db or self.current_db, info, args)
        try:
            ddl.run_job(job)
        except DDLError as e:
            raise err_wrap(SQLError, e) from None
        return ResultSet([], [])

    def _exec_alter(self, stmt: ast.AlterTableStmt) -> ResultSet:
        for spec in stmt.specs:
            if spec.op in ("drop_partition", "truncate_partition"):
                self._exec_alter_partition(stmt.table, spec)
                continue
            info = self.catalog.try_table(
                stmt.table.db or self.current_db, stmt.table.name)
            if info is not None and getattr(info, "partition",
                                            None) is not None:
                raise SQLError(
                    f"ALTER {spec.op} on partitioned tables is "
                    "unsupported")
            if spec.op == "add_index":
                idef = spec.index
                if idef.primary:
                    raise SQLError("ADD PRIMARY KEY after create is "
                                   "unsupported")
                name = idef.name or f"idx_{'_'.join(idef.columns)}"
                self._exec_ddl_job("add_index", stmt.table, {
                    "name": name, "columns": idef.columns,
                    "unique": idef.unique})
            elif spec.op == "drop_index":
                self._exec_ddl_job("drop_index", stmt.table,
                                   {"name": spec.name})
            elif spec.op == "add_column":
                cd = spec.column
                ft = _coldef_ftype(cd)
                default = None
                if cd.default is not None:
                    c = _literal_const(cd.default)
                    default = self._decode_default(c, ft)
                self._exec_ddl_job("add_column", stmt.table, {
                    "name": cd.name, "ftype": ft, "default": default,
                    "phys_default": self._phys_value(default, ft)})
            elif spec.op == "drop_column":
                self._exec_ddl_job("drop_column", stmt.table,
                                   {"name": spec.name})
            elif spec.op == "modify_column":
                cd = spec.column
                self._exec_ddl_job("modify_column", stmt.table,
                                   {"name": cd.name,
                                    "ftype": _coldef_ftype(cd)})
            elif spec.op == "rename":
                self._exec_ddl_job("rename_table", stmt.table, {
                    "new_name": spec.name,
                    "new_db": stmt.table.db or self.current_db})
                stmt = ast.AlterTableStmt(
                    ast.TableName(spec.name, stmt.table.db), [])
            else:
                raise SQLError(f"unsupported ALTER action {spec.op}")
        return ResultSet([], [])

    def _exec_alter_partition(self, tn: ast.TableName,
                              spec: ast.AlterSpec) -> None:
        """DROP/TRUNCATE PARTITION (reference: ddl/partition.go
        onDropTablePartition + truncate — partition data reclaim via
        delete-range, here unsafe_destroy_range on the child id)."""
        info, _ = self._table_for(tn)
        part = getattr(info, "partition", None)
        if part is None:
            raise SQLError(f"table {info.name} is not partitioned")
        d = part.by_name(spec.name)
        if d is None:
            raise SQLError(f"unknown partition {spec.name}")
        self._commit_implicit()
        # the first partition's store is the table's shared handle
        # allocator (_table_for): its counter must survive this DDL or
        # re-issued handles would overwrite live rows elsewhere
        alloc = self.storage.table_store(part.defs[0].id)._next_handle
        if spec.op == "drop_partition":
            if part.kind != "range":
                raise SQLError(
                    "DROP PARTITION is only supported for RANGE "
                    "partitioning (use a smaller PARTITIONS count "
                    "for HASH)")
            if len(part.defs) == 1:
                raise SQLError("cannot drop the last partition")
            part.defs.remove(d)
            self.storage.unregister_table(d.id)
            self.storage.stats.drop_table(d.id)
            self.storage.destroy_table_data(d.id)
            new_first = self.storage.table_store(part.defs[0].id)
            new_first._next_handle = max(new_first._next_handle, alloc)
            self.catalog.bump_version()
        else:  # truncate_partition: fresh store, same identity
            self.storage.destroy_table_data(d.id)
            self.storage.stats.drop_table(d.id)
            store = TableStore(Storage.child_table_info(info, d))
            # keep the shared dictionaries (other partitions still
            # reference their codes)
            other = next((p for p in part.defs if p.id != d.id), None)
            if other is not None:
                store.dictionaries = \
                    self.storage.table_store(other.id).dictionaries
            self.storage.tables[d.id] = store
            self.storage.adopt_table_store(store)
            if d.id == part.defs[0].id:
                store._next_handle = alloc
            self.catalog.bump_version()

    def _phys_value(self, v, ft: FieldType):
        """Host default -> physical encoding (scaled decimal, day number)."""
        if v is None:
            return None
        if ft.is_string:
            return str(v)
        return _encode_scalar(ft, v, None)

    # ==================== sequences ====================
    def _exec_create_sequence(self, stmt: ast.CreateSequenceStmt
                              ) -> ResultSet:
        from ..catalog.schema import SequenceInfo

        db = stmt.name.db or self.current_db
        schema = self.catalog.schema(db)
        seqs = getattr(schema, "sequences", None)
        if seqs is None:  # catalogs pickled before the field existed
            schema.sequences = seqs = {}
        key = stmt.name.name.lower()
        if key in seqs or self.catalog.try_table(db, stmt.name.name):
            if stmt.if_not_exists:
                return ResultSet([], [])
            raise SQLError(f"table exists: {db}.{stmt.name.name}",
                           errno=ER_TABLE_EXISTS)
        seqs[key] = SequenceInfo(
            id=self.catalog.alloc_id(), name=stmt.name.name,
            start=stmt.start, increment=stmt.increment,
            min_value=stmt.min_value, max_value=stmt.max_value,
            cycle=stmt.cycle, next_value=stmt.start)
        self.catalog.bump_version()
        return ResultSet([], [])

    def _exec_drop_sequence(self, stmt: ast.DropSequenceStmt) -> ResultSet:
        for tn in stmt.names:
            db = tn.db or self.current_db
            schema = self.catalog.schema(db)
            seqs = getattr(schema, "sequences", {}) or {}
            if tn.name.lower() not in seqs:
                if stmt.if_exists:
                    continue
                raise SQLError(f"unknown table: {db}.{tn.name}",
                               errno=ER_NO_SUCH_TABLE)
            del seqs[tn.name.lower()]
        self.catalog.bump_version()
        return ResultSet([], [])

    def _sequence_for(self, node):
        if not isinstance(node, ast.ColumnRef):
            raise SQLError("sequence functions take a sequence name")
        db = node.table or self.current_db
        schema = self.catalog.schema(db)
        seq = (getattr(schema, "sequences", {}) or {}).get(
            node.name.lower())
        if seq is None:
            raise SQLError(f"unknown sequence: {db}.{node.name}")
        return seq

    # ==================== CHECKSUM / ADMIN CHECK ====================
    CHECKSUM_CHUNK = 1 << 16

    def _exec_checksum(self, stmt: ast.ChecksumTableStmt) -> ResultSet:
        """CHECKSUM TABLE: deterministic crc32 over the visible rows in
        HANDLE order (two replicas with identical content but different
        compaction state must agree), column-major: handles, then per
        column the validity bitmap followed by the cell payloads —
        fixed-width cells with NULLs zeroed, strings length-prefixed
        (("ab","c") != ("a","bc")) with only valid cells contributing;
        in chunks of rows, with the KILL flag polled between them
        (reference: executor/checksum.go; the polynomial differs — the
        value is stable across servers and restarts)."""
        import zlib

        step = self.CHECKSUM_CHUNK
        txn = self._ensure_txn()
        rows = []
        for tn in stmt.tables:
            info, _ = self._table_for(tn)
            crc = 0
            for cinfo, _store in self._partition_children(info):
                snap = txn.snapshot(cinfo.id)
                n = snap.num_visible_rows
                handles = snap.handles()
                order = np.argsort(handles, kind="stable")
                hs = np.ascontiguousarray(
                    handles[order].astype("<i8", copy=False))
                for lo in range(0, n, step):
                    interrupt.check()
                    crc = zlib.crc32(hs[lo:lo + step].tobytes(), crc)
                for off in range(cinfo.num_columns):
                    col = snap.column(off)
                    data = col.data[order]
                    valid = col.validity[order].astype(bool, copy=False)
                    d = col.dictionary
                    is_str = d is not None and len(d) and \
                        cinfo.columns[off].ftype.is_string
                    if is_str:
                        # one length-prefixed encode per DICTIONARY
                        # entry, not per cell
                        blobs = [len(b).to_bytes(4, "little") + b
                                 for b in (s.encode() for s in d.values)]
                    for lo in range(0, n, step):
                        interrupt.check()
                        dv = data[lo:lo + step]
                        vv = valid[lo:lo + step]
                        crc = zlib.crc32(
                            np.packbits(vv).tobytes(), crc)
                        if is_str:
                            payload = b"".join(
                                map(blobs.__getitem__,
                                    dv[vv].astype(np.int64).tolist()))
                            crc = zlib.crc32(payload, crc)
                        elif dv.dtype.kind in "iub":
                            ints = np.where(
                                vv, dv.astype("<i8", copy=False),
                                np.int64(0))
                            crc = zlib.crc32(
                                np.ascontiguousarray(ints).tobytes(),
                                crc)
                        else:
                            f = np.array(dv, copy=True)
                            f[~vv] = 0
                            crc = zlib.crc32(
                                np.ascontiguousarray(f).tobytes(), crc)
                crc = zlib.crc32(str(n).encode(), crc)
            db = tn.db or self.current_db
            rows.append((f"{db}.{info.name}", crc & 0xFFFFFFFF))
        return ResultSet(["Table", "Checksum"], rows)

    def _exec_admin_check(self, stmt: ast.AdminStmt) -> ResultSet:
        """ADMIN CHECK TABLE: verify storage/index invariants per table
        (reference: executor/admin.go CheckTable). An index here is a sort
        order, with no per-row index KV to drift, so the checked
        invariants are the ones this storage can violate: epoch
        column/validity shapes, handle uniqueness, cached index orders
        actually sorting their epoch, unique-key duplicates among visible
        rows, and partition routing."""
        for tn in stmt.tables:
            info, _ = self._table_for(tn)
            for cinfo, cstore in self._partition_children(info):
                self._admin_check_store(info, cinfo, cstore)
        return ResultSet([], [])

    def _admin_check_store(self, root: TableInfo, info: TableInfo,
                           store: TableStore) -> None:
        from ..store.index import epoch_index_order

        def fail(what: str) -> None:
            raise SQLError(
                f"admin check table {root.name} failed: {what}",
                errno=ER_DATA_INCONSISTENT)

        txn = self._ensure_txn()
        snap = txn.snapshot(info.id)
        epoch = snap.epoch
        n = epoch.num_rows
        for ci in range(info.num_columns):
            if len(epoch.columns[ci]) != n:
                fail(f"column {info.columns[ci].name} has "
                     f"{len(epoch.columns[ci])} rows, epoch has {n}")
            v = epoch.valids[ci]
            if v is not None and len(v) != n:
                fail(f"validity of {info.columns[ci].name} has {len(v)} "
                     f"rows, epoch has {n}")
        if len(np.unique(epoch.handles)) != n:
            fail("duplicate handles in epoch")
        for idx in info.indices:
            if not idx.visible:
                continue
            order = epoch_index_order(store, epoch, idx)
            if len(order) != n or (
                    n and not np.array_equal(np.sort(order),
                                             np.arange(n))):
                fail(f"index {idx.name}: cached order is not a "
                     "permutation of the epoch")
            # key columns must be lexicographically non-decreasing along
            # the permutation (NULLs-first per level)
            if n:
                prev_eq = np.ones(n - 1, bool)
                for off in idx.col_offsets:
                    data = epoch.columns[off][order]
                    valid = epoch.valids[off]
                    vv = valid[order] if valid is not None else \
                        np.ones(n, bool)
                    lvl = np.stack([vv.astype(np.int64),
                                    np.where(vv, data, 0)], axis=1)
                    cmp_lt = (lvl[:-1, 0] < lvl[1:, 0]) | (
                        (lvl[:-1, 0] == lvl[1:, 0])
                        & (lvl[:-1, 1] < lvl[1:, 1]))
                    cmp_eq = (lvl[:-1] == lvl[1:]).all(axis=1)
                    if not np.all(~prev_eq | cmp_lt | cmp_eq):
                        fail(f"index {idx.name}: epoch not sorted by key")
                    prev_eq &= cmp_eq
            if idx.unique:
                self._admin_check_unique(snap, idx, fail)
        part = getattr(root, "partition", None)
        if part is not None and info.id != root.id:
            off = part.col_offset
            vals = epoch.columns[off]
            vv = epoch.valids[off]
            check_vals = vals if vv is None else vals[vv]
            for u in np.unique(check_vals):
                if part.route(int(u)).id != info.id:
                    fail(f"row with partition key {u} stored in wrong "
                         f"partition {info.name}")

    def _admin_check_unique(self, snap, idx, fail) -> None:
        """No duplicate fully-non-NULL unique-key tuples among rows
        visible at this snapshot (epoch ∩ base_visible + overlay)."""
        keys = []
        valid_all = None
        vis = snap.base_visible
        for off in idx.col_offsets:
            base = snap.epoch.columns[off][vis]
            ov = snap.overlay_columns[off]
            col = np.concatenate([base, ov])
            if np.issubdtype(col.dtype, np.floating):
                # dedup on bit patterns, not truncation
                from ..copr.analyze import float_bits_key
                col = float_bits_key(col)
            else:
                col = col.astype(np.int64)
            bvl = snap.epoch.valids[off]
            bv = bvl[vis] if bvl is not None else np.ones(len(base), bool)
            ovl = snap.overlay_valids[off]
            o = ovl if ovl is not None else np.ones(len(ov), bool)
            vcat = np.concatenate([bv, o])
            keys.append(col)
            valid_all = vcat if valid_all is None else (valid_all & vcat)
        if not keys or valid_all is None or not valid_all.any():
            return
        stacked = np.stack(keys, axis=1)[valid_all]
        uniq = np.unique(stacked, axis=0)
        if len(uniq) != len(stacked):
            fail(f"unique index {idx.name}: duplicate key values among "
                 "visible rows")

    # ==================== EXPLAIN ====================
    def _exec_explain(self, stmt: ast.ExplainStmt) -> ResultSet:
        if not isinstance(stmt.target, (ast.SelectStmt, ast.SetOpStmt)):
            raise SQLError("EXPLAIN supports SELECT only for now")
        # bindings apply to the displayed plan too: EXPLAIN shows what
        # would run
        m = re.match(r"(?is)\s*explain\s+(?:analyze\s+)?(.*)$",
                     self._raw_sql or "")
        if m and m.group(1):
            prev = self._binding_match_sql
            self._binding_match_sql = m.group(1)
            try:
                stmt.target = self._apply_binding(stmt.target)
            finally:
                self._binding_match_sql = prev
        if stmt.analyze:
            # a point statement runs the fast path and shows it AS the
            # plan
            rs = self._explain_analyze_point(
                stmt.target, m.group(1) if m else None)
            if rs is not None:
                return rs
        plan = self._plan(stmt.target)
        if not stmt.analyze:
            return ResultSet(["plan"],
                             [(line,) for line in explain_plan(plan)])
        # EXPLAIN ANALYZE: run the plan with per-node runtime stats
        from ..plan.physical import explain_nodes

        # follower read tier: when the router would serve this read
        # from a replica, EXPLAIN ANALYZE executes THAT — the routing
        # decision is the plan (engine column `replica@host:port`);
        # per-node device stats belong to the serving replica's own
        # surfaces (its slow log / Top SQL / EXPLAIN ANALYZE)
        from ..rpc import replica as _replica
        routed = _replica.try_route(
            self, stmt.target, m.group(1) if m else None,
            self._has_var_reads(stmt.target),
            expect_cols=len(plan.schema.fields))
        if routed is not None:
            self._commit_implicit()  # release the routing read ts
            rows = []
            for i, line in enumerate(explain_plan(plan)):
                rows.append((
                    line,
                    len(routed.rows) if i == 0 else None,
                    round(routed.wall_ms, 2) if i == 0 else None,
                    f"replica@{routed.addr}" if i == 0 else "",
                    f"replica_read:{routed.wall_ms / 1e3:.3f}"
                    if i == 0 else "", "",
                    self._wait_profile_cell() if i == 0 else ""))
            return ResultSet(list(_EXPLAIN_ANALYZE_COLS), rows)

        coll = obs.RuntimeStatsColl()

        def run():
            ctx = self._exec_ctx(stats=coll)
            try:
                return run_physical(plan, ctx)
            finally:
                ctx.close()

        self._run_in_txn(run)
        wp = self._wait_profile_cell()
        rows = []
        for i, (node, line) in enumerate(explain_nodes(plan)):
            st = coll.for_plan(node)
            if st is None:
                rows.append((line, None, None, "", "", "",
                             wp if i == 0 else ""))
            else:
                rows.append((line, st["rows"],
                             round(st["time"] * 1e3, 2),
                             st["engine"] or "",
                             obs.fmt_stages(st.get("stages")),
                             obs.fmt_mesh(st.get("mesh")),
                             wp if i == 0 else ""))
        return ResultSet(list(_EXPLAIN_ANALYZE_COLS), rows)

    @staticmethod
    def _wait_profile_cell() -> str:
        """The statement's typed wait profile for the EXPLAIN ANALYZE
        header row: EXPLAIN ANALYZE runs under the statement's wait
        ledger, so the active ledger holds exactly the waits the analyzed
        execution accrued so far. Empty when the wait profile is off."""
        led = obs.active_wait_ledger()
        if led is None or not led.totals:
            return ""
        return obs.fmt_waits(led.totals)

    def _explain_analyze_point(self, target,
                               bare_sql: Optional[str] = None
                               ) -> Optional[ResultSet]:
        """EXPLAIN ANALYZE of a point-eligible SELECT runs the fast path
        and renders one Point_Get row: engine `point`, the plan-cache
        outcome in the stages cell. `bare_sql` (the target's own text)
        keys the same cache entry the bare statement uses."""
        if not isinstance(target, ast.SelectStmt) or \
                not self._fast_path_eligible(target):
            return None
        from ..plan import fastpath
        prev_key = self._plan_cache_key
        self._plan_cache_key = bare_sql or prev_key
        try:
            with obs.stage("fast_plan"):
                fp = self._fast_plan_cached(target)
        finally:
            self._plan_cache_key = prev_key
        if fp is None:
            return None
        obs.note_engine("point")
        t0 = time.perf_counter()
        rs = fastpath.execute(self, fp)
        dt = (time.perf_counter() - t0) * 1e3
        cache = "hit" if self.last_plan_from_cache else "miss"
        key = f"handle:{fp.handle}" if fp.handle is not None \
            else f"key:{fp.index.name}"
        row = (f"Point_Get_1(table:{fp.info.name}, {key})",
               len(rs.rows), round(dt, 3), "point",
               f"plan_cache:{cache}", "", self._wait_profile_cell())
        return ResultSet(list(_EXPLAIN_ANALYZE_COLS), [row])

    def _exec_trace(self, stmt: ast.TraceStmt) -> ResultSet:
        """TRACE <select|dml>: run it under a span collector and return
        the span tree, then one row per plan node of a SELECT with its
        EXPLAIN ANALYZE time."""
        from ..plan.physical import explain_nodes

        target = stmt.target
        if not isinstance(target, (ast.SelectStmt, ast.SetOpStmt) + _DML):
            raise SQLError("TRACE supports SELECT and DML statements")
        is_select = isinstance(target, (ast.SelectStmt, ast.SetOpStmt))
        coll = obs.RuntimeStatsColl()
        plan = None
        try:
            raw = self._sysvar_value("tidb_trace_span_cap")
            cap = obs.TRACE_SPAN_CAP if raw is None or raw == "" \
                else max(int(raw), 1)  # 1 = root only, rest dropped
        except (TypeError, ValueError, SQLError):
            cap = obs.TRACE_SPAN_CAP
        with obs.SpanCollector("session.run", cap=cap) as spans:
            if is_select:
                with obs.span("session.prepare"):
                    target = self._maybe_bind_vars(target)
                    self._refresh_infoschema(target)
                with obs.stage("plan_build", span_name="planner.optimize"):
                    plan = self._plan(target)

                def run():
                    ctx = self._exec_ctx(stats=coll)
                    try:
                        return run_physical(plan, ctx)
                    finally:
                        ctx.close()

                with obs.span("executor.run"):
                    self._run_in_txn(run)
            else:
                with obs.span("executor.dml"):
                    self._execute_stmt(target)
        rows: list[tuple] = spans.rows()
        if plan is not None:
            for node, line in explain_nodes(plan):
                st = coll.for_plan(node)
                dur = round(st["time"] * 1e3, 3) if st else None
                rows.append((f"  {line}", None, dur))
        self.storage.obs.record_trace(self.conn_id or 0, rows)
        return ResultSet(["operation", "start_ms", "duration_ms"], rows)

    def _exec_show(self, stmt: ast.ShowStmt) -> ResultSet:
        if stmt.kind == "TABLES":
            schema = self.catalog.schema(self.current_db)
            names = sorted(t.name for t in schema.tables.values()
                           if _like_match(stmt.pattern, t.name))
            return ResultSet([f"Tables_in_{self.current_db}"],
                             [(n,) for n in names])
        if stmt.kind == "DATABASES":
            return ResultSet(
                ["Database"],
                [(s.name,) for s in sorted(self.catalog.schemas.values(),
                                           key=lambda s: s.name)])
        if stmt.kind == "CREATE_TABLE":
            assert stmt.target is not None
            info, _ = self._table_for(stmt.target)
            lines = [
                f"`{c.name}` {c.ftype!r}"
                f"{'' if c.ftype.nullable else ' NOT NULL'}"
                for c in info.columns
            ]
            for fk in getattr(info, "foreign_keys", []) or []:
                cols_s = ", ".join(f"`{info.columns[o].name}`"
                                   for o in fk.col_offsets)
                refs = ", ".join(f"`{c}`" for c in fk.ref_cols)
                lines.append(
                    f"CONSTRAINT `{fk.name}` FOREIGN KEY ({cols_s}) "
                    f"REFERENCES `{fk.ref_table}` ({refs})"
                    + (f" ON DELETE {fk.on_delete}"
                       if fk.on_delete != "RESTRICT" else "")
                    + (f" ON UPDATE {fk.on_update}"
                       if fk.on_update != "RESTRICT" else ""))
            body = ",\n  ".join(lines)
            ddl = f"CREATE TABLE `{info.name}` (\n  {body}\n)"
            return ResultSet(["Table", "Create Table"], [(info.name, ddl)])
        if stmt.kind == "VARIABLES":
            vals = dict(self.storage.sysvars.all_globals())
            if stmt.scope != "GLOBAL":
                vals.update({k: v for k, v in self.vars.items()})
            rows = [(k, "" if v is None else str(v))
                    for k, v in sorted(vals.items())
                    if _like_match(stmt.pattern, k)]
            return ResultSet(["Variable_name", "Value"], rows)
        if stmt.kind == "STATUS":
            rows = [("Uptime", "0"), ("Threads_connected", "1"),
                    ("Questions", str(self._stmt_seq)),
                    ("Ssl_cipher", "")]
            return ResultSet(["Variable_name", "Value"],
                             [r for r in rows
                              if _like_match(stmt.pattern, r[0])])
        if stmt.kind == "GRANTS":
            target = stmt.pattern or self.user or "root"
            rows = []
            for p, db, tbl in self.storage.privileges.grants_for(target):
                obj = "*.*" if db == "*" and tbl == "*" else f"{db}.{tbl}"
                rows.append((f"GRANT {p} ON {obj} TO '{target}'@'%'",))
            by_scope: dict[tuple, list[str]] = {}
            for p, db, tbl, col in \
                    self.storage.privileges.col_grants_for(target):
                by_scope.setdefault((p, db, tbl), []).append(col)
            for (p, db, tbl), cols in sorted(by_scope.items()):
                rows.append((
                    f"GRANT {p} ({', '.join(cols)}) ON {db}.{tbl} "
                    f"TO '{target}'@'%'",))
            roles = sorted(self.storage.privileges.roles_of(target))
            if roles:
                rs = ", ".join(f"'{r}'@'%'" for r in roles)
                rows.append((f"GRANT {rs} TO '{target}'@'%'",))
            return ResultSet([f"Grants for {target}@%"], rows)
        if stmt.kind == "TABLE_STATUS":
            schema = self.catalog.schema(self.current_db)
            rows = []
            for t in sorted(schema.tables.values(), key=lambda t: t.name):
                if not _like_match(stmt.pattern, t.name):
                    continue
                from ..catalog.infoschema import _store_rows
                part = getattr(t, "partition", None)
                nrows = sum(_store_rows(self.storage, tid)
                            for tid in self._physical_ids(t))
                rows.append((t.name, "InnoDB", 10, "Fixed", nrows, 0,
                             0, 0, 0, 0, None, None, None, None,
                             "utf8mb4_bin", None,
                             "partitioned" if part else "", ""))
            for v in sorted(getattr(schema, "views", {}).values(),
                            key=lambda v: v.name):
                if _like_match(stmt.pattern, v.name):
                    rows.append((v.name, None, None, None, None, None,
                                 None, None, None, None, None, None,
                                 None, None, None, None, None, "VIEW"))
            return ResultSet(
                ["Name", "Engine", "Version", "Row_format", "Rows",
                 "Avg_row_length", "Data_length", "Max_data_length",
                 "Index_length", "Data_free", "Auto_increment",
                 "Create_time", "Update_time", "Check_time", "Collation",
                 "Checksum", "Create_options", "Comment"], rows)
        if stmt.kind == "CHARSET":
            rows = [("utf8mb4", "UTF-8 Unicode", "utf8mb4_bin", 4),
                    ("binary", "Binary pseudo charset", "binary", 1),
                    ("utf8", "UTF-8 Unicode", "utf8_bin", 3)]
            rows = [r for r in rows if _like_match(stmt.pattern, r[0])]
            return ResultSet(
                ["Charset", "Description", "Default collation",
                 "Maxlen"], rows)
        if stmt.kind == "PRIVILEGES":
            from .privileges import PRIVS
            return ResultSet(
                ["Privilege", "Context", "Comment"],
                [(p.title(), "Tables,Databases,Global", "")
                 for p in sorted(PRIVS - {"ALL", "USAGE"})])
        if stmt.kind == "CREATE_DATABASE":
            name = stmt.pattern or ""
            try:
                self.catalog.schema(name)  # raises if unknown
            except KeyError as e:
                raise err_wrap(SQLError, e) from None
            return ResultSet(
                ["Database", "Create Database"],
                [(name, f"CREATE DATABASE `{name}` /*!40100 DEFAULT "
                  f"CHARACTER SET utf8mb4 */")])
        if stmt.kind == "CREATE_VIEW":
            assert stmt.target is not None
            db = stmt.target.db or self.current_db
            schema = self.catalog.schema(db)
            v = getattr(schema, "views", {}).get(stmt.target.name.lower())
            if v is None:
                raise SQLError(f"Unknown view '{stmt.target.name}'",
                               errno=ER_NO_SUCH_TABLE)
            return ResultSet(
                ["View", "Create View", "character_set_client",
                 "collation_connection"],
                [(v.name,
                  f"CREATE VIEW `{v.name}` AS {v.sql}",
                  "utf8mb4", "utf8mb4_bin")])
        if stmt.kind == "WARNINGS":
            return ResultSet(["Level", "Code", "Message"],
                             [tuple(w) for w in self.warnings])
        if stmt.kind == "BINDINGS":
            recs = self.storage.bindings.all() if stmt.scope == "GLOBAL" \
                else list(self.session_bindings.values())
            return ResultSet(
                ["Original_sql", "Bind_sql", "Default_db", "Status",
                 "Create_time", "Update_time", "Charset", "Collation",
                 "Source"],
                [(r["original_sql"], r["bind_sql"], r["default_db"],
                  r["status"], r["create_time"], r["update_time"],
                  "utf8mb4", "utf8mb4_bin", "manual") for r in recs])
        if stmt.kind == "PROCESSLIST":
            provider = getattr(self.storage, "processlist", None)
            if provider is not None:
                # the provider's rows carry (.., mem_max, spill_count)
                # tails for information_schema.processlist; the SHOW
                # surface keeps MySQL's classic eight columns
                rows = [tuple(r[:8]) for r in provider()]
                # MySQL: without the PROCESS privilege, only your own
                # connections' rows are visible
                if self.user is not None and not (
                        self.storage.privileges.check(
                            self.user, "PROCESS", "*", "*",
                            roles=self.active_roles)):
                    rows = [r for r in rows if r[1] == self.user]
            else:
                # embedded session: no wire server; list this session
                info = self.in_flight_sql
                t = int(time.time() - self.in_flight_since) \
                    if info and self.in_flight_since else 0
                rows = [(getattr(self, "conn_id", 0),
                         self.user or "root", "localhost",
                         self.current_db, "Query", t, "executing",
                         info)]
            return ResultSet(
                ["Id", "User", "Host", "db", "Command", "Time",
                 "State", "Info"], rows)
        if stmt.kind == "PROFILES":
            # the @@profiling ring (MySQL SHOW PROFILES; entries
            # recorded by the per-statement sampling profiler)
            return ResultSet(
                ["Query_ID", "Duration", "Query"],
                [(p["query_id"], round(p["duration"], 6), p["sql"])
                 for p in self._profiles])
        if stmt.kind == "PROFILE":
            # flamegraph-style table for one profiled statement: frame
            # tree rows with estimated seconds and raw sample counts
            if not self._profiles:
                return ResultSet(["Status", "Duration", "Samples"], [])
            if stmt.pattern:
                qid = int(stmt.pattern)
                ent = next((p for p in self._profiles
                            if p["query_id"] == qid), None)
                if ent is None:
                    raise SQLError(f"no profile for query {qid}")
            else:
                ent = self._profiles[-1]
            prof = ent["profile"]
            rows = [(f_, sec, n) for f_, sec, n in prof.tree_rows()]
            if not rows:
                rows = [("(no samples: statement finished between "
                         f"ticks at {prof.hz:g}Hz)", 0.0, 0)]
            return ResultSet(["Status", "Duration", "Samples"], rows)
        if stmt.kind == "SLOW":
            rows = [(e["ts"], e["db"], e["duration_ms"], e["sql"],
                     e["plan_digest"],
                     obs.fmt_stages_ms(e.get("stages")),
                     e["mem_max"], e["spill_count"],
                     obs.fmt_waits_ms(e.get("waits")))
                    for e in self.storage.obs.slow_queries()]
            return ResultSet(["Time", "DB", "Duration_ms", "Query",
                              "Plan_digest", "Stages", "Mem_max",
                              "Spill_count", "Wait_profile"], rows)
        if stmt.kind == "ENGINES":
            return ResultSet(
                ["Engine", "Support", "Comment", "Transactions", "XA",
                 "Savepoints"],
                [("InnoDB", "DEFAULT",
                  "TiTPU columnar engine (InnoDB-compatible surface)",
                  "YES", "NO", "NO")])
        if stmt.kind == "COLLATION":
            return ResultSet(
                ["Collation", "Charset", "Id", "Default", "Compiled",
                 "Sortlen"],
                [("utf8mb4_bin", "utf8mb4", 46, "Yes", "Yes", 1)])
        if stmt.kind == "COLUMNS":
            assert stmt.target is not None
            info, _ = self._table_for(stmt.target)
            rows = []
            for c in info.columns:
                key = "PRI" if c.is_primary else ""
                rows.append((c.name, repr(c.ftype),
                             "YES" if c.nullable else "NO", key,
                             None if c.default is None else str(c.default),
                             "auto_increment" if c.auto_increment else ""))
            return ResultSet(
                ["Field", "Type", "Null", "Key", "Default", "Extra"],
                [r for r in rows if _like_match(stmt.pattern, r[0])])
        if stmt.kind == "INDEX":
            assert stmt.target is not None
            info, _ = self._table_for(stmt.target)
            rows = []
            for ix in info.indices:
                if not ix.visible:
                    continue
                for seq, off in enumerate(ix.col_offsets):
                    rows.append((
                        info.name, 0 if ix.unique or ix.primary else 1,
                        ix.name, seq + 1, info.columns[off].name, "A",
                        0, None, None, "", "BTREE", "", ""))
            return ResultSet(
                ["Table", "Non_unique", "Key_name", "Seq_in_index",
                 "Column_name", "Collation", "Cardinality", "Sub_part",
                 "Packed", "Null", "Index_type", "Comment",
                 "Index_comment"], rows)
        if stmt.kind == "METRICS":
            rows = []
            # this storage's registry and the process-wide one: their
            # families are disjoint
            text = self.storage.obs.render() + obs.PROCESS_METRICS.render()
            for line in text.splitlines():
                if line.startswith("#") or not line.strip():
                    continue
                name, _, val = line.rpartition(" ")
                rows.append((name, val))
            return ResultSet(["Metric", "Value"], rows)
        raise SQLError(f"unsupported SHOW {stmt.kind}")

    def _table_for(self, tn: ast.TableName) -> tuple[TableInfo, TableStore]:
        db = tn.db or self.current_db
        try:
            info = self.catalog.table(db, tn.name)
        except KeyError as e:
            raise err_wrap(SQLError, e) from None
        part = getattr(info, "partition", None)
        if part is not None:
            # first partition's store: the shared allocator + shared
            # dictionaries (see Storage._register_partitioned)
            return info, self.storage.table_store(part.defs[0].id)
        return info, self.storage.table_store(info.id)

    def _partition_children(self, info: TableInfo):
        """[(child TableInfo, store)] — a single pair for unpartitioned
        tables, so DML loops uniformly over physical tables."""
        part = getattr(info, "partition", None)
        if part is None:
            return [(info, self.storage.table_store(info.id))]
        return [(Storage.child_table_info(info, d),
                 self.storage.table_store(d.id)) for d in part.defs]

    @staticmethod
    def _physical_ids(info: TableInfo) -> list[int]:
        """The table ids holding a table's rows: its partitions' ids, or
        its own."""
        part = getattr(info, "partition", None)
        return [d.id for d in part.defs] if part is not None else [info.id]


def _parse_load_file(text: str, fmt) -> list[list[Optional[str]]]:
    """One-pass LOAD DATA record and field splitter honoring FIELDS
    TERMINATED/ENCLOSED/ESCAPED BY and LINES TERMINATED BY. esc+'N' as a
    whole field is SQL NULL; escapes apply before terminator matching, so
    escaped terminator characters stay literal."""
    ft, lt = fmt.field_term, fmt.line_term
    if not ft or not lt:
        # the parser rejects these; startswith("") would never advance
        raise ValueError("empty field/line terminator")
    enc, esc = fmt.enclosed, fmt.escaped
    esc_map = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "Z": "\x1a"}
    rows: list[list[Optional[str]]] = []
    fields: list[Optional[str]] = []
    cur: list[str] = []
    null_pending = False
    enclosure_seen = False  # an empty enclosed field ("") still counts
    i, n = 0, len(text)

    def end_field() -> None:
        nonlocal cur, null_pending, enclosure_seen
        if null_pending and not cur:
            fields.append(None)
        else:
            fields.append("".join(cur))
        cur = []
        null_pending = False
        enclosure_seen = False

    def end_line() -> None:
        nonlocal fields
        end_field()
        rows.append(fields)
        fields = []

    while i < n:
        c = text[i]
        if enc and not cur and not null_pending and c == enc:
            # enclosed field: scan to the closing quote (enc+enc = literal)
            enclosure_seen = True
            i += 1
            while i < n:
                c = text[i]
                if esc and c == esc and i + 1 < n:
                    nxt = text[i + 1]
                    cur.append(esc_map.get(nxt, nxt))
                    i += 2
                    continue
                if c == enc:
                    if i + 1 < n and text[i + 1] == enc:
                        cur.append(enc)
                        i += 2
                        continue
                    i += 1
                    break
                cur.append(c)
                i += 1
            continue  # the next characters should be a terminator
        if esc and c == esc and i + 1 < n:
            nxt = text[i + 1]
            if nxt == "N" and not cur and not null_pending:
                null_pending = True
            else:
                if null_pending:
                    cur.append("N")
                    null_pending = False
                cur.append(esc_map.get(nxt, nxt))
            i += 2
            continue
        if text.startswith(lt, i):
            end_line()
            i += len(lt)
            continue
        if text.startswith(ft, i):
            end_field()
            i += len(ft)
            continue
        if null_pending:
            cur.append("N")
            null_pending = False
        cur.append(c)
        i += 1
    if cur or fields or null_pending or enclosure_seen:
        end_line()
    return rows


def _load_convert(ft: FieldType, s: Optional[str]) -> Any:
    """LOAD DATA text field -> host value for the insert path, with
    MySQL's coercions: \\N is NULL; empty numeric and decimal fields load
    as 0; empty temporal fields as NULL; fractional text into an integer
    column rounds half away from zero."""
    if s is None:
        return None
    if ft.is_string or ft.kind == TypeKind.JSON:
        return s
    s = s.strip()
    if ft.kind in (TypeKind.DATE, TypeKind.DATETIME, TypeKind.TIMESTAMP):
        return s if s else None
    if ft.is_decimal:
        return s if s else "0"
    if not s:
        return 0
    try:
        if ft.is_float:
            return float(s)
        try:
            return int(s)
        except ValueError:
            f = float(s)
            return int(f + 0.5) if f >= 0 else -int(-f + 0.5)
    except ValueError:
        raise SQLError(
            f"Truncated incorrect {'DOUBLE' if ft.is_float else 'INTEGER'}"
            f" value: '{s}'",
            errno=ER_TRUNCATED_WRONG_VALUE) from None


def _outfile_text(v) -> str:
    """INTO OUTFILE cell rendering (MySQL text form)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _like_match(pattern: Optional[str], s: str) -> bool:
    """MySQL LIKE over SHOW output (case-insensitive, %, _ and \\-escapes;
    same conversion the coprocessor's LIKE kernel uses)."""
    if pattern is None:
        return True
    import re

    from ..copr.client import _like_to_regex

    return re.fullmatch(_like_to_regex(pattern), s,
                        re.IGNORECASE) is not None


def _coldef_ftype(cd) -> FieldType:
    """Column-definition type with NOT NULL applied."""
    ft = cd.ftype
    if cd.not_null:
        return FieldType(ft.kind, ft.flen, ft.scale, nullable=False)
    return ft


class _UniqueChecker:
    """Duplicate-key detection for DML writes: checks new rows against the
    snapshot (via index lookups) and against rows written earlier in the
    same statement. Counterpart of the reference's unique-index constraint
    path (table/tables/index.go Create; executor/insert.go dup handling,
    REPLACE semantics in executor/replace.go). NULL keys are never
    duplicates (MySQL unique-index NULL rule)."""

    def __init__(self, info: TableInfo, store: TableStore, txn: Transaction,
                 snap=None) -> None:
        from ..store.index import IndexSearcher

        self.info = info
        self.store = store
        self.uniques = [ix for ix in info.indices if ix.unique or ix.primary]
        need = bool(self.uniques) or info.pk_handle_offset is not None
        self.snap = snap if snap is not None else (
            txn.snapshot(info.id) if need else None)
        self._searchers = [
            IndexSearcher(store, self.snap, ix) for ix in self.uniques
        ] if self.snap is not None else []
        self._seen: list[dict] = [dict() for _ in self.uniques]
        self._deleted: set[int] = set()
        self._inserted: set[int] = set()

    def _key(self, ix: IndexInfo, enc: tuple):
        vals = tuple(enc[off] for off in ix.col_offsets)
        return None if any(v is None for v in vals) else vals

    def conflicts(self, handle: int, enc: tuple,
                  exclude: Optional[int] = None) -> list[int]:
        """Visible handles the new row collides with (pk or unique keys).
        Records the first violated constraint for dup_message."""
        out: list[int] = []
        self.last_dup: Optional[tuple[str, tuple]] = None
        if self.snap is None:
            return out
        if self.info.pk_handle_offset is not None:
            live = handle in self._inserted or (
                self.snap.has_handle(handle) and handle not in self._deleted)
            if live and handle != exclude:
                out.append(handle)
                self.last_dup = ("PRIMARY", (handle,))
        for ix, searcher, seen in zip(self.uniques, self._searchers,
                                      self._seen):
            key = self._key(ix, enc)
            if key is None:
                continue
            hits: list[int] = []
            h2 = seen.get(key)
            if h2 is not None and h2 != exclude and h2 not in self._deleted:
                hits.append(h2)
            for h in searcher.eq(key):
                h = int(h)
                # _inserted handles were rewritten this statement: their
                # snapshot index entries are stale (e.g. a multi-row UPDATE
                # vacating a unique value); their live keys are in `seen`
                if h != exclude and h not in self._deleted and \
                        h not in self._inserted:
                    hits.append(h)
            for h in hits:
                if h not in out:
                    out.append(h)
            if hits and self.last_dup is None:
                name = "PRIMARY" if ix.primary else ix.name
                shown = []  # decode dictionary codes back to strings
                for v, off in zip(key, ix.col_offsets):
                    d = self.store.dictionaries[off]
                    shown.append(d.decode(int(v)) if d is not None else v)
                self.last_dup = (name, tuple(shown))
        return out

    def dup_message(self, handle: int, enc: tuple, conflicts: list[int]) -> str:
        if self.last_dup is None:
            return "Duplicate entry"
        name, key = self.last_dup
        return (f"Duplicate entry '{'-'.join(str(v) for v in key)}' "
                f"for key '{name}'")

    def note_insert(self, handle: int, enc: tuple) -> None:
        self._inserted.add(handle)
        self._deleted.discard(handle)
        for ix, seen in zip(self.uniques, self._seen):
            key = self._key(ix, enc)
            if key is not None:
                seen[key] = handle

    def note_delete(self, handle: int) -> None:
        self._deleted.add(handle)
        self._inserted.discard(handle)


def _np_scalar(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _bind_params(node, params: list):
    """Replace ParamMarker nodes with typed literals (in a deep copy)."""
    import dataclasses as _dc

    if isinstance(node, ast.ParamMarker):
        v = params[node.idx]
        if v is None:
            return ast.Literal(None, "null")
        if isinstance(v, bool):
            return ast.Literal(v, "bool")
        if isinstance(v, int):
            return ast.Literal(v, "int")
        if isinstance(v, float):
            return ast.Literal(v, "float")
        if isinstance(v, Decimal):
            return ast.Literal(v, "decimal")
        return ast.Literal(str(v), "string")
    if not _dc.is_dataclass(node):
        return node
    for f in _dc.fields(node):
        v = getattr(node, f.name)
        if _dc.is_dataclass(v) and not isinstance(v, type):
            setattr(node, f.name, _bind_params(v, params))
        elif isinstance(v, list):
            setattr(node, f.name, [
                _bind_params(x, params)
                if _dc.is_dataclass(x) and not isinstance(x, type) else
                (tuple(_bind_params(y, params)
                       if _dc.is_dataclass(y) and not isinstance(y, type)
                       else y for y in x) if isinstance(x, tuple) else x)
                for x in v
            ])
    return node
