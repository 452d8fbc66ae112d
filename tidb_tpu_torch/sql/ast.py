"""AST node definitions for the SQL subset.

Counterpart of the reference's `ast.StmtNode`/`ast.ExprNode` hierarchy in
the external parser module. Plain dataclasses; the planner walks these.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..types.field_type import FieldType


# ---- generic traversal ------------------------------------------------------

def walk(node, visit) -> None:
    """Depth-first visit of every dataclass node (lists and tuples of
    nodes included). visit(node) returning False prunes that subtree."""
    import dataclasses as _dc

    if _dc.is_dataclass(node) and not isinstance(node, type):
        if visit(node) is False:
            return
        for f in _dc.fields(node):
            walk_value(getattr(node, f.name), visit)


def walk_value(v, visit) -> None:
    import dataclasses as _dc

    if _dc.is_dataclass(v) and not isinstance(v, type):
        walk(v, visit)
    elif isinstance(v, (list, tuple)):
        for x in v:
            walk_value(x, visit)


def transform(node, fn):
    """Bottom-up rewrite: fn(node) -> replacement (or the node itself).
    Mutates dataclass fields in place; lists/tuples are rebuilt."""
    import dataclasses as _dc

    def rec(v):
        if _dc.is_dataclass(v) and not isinstance(v, type):
            for f in _dc.fields(v):
                setattr(v, f.name, rec(getattr(v, f.name)))
            return fn(v)
        if isinstance(v, list):
            return [rec(x) for x in v]
        if isinstance(v, tuple):
            return tuple(rec(x) for x in v)
        return v

    return rec(node)


# ---- expressions ------------------------------------------------------------

class Expr:
    pass


@dataclass
class Literal(Expr):
    value: Any  # int | float | Decimal | str | bool | None
    # literal type tag: 'int' | 'float' | 'decimal' | 'string' | 'null' | 'bool'
    tag: str = "int"


@dataclass
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None  # qualifier as written
    db: Optional[str] = None

    def __str__(self) -> str:
        parts = [p for p in (self.db, self.table, self.name) if p]
        return ".".join(parts)


@dataclass
class BinaryOp(Expr):
    op: str  # '+', '-', '*', '/', 'DIV', '%', '=', '<', 'AND', 'OR', ...
    left: Expr
    right: Expr


@dataclass
class UnaryOp(Expr):
    op: str  # '-', 'NOT'
    operand: Expr


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    operand: Expr
    items: list[Expr]
    negated: bool = False


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class Like(Expr):
    operand: Expr
    pattern: Expr
    negated: bool = False


@dataclass
class ParamMarker(Expr):
    """A '?' placeholder in a prepared statement (binds at EXECUTE)."""

    idx: int


@dataclass
class SysVarExpr(Expr):
    """@@name / @@global.name / @@session.name — substituted with the
    variable's current value before planning."""

    name: str
    scope: str = "SESSION"


@dataclass
class UserVarExpr(Expr):
    """@name user variable read (session-scoped, SET @name = ...)."""

    name: str


@dataclass
class WindowFrame:
    """ROWS|RANGE BETWEEN <start> AND <end>. Bound types: 'unbounded',
    'current', 'preceding', 'following'; value set for the offset kinds."""

    unit: str  # 'ROWS' | 'RANGE'
    start_type: str
    start_value: Optional[int] = None
    end_type: str = "current"
    end_value: Optional[int] = None


@dataclass
class WindowSpec:
    partition_by: list["Expr"] = field(default_factory=list)
    order_by: list["OrderItem"] = field(default_factory=list)
    frame: Optional[WindowFrame] = None


@dataclass
class FuncCall(Expr):
    name: str  # upper-cased
    args: list[Expr]
    distinct: bool = False  # COUNT(DISTINCT x)
    is_star: bool = False  # COUNT(*)
    window: Optional[WindowSpec] = None  # fn(...) OVER (...)


@dataclass
class Case(Expr):
    operand: Optional[Expr]  # CASE x WHEN ... vs CASE WHEN cond ...
    branches: list[tuple[Expr, Expr]]  # (when, then)
    else_expr: Optional[Expr] = None


@dataclass
class Cast(Expr):
    operand: Expr
    target: FieldType


@dataclass
class IntervalExpr(Expr):
    value: Expr
    unit: str  # 'DAY', 'MONTH', 'YEAR', ...


@dataclass
class SubqueryExpr(Expr):
    query: "SelectStmt"
    # modifier: None (scalar), 'EXISTS', 'IN' handled via InSubquery
    exists: bool = False
    negated: bool = False


@dataclass
class InSubquery(Expr):
    operand: Expr
    query: "SelectStmt"
    negated: bool = False


# ---- statements -------------------------------------------------------------

class Stmt:
    pass


@dataclass
class SelectField:
    expr: Optional[Expr]  # None => wildcard
    alias: Optional[str] = None
    wildcard_table: Optional[str] = None  # t.* qualifier


@dataclass
class TableRef:
    pass


@dataclass
class TableName(TableRef):
    name: str
    db: Optional[str] = None
    alias: Optional[str] = None


@dataclass
class Join(TableRef):
    kind: str  # 'INNER' | 'LEFT' | 'RIGHT' | 'CROSS'
    left: TableRef
    right: TableRef
    on: Optional[Expr] = None
    using: Optional[list[str]] = None


@dataclass
class SubqueryTable(TableRef):
    query: "SelectStmt"
    alias: str = ""


@dataclass
class OrderItem:
    expr: Expr
    desc: bool = False


@dataclass
class SelectStmt(Stmt):
    fields: list[SelectField]
    from_: Optional[TableRef] = None
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    distinct: bool = False
    for_update: bool = False  # SELECT ... FOR UPDATE row locks
    # optimizer hints from /*+ ... */: (NAME, [args]) in source order
    hints: list[tuple[str, list[str]]] = field(default_factory=list)
    # SELECT ... INTO OUTFILE 'path' (reference: executor/select_into.go)
    into_outfile: Optional["FileFormat"] = None


@dataclass
class FileFormat:
    """FIELDS/LINES clauses shared by LOAD DATA and INTO OUTFILE
    (reference: ast.FieldsClause/LinesClause; defaults per MySQL docs)."""

    path: str
    field_term: str = "\t"
    enclosed: Optional[str] = None
    escaped: str = "\\"
    line_term: str = "\n"


@dataclass
class SetOpStmt(Stmt):
    """Chain of UNION [ALL] selects; trailing ORDER BY/LIMIT bind to the
    whole union (MySQL semantics for unparenthesized selects)."""

    selects: list[SelectStmt]
    alls: list[bool]  # alls[i]: is selects[i+1] joined with UNION ALL
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    into_outfile: Optional["FileFormat"] = None


@dataclass
class InsertStmt(Stmt):
    table: TableName
    columns: Optional[list[str]]  # None => all, in order
    rows: list[list[Expr]] = field(default_factory=list)
    select: Optional[SelectStmt] = None  # INSERT ... SELECT
    is_replace: bool = False
    # ON DUPLICATE KEY UPDATE assignments; VALUES(col) refs allowed
    on_dup: list = field(default_factory=list)


@dataclass
class LoadDataStmt(Stmt):
    """LOAD DATA [LOCAL] INFILE (reference: executor/load_data.go)."""

    table: TableName
    fmt: FileFormat
    columns: Optional[list[str]] = None  # None => all, in order
    local: bool = False
    dup_mode: str = "error"  # error | ignore | replace
    ignore_lines: int = 0


@dataclass
class Assignment:
    column: ColumnRef
    value: Expr


@dataclass
class UpdateStmt(Stmt):
    table: TableName
    assignments: list[Assignment]
    where: Optional[Expr] = None


@dataclass
class DeleteStmt(Stmt):
    table: TableName
    where: Optional[Expr] = None


@dataclass
class ColumnDef:
    name: str
    ftype: FieldType
    not_null: bool = False
    primary_key: bool = False
    unique: bool = False
    auto_increment: bool = False
    default: Optional[Expr] = None


@dataclass
class IndexDef:
    name: Optional[str]
    columns: list[str]
    unique: bool = False
    primary: bool = False


@dataclass
class FKDef:
    """FOREIGN KEY clause (reference: ast.Constraint with
    ConstraintForeignKey refs)."""

    name: Optional[str]
    columns: list[str]
    ref_table: "TableName"
    ref_columns: list[str]
    on_delete: str = "RESTRICT"
    on_update: str = "RESTRICT"


@dataclass
class CreateSequenceStmt(Stmt):
    name: "TableName"
    start: int = 1
    increment: int = 1
    min_value: int = 1
    max_value: int = (1 << 63) - 1
    cycle: bool = False
    if_not_exists: bool = False


@dataclass
class DropSequenceStmt(Stmt):
    names: list["TableName"]
    if_exists: bool = False


@dataclass
class PartitionByDef:
    """PARTITION BY clause (reference: ast.PartitionOptions)."""

    kind: str  # 'hash' | 'range'
    column: str
    # hash: partition count; range: [(name, less_than|None=MAXVALUE)]
    count: int = 0
    ranges: list[tuple[str, Optional[int]]] = field(default_factory=list)


@dataclass
class CreateTableStmt(Stmt):
    table: TableName
    columns: list[ColumnDef]
    indices: list[IndexDef] = field(default_factory=list)
    if_not_exists: bool = False
    partition_by: Optional[PartitionByDef] = None
    foreign_keys: list = field(default_factory=list)  # [FKDef]


@dataclass
class DropTableStmt(Stmt):
    tables: list[TableName]
    if_exists: bool = False


@dataclass
class AlterSpec:
    """One ALTER TABLE action (reference: ast.AlterTableSpec)."""

    op: str  # add_column | drop_column | add_index | drop_index |
    #          modify_column | rename | drop_partition | truncate_partition
    column: Optional[ColumnDef] = None
    index: Optional[IndexDef] = None
    name: str = ""  # drop target / rename-to / partition name


@dataclass
class AlterTableStmt(Stmt):
    table: TableName
    specs: list[AlterSpec] = field(default_factory=list)


@dataclass
class CreateIndexStmt(Stmt):
    name: str
    table: TableName
    columns: list[str]
    unique: bool = False


@dataclass
class DropIndexStmt(Stmt):
    name: str
    table: TableName


@dataclass
class RenameTableStmt(Stmt):
    renames: list[tuple[TableName, TableName]] = field(default_factory=list)


@dataclass
class AdminStmt(Stmt):
    kind: str  # 'SHOW_DDL_JOBS' | 'CHECK_TABLE'
    tables: list[TableName] = field(default_factory=list)


@dataclass
class AlterUserStmt(Stmt):
    """ALTER USER 'u' IDENTIFIED BY 'pwd' (reference: executor/simple.go
    executeAlterUser; SET PASSWORD maps here too)."""

    name: str
    password: str
    if_exists: bool = False


@dataclass
class RenameUserStmt(Stmt):
    pairs: list  # [(old, new)]


@dataclass
class ChecksumTableStmt(Stmt):
    """CHECKSUM TABLE t[, ...] (reference: executor/checksum.go)."""

    tables: list[TableName]


@dataclass
class CreateBindingStmt(Stmt):
    """CREATE [GLOBAL|SESSION] BINDING FOR <stmt> USING <hinted stmt>
    (reference: bindinfo/handle.go; ast CreateBindingStmt)."""

    scope: str  # 'GLOBAL' | 'SESSION'
    orig_sql: str  # raw text of the FOR statement
    bind_sql: str  # raw text of the USING statement
    bind_stmt: SelectStmt = None  # parsed USING stmt (hints source)


@dataclass
class DropBindingStmt(Stmt):
    scope: str
    orig_sql: str


@dataclass
class CreateDatabaseStmt(Stmt):
    name: str
    if_not_exists: bool = False


@dataclass
class DropDatabaseStmt(Stmt):
    name: str
    if_exists: bool = False


@dataclass
class TruncateTableStmt(Stmt):
    table: TableName


@dataclass
class UseStmt(Stmt):
    db: str


@dataclass
class BeginStmt(Stmt):
    mode: str = ""  # '' (tidb_txn_mode default) | PESSIMISTIC | OPTIMISTIC


@dataclass
class CommitStmt(Stmt):
    pass


@dataclass
class RollbackStmt(Stmt):
    pass


@dataclass
class ExplainStmt(Stmt):
    target: Stmt
    analyze: bool = False


@dataclass
class TraceStmt(Stmt):
    """TRACE <stmt>: runs the statement, returns the span tree
    (reference: executor/trace.go)."""

    target: Stmt


@dataclass
class ShowStmt(Stmt):
    kind: str  # 'TABLES' | 'DATABASES' | 'CREATE_TABLE' | 'VARIABLES' | ...
    target: Optional[TableName] = None
    pattern: Optional[str] = None  # LIKE pattern (VARIABLES/STATUS/COLUMNS)
    scope: str = "SESSION"  # SHOW GLOBAL|SESSION VARIABLES


@dataclass
class SetStmt(Stmt):
    # assignments of session/global variables: list of (scope, name, expr)
    items: list[tuple[str, str, Expr]] = field(default_factory=list)


@dataclass
class AnalyzeTableStmt(Stmt):
    tables: list[TableName] = field(default_factory=list)


@dataclass
class CreateUserStmt(Stmt):
    name: str
    password: str = ""
    if_not_exists: bool = False


@dataclass
class DropUserStmt(Stmt):
    name: str
    if_exists: bool = False


@dataclass
class GrantStmt(Stmt):
    privs: list[str] = field(default_factory=list)  # upper-case names
    db: str = "*"
    table: str = "*"
    user: str = ""
    revoke: bool = False
    # per-priv optional column list: GRANT SELECT (a, b) ON t
    priv_cols: list = field(default_factory=list)


@dataclass
class CreateRoleStmt(Stmt):
    names: list[str]
    if_not_exists: bool = False


@dataclass
class DropRoleStmt(Stmt):
    names: list[str]
    if_exists: bool = False


@dataclass
class GrantRoleStmt(Stmt):
    """GRANT role[, ...] TO user[, ...] / REVOKE ... FROM ...
    (reference: privilege/privileges roles; executor/grant.go)."""

    roles: list[str]
    users: list[str]
    revoke: bool = False


@dataclass
class SetRoleStmt(Stmt):
    mode: str  # 'ALL' | 'NONE' | 'DEFAULT' | 'LIST'
    roles: list[str] = field(default_factory=list)


@dataclass
class SetDefaultRoleStmt(Stmt):
    mode: str  # 'ALL' | 'NONE' | 'LIST'
    roles: list[str]
    users: list[str]


@dataclass
class KillStmt(Stmt):
    """KILL [QUERY | CONNECTION] <id> (reference: server/server.go:548
    Kill; QUERY interrupts the running statement, CONNECTION also drops
    the session)."""

    conn_id: int
    query_only: bool = False


@dataclass
class CreateViewStmt(Stmt):
    name: str
    select_sql: str
    columns: tuple = ()
    or_replace: bool = False
    db: Optional[str] = None


@dataclass
class DropViewStmt(Stmt):
    name: str
    if_exists: bool = False
    db: Optional[str] = None
