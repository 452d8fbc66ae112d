"""Recursive-descent / Pratt parser for the MySQL-compatible subset.

Counterpart of the reference's external goyacc parser (reference:
github.com/pingcap/parser; used via session.ParseSQL, session/session.go:1190).
Covers the surface needed by TPC-H/SSB/ClickBench-style analytics plus DML,
DDL, txn control, EXPLAIN/SHOW — widened as the framework grows.
"""

from __future__ import annotations

from typing import Optional

from ..types.field_type import FieldType, TypeKind
from ..types.value import Decimal
from . import ast
from .lexer import Lexer, Token, TokenKind

# Binary operator precedence (higher binds tighter), MySQL order.
_PRECEDENCE = {
    "OR": 1, "||": 1,
    "XOR": 2,
    "AND": 3, "&&": 3,
    # 4 reserved for NOT (prefix, handled separately)
    "=": 5, "<=>": 5, "<>": 5, "!=": 5, "<": 5, "<=": 5, ">": 5, ">=": 5,
    "|": 6,
    "&": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "DIV": 10, "%": 10, "MOD": 10,
    "^": 11,
}

_COMPARISON_LEVEL = 5

_AGG_FUNCS = frozenset({"COUNT", "SUM", "AVG", "MIN", "MAX"})

_TYPE_KEYWORDS = {
    "TINYINT": TypeKind.TINYINT,
    "SMALLINT": TypeKind.SMALLINT,
    "INT": TypeKind.INT,
    "INTEGER": TypeKind.INT,
    "BIGINT": TypeKind.BIGINT,
    "FLOAT": TypeKind.FLOAT,
    "DOUBLE": TypeKind.DOUBLE,
    "REAL": TypeKind.DOUBLE,
    "DECIMAL": TypeKind.DECIMAL,
    "NUMERIC": TypeKind.DECIMAL,
    "DATE": TypeKind.DATE,
    "DATETIME": TypeKind.DATETIME,
    "TIMESTAMP": TypeKind.TIMESTAMP,
    "CHAR": TypeKind.CHAR,
    "VARCHAR": TypeKind.VARCHAR,
    "TEXT": TypeKind.TEXT,
    "BOOLEAN": TypeKind.BOOLEAN,
    "BOOL": TypeKind.BOOLEAN,
    "YEAR": TypeKind.YEAR,
}


class ParseError(Exception):
    errno = 1064  # ER_PARSE_ERROR (tidb_tpu/errno.py; avoids the import)
    sqlstate = "42000"

    def __init__(self, msg: str, token: Token) -> None:
        where = f"near {token.text!r}" if token.text else "at end of input"
        super().__init__(f"{msg} {where} (pos {token.pos})")
        self.token = token


class Parser:
    def __init__(self, text: str) -> None:
        self.text = text
        toks = list(Lexer(text).tokens())
        # optimizer hints are meaningful only right after SELECT; stray
        # hint comments elsewhere degrade to plain comments (MySQL does
        # the same — hints in unsupported positions are ignored)
        self.toks = [
            t for i, t in enumerate(toks)
            if t.kind != TokenKind.HINT
            or (i > 0 and toks[i - 1].is_kw("SELECT"))
        ]
        self.i = 0

    # ---- token helpers -----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def peek(self, n: int = 1) -> Token:
        j = min(self.i + n, len(self.toks) - 1)
        return self.toks[j]

    def advance(self) -> Token:
        t = self.toks[self.i]
        if t.kind != TokenKind.EOF:
            self.i += 1
        return t

    def accept_kw(self, *names: str) -> Optional[Token]:
        if self.cur.is_kw(*names):
            return self.advance()
        return None

    def accept_op(self, *ops: str) -> Optional[Token]:
        if self.cur.is_op(*ops):
            return self.advance()
        return None

    def expect_kw(self, *names: str) -> Token:
        t = self.accept_kw(*names)
        if t is None:
            raise ParseError(f"expected {'/'.join(names)}", self.cur)
        return t

    def expect_op(self, op: str) -> Token:
        t = self.accept_op(op)
        if t is None:
            raise ParseError(f"expected {op!r}", self.cur)
        return t

    def expect_ident(self) -> str:
        """Identifier; unreserved-ish keywords double as identifiers."""
        t = self.cur
        if t.kind == TokenKind.IDENT:
            self.advance()
            return t.text
        if t.kind == TokenKind.KEYWORD and t.text in _IDENT_KEYWORDS:
            self.advance()
            return t.text.lower()
        raise ParseError("expected identifier", t)

    # ---- entry -------------------------------------------------------------
    def parse(self) -> list[ast.Stmt]:
        stmts: list[ast.Stmt] = []
        while True:
            while self.accept_op(";"):
                pass
            if self.cur.kind == TokenKind.EOF:
                return stmts
            stmts.append(self.parse_statement())
            if self.cur.kind != TokenKind.EOF:
                self.expect_op(";")

    param_count: int = 0

    def parse_statement(self) -> ast.Stmt:
        t = self.cur
        if t.is_kw("SELECT"):
            return self.parse_select_statement()
        if t.is_kw("INSERT", "REPLACE"):
            return self.parse_insert()
        if t.is_kw("UPDATE"):
            return self.parse_update()
        if t.is_kw("DELETE"):
            return self.parse_delete()
        if t.is_kw("CREATE"):
            return self.parse_create()
        if t.is_kw("DROP"):
            return self.parse_drop()
        if t.is_kw("TRUNCATE"):
            self.advance()
            self.accept_kw("TABLE")
            return ast.TruncateTableStmt(self.parse_table_name())
        if t.is_kw("USE"):
            self.advance()
            return ast.UseStmt(self.expect_ident())
        if t.is_kw("BEGIN"):
            self.advance()
            mode = ""
            m = self.accept_kw("PESSIMISTIC", "OPTIMISTIC")
            if m is not None:
                mode = m.text
            return ast.BeginStmt(mode)
        if t.is_kw("START"):
            self.advance()
            self.expect_kw("TRANSACTION")
            return ast.BeginStmt()
        if t.is_kw("COMMIT"):
            self.advance()
            return ast.CommitStmt()
        if t.is_kw("ROLLBACK"):
            self.advance()
            return ast.RollbackStmt()
        if t.is_kw("EXPLAIN", "DESC", "DESCRIBE"):
            return self.parse_explain()
        if t.is_kw("TRACE"):
            self.advance()
            return ast.TraceStmt(self.parse_statement())
        if t.is_kw("KILL"):
            self.advance()
            query_only = self.accept_kw("QUERY") is not None
            if not query_only:
                self.accept_kw("CONNECTION")
            tok = self.cur
            self.advance()
            try:
                cid = int(tok.text)
            except ValueError:
                raise ParseError("expected connection id after KILL", tok)
            return ast.KillStmt(cid, query_only)
        if t.is_kw("SHOW"):
            return self.parse_show()
        if t.is_kw("SET"):
            return self.parse_set()
        if t.is_kw("ANALYZE"):
            self.advance()
            self.expect_kw("TABLE")
            tables = [self.parse_table_name()]
            while self.accept_op(","):
                tables.append(self.parse_table_name())
            return ast.AnalyzeTableStmt(tables)
        if t.is_kw("ALTER"):
            return self.parse_alter()
        if t.is_kw("RENAME"):
            self.advance()
            if self.accept_kw("USER"):
                pairs = []
                while True:
                    old = self._parse_account_name()
                    self.expect_kw("TO")
                    pairs.append((old, self._parse_account_name()))
                    if not self.accept_op(","):
                        break
                return ast.RenameUserStmt(pairs)
            self.expect_kw("TABLE")
            renames = []
            while True:
                old = self.parse_table_name()
                self.expect_kw("TO")
                renames.append((old, self.parse_table_name()))
                if not self.accept_op(","):
                    break
            return ast.RenameTableStmt(renames)
        if t.is_kw("ADMIN"):
            self.advance()
            if self.accept_kw("CHECK"):
                self.expect_kw("TABLE")
                tables = [self.parse_table_name()]
                while self.accept_op(","):
                    tables.append(self.parse_table_name())
                return ast.AdminStmt("CHECK_TABLE", tables)
            self.expect_kw("SHOW")
            self.expect_kw("DDL")
            self.expect_kw("JOBS")
            return ast.AdminStmt("SHOW_DDL_JOBS")
        if t.is_kw("LOAD"):
            return self.parse_load_data()
        if t.kind == TokenKind.IDENT and t.text.upper() == "CHECKSUM":
            self.advance()
            self.expect_kw("TABLE")
            tables = [self.parse_table_name()]
            while self.accept_op(","):
                tables.append(self.parse_table_name())
            return ast.ChecksumTableStmt(tables)
        if t.is_kw("GRANT", "REVOKE"):
            return self.parse_grant(revoke=t.is_kw("REVOKE"))
        raise ParseError("unsupported statement", t)

    def _string_lit(self, what: str) -> str:
        t = self.cur
        if t.kind != TokenKind.STRING:
            raise ParseError(f"expected string literal for {what}", t)
        self.advance()
        return t.text

    def _parse_file_format(self, path: str) -> "ast.FileFormat":
        """[FIELDS|COLUMNS TERMINATED BY s [OPTIONALLY] ENCLOSED BY s
        ESCAPED BY s] [LINES TERMINATED BY s] — shared by LOAD DATA and
        SELECT INTO OUTFILE (MySQL defaults: tab fields, newline lines)."""
        fmt = ast.FileFormat(path)
        if self.accept_kw("FIELDS", "COLUMNS"):
            seen = False
            while True:
                if self.accept_kw("TERMINATED"):
                    self.expect_kw("BY")
                    fmt.field_term = self._string_lit("TERMINATED BY")
                    if not fmt.field_term:
                        raise ParseError(
                            "FIELDS TERMINATED BY must not be empty",
                            self.cur)
                elif self.cur.is_kw("OPTIONALLY") or \
                        self.cur.is_kw("ENCLOSED"):
                    self.accept_kw("OPTIONALLY")
                    self.expect_kw("ENCLOSED")
                    self.expect_kw("BY")
                    fmt.enclosed = self._string_lit("ENCLOSED BY")
                elif self.accept_kw("ESCAPED"):
                    self.expect_kw("BY")
                    fmt.escaped = self._string_lit("ESCAPED BY")
                else:
                    if not seen:
                        raise ParseError("expected TERMINATED/ENCLOSED/"
                                         "ESCAPED BY", self.cur)
                    break
                seen = True
        if self.accept_kw("LINES"):
            self.expect_kw("TERMINATED")
            self.expect_kw("BY")
            fmt.line_term = self._string_lit("LINES TERMINATED BY")
            if not fmt.line_term:
                raise ParseError(
                    "LINES TERMINATED BY must not be empty", self.cur)
        return fmt

    def parse_load_data(self) -> ast.LoadDataStmt:
        """LOAD DATA [LOCAL] INFILE 'path' [REPLACE|IGNORE] INTO TABLE t
        [format] [IGNORE n LINES] [(col, ...)]
        (reference: executor/load_data.go)."""
        self.expect_kw("LOAD")
        self.expect_kw("DATA")
        local = bool(self.accept_kw("LOCAL"))
        self.expect_kw("INFILE")
        path = self._string_lit("INFILE")
        dup = "error"
        if self.accept_kw("REPLACE"):
            dup = "replace"
        elif self.accept_kw("IGNORE"):
            dup = "ignore"
        self.expect_kw("INTO")
        self.expect_kw("TABLE")
        table = self.parse_table_name()
        fmt = self._parse_file_format(path)
        ignore_lines = 0
        if self.accept_kw("IGNORE"):
            ignore_lines = self.parse_uint("IGNORE")
            self.expect_kw("LINES")
        columns = None
        if self.accept_op("("):
            columns = [self.expect_ident()]
            while self.accept_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
        return ast.LoadDataStmt(table, fmt, columns, local, dup,
                                ignore_lines)

    def parse_grant(self, revoke: bool) -> ast.Stmt:
        """GRANT/REVOKE priv[, priv] ON [db.]tbl TO/FROM user
        (reference: privilege checks fed by mysql.user/db/tables_priv)."""
        self.advance()  # GRANT / REVOKE
        privs: list[str] = []
        priv_cols: list = []
        role_names: list[str] = []
        while True:
            if self.accept_kw("ALL"):
                self.accept_kw("PRIVILEGES")
                privs.append("ALL")
                priv_cols.append(None)
                role_names = []  # ALL can't be a role name
            else:
                if self.cur.kind in (TokenKind.STRING, TokenKind.IDENT):
                    role_names.append(self.cur.text)
                else:
                    role_names = []
                t = self.advance()
                privs.append(t.text.upper())
                if self.cur.is_op("("):
                    # column-scoped privilege: GRANT SELECT (a, b) ON t
                    priv_cols.append(self._paren_ident_list())
                    role_names = []
                else:
                    priv_cols.append(None)
                if self.cur.is_op("@"):
                    # 'role'@'host' account form (what SHOW GRANTS
                    # emits); host accepted and discarded (single-host)
                    self.advance()
                    self.advance()
            if not self.accept_op(","):
                break
        # GRANT role[, ...] TO user / REVOKE role FROM user: no ON clause
        if len(role_names) == len(privs) and (
                self.cur.is_kw("FROM") if revoke else self.cur.is_kw("TO")):
            self.advance()
            users = [self._parse_account_name()]
            while self.accept_op(","):
                users.append(self._parse_account_name())
            return ast.GrantRoleStmt(role_names, users, revoke)
        self.expect_kw("ON")
        db = tbl = "*"
        if self.accept_op("*"):
            if self.accept_op("."):
                self.expect_op("*")
        else:
            first = self.expect_ident()
            if self.accept_op("."):
                db = first
                tbl = "*" if self.accept_op("*") else self.expect_ident()
            else:
                # unqualified table scopes to the CURRENT database (MySQL
                # semantics) — resolved at execution, marked "" here
                db = ""
                tbl = first
        self.expect_kw("FROM" if revoke else "TO")
        user = self._parse_account_name()
        return ast.GrantStmt(privs, db, tbl, user, revoke, priv_cols)

    def parse_alter(self) -> ast.Stmt:
        self.expect_kw("ALTER")
        if self.accept_kw("USER"):
            if_exists = self._if_exists()
            name = self._parse_account_name()
            self.expect_kw("IDENTIFIED")
            self.expect_kw("BY")
            pwd = self._string_lit("IDENTIFIED BY")
            return ast.AlterUserStmt(name, pwd, if_exists)
        self.expect_kw("TABLE")
        table = self.parse_table_name()
        specs: list[ast.AlterSpec] = []
        while True:
            if self.accept_kw("ADD"):
                if self.cur.is_kw("PRIMARY"):
                    self.advance()
                    self.expect_kw("KEY")
                    specs.append(ast.AlterSpec(
                        "add_index",
                        index=ast.IndexDef("PRIMARY", self._paren_ident_list(),
                                           unique=True, primary=True)))
                elif self.cur.is_kw("UNIQUE"):
                    self.advance()
                    self.accept_kw("KEY", "INDEX")
                    name = self._opt_index_name()
                    specs.append(ast.AlterSpec(
                        "add_index",
                        index=ast.IndexDef(name, self._paren_ident_list(),
                                           unique=True)))
                elif self.cur.is_kw("KEY", "INDEX"):
                    self.advance()
                    name = self._opt_index_name()
                    specs.append(ast.AlterSpec(
                        "add_index",
                        index=ast.IndexDef(name, self._paren_ident_list())))
                else:
                    self.accept_kw("COLUMN")
                    specs.append(ast.AlterSpec(
                        "add_column", column=self.parse_column_def()))
            elif self.accept_kw("DROP"):
                if self.cur.is_kw("KEY", "INDEX"):
                    self.advance()
                    specs.append(ast.AlterSpec("drop_index",
                                               name=self.expect_ident()))
                elif self.cur.is_kw("PARTITION"):
                    self.advance()
                    specs.append(ast.AlterSpec("drop_partition",
                                               name=self.expect_ident()))
                else:
                    self.accept_kw("COLUMN")
                    specs.append(ast.AlterSpec("drop_column",
                                               name=self.expect_ident()))
            elif self.accept_kw("TRUNCATE"):
                self.expect_kw("PARTITION")
                specs.append(ast.AlterSpec("truncate_partition",
                                           name=self.expect_ident()))
            elif self.accept_kw("MODIFY"):
                self.accept_kw("COLUMN")
                specs.append(ast.AlterSpec(
                    "modify_column", column=self.parse_column_def()))
            elif self.accept_kw("RENAME"):
                self.accept_kw("TO", "AS")
                specs.append(ast.AlterSpec("rename",
                                           name=self.expect_ident()))
            else:
                raise ParseError("unsupported ALTER action", self.cur)
            if not self.accept_op(","):
                break
        return ast.AlterTableStmt(table, specs)

    # ---- SELECT ------------------------------------------------------------
    def parse_select_statement(self) -> ast.Stmt:
        """SELECT ... [UNION [ALL] SELECT ...]*; a trailing ORDER BY/LIMIT
        binds to the union (reference: parser union list grammar)."""
        first = self.parse_select()
        if not self.cur.is_kw("UNION"):
            return first
        selects = [first]
        alls: list[bool] = []
        while self.accept_kw("UNION"):
            if selects[-1].order_by or selects[-1].limit is not None:
                raise ParseError(
                    "incorrect usage of UNION and ORDER BY/LIMIT "
                    "(parenthesize the SELECT)", self.cur)
            is_all = bool(self.accept_kw("ALL"))
            if not is_all:
                self.accept_kw("DISTINCT")
            selects.append(self.parse_select())
            alls.append(is_all)
        # the trailing ORDER BY/LIMIT/INTO OUTFILE was consumed by the
        # last SELECT; it belongs to the union
        last = selects[-1]
        stmt = ast.SetOpStmt(selects, alls, last.order_by, last.limit,
                             last.offset)
        stmt.into_outfile = last.into_outfile
        last.order_by, last.limit, last.offset = [], None, 0
        last.into_outfile = None
        return stmt

    def parse_select(self) -> ast.SelectStmt:
        self.expect_kw("SELECT")
        hints: list[tuple[str, list[str]]] = []
        if self.cur.kind == TokenKind.HINT:
            hints = _parse_hints(self.advance().text)
        distinct = bool(self.accept_kw("DISTINCT"))
        self.accept_kw("ALL")

        fields = [self.parse_select_field()]
        while self.accept_op(","):
            fields.append(self.parse_select_field())

        stmt = ast.SelectStmt(fields=fields, distinct=distinct,
                              hints=hints)
        if self.accept_kw("FROM"):
            stmt.from_ = self.parse_table_refs()
        if self.accept_kw("WHERE"):
            stmt.where = self.parse_expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            stmt.group_by.append(self.parse_expr())
            while self.accept_op(","):
                stmt.group_by.append(self.parse_expr())
        if self.accept_kw("HAVING"):
            stmt.having = self.parse_expr()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by.append(self.parse_order_item())
            while self.accept_op(","):
                stmt.order_by.append(self.parse_order_item())
        if self.accept_kw("LIMIT"):
            first = self.parse_uint("LIMIT")
            if self.accept_op(","):  # LIMIT offset, count
                stmt.offset = first
                stmt.limit = self.parse_uint("LIMIT")
            else:
                stmt.limit = first
                if self.accept_kw("OFFSET"):
                    stmt.offset = self.parse_uint("OFFSET")
        if self.accept_kw("FOR"):
            self.expect_kw("UPDATE")
            stmt.for_update = True
        if self.cur.is_kw("INTO") and self.peek().is_kw("OUTFILE"):
            self.advance()
            self.advance()
            path = self._string_lit("OUTFILE")
            stmt.into_outfile = self._parse_file_format(path)
        return stmt

    def parse_uint(self, what: str) -> int:
        t = self.cur
        if t.kind != TokenKind.INT:
            raise ParseError(f"expected integer after {what}", t)
        self.advance()
        return int(t.text)

    def parse_select_field(self) -> ast.SelectField:
        if self.accept_op("*"):
            return ast.SelectField(expr=None)
        # t.* wildcard
        if (
            self.cur.kind == TokenKind.IDENT
            and self.peek().is_op(".")
            and self.peek(2).is_op("*")
        ):
            tbl = self.advance().text
            self.advance()
            self.advance()
            return ast.SelectField(expr=None, wildcard_table=tbl)
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.expect_ident()
        elif self.cur.kind == TokenKind.IDENT:
            alias = self.advance().text
        elif self.cur.kind == TokenKind.STRING:
            alias = self.advance().text
        return ast.SelectField(expr=expr, alias=alias)

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("DESC"):
            desc = True
        else:
            self.accept_kw("ASC")
        return ast.OrderItem(e, desc)

    # ---- FROM / joins ------------------------------------------------------
    def parse_table_refs(self) -> ast.TableRef:
        left = self.parse_join_chain()
        while self.accept_op(","):  # comma join = cross join
            right = self.parse_join_chain()
            left = ast.Join("CROSS", left, right)
        return left

    def parse_join_chain(self) -> ast.TableRef:
        left = self.parse_table_factor()
        while True:
            kind = None
            if self.accept_kw("INNER"):
                self.expect_kw("JOIN")
                kind = "INNER"
            elif self.accept_kw("CROSS"):
                self.expect_kw("JOIN")
                kind = "CROSS"
            elif self.accept_kw("LEFT"):
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "LEFT"
            elif self.accept_kw("RIGHT"):
                self.accept_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "RIGHT"
            elif self.accept_kw("JOIN"):
                kind = "INNER"
            else:
                return left
            right = self.parse_table_factor()
            on = None
            using = None
            if self.accept_kw("ON"):
                on = self.parse_expr()
            elif self.accept_kw("USING"):
                self.expect_op("(")
                using = [self.expect_ident()]
                while self.accept_op(","):
                    using.append(self.expect_ident())
                self.expect_op(")")
            left = ast.Join(kind, left, right, on=on, using=using)

    def parse_table_factor(self) -> ast.TableRef:
        if self.accept_op("("):
            if self.cur.is_kw("SELECT"):
                sub = self.parse_select_statement()
                self.expect_op(")")
                alias = ""
                self.accept_kw("AS")
                if self.cur.kind == TokenKind.IDENT:
                    alias = self.advance().text
                return ast.SubqueryTable(sub, alias)
            refs = self.parse_table_refs()
            self.expect_op(")")
            return refs
        return self.parse_table_name(allow_alias=True)

    def parse_table_name(self, allow_alias: bool = False) -> ast.TableName:
        name = self.expect_ident()
        db = None
        if self.accept_op("."):
            db, name = name, self.expect_ident()
        alias = None
        if allow_alias:
            if self.accept_kw("AS"):
                alias = self.expect_ident()
            elif self.cur.kind == TokenKind.IDENT:
                alias = self.advance().text
        return ast.TableName(name=name, db=db, alias=alias)

    # ---- DML ---------------------------------------------------------------
    def parse_insert(self) -> ast.InsertStmt:
        is_replace = bool(self.accept_kw("REPLACE"))
        if not is_replace:
            self.expect_kw("INSERT")
        self.accept_kw("INTO")
        table = self.parse_table_name()
        columns = None
        if self.accept_op("("):
            columns = [self.expect_ident()]
            while self.accept_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
        if self.cur.is_kw("SELECT"):
            sel = self.parse_select_statement()
            return ast.InsertStmt(table, columns, select=sel,
                                  is_replace=is_replace,
                                  on_dup=self._parse_on_dup())
        self.expect_kw("VALUES")
        rows = [self.parse_value_row()]
        while self.accept_op(","):
            rows.append(self.parse_value_row())
        return ast.InsertStmt(table, columns, rows=rows,
                              is_replace=is_replace,
                              on_dup=self._parse_on_dup())

    def _parse_on_dup(self) -> list[ast.Assignment]:
        """ON DUPLICATE KEY UPDATE col = expr, ... (reference: ast
        OnDuplicateAssignment; VALUES(col) refers to the would-be
        inserted value)."""
        if not self.accept_kw("ON"):
            return []
        for kw in ("DUPLICATE", "KEY", "UPDATE"):
            t = self.cur
            if not (t.is_kw(kw) or (t.kind == TokenKind.IDENT
                                    and t.text.upper() == kw)):
                raise ParseError(f"expected {kw}", t)
            self.advance()
        out = [self.parse_assignment()]
        while self.accept_op(","):
            out.append(self.parse_assignment())
        return out

    def parse_value_row(self) -> list[ast.Expr]:
        self.expect_op("(")
        if self.accept_op(")"):
            return []
        row = [self.parse_expr()]
        while self.accept_op(","):
            row.append(self.parse_expr())
        self.expect_op(")")
        return row

    def parse_update(self) -> ast.UpdateStmt:
        self.expect_kw("UPDATE")
        table = self.parse_table_name(allow_alias=True)
        self.expect_kw("SET")
        assigns = [self.parse_assignment()]
        while self.accept_op(","):
            assigns.append(self.parse_assignment())
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        return ast.UpdateStmt(table, assigns, where)

    def parse_assignment(self) -> ast.Assignment:
        col = self.parse_column_ref()
        self.expect_op("=")
        return ast.Assignment(col, self.parse_expr())

    def parse_delete(self) -> ast.DeleteStmt:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self.parse_table_name(allow_alias=True)
        where = self.parse_expr() if self.accept_kw("WHERE") else None
        return ast.DeleteStmt(table, where)

    # ---- DDL ---------------------------------------------------------------
    def _parse_account_name(self) -> str:
        """'user'[@'host'] — host accepted and discarded (single-host)."""
        t = self.cur
        if t.kind in (TokenKind.STRING, TokenKind.IDENT):
            self.advance()
            name = t.text
        else:
            name = self.expect_ident()
        if self.accept_op("@"):
            self.advance()  # host (ident or string)
        return name

    def _parse_binding_tail(self) -> tuple[str, str, "ast.Stmt"]:
        """FOR <stmt> USING <stmt> -> (orig raw text, bind raw text,
        parsed bind stmt). The raw texts are what bindinfo stores
        (reference: bindinfo/handle.go normalizes and persists both)."""
        self.expect_kw("FOR")
        start = self.cur.pos
        self.parse_select_statement()
        if not self.cur.is_kw("USING"):
            raise ParseError("expected USING in BINDING", self.cur)
        orig = self.text[start:self.cur.pos].strip()
        self.advance()
        bstart = self.cur.pos
        bind_stmt = self.parse_select_statement()
        bend = self.cur.pos if self.cur.kind != TokenKind.EOF \
            else len(self.text)
        bind = self.text[bstart:bend].strip().rstrip(";").strip()
        return orig, bind, bind_stmt

    def parse_create(self) -> ast.Stmt:
        self.expect_kw("CREATE")
        scope_t = None
        if self.cur.is_kw("GLOBAL", "SESSION") and \
                self.peek().kind == TokenKind.IDENT and \
                self.peek().text.upper() == "BINDING":
            scope_t = self.advance().text
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "BINDING":
            self.advance()
            orig, bind, bind_stmt = self._parse_binding_tail()
            return ast.CreateBindingStmt(scope_t or "SESSION", orig,
                                         bind, bind_stmt)
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "ROLE":
            self.advance()
            ine = self._if_not_exists()
            names = [self._parse_account_name()]
            while self.accept_op(","):
                names.append(self._parse_account_name())
            return ast.CreateRoleStmt(names, ine)
        or_replace = False
        if self.cur.is_kw("OR"):
            self.advance()
            if not (self.cur.kind == TokenKind.IDENT
                    and self.cur.text.upper() == "REPLACE") and \
                    not self.cur.is_kw("REPLACE"):
                raise ParseError("expected REPLACE after OR", self.cur)
            self.advance()
            or_replace = True
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "VIEW":
            self.advance()
            tn = self.parse_table_name()
            cols: tuple = ()
            if self.cur.is_op("("):
                cols = tuple(self._paren_ident_list())
            self.expect_kw("AS")
            start = self.cur.pos
            self.parse_select()  # validate; the TEXT is what's stored
            sql = self.text[start:
                            self.cur.pos if self.cur.kind
                            != TokenKind.EOF else len(self.text)].strip()
            if sql.endswith(";"):
                sql = sql[:-1]
            return ast.CreateViewStmt(tn.name, sql, cols, or_replace,
                                      tn.db)
        if or_replace:
            raise ParseError("OR REPLACE supports only VIEW", self.cur)
        if self.accept_kw("DATABASE", "SCHEMA"):
            ine = self._if_not_exists()
            return ast.CreateDatabaseStmt(self.expect_ident(), ine)
        if self.accept_kw("USER"):
            ine = self._if_not_exists()
            name = self._parse_account_name()
            password = ""
            if self.accept_kw("IDENTIFIED"):
                self.expect_kw("BY")
                password = self.advance().text
            return ast.CreateUserStmt(name, password, ine)
        unique = bool(self.accept_kw("UNIQUE"))
        if self.accept_kw("INDEX", "KEY"):
            name = self.expect_ident()
            self.expect_kw("ON")
            table = self.parse_table_name()
            return ast.CreateIndexStmt(name, table,
                                       self._paren_ident_list(), unique)
        if unique:
            raise ParseError("expected INDEX after CREATE UNIQUE", self.cur)
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "SEQUENCE":
            self.advance()
            return self._parse_create_sequence()
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        table = self.parse_table_name()
        self.expect_op("(")
        columns: list[ast.ColumnDef] = []
        indices: list[ast.IndexDef] = []
        fks: list[ast.FKDef] = []
        while True:
            if self.cur.is_kw("CONSTRAINT", "FOREIGN"):
                fks.append(self._parse_fk_clause())
            elif self.cur.is_kw("PRIMARY"):
                self.advance()
                self.expect_kw("KEY")
                cols = self._paren_ident_list()
                indices.append(ast.IndexDef("PRIMARY", cols, unique=True, primary=True))
            elif self.cur.is_kw("UNIQUE"):
                self.advance()
                self.accept_kw("KEY", "INDEX")
                name = self._opt_index_name()
                indices.append(ast.IndexDef(name, self._paren_ident_list(), unique=True))
            elif self.cur.is_kw("KEY", "INDEX"):
                self.advance()
                name = self._opt_index_name()
                indices.append(ast.IndexDef(name, self._paren_ident_list()))
            else:
                columns.append(self.parse_column_def())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        # table options (ENGINE=..., CHARSET=...) are swallowed up to the
        # PARTITION BY clause (which we parse) or end of statement
        partition_by = None
        while self.cur.kind != TokenKind.EOF and not self.cur.is_op(";"):
            if self.cur.is_kw("PARTITION"):
                partition_by = self._parse_partition_by()
                break
            self.advance()
        # column-level REFERENCES lift into table-level FK metadata
        for cd in columns:
            ref = getattr(cd, "references", None)
            if ref is not None:
                fks.append(ast.FKDef(None, [cd.name], ref[0], ref[1]))
        return ast.CreateTableStmt(table, columns, indices, ine,
                                   partition_by, fks)

    def _parse_fk_clause(self) -> ast.FKDef:
        """[CONSTRAINT [name]] FOREIGN KEY (cols) REFERENCES tbl (cols)
        [ON DELETE action] [ON UPDATE action]."""
        name = None
        if self.accept_kw("CONSTRAINT"):
            if self.cur.kind == TokenKind.IDENT:
                name = self.advance().text
        self.expect_kw("FOREIGN")
        self.expect_kw("KEY")
        if self.cur.kind == TokenKind.IDENT:  # optional index name
            name = name or self.advance().text
        cols = self._paren_ident_list()
        self.expect_kw("REFERENCES")
        ref_table = self.parse_table_name()
        ref_cols = self._paren_ident_list()
        on_delete = on_update = "RESTRICT"
        while self.accept_kw("ON"):
            which = self.expect_kw("DELETE", "UPDATE").text
            action = self._parse_fk_action()
            if which == "DELETE":
                on_delete = action
            else:
                on_update = action
        return ast.FKDef(name, cols, ref_table, ref_cols,
                         on_delete, on_update)

    def _parse_fk_action(self) -> str:
        if self.accept_kw("SET"):
            self.expect_kw("NULL")
            return "SET NULL"
        t = self.cur
        word = t.text.upper()
        if word in ("RESTRICT", "CASCADE"):
            self.advance()
            return word
        if word == "NO":
            self.advance()
            nxt = self.advance()
            if nxt.text.upper() != "ACTION":
                raise ParseError("expected NO ACTION", nxt)
            return "NO ACTION"
        raise ParseError("expected referential action", t)

    def _parse_create_sequence(self) -> ast.CreateSequenceStmt:
        """CREATE SEQUENCE (reference: TiDB's MariaDB-style sequences,
        ddl/sequence.go; CACHE is accepted and ignored — caching is the
        allocator's concern)."""
        ine = self._if_not_exists()
        stmt = ast.CreateSequenceStmt(self.parse_table_name(),
                                      if_not_exists=ine)
        while self.cur.kind in (TokenKind.IDENT, TokenKind.KEYWORD) and \
                not self.cur.is_op(";"):
            word = self.cur.text.upper()
            if word == "START":
                self.advance()
                if self.cur.kind == TokenKind.IDENT and \
                        self.cur.text.upper() == "WITH":
                    self.advance()
                stmt.start = self._parse_signed_int("START")
            elif word == "INCREMENT":
                self.advance()
                if self.cur.is_kw("BY"):
                    self.advance()
                stmt.increment = self._parse_signed_int("INCREMENT")
                if stmt.increment == 0:
                    raise ParseError("INCREMENT must not be 0", self.cur)
            elif word == "MINVALUE":
                self.advance()
                stmt.min_value = self._parse_signed_int("MINVALUE")
            elif word == "MAXVALUE":
                self.advance()
                stmt.max_value = self._parse_signed_int("MAXVALUE")
            elif word == "CACHE":
                self.advance()
                self.parse_uint("CACHE")  # accepted, allocator decides
            elif word in ("CYCLE", "NOCYCLE"):
                self.advance()
                stmt.cycle = word == "CYCLE"
            elif word in ("NOCACHE", "NOMINVALUE", "NOMAXVALUE"):
                self.advance()
            else:
                break
        if stmt.start < stmt.min_value or stmt.start > stmt.max_value:
            raise ParseError("START out of MINVALUE..MAXVALUE", self.cur)
        return stmt

    def _parse_signed_int(self, what: str) -> int:
        neg = bool(self.accept_op("-"))
        v = self.parse_uint(what)
        return -v if neg else v

    def _parse_partition_by(self) -> ast.PartitionByDef:
        """PARTITION BY HASH(col) PARTITIONS n |
        PARTITION BY RANGE (col) (PARTITION p VALUES LESS THAN (v|
        MAXVALUE), ...) (reference: parser partition options ->
        model.PartitionInfo, ddl/partition.go)."""
        self.expect_kw("PARTITION")
        self.expect_kw("BY")
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "HASH":
            self.advance()
            self.expect_op("(")
            col = self.expect_ident()
            self.expect_op(")")
            count = 1
            if self.cur.kind == TokenKind.IDENT and \
                    self.cur.text.upper() == "PARTITIONS":
                self.advance()
                count = self.parse_uint("PARTITIONS")
            if count < 1:
                raise ParseError("PARTITIONS must be >= 1", self.cur)
            return ast.PartitionByDef("hash", col, count=count)
        if self.cur.is_kw("RANGE"):
            self.advance()
            self.expect_op("(")
            col = self.expect_ident()
            self.expect_op(")")
            self.expect_op("(")
            ranges: list[tuple[str, Optional[int]]] = []
            while True:
                self.expect_kw("PARTITION")
                name = self.expect_ident()
                self.expect_kw("VALUES")
                kw = self.cur
                if not (kw.kind == TokenKind.IDENT
                        and kw.text.upper() == "LESS"):
                    raise ParseError("expected LESS THAN", kw)
                self.advance()
                if not (self.cur.kind == TokenKind.IDENT
                        and self.cur.text.upper() == "THAN"):
                    raise ParseError("expected THAN", self.cur)
                self.advance()
                if self.cur.kind == TokenKind.IDENT and \
                        self.cur.text.upper() == "MAXVALUE":
                    self.advance()
                    ranges.append((name, None))
                else:
                    self.expect_op("(")
                    neg = bool(self.accept_op("-"))
                    t = self.cur
                    if t.kind != TokenKind.INT:
                        raise ParseError(
                            "expected integer partition bound", t)
                    self.advance()
                    v = -int(t.text) if neg else int(t.text)
                    self.expect_op(")")
                    ranges.append((name, v))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return ast.PartitionByDef("range", col, ranges=ranges)
        raise ParseError("expected HASH or RANGE after PARTITION BY",
                         self.cur)

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _opt_index_name(self) -> Optional[str]:
        if self.cur.kind == TokenKind.IDENT and not self.peek().is_op("("):
            pass
        if self.cur.kind == TokenKind.IDENT:
            return self.advance().text
        return None

    def _paren_ident_list(self) -> list[str]:
        self.expect_op("(")
        out = [self.expect_ident()]
        while self.accept_op(","):
            out.append(self.expect_ident())
        self.expect_op(")")
        return out

    def parse_column_def(self) -> ast.ColumnDef:
        name = self.expect_ident()
        ftype = self.parse_field_type()
        d = ast.ColumnDef(name, ftype)
        while True:
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                d.not_null = True
            elif self.accept_kw("NULL"):
                pass
            elif self.accept_kw("PRIMARY"):
                self.expect_kw("KEY")
                d.primary_key = True
                d.not_null = True
            elif self.accept_kw("UNIQUE"):
                self.accept_kw("KEY")
                d.unique = True
            elif self.accept_kw("AUTO_INCREMENT"):
                d.auto_increment = True
            elif self.accept_kw("DEFAULT"):
                d.default = self.parse_primary()
            elif self.accept_kw("REFERENCES"):
                # column-level FK shorthand: REFERENCES tbl (col)
                rt = self.parse_table_name()
                rc = self._paren_ident_list()
                d.references = (rt, rc)  # type: ignore[attr-defined]
            elif self.cur.is_kw("COLLATE") or (
                    self.cur.kind == TokenKind.IDENT
                    and self.cur.text.upper() == "COLLATE"):
                self.advance()
                name = self.advance().text.lower()
                if d.ftype.is_string:
                    d.ftype = FieldType(
                        d.ftype.kind, flen=d.ftype.flen,
                        scale=d.ftype.scale, nullable=d.ftype.nullable,
                        elems=d.ftype.elems, collate=name)
            elif self.cur.kind == TokenKind.IDENT and \
                    self.cur.text.upper() == "CHARACTER":
                self.advance()  # CHARACTER SET <name> — swallowed
                self.accept_kw("SET")
                if self.cur.kind in (TokenKind.IDENT, TokenKind.STRING):
                    self.advance()
            elif self.cur.kind == TokenKind.IDENT and \
                    self.cur.text.upper() == "COMMENT":
                self.advance()
                if self.cur.kind in (TokenKind.IDENT, TokenKind.STRING,
                                     TokenKind.KEYWORD):
                    self.advance()
            else:
                return d

    def parse_field_type(self) -> FieldType:
        t = self.cur
        kind = None
        upper = t.text.upper() if t.kind == TokenKind.IDENT else ""
        if t.kind == TokenKind.KEYWORD and t.text in _TYPE_KEYWORDS:
            kind = _TYPE_KEYWORDS[t.text]
            self.advance()
        elif t.is_kw("SET"):  # SET('a','b',...) in type position
            kind = TypeKind.SET
            self.advance()
        elif upper in ("ENUM", "BIT", "JSON"):
            kind = {"ENUM": TypeKind.ENUM, "BIT": TypeKind.BIT,
                    "JSON": TypeKind.JSON}[upper]
            self.advance()
        elif upper in ("SIGNED", "UNSIGNED"):
            self.advance()
            self.accept_kw("INT", "INTEGER")
            kind = TypeKind.BIGINT
        else:
            raise ParseError("expected type name", t)
        flen, scale = -1, 0
        elems: tuple = ()
        if kind in (TypeKind.ENUM, TypeKind.SET):
            self.expect_op("(")
            vals = []
            while True:
                s = self.cur
                if s.kind != TokenKind.STRING:
                    raise ParseError("expected string element", s)
                self.advance()
                vals.append(s.text)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            if kind == TypeKind.SET and len(vals) > 64:
                raise ParseError("SET supports at most 64 elements", t)
            if len(set(v.lower() for v in vals)) != len(vals):
                raise ParseError("duplicate element in ENUM/SET", t)
            elems = tuple(vals)
        elif self.accept_op("("):
            flen = self.parse_uint("type length")
            if self.accept_op(","):
                scale = self.parse_uint("type scale")
            self.expect_op(")")
        if kind == TypeKind.DECIMAL:
            if flen < 0:
                flen = 10  # MySQL default DECIMAL(10,0)
            if flen > 18:
                raise ParseError(f"DECIMAL({flen}) exceeds supported precision 18",
                                 t)
        if kind == TypeKind.BIT:
            if flen < 0:
                flen = 1
            if flen > 63:
                # the int64 physical buffer holds 63 value bits; MySQL's
                # BIT(64) tail is rejected loudly (same policy as the
                # DECIMAL>18 gate)
                raise ParseError("BIT width exceeds supported 63", t)
        if self.cur.kind == TokenKind.IDENT and self.cur.text.upper() == "UNSIGNED":
            self.advance()  # accepted but not tracked yet
        return FieldType(kind, flen=flen, scale=scale, elems=elems)

    def parse_drop(self) -> ast.Stmt:
        self.expect_kw("DROP")
        scope_t = None
        if self.cur.is_kw("GLOBAL", "SESSION") and \
                self.peek().kind == TokenKind.IDENT and \
                self.peek().text.upper() == "BINDING":
            scope_t = self.advance().text
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "BINDING":
            self.advance()
            self.expect_kw("FOR")
            start = self.cur.pos
            self.parse_select_statement()
            end = self.cur.pos if self.cur.kind != TokenKind.EOF \
                else len(self.text)
            orig = self.text[start:end].strip().rstrip(";").strip()
            return ast.DropBindingStmt(scope_t or "SESSION", orig)
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "ROLE":
            self.advance()
            if_exists = self._if_exists()
            names = [self._parse_account_name()]
            while self.accept_op(","):
                names.append(self._parse_account_name())
            return ast.DropRoleStmt(names, if_exists)
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "VIEW":
            self.advance()
            if_exists = self._if_exists()
            tn = self.parse_table_name()
            return ast.DropViewStmt(tn.name, if_exists, tn.db)
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "SEQUENCE":
            self.advance()
            if_exists = self._if_exists()
            names = [self.parse_table_name()]
            while self.accept_op(","):
                names.append(self.parse_table_name())
            return ast.DropSequenceStmt(names, if_exists)
        if self.accept_kw("DATABASE", "SCHEMA"):
            if_exists = self._if_exists()
            return ast.DropDatabaseStmt(self.expect_ident(), if_exists)
        if self.accept_kw("USER"):
            if_exists = self._if_exists()
            return ast.DropUserStmt(self._parse_account_name(), if_exists)
        if self.accept_kw("INDEX", "KEY"):
            name = self.expect_ident()
            self.expect_kw("ON")
            return ast.DropIndexStmt(name, self.parse_table_name())
        self.expect_kw("TABLE")
        if_exists = self._if_exists()
        tables = [self.parse_table_name()]
        while self.accept_op(","):
            tables.append(self.parse_table_name())
        return ast.DropTableStmt(tables, if_exists)

    def _if_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    # ---- misc statements ---------------------------------------------------
    def parse_explain(self) -> ast.Stmt:
        self.advance()  # EXPLAIN/DESC/DESCRIBE
        analyze = bool(self.accept_kw("ANALYZE"))
        return ast.ExplainStmt(self.parse_statement(), analyze)

    def _show_like(self, stmt: ast.ShowStmt) -> ast.ShowStmt:
        if self.cur.is_kw("LIKE"):
            self.advance()
            stmt.pattern = self.advance().text
        elif self.cur.is_kw("WHERE"):
            self.advance()
            self.parse_expr()  # accepted, unfiltered (compat tolerance)
        return stmt

    def parse_show(self) -> ast.ShowStmt:
        self.expect_kw("SHOW")
        scope = "SESSION"
        if self.accept_kw("GLOBAL"):
            scope = "GLOBAL"
        elif self.accept_kw("SESSION"):
            scope = "SESSION"
        self.accept_kw("FULL")
        if self.cur.is_kw("TABLE") and \
                self.peek().is_kw("STATUS"):
            self.advance()
            self.advance()
            return self._show_like(ast.ShowStmt("TABLE_STATUS"))
        if self.accept_kw("TABLES"):
            return self._show_like(ast.ShowStmt("TABLES"))
        if self.accept_kw("DATABASES", "SCHEMAS"):
            return self._show_like(ast.ShowStmt("DATABASES"))
        if self.accept_kw("STATUS"):
            return self._show_like(ast.ShowStmt("STATUS", scope=scope))
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "BINDINGS":
            self.advance()
            return ast.ShowStmt("BINDINGS", scope=scope)
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "PROCESSLIST":
            self.advance()
            return ast.ShowStmt("PROCESSLIST")
        if self.accept_kw("WARNINGS", "ERRORS"):
            return ast.ShowStmt("WARNINGS")
        if self.accept_kw("ENGINES"):
            return ast.ShowStmt("ENGINES")
        if self.accept_kw("COLLATION"):
            return self._show_like(ast.ShowStmt("COLLATION"))
        if self.cur.kind in (TokenKind.IDENT, TokenKind.KEYWORD) and \
                self.cur.text.upper() in ("CHARACTER", "CHARSET"):
            if self.cur.text.upper() == "CHARACTER":
                self.advance()
                self.expect_kw("SET")
            else:
                self.advance()
            return self._show_like(ast.ShowStmt("CHARSET"))
        if self.cur.kind == TokenKind.KEYWORD and \
                self.cur.text == "PRIVILEGES":
            self.advance()
            return ast.ShowStmt("PRIVILEGES")
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "PROFILES":
            self.advance()
            return ast.ShowStmt("PROFILES")
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "PROFILE":
            # SHOW PROFILE [type[, type]...] [FOR QUERY n]: type
            # clauses (CPU, BLOCK IO, ...) are accepted and ignored —
            # the sampler has one view, wall-clock stacks
            self.advance()
            stmt = ast.ShowStmt("PROFILE")
            types = {"ALL", "BLOCK", "IO", "CONTEXT", "SWITCHES", "CPU",
                     "IPC", "MEMORY", "PAGE", "FAULTS", "SOURCE",
                     "SWAPS"}
            while self.cur.kind in (TokenKind.IDENT, TokenKind.KEYWORD) \
                    and self.cur.text.upper() in types:
                self.advance()
                self.accept_op(",")
            if self.accept_kw("FOR"):
                t = self.cur
                if not (t.kind in (TokenKind.IDENT, TokenKind.KEYWORD)
                        and t.text.upper() == "QUERY"):
                    raise ParseError("expected QUERY", t)
                self.advance()
                t = self.cur
                if t.kind != TokenKind.INT:
                    raise ParseError(
                        "expected integer after FOR QUERY", t)
                self.advance()
                stmt.pattern = t.text
            return stmt
        if self.accept_kw("COLUMNS", "FIELDS"):
            self.expect_kw("FROM")
            return self._show_like(
                ast.ShowStmt("COLUMNS", self.parse_table_name()))
        if self.accept_kw("INDEX", "INDEXES", "KEYS"):
            self.expect_kw("FROM")
            return ast.ShowStmt("INDEX", self.parse_table_name())
        if self.accept_kw("GRANTS"):
            stmt = ast.ShowStmt("GRANTS")
            if self.accept_kw("FOR"):
                stmt.pattern = self._parse_account_name()
            return stmt
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "SLOW":
            self.advance()
            if self.cur.kind == TokenKind.IDENT and \
                    self.cur.text.upper() == "QUERIES":
                self.advance()
            return ast.ShowStmt("SLOW")
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "METRICS":
            self.advance()
            return ast.ShowStmt("METRICS")
        if self.accept_kw("CREATE"):
            if self.accept_kw("DATABASE", "SCHEMA"):
                return ast.ShowStmt("CREATE_DATABASE",
                                    pattern=self.expect_ident())
            if self.cur.kind == TokenKind.IDENT and \
                    self.cur.text.upper() == "VIEW":
                self.advance()
                return ast.ShowStmt("CREATE_VIEW", self.parse_table_name())
            self.expect_kw("TABLE")
            return ast.ShowStmt("CREATE_TABLE", self.parse_table_name())
        if self.accept_kw("VARIABLES"):
            return self._show_like(ast.ShowStmt("VARIABLES", scope=scope))
        raise ParseError("unsupported SHOW", self.cur)

    def parse_set(self) -> ast.SetStmt:
        """SET assignments + the special client forms: SET NAMES cs,
        SET CHARACTER SET cs, SET [scope] TRANSACTION ISOLATION LEVEL x
        (reference: executor/set.go + ast SetStmt variants)."""
        self.expect_kw("SET")
        # SET PASSWORD [FOR 'u'] = 'pwd' (maps to ALTER USER; reference:
        # executor/simple.go executeSetPwd)
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "PASSWORD" and \
                (self.peek().is_kw("FOR") or self.peek().is_op("=")):
            self.advance()
            name = ""
            if self.accept_kw("FOR"):
                name = self._parse_account_name()
            self.expect_op("=")
            pwd = self._string_lit("SET PASSWORD")
            return ast.AlterUserStmt(name, pwd)
        # SET [DEFAULT] ROLE (reference: executor/set_role; roles in
        # privilege/privileges) — statement forms, not var assignments
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "ROLE":
            self.advance()
            return self._parse_set_role_tail()
        if self.cur.is_kw("DEFAULT") and \
                self.peek().kind == TokenKind.IDENT and \
                self.peek().text.upper() == "ROLE":
            self.advance()
            self.advance()
            if self.accept_kw("ALL"):
                mode, roles = "ALL", []
            elif self.cur.kind == TokenKind.IDENT and \
                    self.cur.text.upper() == "NONE":
                self.advance()
                mode, roles = "NONE", []
            else:
                mode = "LIST"
                roles = [self._parse_account_name()]
                while self.accept_op(","):
                    roles.append(self._parse_account_name())
            self.expect_kw("TO")
            users = [self._parse_account_name()]
            while self.accept_op(","):
                users.append(self._parse_account_name())
            return ast.SetDefaultRoleStmt(mode, roles, users)
        items = []
        while True:
            scope = "SESSION"
            if self.cur.is_kw("NAMES") or (
                    self.cur.kind == TokenKind.IDENT
                    and self.cur.text.upper() == "NAMES"):
                self.advance()
                cs = self.advance().text  # ident or string literal
                if self.cur.kind in (TokenKind.IDENT, TokenKind.KEYWORD) \
                        and self.cur.text.upper() == "COLLATE":
                    self.advance()
                    self.advance()  # collation name (accepted, ignored)
                items.append(("NAMES", "names", ast.Literal(cs, "string")))
            elif self.cur.kind in (TokenKind.IDENT, TokenKind.KEYWORD) and \
                    self.cur.text.upper() == "CHARACTER" and \
                    self.peek().is_kw("SET"):
                self.advance()
                self.advance()
                cs = self.advance().text
                items.append(("NAMES", "names", ast.Literal(cs, "string")))
            else:
                if self.accept_kw("GLOBAL"):
                    scope = "GLOBAL"
                elif self.accept_kw("SESSION"):
                    scope = "SESSION"
                if self.cur.is_kw("TRANSACTION"):
                    self.advance()
                    if not (self.cur.kind == TokenKind.IDENT
                            and self.cur.text.upper() == "ISOLATION"):
                        raise ParseError("expected ISOLATION LEVEL",
                                         self.cur)
                    self.advance()
                    if not (self.cur.kind == TokenKind.IDENT
                            and self.cur.text.upper() == "LEVEL"):
                        raise ParseError("expected LEVEL", self.cur)
                    self.advance()
                    words = [self.advance().text.upper()]
                    while self.cur.kind in (TokenKind.IDENT,
                                            TokenKind.KEYWORD) and \
                            self.cur.text.upper() in ("READ", "COMMITTED",
                                                      "UNCOMMITTED",
                                                      "REPEATABLE",
                                                      "SERIALIZABLE"):
                        words.append(self.advance().text.upper())
                    level = "-".join(words)
                    items.append((scope, "tx_isolation",
                                  ast.Literal(level, "string")))
                    if not self.accept_op(","):
                        return ast.SetStmt(items)
                    continue
                if self.accept_op("@"):
                    if self.accept_op("@"):  # @@[scope.]var
                        if self.cur.kind in (TokenKind.IDENT,
                                             TokenKind.KEYWORD) and \
                                self.cur.text.upper() in ("GLOBAL",
                                                          "SESSION") and \
                                self.peek().is_op("."):
                            scope = self.advance().text.upper()
                            self.advance()
                    else:
                        scope = "USERVAR"
                name = self.expect_ident()
                if not self.accept_op("=") and not self.accept_op(":="):
                    raise ParseError("expected = in SET", self.cur)
                items.append((scope, name.lower(), self.parse_set_value()))
            if not self.accept_op(","):
                return ast.SetStmt(items)

    def _parse_set_role_tail(self) -> "ast.SetRoleStmt":
        if self.accept_kw("ALL"):
            return ast.SetRoleStmt("ALL")
        if self.cur.is_kw("DEFAULT"):
            self.advance()
            return ast.SetRoleStmt("DEFAULT")
        if self.cur.kind == TokenKind.IDENT and \
                self.cur.text.upper() == "NONE":
            self.advance()
            return ast.SetRoleStmt("NONE")
        roles = [self._parse_account_name()]
        while self.accept_op(","):
            roles.append(self._parse_account_name())
        return ast.SetRoleStmt("LIST", roles)

    def parse_set_value(self) -> ast.Expr:
        """SET values admit bare idents/keywords (utf8mb4, ON, DEFAULT) as
        string-ish tokens in addition to ordinary expressions."""
        t = self.cur
        if t.is_kw("DEFAULT"):
            self.advance()
            return ast.Literal(None, "default")
        if t.kind == TokenKind.IDENT and not self.peek().is_op("(", "."):
            self.advance()
            return ast.Literal(t.text, "string")
        if t.kind == TokenKind.KEYWORD and t.text in ("ON", "OFF") :
            self.advance()
            return ast.Literal(t.text, "string")
        return self.parse_expr()

    # ---- expressions (Pratt) -----------------------------------------------
    def parse_expr(self) -> ast.Expr:
        return self.parse_binary(0)

    def parse_binary(self, min_prec: int) -> ast.Expr:
        left = self.parse_unary()
        while True:
            t = self.cur
            op = None
            if t.kind == TokenKind.OP and t.text in _PRECEDENCE:
                op = t.text
            elif t.kind == TokenKind.KEYWORD and t.text in _PRECEDENCE:
                op = t.text
            # NOT IN / NOT LIKE / NOT BETWEEN / IS / IN / BETWEEN / LIKE
            if t.is_kw("IS", "IN", "BETWEEN", "LIKE", "NOT") and (
                _COMPARISON_LEVEL > min_prec
            ):
                handled, left = self._parse_predicate_suffix(left)
                if handled:
                    continue
            if op is None:
                return left
            prec = _PRECEDENCE[op]
            if prec <= min_prec:
                return left
            self.advance()
            if op in ("||",):
                op = "OR"
            if op in ("&&",):
                op = "AND"
            if op == "!=":
                op = "<>"
            if op == "MOD":
                op = "%"
            right = self.parse_binary(prec)
            left = ast.BinaryOp(op, left, right)

    def _parse_predicate_suffix(self, left: ast.Expr) -> tuple[bool, ast.Expr]:
        """IS [NOT] NULL, [NOT] IN, [NOT] BETWEEN, [NOT] LIKE."""
        if self.cur.is_kw("IS"):
            self.advance()
            negated = bool(self.accept_kw("NOT"))
            if self.accept_kw("NULL"):
                return True, ast.IsNull(left, negated)
            if self.accept_kw("TRUE"):
                e: ast.Expr = ast.BinaryOp("=", left, ast.Literal(True, "bool"))
            elif self.accept_kw("FALSE"):
                e = ast.BinaryOp("=", left, ast.Literal(False, "bool"))
            else:
                raise ParseError("expected NULL/TRUE/FALSE after IS", self.cur)
            if negated:
                e = ast.UnaryOp("NOT", e)
            return True, e
        negated = False
        if self.cur.is_kw("NOT") and self.peek().is_kw("IN", "BETWEEN", "LIKE"):
            self.advance()
            negated = True
        if self.accept_kw("IN"):
            self.expect_op("(")
            if self.cur.is_kw("SELECT"):
                sub = self.parse_select()
                self.expect_op(")")
                return True, ast.InSubquery(left, sub, negated)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return True, ast.InList(left, items, negated)
        if self.accept_kw("BETWEEN"):
            low = self.parse_binary(_COMPARISON_LEVEL)
            self.expect_kw("AND")
            high = self.parse_binary(_COMPARISON_LEVEL)
            return True, ast.Between(left, low, high, negated)
        if self.accept_kw("LIKE"):
            pattern = self.parse_binary(_COMPARISON_LEVEL)
            return True, ast.Like(left, pattern, negated)
        return False, left

    def parse_unary(self) -> ast.Expr:
        if self.accept_kw("NOT") or self.accept_op("!"):
            return ast.UnaryOp("NOT", self.parse_binary(4))
        if self.accept_op("-"):
            operand = self.parse_unary()
            if isinstance(operand, ast.Literal) and operand.tag in (
                "int", "decimal", "float"
            ):
                if operand.tag == "decimal":
                    return ast.Literal(-operand.value, "decimal")
                return ast.Literal(-operand.value, operand.tag)
            return ast.UnaryOp("-", operand)
        if self.accept_op("+"):
            return self.parse_unary()
        if self.accept_kw("INTERVAL"):
            value = self.parse_primary()
            unit = self._interval_unit()
            return ast.IntervalExpr(value, unit)
        if self.cur.is_kw("VALUES") and self.peek().is_op("("):
            # VALUES(col) inside ON DUPLICATE KEY UPDATE
            self.advance()
            self.expect_op("(")
            ref = self.parse_column_ref()
            self.expect_op(")")
            return ast.FuncCall("VALUES", [ref])
        e = self.parse_primary()
        # JSON path extraction operators: col->'$.k' / col->>'$.k'
        # (reference: parser maps -> to JSON_EXTRACT and ->> to
        # JSON_UNQUOTE(JSON_EXTRACT))
        while self.cur.is_op("->", "->>"):
            op = self.advance().text
            p = self.cur
            if p.kind != TokenKind.STRING:
                raise ParseError("expected JSON path string", p)
            self.advance()
            e = ast.FuncCall("JSON_EXTRACT",
                             [e, ast.Literal(p.text, "string")])
            if op == "->>":
                e = ast.FuncCall("JSON_UNQUOTE", [e])
        return e

    def _interval_unit(self) -> str:
        t = self.cur
        units = {"DAY", "WEEK", "MONTH", "QUARTER", "YEAR", "HOUR", "MINUTE",
                 "SECOND", "MICROSECOND"}
        if t.kind == TokenKind.IDENT and t.text.upper() in units:
            self.advance()
            return t.text.upper()
        if t.kind == TokenKind.KEYWORD and t.text in units:
            self.advance()
            return t.text
        raise ParseError("expected interval unit", t)

    def parse_primary(self) -> ast.Expr:
        t = self.cur
        if t.is_op("@"):
            self.advance()
            if self.accept_op("@"):
                scope = "SESSION"
                if self.cur.kind in (TokenKind.IDENT, TokenKind.KEYWORD) \
                        and self.cur.text.upper() in ("GLOBAL", "SESSION") \
                        and self.peek().is_op("."):
                    scope = self.advance().text.upper()
                    self.advance()
                return ast.SysVarExpr(self.expect_ident().lower(), scope)
            return ast.UserVarExpr(self.expect_ident().lower())
        if t.is_op("?"):
            self.advance()
            self.param_count += 1
            return ast.ParamMarker(self.param_count - 1)
        if t.kind == TokenKind.INT:
            self.advance()
            return ast.Literal(int(t.text), "int")
        if t.kind == TokenKind.DECIMAL:
            self.advance()
            return ast.Literal(Decimal.parse(t.text), "decimal")
        if t.kind == TokenKind.FLOAT:
            self.advance()
            return ast.Literal(float(t.text), "float")
        if t.kind == TokenKind.STRING:
            self.advance()
            return ast.Literal(t.text, "string")
        if t.is_kw("NULL"):
            self.advance()
            return ast.Literal(None, "null")
        if t.is_kw("TRUE"):
            self.advance()
            return ast.Literal(True, "bool")
        if t.is_kw("FALSE"):
            self.advance()
            return ast.Literal(False, "bool")
        # DATE 'lit' / TIMESTAMP 'lit' typed literals
        if t.is_kw("DATE", "TIMESTAMP", "DATETIME") and \
                self.peek().kind == TokenKind.STRING:
            self.advance()
            lit = self.advance()
            return ast.Literal(lit.text, {"DATE": "date"}.get(t.text, "datetime"))
        if t.is_kw("CASE"):
            return self.parse_case()
        if t.is_kw("CAST", "CONVERT"):
            return self.parse_cast()
        if t.is_kw("EXISTS"):
            self.advance()
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return ast.SubqueryExpr(sub, exists=True)
        if t.is_op("("):
            self.advance()
            if self.cur.is_kw("SELECT"):
                sub = self.parse_select()
                self.expect_op(")")
                return ast.SubqueryExpr(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        # aggregate keywords used as functions
        if t.kind == TokenKind.KEYWORD and t.text in _AGG_FUNCS:
            self.advance()
            return self.parse_func_call(t.text)
        # reserved words that double as function names when followed by (
        if t.kind == TokenKind.KEYWORD and \
                (t.text in _FUNC_KEYWORDS or t.text in ("INSERT",
                                                        "REPLACE")) and \
                self.peek().is_op("("):
            self.advance()
            return self.parse_func_call(t.text)
        if t.kind == TokenKind.IDENT or (
            t.kind == TokenKind.KEYWORD and t.text in _IDENT_KEYWORDS
        ):
            name = self.advance().text
            if self.cur.is_op("("):
                return self.parse_func_call(name.upper())
            return self._finish_column_ref(name)
        raise ParseError("expected expression", t)

    def parse_func_call(self, name: str) -> ast.Expr:
        self.expect_op("(")
        if name == "EXTRACT":
            # EXTRACT(unit FROM expr) -> YEAR/MONTH/DAY(expr)
            unit = self._interval_unit()
            if unit not in ("YEAR", "MONTH", "DAY"):
                raise ParseError(f"EXTRACT unit {unit} unsupported", self.cur)
            self.expect_kw("FROM")
            arg = self.parse_expr()
            self.expect_op(")")
            return ast.FuncCall(unit, [arg])
        if name in ("SUBSTRING", "SUBSTR"):
            # SUBSTRING(s FROM a [FOR b]) | SUBSTRING(s, a [, b])
            args = [self.parse_expr()]
            if self.accept_kw("FROM"):
                args.append(self.parse_expr())
                if self.accept_kw("FOR"):
                    args.append(self.parse_expr())
            else:
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            return ast.FuncCall("SUBSTRING", args)
        distinct = bool(self.accept_kw("DISTINCT"))
        if self.accept_op("*"):
            self.expect_op(")")
            return self._maybe_over(ast.FuncCall(name, [], is_star=True))
        if self.accept_op(")"):
            return self._maybe_over(ast.FuncCall(name, []))
        args = [self.parse_expr()]
        while self.accept_op(","):
            args.append(self.parse_expr())
        self.expect_op(")")
        return self._maybe_over(ast.FuncCall(name, args, distinct=distinct))

    def _maybe_over(self, fc: ast.FuncCall) -> ast.FuncCall:
        """fn(...) OVER ([PARTITION BY ...] [ORDER BY ...]) — default
        frames only (RANGE UNBOUNDED PRECEDING .. CURRENT ROW)."""
        if not self.cur.is_kw("OVER"):
            return fc
        self.advance()
        self.expect_op("(")
        spec = ast.WindowSpec()
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            spec.partition_by.append(self.parse_expr())
            while self.accept_op(","):
                spec.partition_by.append(self.parse_expr())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            spec.order_by.append(self.parse_order_item())
            while self.accept_op(","):
                spec.order_by.append(self.parse_order_item())
        if self.cur.is_kw("ROWS", "RANGE"):
            spec.frame = self._parse_frame()
        self.expect_op(")")
        fc.window = spec
        return fc

    def _parse_frame(self) -> ast.WindowFrame:
        """ROWS|RANGE BETWEEN <bound> AND <bound>, or the single-bound
        form (bound .. CURRENT ROW)."""
        unit = self.advance().text  # ROWS | RANGE

        def bound() -> tuple[str, Optional[int]]:
            if self.accept_kw("UNBOUNDED"):
                kw = self.expect_kw("PRECEDING", "FOLLOWING")
                return ("unbounded" if kw.text == "PRECEDING"
                        else "unbounded_following"), None
            if self.accept_kw("CURRENT"):
                self.expect_kw("ROW")
                return "current", None
            t = self.cur
            if t.kind != TokenKind.INT:
                raise ParseError("expected frame bound", t)
            self.advance()
            kw = self.expect_kw("PRECEDING", "FOLLOWING")
            return kw.text.lower(), int(t.text)

        if self.accept_kw("BETWEEN"):
            s_type, s_val = bound()
            self.expect_kw("AND")
            e_type, e_val = bound()
        else:
            s_type, s_val = bound()
            e_type, e_val = "current", None
        if s_type == "unbounded_following" or e_type == "unbounded":
            raise ParseError("invalid window frame bounds", self.cur)
        return ast.WindowFrame(unit, s_type, s_val, e_type, e_val)

    def _finish_column_ref(self, first: str) -> ast.ColumnRef:
        if self.accept_op("."):
            second = self.expect_ident()
            if self.accept_op("."):
                return ast.ColumnRef(self.expect_ident(), table=second, db=first)
            return ast.ColumnRef(second, table=first)
        return ast.ColumnRef(first)

    def parse_column_ref(self) -> ast.ColumnRef:
        return self._finish_column_ref(self.expect_ident())

    def parse_case(self) -> ast.Case:
        self.expect_kw("CASE")
        operand = None
        if not self.cur.is_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.accept_kw("WHEN"):
            when = self.parse_expr()
            self.expect_kw("THEN")
            branches.append((when, self.parse_expr()))
        else_expr = self.parse_expr() if self.accept_kw("ELSE") else None
        self.expect_kw("END")
        return ast.Case(operand, branches, else_expr)

    def parse_cast(self) -> ast.Cast:
        kw = self.advance()  # CAST or CONVERT
        self.expect_op("(")
        operand = self.parse_expr()
        if kw.text == "CAST":
            self.expect_kw("AS")
        else:
            self.expect_op(",")
        target = self.parse_field_type()
        self.expect_op(")")
        return ast.Cast(operand, target)


# Keywords that may double as identifiers (table/column names) when not in
# keyword position — mirrors MySQL's non-reserved keyword list for the subset
# we actually reserve.
def _parse_hints(text: str) -> list[tuple[str, list[str]]]:
    """'LEADING(a, b) USE_INDEX(t, i)' -> [('LEADING', ['a','b']), ...]
    (reference: planner/core/hints.go hint table). Unknown hints are
    carried through; the planner ignores what it doesn't implement."""
    import re as _re

    out: list[tuple[str, list[str]]] = []
    for m in _re.finditer(r"([A-Za-z_][A-Za-z0-9_]*)\s*(\(([^)]*)\))?",
                          text):
        name = m.group(1).upper()
        args = [a.strip().strip("`").lower()
                for a in (m.group(3) or "").split(",") if a.strip()]
        out.append((name, args))
    return out


_IDENT_KEYWORDS = frozenset(
    """
    DATE TIME TIMESTAMP DATETIME YEAR STATUS VARIABLES TABLES DATABASES
    COUNT SUM AVG MIN MAX COLUMN FIRST AFTER BEGIN COMMIT IF
    ADMIN DDL JOBS OVER PARTITION ROWS RANGE
    SCHEMAS WARNINGS ERRORS ENGINES COLLATION COLUMNS FIELDS INDEXES KEYS
    NAMES USER IDENTIFIED PRIVILEGES GRANTS PESSIMISTIC OPTIMISTIC
    UNBOUNDED PRECEDING FOLLOWING CURRENT ROW TRACE
    KILL QUERY CONNECTION
    DATA LOCAL TERMINATED ENCLOSED ESCAPED LINES
    """.split()
)

# Reserved words that double as function names when followed immediately by
# '(' — mirrors MySQL's treatment of LEFT(), RIGHT(), REPLACE(), etc.
# Keywords already in _IDENT_KEYWORDS (IF, DATE, YEAR, ...) are handled by
# the identifier branch and are deliberately not repeated here.
_FUNC_KEYWORDS = frozenset(
    """
    LEFT RIGHT REPLACE MOD TRUNCATE DATABASE SCHEMA CHAR
    """.split()
)


def parse_sql(text: str) -> list[ast.Stmt]:
    return Parser(text).parse()


def parse_one(text: str) -> ast.Stmt:
    stmts = parse_sql(text)
    if len(stmts) != 1:
        raise ParseError("expected exactly one statement",
                         Token(TokenKind.EOF, "", 0))
    return stmts[0]
