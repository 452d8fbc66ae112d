"""SQL lexer for the MySQL-compatible subset.

Counterpart of the reference's goyacc-generated lexer in the external parser
module (reference: github.com/pingcap/parser, entry session/session.go:1190).
Hand-written: the grammar subset doesn't warrant a generator, and error
messages stay precise.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, Optional


class LexError(Exception):
    errno = 1064  # ER_PARSE_ERROR
    sqlstate = "42000"

    def __init__(self, msg: str, pos: int) -> None:
        super().__init__(f"{msg} at position {pos}")
        self.pos = pos


class TokenKind(enum.Enum):
    IDENT = "ident"
    KEYWORD = "keyword"
    INT = "int"
    DECIMAL = "decimal"  # numeric literal with a fractional part
    FLOAT = "float"  # scientific notation -> double
    STRING = "string"
    OP = "op"
    HINT = "hint"  # /*+ ... */ optimizer hint; text = inner content
    EOF = "eof"


@dataclass(frozen=True)
class Token:
    kind: TokenKind
    text: str  # keywords normalized to upper, idents as written
    pos: int

    def is_kw(self, *names: str) -> bool:
        return self.kind == TokenKind.KEYWORD and self.text in names

    def is_op(self, *ops: str) -> bool:
        return self.kind == TokenKind.OP and self.text in ops


# Reserved + non-reserved words the parser dispatches on. Anything else is an
# identifier. (MySQL has non-reserved keywords usable as idents; the parser
# handles the few cases that matter via expect_ident_or_kw.)
KEYWORDS = frozenset(
    """
    SELECT FROM WHERE GROUP BY HAVING ORDER LIMIT OFFSET AS DISTINCT ALL
    AND OR NOT XOR IS NULL TRUE FALSE IN BETWEEN LIKE EXISTS
    JOIN INNER LEFT RIGHT FULL OUTER CROSS ON USING
    INSERT INTO VALUES UPDATE SET DELETE REPLACE
    CREATE TABLE DATABASE SCHEMA DROP ALTER ADD COLUMN INDEX KEY PRIMARY
    UNIQUE DEFAULT AUTO_INCREMENT IF EXISTS USE
    BEGIN START TRANSACTION COMMIT ROLLBACK PESSIMISTIC OPTIMISTIC
    EXPLAIN ANALYZE SHOW TABLES DATABASES DESC DESCRIBE TRACE
    ASC CASE WHEN THEN ELSE END CAST AS CONVERT
    INTERVAL DATE TIME TIMESTAMP DATETIME YEAR
    UNION EXCEPT INTERSECT
    COUNT SUM AVG MIN MAX
    TINYINT SMALLINT INT INTEGER BIGINT FLOAT DOUBLE REAL DECIMAL NUMERIC
    CHAR VARCHAR TEXT BOOLEAN BOOL
    DIV MOD
    FIRST AFTER MODIFY CHANGE RENAME TO TRUNCATE
    GLOBAL SESSION VARIABLES STATUS SCHEMAS WARNINGS ERRORS ENGINES
    COLLATION COLUMNS FIELDS INDEXES KEYS NAMES
    GRANT REVOKE USER IDENTIFIED PRIVILEGES GRANTS
    CONSTRAINT FOREIGN REFERENCES
    FOR
    ADMIN DDL JOBS KILL QUERY CONNECTION
    OVER PARTITION ROWS RANGE UNBOUNDED PRECEDING FOLLOWING CURRENT ROW
    LOAD DATA LOCAL INFILE OUTFILE TERMINATED ENCLOSED ESCAPED LINES IGNORE
    OPTIONALLY CHECK
    """.split()
)

_MULTI_OPS = ("<=>", "->>", "->", "<<", ">>", "<>", "!=", "<=", ">=",
              ":=", "||", "&&")
_SINGLE_OPS = "+-*/%(),.;=<>!&|^~@?"


class Lexer:
    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    def tokens(self) -> Iterator[Token]:
        while True:
            tok = self.next_token()
            yield tok
            if tok.kind == TokenKind.EOF:
                return

    # ------------------------------------------------------------------
    def next_token(self) -> Token:
        self._skip_ws_and_comments()
        text, pos = self.text, self.pos
        if pos >= len(text):
            return Token(TokenKind.EOF, "", pos)
        c = text[pos]

        if text.startswith("/*+", pos):
            # optimizer hint comment survives as a token (reference: the
            # parser yields hints to planner/core/hints.go)
            end = text.find("*/", pos + 3)
            if end < 0:
                raise LexError("unterminated hint comment", pos)
            self.pos = end + 2
            return Token(TokenKind.HINT, text[pos + 3:end].strip(), pos)
        if c.isdigit() or (c == "." and pos + 1 < len(text) and text[pos + 1].isdigit()):
            return self._number()
        if c in "bB" and pos + 1 < len(text) and text[pos + 1] == "'":
            # bit literal b'0101' -> integer token (reference: parser
            # BitValueLit)
            end = text.find("'", pos + 2)
            if end < 0:
                raise LexError("unterminated bit literal", pos)
            bits = text[pos + 2:end]
            if bits and not set(bits) <= {"0", "1"}:
                raise LexError(f"invalid bit literal b'{bits}'", pos)
            self.pos = end + 1
            return Token(TokenKind.INT, str(int(bits or "0", 2)), pos)
        if c.isalpha() or c == "_":
            return self._word()
        if c == "`":
            return self._quoted_ident()
        if c in "'\"":
            return self._string(c)
        for op in _MULTI_OPS:
            if text.startswith(op, pos):
                self.pos += len(op)
                return Token(TokenKind.OP, op, pos)
        if c in _SINGLE_OPS:
            self.pos += 1
            return Token(TokenKind.OP, c, pos)
        raise LexError(f"unexpected character {c!r}", pos)

    # ------------------------------------------------------------------
    def _skip_ws_and_comments(self) -> None:
        text = self.text
        while self.pos < len(text):
            c = text[self.pos]
            if c.isspace():
                self.pos += 1
            elif text.startswith("--", self.pos) and (
                self.pos + 2 >= len(text) or text[self.pos + 2] in " \t\n"
            ):
                nl = text.find("\n", self.pos)
                self.pos = len(text) if nl < 0 else nl + 1
            elif c == "#":
                nl = text.find("\n", self.pos)
                self.pos = len(text) if nl < 0 else nl + 1
            elif text.startswith("/*", self.pos) and not text.startswith(
                    "/*+", self.pos):
                end = text.find("*/", self.pos + 2)
                if end < 0:
                    raise LexError("unterminated comment", self.pos)
                self.pos = end + 2
            else:
                return

    def _number(self) -> Token:
        text, start = self.text, self.pos
        i = start
        while i < len(text) and text[i].isdigit():
            i += 1
        is_decimal = False
        if i < len(text) and text[i] == ".":
            is_decimal = True
            i += 1
            while i < len(text) and text[i].isdigit():
                i += 1
        is_float = False
        if i < len(text) and text[i] in "eE":
            j = i + 1
            if j < len(text) and text[j] in "+-":
                j += 1
            if j < len(text) and text[j].isdigit():
                is_float = True
                i = j
                while i < len(text) and text[i].isdigit():
                    i += 1
        self.pos = i
        lit = text[start:i]
        if is_float:
            return Token(TokenKind.FLOAT, lit, start)
        if is_decimal:
            return Token(TokenKind.DECIMAL, lit, start)
        return Token(TokenKind.INT, lit, start)

    def _word(self) -> Token:
        text, start = self.text, self.pos
        i = start
        while i < len(text) and (text[i].isalnum() or text[i] == "_"):
            i += 1
        self.pos = i
        word = text[start:i]
        upper = word.upper()
        if upper in KEYWORDS:
            return Token(TokenKind.KEYWORD, upper, start)
        return Token(TokenKind.IDENT, word, start)

    def _quoted_ident(self) -> Token:
        text, start = self.text, self.pos
        i = start + 1
        out = []
        while i < len(text):
            if text[i] == "`":
                if i + 1 < len(text) and text[i + 1] == "`":
                    out.append("`")
                    i += 2
                    continue
                self.pos = i + 1
                return Token(TokenKind.IDENT, "".join(out), start)
            out.append(text[i])
            i += 1
        raise LexError("unterminated quoted identifier", start)

    def _string(self, quote: str) -> Token:
        text, start = self.text, self.pos
        i = start + 1
        out = []
        while i < len(text):
            c = text[i]
            if c == quote:
                if i + 1 < len(text) and text[i + 1] == quote:
                    out.append(quote)
                    i += 2
                    continue
                self.pos = i + 1
                return Token(TokenKind.STRING, "".join(out), start)
            if c == "\\" and i + 1 < len(text):
                nxt = text[i + 1]
                mapped = {"n": "\n", "t": "\t", "r": "\r", "0": "\0",
                          "\\": "\\", "'": "'", '"': '"', "%": "\\%", "_": "\\_"}
                out.append(mapped.get(nxt, nxt))
                i += 2
                continue
            out.append(c)
            i += 1
        raise LexError("unterminated string literal", start)
