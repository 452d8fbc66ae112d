"""SQL field types with TPU-friendly physical encodings.

Plays the role of the reference's type metadata (reference:
types/field_type.go, parser `types.FieldType`), redesigned for a columnar
device layout instead of the row-based `Datum` interpreter:

  logical SQL type          physical device encoding
  ------------------------  ----------------------------------------------
  TINYINT..BIGINT           int64
  BOOLEAN                   int64 (0/1; MySQL booleans are tinyint)
  FLOAT/DOUBLE              float64 host / float32 on device when needed
  DECIMAL(M, D)             int64 scaled by 10**D (exact fixed-point;
                            reference types/mydecimal.go is an arbitrary-
                            precision engine — we keep MySQL semantics for
                            M<=18 which covers TPC-H/SSB, and overflow-check
                            on the host for the long tail)
  DATE                      int32 days since 1970-01-01
  DATETIME/TIMESTAMP        int64 microseconds since epoch
  CHAR/VARCHAR/TEXT         int32 dictionary code (append-ordered, NOT
                            order-preserving; ordering/range predicates go
                            through Dictionary.sort_ranks / code_table)

Static dtypes keep every column XLA-tileable; NULLs live in a separate
validity bitmap (see tidb_tpu/chunk).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class TypeKind(enum.IntEnum):
    NULL = 0
    TINYINT = 1
    SMALLINT = 2
    INT = 3
    BIGINT = 4
    FLOAT = 5
    DOUBLE = 6
    DECIMAL = 7
    DATE = 8
    DATETIME = 9
    TIMESTAMP = 10
    CHAR = 11
    VARCHAR = 12
    TEXT = 13
    BOOLEAN = 14
    YEAR = 15
    TIME = 16  # MySQL TIME (duration); int64 microseconds
    ENUM = 17  # dictionary code over a fixed, definition-ordered elem set
    SET = 18   # int64 bitmask over up to 64 elems
    BIT = 19   # int64 (BIT(n), n <= 64)
    JSON = 20  # dictionary-coded normalized JSON text


INT_KINDS = frozenset(
    {TypeKind.TINYINT, TypeKind.SMALLINT, TypeKind.INT, TypeKind.BIGINT,
     TypeKind.BOOLEAN, TypeKind.YEAR, TypeKind.BIT}
)
FLOAT_KINDS = frozenset({TypeKind.FLOAT, TypeKind.DOUBLE})
# ENUM and JSON ride the dictionary-string machinery: predicates, joins,
# grouping and rendering all go through codes (reference: types/json
# binary docs + enum/set in types/etc.go — re-based on the columnar
# dictionary layout instead of row bytes)
STRING_KINDS = frozenset({TypeKind.CHAR, TypeKind.VARCHAR, TypeKind.TEXT,
                          TypeKind.ENUM, TypeKind.JSON})
TIME_KINDS = frozenset({TypeKind.DATE, TypeKind.DATETIME, TypeKind.TIMESTAMP})

# collations with case-insensitive equality (reference:
# util/collate/collate.go:62 — the general_ci/unicode_ci family)
_CI_SUFFIXES = ("_ci", "_ai_ci")


@dataclass(frozen=True)
class FieldType:
    kind: TypeKind
    # DECIMAL precision/scale; flen doubles as CHAR/VARCHAR length and
    # BIT width.
    flen: int = -1
    scale: int = 0
    nullable: bool = True
    # ENUM/SET element labels in definition order
    elems: tuple = ()
    # '' = binary collation (code-space compares); *_ci = case-insensitive
    collate: str = ""

    @property
    def is_ci(self) -> bool:
        return self.collate.endswith(_CI_SUFFIXES)

    # ---- classification ----------------------------------------------------
    @property
    def is_integer(self) -> bool:
        return self.kind in INT_KINDS

    @property
    def is_float(self) -> bool:
        return self.kind in FLOAT_KINDS

    @property
    def is_decimal(self) -> bool:
        return self.kind == TypeKind.DECIMAL

    @property
    def is_string(self) -> bool:
        return self.kind in STRING_KINDS

    @property
    def is_temporal(self) -> bool:
        return self.kind in TIME_KINDS or self.kind == TypeKind.TIME

    # ---- physical layout ---------------------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        """Host-side storage dtype for a column of this type."""
        if self.is_integer or self.is_decimal:
            return np.dtype(np.int64)
        if self.is_float:
            return np.dtype(np.float64)
        if self.kind == TypeKind.DATE:
            return np.dtype(np.int32)
        if self.kind in (TypeKind.DATETIME, TypeKind.TIMESTAMP, TypeKind.TIME):
            return np.dtype(np.int64)
        if self.is_string:
            return np.dtype(np.int32)  # dictionary code
        if self.kind == TypeKind.SET:
            return np.dtype(np.int64)  # element bitmask
        if self.kind == TypeKind.NULL:
            return np.dtype(np.int64)
        raise TypeError(f"no physical dtype for {self.kind!r}")

    @property
    def decimal_multiplier(self) -> int:
        assert self.is_decimal
        return 10 ** self.scale

    def __repr__(self) -> str:  # compact, for plan explain output
        name = self.kind.name.lower()
        if self.is_decimal:
            return f"{name}({self.flen},{self.scale})"
        if self.kind in (TypeKind.ENUM, TypeKind.SET):
            return f"{name}({','.join(repr(e) for e in self.elems)})"
        if self.kind == TypeKind.BIT and self.flen >= 0:
            return f"{name}({self.flen})"
        if self.is_string and self.flen >= 0:
            return f"{name}({self.flen})"
        return name


# ---- constructors ----------------------------------------------------------

def bigint_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.BIGINT, nullable=nullable)


def double_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DOUBLE, nullable=nullable)


def decimal_type(flen: int = 15, scale: int = 2, nullable: bool = True) -> FieldType:
    if flen > 18:
        # int64 holds 18 full decimal digits; MySQL supports 65. The wide
        # tail is rejected loudly rather than silently corrupted.
        raise ValueError(f"DECIMAL precision {flen} > 18 not supported yet")
    return FieldType(TypeKind.DECIMAL, flen=flen, scale=scale, nullable=nullable)


def date_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DATE, nullable=nullable)


def datetime_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.DATETIME, nullable=nullable)


def varchar_type(flen: int = -1, nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.VARCHAR, flen=flen, nullable=nullable)


def char_type(flen: int = 1, nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.CHAR, flen=flen, nullable=nullable)


def boolean_type(nullable: bool = True) -> FieldType:
    return FieldType(TypeKind.BOOLEAN, nullable=nullable)
