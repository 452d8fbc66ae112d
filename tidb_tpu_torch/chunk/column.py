"""Columnar storage: typed flat buffers + validity masks + string dictionaries.

Counterpart of the reference's Apache-Arrow-like chunk column (reference:
util/chunk/column.go:61 — null bitmap + offsets + flat data buffer), with two
TPU-first changes:

* Strings are dictionary-encoded as int32 codes against a shared, append-only
  per-table-column `Dictionary`. Any string predicate or collation-aware
  ordering is evaluated host-side ONCE over the (small) dictionary and then
  applied device-side as a gather over codes — the device never touches
  variable-length bytes.
* NULLs are a `bool` validity array (True = valid), not a packed bitmap:
  XLA fuses mask ops for free, and padding masks for static tiles reuse the
  same representation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from ..errno import ER_INVALID_JSON_TEXT, WARN_DATA_TRUNCATED, CodedError
from ..types.field_type import FieldType, TypeKind
from ..types.value import (
    Decimal,
    decode_date,
    decode_datetime,
    encode_date,
    encode_datetime,
    parse_date,
    parse_datetime,
)


class Dictionary:
    """Append-only string dictionary shared by all regions of a table column.

    Codes are NOT order-preserving (inserts append); ordering and range
    predicates are handled by computing per-code lookup tables host-side
    (see copr/kernels). Equality is exact on codes.
    """

    __slots__ = ("values", "_index", "_ci_cache", "_ci_len")

    def __init__(self, values: Optional[Iterable[str]] = None) -> None:
        self.values: list[str] = []
        self._index: dict[str, int] = {}
        self._ci_cache: Optional[dict[str, int]] = None
        self._ci_len = 0
        if values:
            for v in values:
                self.encode(v)

    def __len__(self) -> int:
        return len(self.values)

    def encode(self, s: str) -> int:
        code = self._index.get(s)
        if code is None:
            code = len(self.values)
            self.values.append(s)
            self._index[s] = code
        return code

    def lookup(self, s: str) -> int:
        """Code for s, or -1 if the string is absent (never matches equality)."""
        return self._index.get(s, -1)

    def decode(self, code: int) -> str:
        return self.values[code]

    def code_table(self, pred) -> np.ndarray:
        """bool[len(dict)] lookup table: pred evaluated over every dict value.

        This is how arbitrary string predicates (LIKE, >=, collation compares)
        become a single device-side gather.
        """
        return np.fromiter((pred(v) for v in self.values), dtype=bool,
                           count=len(self.values))

    def sort_ranks(self, ci: bool = False) -> np.ndarray:
        """int32[len(dict)] rank of each code in sorted order; device maps
        codes -> ranks to get order-correct comparisons. ci=True ranks by
        casefolded value (the *_ci collation family, reference:
        util/collate/collate.go:62)."""
        if ci:
            keyed = np.array([v.casefold() for v in self.values],
                             dtype=object)
        else:
            keyed = np.array(self.values, dtype=object)
        order = np.argsort(keyed, kind="stable")
        ranks = np.empty(len(self.values), dtype=np.int32)
        ranks[order] = np.arange(len(self.values), dtype=np.int32)
        return ranks

    def _ci_map(self) -> dict[str, int]:
        """casefolded value -> first (canonical) code; grown
        incrementally as the append-only dictionary grows, so repeated
        ci joins/IN-lists stay O(1) per probe."""
        m = self._ci_cache
        if m is None:
            m = {}
            self._ci_cache = m
            self._ci_len = 0
        for i in range(self._ci_len, len(self.values)):
            m.setdefault(self.values[i].casefold(), i)
        self._ci_len = len(self.values)
        return m

    def ci_canonical(self) -> np.ndarray:
        """int64[len(dict)] canonical code per code: the first code whose
        value casefolds equally. Grouping/joining ci-collated columns maps
        codes through this so 'A' and 'a' land together."""
        m = self._ci_map()
        return np.fromiter((m[v.casefold()] for v in self.values),
                           np.int64, count=len(self.values))

    def lookup_ci(self, s: str) -> int:
        """Canonical code of any value casefold-equal to s, or -1."""
        return self._ci_map().get(s.casefold(), -1)


class EnumDictionary(Dictionary):
    """Fixed, definition-ordered dictionary for ENUM columns: encode
    validates membership (case-insensitively, like MySQL) and sort order
    is definition order, not lexicographic (reference: ENUM compares by
    index, types/enum.go)."""

    __slots__ = ()

    def __init__(self, elems) -> None:
        super().__init__()
        for e in elems:
            Dictionary.encode(self, e)  # seed bypasses validation

    def encode(self, s: str) -> int:
        code = self._index.get(s)
        if code is not None:
            return code
        code = self.lookup_ci(s)
        if code < 0:
            raise TruncateError(
                f"Data truncated: invalid ENUM value {s!r}")
        return code

    def sort_ranks(self, ci: bool = False) -> np.ndarray:
        return np.arange(len(self.values), dtype=np.int32)



class TruncateError(CodedError, ValueError):
    """Value does not fit the column's domain (ENUM/SET membership)."""

    errno = WARN_DATA_TRUNCATED
    sqlstate = "01000"


class InvalidJSONError(CodedError, ValueError):
    errno = ER_INVALID_JSON_TEXT
    sqlstate = "22032"


@dataclass
class Column:
    """One typed column: flat numpy buffer + validity + optional dictionary."""

    ftype: FieldType
    data: np.ndarray
    valid: Optional[np.ndarray] = None  # None => all valid
    dictionary: Optional[Dictionary] = None

    def __len__(self) -> int:
        return len(self.data)

    @property
    def nbytes(self) -> int:
        """Buffer bytes held by this column (dictionary excluded: it is
        shared table state, not per-chunk working set)."""
        n = self.data.nbytes
        if self.valid is not None:
            n += self.valid.nbytes
        return n

    @property
    def validity(self) -> np.ndarray:
        if self.valid is None:
            return np.ones(len(self.data), dtype=bool)
        return self.valid

    def null_at(self, i: int) -> bool:
        return self.valid is not None and not self.valid[i]

    # ---- element access (render / host fallback path) ----------------------
    def value_at(self, i: int) -> Any:
        """Decode physical storage to a host scalar (None for NULL)."""
        if self.null_at(i):
            return None
        return decode_scalar(self.ftype, self.data[i], self.dictionary)

    def to_pylist(self) -> list[Any]:
        return [self.value_at(i) for i in range(len(self))]

    # ---- construction ------------------------------------------------------
    @staticmethod
    def empty(ftype: FieldType, dictionary: Optional[Dictionary] = None) -> "Column":
        return Column(ftype, np.empty(0, dtype=ftype.np_dtype), None, dictionary)

    @staticmethod
    def from_values(
        ftype: FieldType,
        values: Sequence[Any],
        dictionary: Optional[Dictionary] = None,
    ) -> "Column":
        """Encode host scalars into the physical layout.

        Accepts Python ints/floats/strs/Decimals/dates and string literals for
        temporal types. None encodes as NULL.
        """
        n = len(values)
        data = np.zeros(n, dtype=ftype.np_dtype)
        valid = np.ones(n, dtype=bool)
        if ftype.is_string and dictionary is None:
            dictionary = Dictionary()
        for i, v in enumerate(values):
            if v is None:
                valid[i] = False
                continue
            data[i] = _encode_scalar(ftype, v, dictionary)
        return Column(ftype, data, None if valid.all() else valid, dictionary)

    def take(self, indices: np.ndarray) -> "Column":
        return Column(
            self.ftype,
            self.data[indices],
            None if self.valid is None else self.valid[indices],
            self.dictionary,
        )

    def _remapped_data(self, other: "Column") -> np.ndarray:
        """other's codes re-encoded into self's dictionary (strings only)."""
        assert self.dictionary is not None and other.dictionary is not None
        if len(other.dictionary) == 0:
            # all-NULL column: placeholder codes, nothing to remap
            return other.data
        remap = np.fromiter(
            (self.dictionary.encode(v) for v in other.dictionary.values),
            dtype=np.int32,
            count=len(other.dictionary),
        )
        return remap[other.data]

    def append(self, other: "Column") -> "Column":
        if self.ftype.kind != other.ftype.kind or (
            self.ftype.is_decimal and self.ftype.scale != other.ftype.scale
        ):
            raise TypeError(f"append type mismatch: {self.ftype!r} vs {other.ftype!r}")
        other_data = other.data
        dictionary = self.dictionary or other.dictionary
        if (
            self.ftype.is_string
            and self.dictionary is not None
            and other.dictionary is not None
            and other.dictionary is not self.dictionary
        ):
            other_data = self._remapped_data(other)
            dictionary = self.dictionary
        data = np.concatenate([self.data, other_data])
        if self.valid is None and other.valid is None:
            valid = None
        else:
            valid = np.concatenate([self.validity, other.validity])
        return Column(self.ftype, data, valid, dictionary)


def decode_scalar(ftype: FieldType, raw: Any,
                  dictionary: Optional[Dictionary]) -> Any:
    """Physical cell value -> host scalar (the inverse of
    _encode_scalar; shared by Column.value_at and the point fast path's
    row decode, which reads physical tuples without ever building a
    Column)."""
    if raw is None:
        return None
    k = ftype.kind
    if k == TypeKind.SET:
        mask = int(raw)
        return ",".join(e for j, e in enumerate(ftype.elems)
                        if mask >> j & 1)
    if ftype.is_decimal:
        return Decimal(int(raw), ftype.scale)
    if k == TypeKind.DATE:
        return decode_date(int(raw))
    if k in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        return decode_datetime(int(raw))
    if ftype.is_string:
        assert dictionary is not None
        return dictionary.decode(int(raw))
    if ftype.is_float:
        return float(raw)
    return int(raw)


def _encode_scalar(ftype: FieldType, v: Any, dictionary: Optional[Dictionary]) -> Any:
    """Host scalar -> physical representation for one cell."""
    k = ftype.kind
    if k == TypeKind.SET:
        if isinstance(v, (int, np.integer)):
            mask = int(v)
            if mask >> len(ftype.elems):
                raise ValueError(f"invalid SET bitmask {mask}")
            return mask
        lowered = {e.lower(): j for j, e in enumerate(ftype.elems)}
        mask = 0
        for part in str(v).split(","):
            part = part.strip()
            if not part:
                continue
            j = lowered.get(part.lower())
            if j is None:
                raise TruncateError(
                    f"Data truncated: invalid SET value {part!r}")
            mask |= 1 << j
        return mask
    if k == TypeKind.BIT:
        n = int(v)
        width = min(ftype.flen if ftype.flen > 0 else 1, 63)
        if n < 0 or n >> width:
            raise ValueError(f"BIT({width}) value {n} out of range")
        return n
    if k == TypeKind.JSON:
        import json as _json

        assert dictionary is not None
        s = v if isinstance(v, str) else _json.dumps(v)
        try:
            # normalize so equal documents encode to equal codes
            # (reference: types/json/binary.go canonical binary form)
            s = _json.dumps(_json.loads(s), sort_keys=True,
                            separators=(", ", ": "))
        except ValueError:
            raise InvalidJSONError(
                f"Invalid JSON text: {s[:40]!r}") from None
        return dictionary.encode(s)
    if ftype.is_decimal:
        if isinstance(v, Decimal):
            d = v.rescale(ftype.scale)
        elif isinstance(v, str):
            d = Decimal.parse(v).rescale(ftype.scale)
        elif isinstance(v, int):
            d = Decimal.from_int(v, ftype.scale)
        elif isinstance(v, float):
            # MySQL converts doubles via their decimal string form (shortest
            # repr), then rounds half away from zero
            d = Decimal.parse(repr(v)).rescale(ftype.scale)
        else:
            raise TypeError(f"cannot encode {type(v)} as {ftype!r}")
        if not (-(2**63) < d.unscaled < 2**63):
            raise OverflowError(f"decimal out of device range: {d}")
        return d.unscaled
    if k == TypeKind.DATE:
        if isinstance(v, str):
            return parse_date(v)
        if hasattr(v, "year") and not hasattr(v, "hour"):
            return encode_date(v)
        return int(v)
    if k in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        if isinstance(v, str):
            return parse_datetime(v)
        if hasattr(v, "hour"):
            return encode_datetime(v)
        return int(v)
    if ftype.is_string:
        assert dictionary is not None
        return dictionary.encode(str(v))
    if ftype.is_float:
        if isinstance(v, Decimal):
            return v.to_float()
        return float(v)
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, float) and v.is_integer():
        return int(v)
    return int(v)
