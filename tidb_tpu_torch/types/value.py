"""Host-side scalar values and temporal codecs.

The reference carries row values as dynamic `types.Datum` (reference:
types/datum.go) with a 2.4k-line arbitrary-precision decimal engine
(types/mydecimal.go). On TPU the data plane is columnar and typed, so the
host only needs thin exact scalars for: literals in the parser/planner,
final-stage arithmetic (e.g. AVG = SUM/COUNT with MySQL scale rules), and
result rendering.

Decimal here is an exact scaled integer over Python's bignum ints, so host
math never overflows; only the *device* columns are bounded to int64
(checked at ingest).
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass

_EPOCH = _dt.date(1970, 1, 1)


@dataclass(frozen=True)
class Decimal:
    """Exact fixed-point decimal: value = unscaled / 10**scale."""

    unscaled: int
    scale: int

    # ---- construction ------------------------------------------------------
    @staticmethod
    def parse(text: str) -> "Decimal":
        text = text.strip()
        neg = text.startswith("-")
        if text and text[0] in "+-":
            text = text[1:]
        exp = 0
        for e in ("e", "E"):
            if e in text:
                text, exp_s = text.split(e, 1)
                exp = int(exp_s)
                break
        if "." in text:
            intpart, frac = text.split(".", 1)
        else:
            intpart, frac = text, ""
        intpart = intpart or "0"
        unscaled = int(intpart + frac) if (intpart + frac) else 0
        if neg:
            unscaled = -unscaled
        scale = len(frac) - exp
        if scale < 0:
            unscaled *= 10 ** (-scale)
            scale = 0
        return Decimal(unscaled, scale)

    @staticmethod
    def from_int(v: int, scale: int = 0) -> "Decimal":
        return Decimal(v * 10 ** scale, scale)

    # ---- scale management --------------------------------------------------
    def rescale(self, scale: int) -> "Decimal":
        """Exact when widening; MySQL half-away-from-zero rounding when narrowing
        (reference: types/mydecimal.go Round, ModeHalfEven name notwithstanding
        MySQL rounds half away from zero)."""
        if scale == self.scale:
            return self
        if scale > self.scale:
            return Decimal(self.unscaled * 10 ** (scale - self.scale), scale)
        div = 10 ** (self.scale - scale)
        q, r = divmod(abs(self.unscaled), div)
        if 2 * r >= div:
            q += 1
        return Decimal(-q if self.unscaled < 0 else q, scale)

    # ---- arithmetic (MySQL result-scale rules) -----------------------------
    def __add__(self, other: "Decimal") -> "Decimal":
        s = max(self.scale, other.scale)
        return Decimal(self.rescale(s).unscaled + other.rescale(s).unscaled, s)

    def __sub__(self, other: "Decimal") -> "Decimal":
        s = max(self.scale, other.scale)
        return Decimal(self.rescale(s).unscaled - other.rescale(s).unscaled, s)

    def __mul__(self, other: "Decimal") -> "Decimal":
        return Decimal(self.unscaled * other.unscaled, self.scale + other.scale)

    def div(self, other: "Decimal", incr_scale: int = 4) -> "Decimal":
        """MySQL division: result scale = dividend scale + div_precincrement
        (default 4; reference: expression/builtin_arithmetic.go DIV scale)."""
        if other.unscaled == 0:
            raise ZeroDivisionError("decimal division by zero")
        target = self.scale + incr_scale
        # compute the quotient at the target scale directly and round once on
        # the true remainder (half away from zero)
        num = self.unscaled * 10 ** (target - self.scale)
        q, r = divmod(abs(num), abs(other.unscaled))
        if 2 * r >= abs(other.unscaled):
            q += 1
        if (self.unscaled < 0) != (other.unscaled < 0):
            q = -q
        return Decimal(q, target)

    def __neg__(self) -> "Decimal":
        return Decimal(-self.unscaled, self.scale)

    # ---- comparison --------------------------------------------------------
    def _cmp(self, other: "Decimal") -> int:
        s = max(self.scale, other.scale)
        a, b = self.rescale(s).unscaled, other.rescale(s).unscaled
        return (a > b) - (a < b)

    def __lt__(self, o):  # type: ignore[no-untyped-def]
        return self._cmp(o) < 0

    def __le__(self, o):  # type: ignore[no-untyped-def]
        return self._cmp(o) <= 0

    def __gt__(self, o):  # type: ignore[no-untyped-def]
        return self._cmp(o) > 0

    def __ge__(self, o):  # type: ignore[no-untyped-def]
        return self._cmp(o) >= 0

    def __eq__(self, o: object) -> bool:
        return isinstance(o, Decimal) and self._cmp(o) == 0

    def __hash__(self) -> int:
        return hash(self.normalize())

    def normalize(self) -> tuple[int, int]:
        u, s = self.unscaled, self.scale
        while s > 0 and u % 10 == 0:
            u //= 10
            s -= 1
        return (u, s)

    # ---- conversion --------------------------------------------------------
    def to_float(self) -> float:
        return self.unscaled / 10 ** self.scale

    def __str__(self) -> str:
        if self.scale == 0:
            return str(self.unscaled)
        sign = "-" if self.unscaled < 0 else ""
        digits = str(abs(self.unscaled)).rjust(self.scale + 1, "0")
        return f"{sign}{digits[:-self.scale]}.{digits[-self.scale:]}"

    def __repr__(self) -> str:
        return f"Decimal({self})"


# ---- temporal encodings -----------------------------------------------------
# DATE      -> int32 days since 1970-01-01
# DATETIME  -> int64 microseconds since 1970-01-01T00:00:00

Date = _dt.date
DateTime = _dt.datetime


def encode_date(d: _dt.date) -> int:
    return (d - _EPOCH).days


def decode_date(days: int) -> _dt.date:
    return _EPOCH + _dt.timedelta(days=int(days))


def parse_date(text: str) -> int:
    y, m, d = text.strip().split("-")
    return encode_date(_dt.date(int(y), int(m), int(d)))


def encode_datetime(dt: _dt.datetime) -> int:
    delta = dt - _dt.datetime(1970, 1, 1)
    return (delta.days * 86_400 + delta.seconds) * 1_000_000 + delta.microseconds


def decode_datetime(micros: int) -> _dt.datetime:
    return _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(micros))


def parse_datetime(text: str) -> int:
    text = text.strip()
    if " " in text:
        datepart, timepart = text.split(" ", 1)
    else:
        datepart, timepart = text, "00:00:00"
    y, m, d = (int(x) for x in datepart.split("-"))
    hms = timepart.split(":")
    h, mi = int(hms[0]), int(hms[1])
    sec = float(hms[2]) if len(hms) > 2 else 0.0
    s = int(sec)
    us = round((sec - s) * 1e6)
    return encode_datetime(_dt.datetime(y, m, d, h, mi, s, us))
