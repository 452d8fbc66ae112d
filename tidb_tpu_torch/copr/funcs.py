"""Scalar function registry: the long tail of the MySQL builtin surface.

Port of `tidb_tpu/copr/funcs.py`, kept name for name: the same `FuncDef`s
(argument ranges, return domain `ret`, `null_prop`, `dict_vec`) under the
same names, so both packages resolve and evaluate every builtin alike. It
is pure Python and touches no device.

The reference implements ~800 builtin signatures across
expression/builtin_string.go, builtin_math.go, builtin_time.go,
builtin_encryption.go, builtin_regexp*.go and friends. The hot,
vectorizable core (arithmetic, comparisons, CASE, date parts, LIKE,
common string ops) lives in the device kernels (copr/eval.py) and the
vectorized host evaluator (copr/npeval.py). THIS module is the breadth
layer: per-row Python implementations registered declaratively, resolved
generically by the planner (plan/builder.py falls through to the
registry) and evaluated host-side by npeval's registry hook. The device
gate rejects `fx:` ops, so queries using them simply keep those
projections on the host — the same split the reference draws with its
coprocessor pushdown allowlist (expression/expr_to_pb.go
canFuncBePushed).

Value domains at the registry boundary: strings -> str, DATE -> day
number (int; helpers below convert), DECIMAL -> stdlib decimal.Decimal
(EXACT — the evaluator converts unscaled ints without a float round
trip, and decimal-typed results rescale exactly; reference keeps
MyDecimal exact through every builtin, types/mydecimal.go), other
numerics -> int/float. Returning None yields SQL NULL. With
null_prop=True (default) any NULL argument short-circuits to NULL,
matching most MySQL builtins.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import math
import re as _re
import time as _time
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

from ..types.value import decode_date, encode_date


@dataclass(frozen=True)
class FuncDef:
    name: str
    min_args: int
    max_args: int
    ret: str                  # str | int | float | date | arg0
    fn: Callable
    null_prop: bool = True
    # pure function of its arguments whose only string input can be a
    # dictionary column: NumpyEval evaluates it once per DISTINCT
    # dictionary value and gathers by code (npeval._dict_vec_call)
    # instead of once per row
    dict_vec: bool = False


REGISTRY: dict[str, FuncDef] = {}


def _reg(name: str, lo: int, hi: int, ret: str, fn: Callable,
         null_prop: bool = True, dict_vec: bool = False) -> None:
    REGISTRY[name] = FuncDef(name, lo, hi, ret, fn, null_prop, dict_vec)


def lookup(name: str) -> Optional[FuncDef]:
    return REGISTRY.get(name.upper())


# ---------------------------------------------------------------------------
# string functions (reference: expression/builtin_string.go)
# ---------------------------------------------------------------------------

def _substring_index(s, delim, count):
    if not delim:
        return ""
    count = int(count)
    parts = s.split(delim)
    if count == 0:
        return ""
    if count > 0:
        return delim.join(parts[:count])
    return delim.join(parts[count:])


def _insert(s, pos, ln, news):
    pos, ln = int(pos), int(ln)
    if pos < 1 or pos > len(s):
        return s
    if ln < 0 or pos + ln - 1 > len(s):
        ln = len(s) - pos + 1
    return s[: pos - 1] + news + s[pos - 1 + ln:]


def _mid(s, pos, ln=None):
    pos = int(pos)
    if pos == 0:
        return ""
    if pos < 0:
        pos = len(s) + pos + 1
        if pos < 1:
            return ""
    out = s[pos - 1:]
    if ln is not None:
        ln = int(ln)
        if ln <= 0:
            return ""
        out = out[:ln]
    return out


def _locate(sub, s, pos=None):
    start = max(int(pos) - 1, 0) if pos is not None else 0
    i = s.find(sub, start)
    return i + 1


def _conv(n, from_base, to_base):
    from_base, to_base = int(from_base), int(to_base)
    if not (2 <= abs(from_base) <= 36 and 2 <= abs(to_base) <= 36):
        return None
    try:
        v = int(str(n).strip() or "0", abs(from_base))
    except ValueError:
        v = 0
    neg = v < 0
    v = abs(v)
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    out = ""
    while True:
        out = digits[v % abs(to_base)] + out
        v //= abs(to_base)
        if v == 0:
            break
    return ("-" if neg and to_base < 0 else "") + out


def _hex(v):
    if isinstance(v, str):
        return v.encode("utf-8").hex().upper()
    return format(int(v), "X")


def _format_num(x, d):
    import decimal as _pydec

    d = max(int(d), 0)
    if isinstance(x, _pydec.Decimal):  # exact decimal formatting
        q = x.quantize(_pydec.Decimal(1).scaleb(-d),
                       rounding=_pydec.ROUND_HALF_UP)
        return f"{q:,.{d}f}"
    return f"{float(x):,.{d}f}"


def _soundex(s):
    s = "".join(c for c in s.upper() if c.isalpha())
    if not s:
        return ""
    codes = {**dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
             **dict.fromkeys("DT", "3"), "L": "4",
             **dict.fromkeys("MN", "5"), "R": "6"}
    out = s[0]
    last = codes.get(s[0], "")
    for c in s[1:]:
        code = codes.get(c, "")
        if code and code != last:
            out += code
        last = code
    return (out + "000")[:4] if len(out) < 4 else out


def _export_set(bits, on, off, sep=",", n=64):
    bits, n = int(bits), min(max(int(n), 0), 64)
    return sep.join(on if (bits >> i) & 1 else off for i in range(n))


def _make_set(bits, *strs):
    bits = int(bits)
    return ",".join(s for i, s in enumerate(strs)
                    if s is not None and (bits >> i) & 1)


def _sha2(s, bits):
    algo = {0: "sha256", 224: "sha224", 256: "sha256", 384: "sha384",
            512: "sha512"}.get(int(bits))
    if algo is None:
        return None
    return hashlib.new(algo, s.encode("utf-8")).hexdigest()


def _elt(n, *strs):
    n = int(n)
    if n < 1 or n > len(strs):
        return None
    return strs[n - 1]


def _field(s, *strs):
    if s is None:
        return 0
    for i, t in enumerate(strs):
        if t is not None and t == s:
            return i + 1
    return 0


_reg("SUBSTRING_INDEX", 3, 3, "str", _substring_index, dict_vec=True)
_reg("INSERT", 4, 4, "str", _insert)
_reg("MID", 2, 3, "str", _mid)
_reg("SUBSTR", 2, 3, "str", _mid)
_reg("ELT", 1, 99, "str", _elt, null_prop=False)
_reg("FIELD", 1, 99, "int", _field, null_prop=False)
_reg("STRCMP", 2, 2, "int",
     lambda a, b: -1 if a < b else (1 if a > b else 0))
_reg("QUOTE", 1, 1, "str",
     lambda s: "'" + s.replace("\\", "\\\\").replace("'", "\\'") + "'")
_reg("SPACE", 1, 1, "str", lambda n: " " * max(int(n), 0))
_reg("BIN", 1, 1, "str", lambda n: format(int(n), "b"))
_reg("OCT", 1, 1, "str", lambda n: format(int(n), "o"))
_reg("HEX", 1, 1, "str", _hex)
_reg("UNHEX", 1, 1, "str",
     lambda s: _unhex(s))
_reg("CONV", 3, 3, "str", _conv)
_reg("CHAR", 1, 99, "str",
     lambda *ns: "".join(chr(int(n) & 0xFF) for n in ns
                         if n is not None), null_prop=False)
_reg("ORD", 1, 1, "int", lambda s: ord(s[0]) if s else 0)
_reg("FORMAT", 2, 2, "str", _format_num)
_reg("SOUNDEX", 1, 1, "str", _soundex)
_reg("TO_BASE64", 1, 1, "str",
     lambda s: base64.b64encode(s.encode("utf-8")).decode("ascii"))
_reg("FROM_BASE64", 1, 1, "str", lambda s: _from_base64(s))
_reg("MD5", 1, 1, "str",
     lambda s: hashlib.md5(str(s).encode("utf-8")).hexdigest())
_reg("SHA", 1, 1, "str",
     lambda s: hashlib.sha1(str(s).encode("utf-8")).hexdigest())
_reg("SHA1", 1, 1, "str",
     lambda s: hashlib.sha1(str(s).encode("utf-8")).hexdigest())
_reg("SHA2", 2, 2, "str", _sha2)
_reg("CRC32", 1, 1, "int",
     lambda s: zlib.crc32(str(s).encode("utf-8")) & 0xFFFFFFFF)
_reg("BIT_LENGTH", 1, 1, "int",
     lambda s: len(str(s).encode("utf-8")) * 8)
_reg("EXPORT_SET", 3, 5, "str", _export_set)
_reg("MAKE_SET", 1, 99, "str", _make_set, null_prop=False)
_reg("ISNULL", 1, 1, "int",
     lambda v: 1 if v is None else 0, null_prop=False)
def _sleep(x):
    """Interruptible sleep (KILL QUERY breaks it, like MySQL's)."""
    from ..util import interrupt
    end = _time.monotonic() + min(float(x), 30)
    while _time.monotonic() < end:
        interrupt.check()
        _time.sleep(0.05)
    return 0


_reg("SLEEP", 1, 1, "int", _sleep)
_reg("LOCATE3", 3, 3, "int", _locate)  # 3-arg LOCATE (2-arg is core)


def _unhex(s):
    try:
        return binascii.unhexlify(s if len(s) % 2 == 0 else "0" + s
                                  ).decode("utf-8", "replace")
    except (binascii.Error, ValueError):
        return None


def _from_base64(s):
    try:
        return base64.b64decode(s).decode("utf-8", "replace")
    except (binascii.Error, ValueError):
        return None


# ---- regexp family (reference: expression/builtin_regexp.go;
# MySQL 8 ICU regex ~ python re for the common subset) ----------------

def _regexp_like(s, pat, match_type=""):
    flags = _re.IGNORECASE if "i" in (match_type or "") else 0
    try:
        return 1 if _re.search(pat, s, flags) else 0
    except _re.error:
        return None


def _regexp_substr(s, pat, pos=1, occ=1):
    try:
        ms = list(_re.finditer(pat, s[int(pos) - 1:]))
    except _re.error:
        return None
    occ = int(occ)
    if len(ms) < occ or occ < 1:
        return None
    return ms[occ - 1].group(0)


def _regexp_instr(s, pat, pos=1, occ=1):
    try:
        ms = list(_re.finditer(pat, s[int(pos) - 1:]))
    except _re.error:
        return None
    occ = int(occ)
    if len(ms) < occ or occ < 1:
        return 0
    return ms[occ - 1].start() + int(pos)


def _regexp_replace(s, pat, repl, pos=1, occ=0):
    pos, occ = int(pos), int(occ)
    head, tail = s[: pos - 1], s[pos - 1:]
    try:
        if occ == 0:
            return head + _re.sub(pat, repl, tail)
        ms = list(_re.finditer(pat, tail))
        if len(ms) < occ:
            return s
        m = ms[occ - 1]
        return head + tail[: m.start()] + repl + tail[m.end():]
    except _re.error:
        return None


_reg("REGEXP_LIKE", 2, 3, "int", _regexp_like, dict_vec=True)
_reg("REGEXP_SUBSTR", 2, 4, "str", _regexp_substr, dict_vec=True)
_reg("REGEXP_INSTR", 2, 4, "int", _regexp_instr, dict_vec=True)
_reg("REGEXP_REPLACE", 3, 5, "str", _regexp_replace, dict_vec=True)

# ---------------------------------------------------------------------------
# math functions (reference: expression/builtin_math.go)
# ---------------------------------------------------------------------------

_reg("SIN", 1, 1, "float", lambda x: math.sin(float(x)))
_reg("COS", 1, 1, "float", lambda x: math.cos(float(x)))
_reg("TAN", 1, 1, "float", lambda x: math.tan(float(x)))
_reg("COT", 1, 1, "float",
     lambda x: 1.0 / math.tan(float(x)) if math.tan(float(x)) else None)
_reg("ASIN", 1, 1, "float",
     lambda x: math.asin(float(x)) if -1 <= float(x) <= 1 else None)
_reg("ACOS", 1, 1, "float",
     lambda x: math.acos(float(x)) if -1 <= float(x) <= 1 else None)
_reg("ATAN", 1, 2, "float",
     lambda x, y=None: math.atan(float(x)) if y is None
     else math.atan2(float(x), float(y)))
_reg("ATAN2", 2, 2, "float",
     lambda x, y: math.atan2(float(x), float(y)))
_reg("DEGREES", 1, 1, "float", lambda x: math.degrees(float(x)))
_reg("RADIANS", 1, 1, "float", lambda x: math.radians(float(x)))
_reg("CBRT", 1, 1, "float", lambda x: math.copysign(
    abs(float(x)) ** (1 / 3), float(x)))
_reg("SINH", 1, 1, "float", lambda x: math.sinh(float(x)))
_reg("COSH", 1, 1, "float", lambda x: math.cosh(float(x)))
_reg("TANH", 1, 1, "float", lambda x: math.tanh(float(x)))
def _mod(a, b):
    """MySQL MOD: result carries the dividend's sign. Exact for int and
    decimal.Decimal operands (no float round trip); float when an operand
    is one, and string operands coerce numerically (MySQL MOD('7',2)=1)."""
    import decimal as _pydec

    if not isinstance(a, (int, float, _pydec.Decimal)):
        a = float(a)
    if not isinstance(b, (int, float, _pydec.Decimal)):
        b = float(b)
    if isinstance(a, float) or isinstance(b, float):
        if float(b) == 0:
            return None
        return math.fmod(float(a), float(b))
    if b == 0:
        return None
    r = abs(a) % abs(b)
    return -r if a < 0 else r


_reg("MOD", 2, 2, "arg0", _mod)

# ---------------------------------------------------------------------------
# date/time functions (reference: expression/builtin_time.go). DATE
# arguments arrive as day numbers; helpers convert.
# ---------------------------------------------------------------------------

_DAYNAMES = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
             "Saturday", "Sunday")
_MONTHNAMES = ("January", "February", "March", "April", "May", "June",
               "July", "August", "September", "October", "November",
               "December")

# MySQL TO_DAYS epoch: day number of 0000-01-01 is 1; python date
# toordinal() day 1 is 0001-01-01 -> offset 365
_TO_DAYS_OFFSET = 365


def _d(days):
    return decode_date(int(days))


def _week(days, mode=0):
    """WEEK() modes 0-3 (the commonly used ones)."""
    d = _d(days)
    mode = int(mode) & 7
    if mode in (1, 3):
        return d.isocalendar()[1]
    # mode 0/2: week starts Sunday; week 1 = first week with a Sunday
    jan1 = d.replace(month=1, day=1)
    days_since_sunday = (jan1.weekday() + 1) % 7
    first_sunday_ord = jan1.toordinal() + ((7 - days_since_sunday) % 7)
    if d.toordinal() < first_sunday_ord:
        if mode == 2:
            # mode 2 has no week 0: early-January days belong to the
            # previous year's last week
            prev_dec31 = jan1.toordinal() - 1
            from datetime import date as _date
            return _week(encode_date(_date.fromordinal(prev_dec31)), 2)
        return 0
    return (d.toordinal() - first_sunday_ord) // 7 + 1


def _yearweek(days, mode=0):
    d = _d(days)
    if int(mode) & 1:
        y, w, _ = d.isocalendar()
        return y * 100 + w
    w = _week(days, 0)
    if w == 0:
        prev = d.replace(month=1, day=1).toordinal() - 1
        pd = prev  # last day of previous year
        from datetime import date as _date
        pdd = _date.fromordinal(pd)
        return pdd.year * 100 + _week(encode_date(pdd), 0)
    return d.year * 100 + w


def _makedate(y, doy):
    y, doy = int(y), int(doy)
    if doy < 1:
        return None
    from datetime import date as _date, timedelta
    try:
        return encode_date(_date(y, 1, 1) + timedelta(days=doy - 1))
    except (ValueError, OverflowError):
        return None


def _period_add(p, n):
    p, n = int(p), int(n)
    y, m = divmod(p, 100)
    if y < 100:
        y += 2000 if y < 70 else 1900
    months = y * 12 + (m - 1) + n
    return (months // 12) * 100 + months % 12 + 1


def _period_diff(p1, p2):
    def months(p):
        y, m = divmod(int(p), 100)
        if y < 100:
            y += 2000 if y < 70 else 1900
        return y * 12 + m - 1
    return months(p1) - months(p2)


_DATE_FMT = {
    "Y": lambda d: f"{d.year:04d}", "y": lambda d: f"{d.year % 100:02d}",
    "m": lambda d: f"{d.month:02d}", "c": lambda d: str(d.month),
    "d": lambda d: f"{d.day:02d}", "e": lambda d: str(d.day),
    "H": lambda d: "00", "k": lambda d: "0", "h": lambda d: "12",
    "I": lambda d: "12", "l": lambda d: "12",
    "i": lambda d: "00", "s": lambda d: "00", "S": lambda d: "00",
    "f": lambda d: "000000", "p": lambda d: "AM",
    "W": lambda d: _DAYNAMES[d.weekday()],
    "a": lambda d: _DAYNAMES[d.weekday()][:3],
    "M": lambda d: _MONTHNAMES[d.month - 1],
    "b": lambda d: _MONTHNAMES[d.month - 1][:3],
    "j": lambda d: f"{d.timetuple().tm_yday:03d}",
    "w": lambda d: str((d.weekday() + 1) % 7),
    "u": lambda d: f"{_week(encode_date(d), 1):02d}",
    "U": lambda d: f"{_week(encode_date(d), 0):02d}",
    "V": lambda d: f"{_week(encode_date(d), 2):02d}",
    "v": lambda d: f"{d.isocalendar()[1]:02d}",
    "x": lambda d: f"{d.isocalendar()[0]:04d}",
    "X": lambda d: f"{d.isocalendar()[0]:04d}",
    "D": lambda d: str(d.day) + (
        "th" if 10 <= d.day % 100 <= 20
        else {1: "st", 2: "nd", 3: "rd"}.get(d.day % 10, "th")),
    "T": lambda d: "00:00:00", "r": lambda d: "12:00:00 AM",
    "%": lambda d: "%",
}


def _date_format(days, fmt):
    d = _d(days)
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            out.append(_DATE_FMT.get(spec, lambda _: spec)(d))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


_STRPTIME = {"Y": "%Y", "y": "%y", "m": "%m", "c": "%m", "d": "%d",
             "e": "%d", "M": "%B", "b": "%b", "j": "%j"}


def _str_to_date(s, fmt):
    py = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            conv = _STRPTIME.get(spec)
            if conv is None:
                return None  # time-part specifiers unsupported for DATE
            py.append(conv)
            i += 2
        else:
            py.append("%%" if c == "%" else c)
            i += 1
    from datetime import datetime as _dtm
    try:
        return encode_date(_dtm.strptime(s.strip(), "".join(py)).date())
    except ValueError:
        return None


_reg("DATE_FORMAT", 2, 2, "str", _date_format)
_reg("STR_TO_DATE", 2, 2, "date", _str_to_date)
_reg("TO_DAYS", 1, 1, "int",
     lambda days: _d(days).toordinal() + _TO_DAYS_OFFSET)
_reg("FROM_DAYS", 1, 1, "date", lambda n: _from_days(n))
_reg("DAYNAME", 1, 1, "str", lambda days: _DAYNAMES[_d(days).weekday()])
_reg("MONTHNAME", 1, 1, "str",
     lambda days: _MONTHNAMES[_d(days).month - 1])
_reg("WEEK", 1, 2, "int", _week)
_reg("WEEKOFYEAR", 1, 1, "int", lambda days: _d(days).isocalendar()[1])
_reg("YEARWEEK", 1, 2, "int", _yearweek)
_reg("MAKEDATE", 2, 2, "date", _makedate)
_reg("PERIOD_ADD", 2, 2, "int", _period_add)
_reg("PERIOD_DIFF", 2, 2, "int", _period_diff)
_reg("UNIX_TIMESTAMP", 1, 1, "int",
     lambda days: int(_time.mktime(_d(days).timetuple())))
_reg("ADDDATE", 2, 2, "date", lambda days, n: int(days) + int(n))
_reg("SUBDATE", 2, 2, "date", lambda days, n: int(days) - int(n))
_reg("TIMESTAMPDIFF_DAYS", 2, 2, "int",
     lambda a, b: int(b) - int(a))


def _from_days(n):
    from datetime import date as _date
    try:
        return encode_date(_date.fromordinal(int(n) - _TO_DAYS_OFFSET))
    except (ValueError, OverflowError):
        return None


# ---------------------------------------------------------------------------
# misc (reference: expression/builtin_miscellaneous.go)
# ---------------------------------------------------------------------------

def _inet_aton(s):
    parts = s.split(".")
    if not 1 <= len(parts) <= 4:
        return None
    try:
        nums = [int(p) for p in parts]
    except ValueError:
        return None
    if any(p < 0 or p > 255 for p in nums):
        return None
    # MySQL: shorthand forms fill from the right
    v = 0
    for p in nums[:-1]:
        v = (v << 8) | p
    v = (v << (8 * (4 - len(nums) + 1))) | nums[-1] \
        if len(nums) < 4 else (v << 8) | nums[-1]
    return v


_reg("INET_ATON", 1, 1, "int", _inet_aton)
_reg("INET_NTOA", 1, 1, "str",
     lambda n: ".".join(str((int(n) >> s) & 255)
                        for s in (24, 16, 8, 0))
     if 0 <= int(n) <= 0xFFFFFFFF else None)
_reg("IS_IPV4", 1, 1, "int",
     lambda s: 1 if _re.fullmatch(
         r"(\d{1,3}\.){3}\d{1,3}", s) and all(
         int(p) <= 255 for p in s.split(".")) else 0)


# ---------------------------------------------------------------------------
# JSON modification/query family (reference: expression/builtin_json.go;
# docs arrive as canonical JSON text, results re-canonicalize on encode)
# ---------------------------------------------------------------------------

import json as _json


def _jload(doc):
    try:
        return _json.loads(doc)
    except (ValueError, TypeError):
        return _JSON_BAD


_JSON_BAD = object()


def _jdump(v) -> str:
    return _json.dumps(v, sort_keys=True, separators=(", ", ": "))


def _jpath(path):
    from .npeval import _json_path_steps
    return _json_path_steps(path)


def _jval(v):
    """Registry argument -> JSON value (MySQL: non-JSON string args are
    string values; ints/floats/bools pass through)."""
    import decimal
    if isinstance(v, decimal.Decimal):
        f = float(v)
        return int(v) if f.is_integer() else f
    return v


def _j_walk_set(v, steps, new, mode):
    """Immutable set/insert/replace at path; returns updated value."""
    if not steps:
        return new if mode in ("set", "replace") else v
    s = steps[0]
    if isinstance(s, int):
        if not isinstance(v, list):
            return v
        out = list(v)
        if s < len(v):
            out[s] = _j_walk_set(v[s], steps[1:], new, mode)
        elif len(steps) == 1 and mode in ("set", "insert"):
            out.append(new)
        return out
    if not isinstance(v, dict):
        return v
    out = dict(v)
    if s in v:
        out[s] = _j_walk_set(v[s], steps[1:], new, mode)
    elif len(steps) == 1 and mode in ("set", "insert"):
        out[s] = new
    return out


def _j_modify(mode):
    def fn(doc, *pairs):
        v = _jload(doc)
        if v is _JSON_BAD or len(pairs) % 2:
            return None
        for i in range(0, len(pairs), 2):
            steps = _jpath(pairs[i])
            if steps is None:
                return None
            v = _j_walk_set(v, steps, _jval(pairs[i + 1]), mode)
        return _jdump(v)
    return fn


def _j_remove(doc, *paths):
    v = _jload(doc)
    if v is _JSON_BAD:
        return None

    def rm(val, steps):
        if not steps:
            return val
        s = steps[0]
        if isinstance(s, int) and isinstance(val, list) and s < len(val):
            out = list(val)
            if len(steps) == 1:
                del out[s]
            else:
                out[s] = rm(val[s], steps[1:])
            return out
        if isinstance(s, str) and isinstance(val, dict) and s in val:
            out = dict(val)
            if len(steps) == 1:
                del out[s]
            else:
                out[s] = rm(val[s], steps[1:])
            return out
        return val

    for p in paths:
        steps = _jpath(p)
        if not steps:  # '$' itself is not removable
            return None
        v = rm(v, steps)
    return _jdump(v)


def _j_at(doc, path):
    """(parsed value at path, found) over a JSON text."""
    v = _jload(doc)
    if v is _JSON_BAD:
        return None, False
    steps = _jpath(path) if path is not None else []
    if steps is None:
        return None, False
    for s in steps:
        if isinstance(s, int):
            if not isinstance(v, list) or s >= len(v):
                return None, False
            v = v[s]
        else:
            if not isinstance(v, dict) or s not in v:
                return None, False
            v = v[s]
    return v, True


def _j_contains_val(hay, needle):
    """MySQL containment: arrays contain elements/subsets; objects
    contain key-subset docs; scalars contain equal scalars."""
    if isinstance(hay, list):
        if isinstance(needle, list):
            return all(any(_j_contains_val(h, n) for h in hay)
                       for n in needle)
        return any(_j_contains_val(h, needle) for h in hay)
    if isinstance(hay, dict):
        if not isinstance(needle, dict):
            return False
        return all(k in hay and _j_contains_val(hay[k], v)
                   for k, v in needle.items())
    # scalars: equal values of the same JSON type; booleans are a
    # distinct type from numbers (bool subclasses int in Python, so the
    # bool-ness must match explicitly on both sides)
    if isinstance(hay, bool) != isinstance(needle, bool):
        return False
    if isinstance(hay, bool):
        return hay == needle
    if isinstance(hay, (int, float)) and isinstance(needle, (int, float)):
        return hay == needle
    return type(hay) is type(needle) and hay == needle


def _j_contains(doc, cand, path=None):
    hay, ok = _j_at(doc, path)
    if not ok:
        return None
    needle = _jload(cand)
    if needle is _JSON_BAD:
        return None
    return 1 if _j_contains_val(hay, needle) else 0


def _j_contains_path(doc, one_or_all, *paths):
    mode = str(one_or_all).lower()
    if mode not in ("one", "all") or not paths:
        return None
    found = [_j_at(doc, p)[1] for p in paths]
    return 1 if (any(found) if mode == "one" else all(found)) else 0


def _j_keys(doc, path=None):
    v, ok = _j_at(doc, path)
    if not ok or not isinstance(v, dict):
        return None
    return _jdump(sorted(v.keys()))


def _j_depth(doc):
    v = _jload(doc)
    if v is _JSON_BAD:
        return None

    def d(x):
        if isinstance(x, dict):
            return 1 + max((d(v2) for v2 in x.values()), default=0)
        if isinstance(x, list):
            return 1 + max((d(v2) for v2 in x), default=0)
        return 1
    return d(v)


def _j_merge_patch(*docs):
    vals = [_jload(d) for d in docs]
    if any(v is _JSON_BAD for v in vals):
        return None

    def patch(a, b):
        if not isinstance(b, dict):
            return b
        out = dict(a) if isinstance(a, dict) else {}
        for k, v in b.items():
            if v is None:
                out.pop(k, None)
            else:
                out[k] = patch(out.get(k), v)
        return out

    acc = vals[0]
    for v in vals[1:]:
        acc = patch(acc, v)
    return _jdump(acc)


def _j_merge_preserve(*docs):
    vals = [_jload(d) for d in docs]
    if any(v is _JSON_BAD for v in vals):
        return None

    def merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = merge(out[k], v) if k in out else v
            return out
        la = a if isinstance(a, list) else [a]
        lb = b if isinstance(b, list) else [b]
        return la + lb

    acc = vals[0]
    for v in vals[1:]:
        acc = merge(acc, v)
    return _jdump(acc)


def _j_array_append(doc, *pairs):
    v = _jload(doc)
    if v is _JSON_BAD or len(pairs) % 2:
        return None
    for i in range(0, len(pairs), 2):
        steps = _jpath(pairs[i])
        if steps is None:
            return None
        cur, ok = _j_at(_jdump(v), pairs[i])
        if not ok:
            continue
        new = (cur + [_jval(pairs[i + 1])]) if isinstance(cur, list) \
            else [cur, _jval(pairs[i + 1])]
        v = _j_walk_set(v, steps, new, "set") if steps else new
    return _jdump(v)


def _j_search(doc, one_or_all, target):
    mode = str(one_or_all).lower()
    if mode not in ("one", "all"):
        return None
    v = _jload(doc)
    if v is _JSON_BAD:
        return None
    hits: list[str] = []

    def like(s):
        import re
        pat = "".join(".*" if c == "%" else "." if c == "_"
                      else re.escape(c) for c in str(target))
        return re.fullmatch(pat, s) is not None

    def walk(x, path):
        if isinstance(x, str) and like(x):
            hits.append(path)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}.{k}")
        elif isinstance(x, list):
            for i, e in enumerate(x):
                walk(e, f"{path}[{i}]")

    walk(v, "$")
    if not hits:
        return None
    if mode == "one":
        return _jdump(hits[0])
    return _jdump(hits[0] if len(hits) == 1 else hits)


_reg("JSON_QUOTE", 1, 1, "str", lambda s: _json.dumps(str(s)))
_reg("JSON_DEPTH", 1, 1, "int", _j_depth)
_reg("JSON_KEYS", 1, 2, "str", _j_keys)
_reg("JSON_CONTAINS", 2, 3, "int", _j_contains)
_reg("JSON_CONTAINS_PATH", 3, 8, "int", _j_contains_path)
_reg("JSON_SET", 3, 13, "str", _j_modify("set"))
_reg("JSON_INSERT", 3, 13, "str", _j_modify("insert"))
_reg("JSON_REPLACE", 3, 13, "str", _j_modify("replace"))
_reg("JSON_REMOVE", 2, 8, "str", _j_remove)
_reg("JSON_MERGE_PATCH", 2, 8, "str", _j_merge_patch)
_reg("JSON_MERGE_PRESERVE", 2, 8, "str", _j_merge_preserve)
_reg("JSON_MERGE", 2, 8, "str", _j_merge_preserve)
_reg("JSON_ARRAY_APPEND", 3, 13, "str", _j_array_append)
_reg("JSON_SEARCH", 3, 3, "str", _j_search)
_reg("JSON_PRETTY", 1, 1, "str",
     lambda d: None if _jload(d) is _JSON_BAD
     else _json.dumps(_jload(d), indent=2, sort_keys=True))
_reg("JSON_STORAGE_SIZE", 1, 1, "int",
     lambda d: None if _jload(d) is _JSON_BAD else len(d))
_reg("JSON_OVERLAPS", 2, 2, "int",
     lambda a, b: None if _jload(a) is _JSON_BAD
     or _jload(b) is _JSON_BAD
     else (1 if _j_overlaps(_jload(a), _jload(b)) else 0))


def _j_overlaps(a, b):
    if isinstance(a, list) and isinstance(b, list):
        return any(_j_contains_val([x], y) for x in a for y in b)
    if isinstance(a, list):
        return _j_contains_val(a, b)
    if isinstance(b, list):
        return _j_contains_val(b, a)
    if isinstance(a, dict) and isinstance(b, dict):
        # MySQL: objects overlap when ANY key/value pair is shared
        return any(k in b and _j_contains_val(b[k], v)
                   and _j_contains_val(v, b[k]) for k, v in a.items())
    return _j_contains_val(a, b)


# ---------------------------------------------------------------------------
# misc compat (reference: builtin_miscellaneous.go, builtin_info.go)
# ---------------------------------------------------------------------------

# ---- session time zone routing ---------------------------------------------
# The session installs @@time_zone here for the statement's duration
# (thread-local, like obs' stage recorder) so time-zone-sensitive
# builtins — FROM_UNIXTIME — format in the session zone like MySQL
# instead of hardcoded UTC.

import threading as _threading

_tz_tls = _threading.local()


def install_session_time_zone(tz):
    """Install the session @@time_zone for this thread; returns the
    previous value so callers can restore it."""
    prev = getattr(_tz_tls, "tz", None)
    _tz_tls.tz = tz
    return prev


def session_time_zone() -> str:
    return str(getattr(_tz_tls, "tz", None) or "SYSTEM")


def _session_struct_time(ts: float):
    """struct_time of a unix timestamp in the session time zone.
    SYSTEM behaves as UTC (the server's @@system_time_zone); '+HH:MM'
    offsets apply arithmetically; named zones resolve via zoneinfo and
    fall back to UTC when unknown (MySQL would have rejected the SET)."""
    name = session_time_zone()
    if name in ("SYSTEM", "UTC", "+00:00", "+0:00"):
        return _time.gmtime(ts)
    if name and name[0] in "+-":
        try:
            hh, mm = name[1:].split(":")
            off = int(hh) * 3600 + int(mm) * 60
        except ValueError:
            return _time.gmtime(ts)
        return _time.gmtime(ts + (-off if name[0] == "-" else off))
    try:
        from datetime import datetime
        from zoneinfo import ZoneInfo
        return datetime.fromtimestamp(ts, ZoneInfo(name)).timetuple()
    except Exception:  # noqa: BLE001 - unknown zone: UTC fallback
        return _time.gmtime(ts)


_FU_FMT = {"Y": "%Y", "y": "%y", "m": "%m", "d": "%d",
           "H": "%H", "i": "%M", "s": "%S",
           "S": "%S", "p": "%p", "W": "%A", "a": "%a", "b": "%b",
           "M": "%B", "j": "%j", "T": "%H:%M:%S", "%": "%%"}

# MySQL's non-padded codes have no PORTABLE strftime equivalent ("%-m"
# is a glibc extension that raises on other libcs): format the struct
# component directly instead
_FU_DIRECT = {"c": lambda t: str(t.tm_mon),   # month, no leading zero
              "e": lambda t: str(t.tm_mday),  # day, no leading zero
              "k": lambda t: str(t.tm_hour)}  # hour, no leading zero


def _from_unixtime(ts, fmt=None):
    if float(ts) < 0:
        return None
    t = _session_struct_time(float(ts))
    if fmt is None:
        return _time.strftime("%Y-%m-%d %H:%M:%S", t)
    out = []
    run = []  # literal/strftime-safe segment being accumulated

    def flush():
        if run:
            out.append(_time.strftime("".join(run), t))
            del run[:]

    i = 0
    fmt = str(fmt)
    try:
        while i < len(fmt):
            c = fmt[i]
            if c == "%" and i + 1 < len(fmt):
                nxt = fmt[i + 1]
                if nxt in _FU_DIRECT:
                    flush()
                    out.append(_FU_DIRECT[nxt](t))
                else:
                    run.append(_FU_FMT.get(nxt, nxt))
                i += 2
            else:
                run.append("%%" if c == "%" else c)
                i += 1
        flush()
    except ValueError:
        return None
    return "".join(out)


_reg("UUID", 0, 0, "str",
     lambda: __import__("uuid").uuid1().hex[:8] + "-" +
     __import__("uuid").uuid4().hex[:4] + "-" +
     __import__("uuid").uuid4().hex[:4] + "-" +
     __import__("uuid").uuid4().hex[:4] + "-" +
     __import__("uuid").uuid4().hex[:12], null_prop=False)
_reg("IS_UUID", 1, 1, "int",
     lambda s: 1 if _re.fullmatch(
         r"[0-9a-fA-F]{8}-?[0-9a-fA-F]{4}-?[0-9a-fA-F]{4}-?"
         r"[0-9a-fA-F]{4}-?[0-9a-fA-F]{12}", str(s)) else 0)
_reg("IS_IPV6", 1, 1, "int",
     lambda s: 1 if _is_ipv6(s) else 0)
_reg("INET6_ATON", 1, 1, "str", lambda s: _inet6_aton(s))
_reg("INET6_NTOA", 1, 1, "str", lambda s: _inet6_ntoa(s))
_reg("COMPRESS", 1, 1, "str",
     lambda s: "" if s == "" else
     (len(s.encode()).to_bytes(4, "little")
      + zlib.compress(s.encode())).hex())
_reg("UNCOMPRESS", 1, 1, "str", lambda h: _uncompress(h))
_reg("UNCOMPRESSED_LENGTH", 1, 1, "int",
     lambda h: 0 if h == "" else int.from_bytes(
         bytes.fromhex(h)[:4], "little"))
_reg("CHARSET", 1, 1, "str", lambda s: "utf8mb4", null_prop=False)
_reg("COLLATION", 1, 1, "str", lambda s: "utf8mb4_bin",
     null_prop=False)
_reg("COERCIBILITY", 1, 1, "int", lambda s: 2, null_prop=False)
_reg("FROM_UNIXTIME", 1, 2, "str", _from_unixtime)
_reg("NAME_CONST", 2, 2, "arg1", lambda n, v: v, null_prop=False)
_reg("FORMAT_BYTES", 1, 1, "str", lambda n: _format_bytes(float(n)))


def _is_ipv6(s) -> bool:
    import ipaddress
    try:
        ipaddress.IPv6Address(str(s))
        return True
    except ValueError:
        return False


def _inet6_aton(s):
    import ipaddress
    try:
        return ipaddress.ip_address(str(s)).packed.hex()
    except ValueError:
        return None


def _inet6_ntoa(h):
    import ipaddress
    try:
        b = bytes.fromhex(str(h))
        if len(b) == 4 or len(b) == 16:
            return str(ipaddress.ip_address(b))
    except ValueError:
        pass
    return None


def _uncompress(h):
    if h == "":
        return ""
    try:
        raw = bytes.fromhex(str(h))
        return zlib.decompress(raw[4:]).decode("utf-8", "replace")
    except (ValueError, zlib.error):
        return None


def _format_bytes(n: float) -> str:
    units = ["bytes", "KiB", "MiB", "GiB", "TiB", "PiB", "EiB"]
    i = 0
    while abs(n) >= 1024 and i < len(units) - 1:
        n /= 1024
        i += 1
    return f"{n:.0f} {units[0]}" if i == 0 else f"{n:.2f} {units[i]}"


# ---------------------------------------------------------------------------
# TIME-of-day functions over 'HH:MM:SS' strings (no TIME column type:
# the reference's TIME value domain maps to text here; reference:
# expression/builtin_time.go)
# ---------------------------------------------------------------------------

def _parse_tod(s):
    """'[-]H:MM:SS[.ffffff]' | 'YYYY-MM-DD HH:MM:SS' -> signed seconds
    (fractional kept), or None."""
    s = str(s).strip()
    if " " in s:  # datetime literal: take the time part
        s = s.split(" ", 1)[1]
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    parts = s.split(":")
    try:
        if len(parts) == 3:
            h, m, sec = int(parts[0]), int(parts[1]), float(parts[2])
        elif len(parts) == 2:
            h, m, sec = int(parts[0]), int(parts[1]), 0.0
        elif len(parts) == 1 and parts[0]:
            h, m, sec = 0, 0, float(parts[0])
        else:
            return None
    except ValueError:
        return None
    if m >= 60 or sec >= 60:
        return None
    tot = h * 3600 + m * 60 + sec
    return -tot if neg else tot


def _fmt_tod(total) -> str:
    neg = total < 0
    # integer microseconds FIRST so fraction rounding carries into
    # seconds instead of printing a 7-digit fraction
    us = round(abs(total) * 1_000_000)
    sec, us = divmod(us, 1_000_000)
    h, rem = divmod(sec, 3600)
    m, s = divmod(rem, 60)
    out = f"{'-' if neg else ''}{h:02d}:{m:02d}:{s:02d}"
    if us:
        out += f".{us:06d}"
    return out


def _sec_to_time(n):
    return _fmt_tod(float(n))


def _time_to_sec(s):
    t = _parse_tod(s)
    return None if t is None else int(t)


def _maketime(h, m, s):
    h, m = int(h), int(m)
    if m < 0 or m >= 60 or float(s) < 0 or float(s) >= 60:
        return None
    sign = -1 if h < 0 else 1
    return _fmt_tod(sign * (abs(h) * 3600 + m * 60 + float(s)))


def _addtime(a, b, sign=1):
    ta = str(a).strip()
    tb = _parse_tod(b)
    if tb is None:
        return None
    if " " in ta or "-" in ta[1:]:  # datetime form: add to full stamp
        from datetime import datetime, timedelta
        for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S"):
            try:
                dt = datetime.strptime(ta, fmt)
                break
            except ValueError:
                dt = None
        if dt is None:
            return None
        out = dt + timedelta(seconds=sign * tb)
        s = out.strftime("%Y-%m-%d %H:%M:%S.%f")
        return s[:-7] if s.endswith("000000") else s
    t = _parse_tod(ta)
    if t is None:
        return None
    return _fmt_tod(t + sign * tb)


def _timediff(a, b):
    sa = str(a).strip()
    sb = str(b).strip()
    both_dt = (" " in sa) == (" " in sb)
    if not both_dt:
        return None  # MySQL: mixed TIME/DATETIME -> NULL
    if " " in sa:
        from datetime import datetime
        try:
            da = datetime.fromisoformat(sa)
            db = datetime.fromisoformat(sb)
        except ValueError:
            return None
        return _fmt_tod((da - db).total_seconds())
    ta, tb = _parse_tod(sa), _parse_tod(sb)
    if ta is None or tb is None:
        return None
    return _fmt_tod(ta - tb)


_TF_MAP = {"H": lambda t: f"{int(t // 3600):02d}",
           "k": lambda t: str(int(t // 3600)),
           "h": lambda t: f"{int(t // 3600) % 12 or 12:02d}",
           "i": lambda t: f"{int((t % 3600) // 60):02d}",
           "s": lambda t: f"{int(t % 60):02d}",
           "S": lambda t: f"{int(t % 60):02d}",
           "f": lambda t: f"{round((t - int(t)) * 1e6):06d}",
           "p": lambda t: "AM" if (t // 3600) % 24 < 12 else "PM",
           "%": lambda t: "%"}


def _time_format(s, fmt):
    t = _parse_tod(s)
    if t is None:
        return None
    out = []
    i = 0
    fmt = str(fmt)
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            f = _TF_MAP.get(fmt[i + 1])
            out.append(f(abs(t)) if f else fmt[i + 1])
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _convert_tz(dtv, from_tz, to_tz):
    from datetime import datetime
    try:
        from zoneinfo import ZoneInfo
    except ImportError:
        return None

    def tz(name):
        name = str(name)
        if name in ("SYSTEM", "UTC", "+00:00", "+0:00"):
            from datetime import timezone
            return timezone.utc
        if name and name[0] in "+-":
            from datetime import timedelta, timezone
            sign = -1 if name[0] == "-" else 1
            hh, mm = name[1:].split(":")
            return timezone(sign * timedelta(hours=int(hh),
                                             minutes=int(mm)))
        try:
            return ZoneInfo(name)
        except Exception:  # noqa: BLE001 - unknown tz -> NULL
            return None

    fz, tzo = tz(from_tz), tz(to_tz)
    if fz is None or tzo is None:
        return None
    try:
        dt = datetime.fromisoformat(str(dtv))
    except ValueError:
        return None
    out = dt.replace(tzinfo=fz).astimezone(tzo)
    return out.strftime("%Y-%m-%d %H:%M:%S")


_reg("SEC_TO_TIME", 1, 1, "str", _sec_to_time)
_reg("TIME_TO_SEC", 1, 1, "int", _time_to_sec)
_reg("MAKETIME", 3, 3, "str", _maketime)
def _time_fn(s):
    t = _parse_tod(s)
    return None if t is None else _fmt_tod(t)


_reg("TIME", 1, 1, "str", _time_fn)
_reg("ADDTIME", 2, 2, "str", _addtime)
_reg("SUBTIME", 2, 2, "str", lambda a, b: _addtime(a, b, -1))
_reg("TIMEDIFF", 2, 2, "str", _timediff)
_reg("TIME_FORMAT", 2, 2, "str", _time_format)
_reg("CONVERT_TZ", 3, 3, "str", _convert_tz)


# ---------------------------------------------------------------------------
# misc / crypto compat (reference: builtin_miscellaneous.go,
# builtin_encryption.go; AES via the cryptography package like the
# reference's openssl-compatible aes-128-ecb default)
# ---------------------------------------------------------------------------

def _aes_key(key: str) -> bytes:
    """MySQL key folding: XOR the UTF-8 key bytes into 16 bytes."""
    out = bytearray(16)
    for i, b in enumerate(str(key).encode("utf-8")):
        out[i % 16] ^= b
    return bytes(out)


def _aes_encrypt(s, key):
    try:
        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes)
        from cryptography.hazmat.primitives import padding
    except ImportError:
        return None
    data = str(s).encode("utf-8")
    p = padding.PKCS7(128).padder()
    data = p.update(data) + p.finalize()
    enc = Cipher(algorithms.AES(_aes_key(key)), modes.ECB()).encryptor()
    return (enc.update(data) + enc.finalize()).hex()


def _aes_decrypt(h, key):
    try:
        from cryptography.hazmat.primitives.ciphers import (
            Cipher, algorithms, modes)
        from cryptography.hazmat.primitives import padding
    except ImportError:
        return None
    try:
        raw = bytes.fromhex(str(h))
        dec = Cipher(algorithms.AES(_aes_key(key)),
                     modes.ECB()).decryptor()
        data = dec.update(raw) + dec.finalize()
        u = padding.PKCS7(128).unpadder()
        return (u.update(data) + u.finalize()).decode("utf-8", "replace")
    except Exception:  # noqa: BLE001 - bad input -> NULL (MySQL)
        return None


_reg("BIT_COUNT", 1, 1, "int", lambda n: bin(int(n) & (2**64 - 1)).count("1"))
_reg("IS_IPV4_COMPAT", 1, 1, "int",
     lambda h: 1 if len(str(h)) == 32 and str(h)[:24] == "0" * 24 else 0)
_reg("IS_IPV4_MAPPED", 1, 1, "int",
     lambda h: 1 if len(str(h)) == 32
     and str(h)[:24] == "0" * 20 + "ffff" else 0)
_reg("RANDOM_BYTES", 1, 1, "str",
     lambda n: __import__("secrets").token_bytes(int(n)).hex()
     if 1 <= int(n) <= 1024 else None, null_prop=False)
_reg("UUID_SHORT", 0, 0, "int",
     lambda: __import__("secrets").randbits(63), null_prop=False)
# RAND() (no seed): independent value per row. RAND(seed) is resolved
# by the planner into a vectorized per-statement sequence
# (plan/builder.py rand_seeded) — a per-row Random(seed) here would
# return the same value on every row.
_reg("RAND", 0, 0, "float",
     lambda: __import__("random").random(), null_prop=False)
_reg("BENCHMARK", 2, 2, "int", lambda n, e: 0)
_reg("PASSWORD", 1, 1, "str",
     lambda s: "*" + hashlib.sha1(hashlib.sha1(
         str(s).encode()).digest()).hexdigest().upper())
_reg("VALIDATE_PASSWORD_STRENGTH", 1, 1, "int",
     lambda s: 0 if len(str(s)) < 4 else
     25 if len(str(s)) < 8 else
     50 + 25 * (any(c.isdigit() for c in str(s))
                and any(c.isalpha() for c in str(s)))
     + 25 * any(not c.isalnum() for c in str(s)))
_reg("WEIGHT_STRING", 1, 1, "str",
     lambda s: str(s).encode("utf-8").hex().upper())
_reg("AES_ENCRYPT", 2, 2, "str", _aes_encrypt)
_reg("AES_DECRYPT", 2, 2, "str", _aes_decrypt)
_reg("TIDB_VERSION", 0, 0, "str",
     lambda: "5.7.25-TiDB-TPU\nEdition: Community\n"
     "Engine: JAX/XLA columnar coprocessor", null_prop=False)
_reg("TIDB_PARSE_TSO", 1, 1, "str",
     lambda ts: __import__("time").strftime(
         "%Y-%m-%d %H:%M:%S",
         __import__("time").gmtime((int(ts) >> 18) / 1000))
     if int(ts) > 0 else None)
