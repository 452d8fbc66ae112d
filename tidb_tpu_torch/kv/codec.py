"""Memcomparable byte encodings for all SQL types.

Counterpart of the reference's util/codec (reference: util/codec/codec.go,
number.go, bytes.go, decimal.go): every encoding preserves SQL ordering
under plain bytewise comparison, so the KV engine (Python or C++) can stay
type-blind. Formats match the reference's scheme conceptually:

* ints: flag byte + big-endian uint64 biased by 2^63
* bytes: 8-byte groups, each followed by a pad-count marker (0xF7+n used,
  0xFF = full group continues) — preserves prefix ordering with escapes
* floats: IEEE bits with sign-flip trick
* decimals: encoded via scaled int64 (precision <= 18 in this build)
* dates/datetimes: their int encodings ride the int format
* NULL sorts before everything

Port of `tidb_tpu/kv/codec.py`, whole.
"""

from __future__ import annotations

import struct
from typing import Any

NIL_FLAG = 0x00
BYTES_FLAG = 0x01
INT_FLAG = 0x03
FLOAT_FLAG = 0x05
MAX_FLAG = 0xFA

_SIGN_MASK = 0x8000000000000000


# ---- ints -------------------------------------------------------------------

def encode_int(buf: bytearray, v: int) -> None:
    buf.append(INT_FLAG)
    buf += struct.pack(">Q", (v + _SIGN_MASK) & 0xFFFFFFFFFFFFFFFF)


def decode_int(buf: bytes, pos: int) -> tuple[int, int]:
    if buf[pos] != INT_FLAG:
        raise ValueError(f"int flag expected at {pos}, got {buf[pos]:#x}")
    (u,) = struct.unpack_from(">Q", buf, pos + 1)
    return u - _SIGN_MASK, pos + 9


def encode_uint_desc(v: int) -> bytes:
    """Descending-order uint64 (used for reverse-ts MVCC keys)."""
    return struct.pack(">Q", 0xFFFFFFFFFFFFFFFF - v)


def decode_uint_desc(b: bytes) -> int:
    return 0xFFFFFFFFFFFFFFFF - struct.unpack(">Q", b)[0]


# ---- floats -----------------------------------------------------------------

def encode_float(buf: bytearray, v: float) -> None:
    buf.append(FLOAT_FLAG)
    u = struct.unpack(">Q", struct.pack(">d", v))[0]
    if u & _SIGN_MASK:
        u = ~u & 0xFFFFFFFFFFFFFFFF  # negative: flip all
    else:
        u |= _SIGN_MASK  # positive: flip sign bit
    buf += struct.pack(">Q", u)


def decode_float(buf: bytes, pos: int) -> tuple[float, int]:
    if buf[pos] != FLOAT_FLAG:
        raise ValueError(f"float flag expected at {pos}")
    (u,) = struct.unpack_from(">Q", buf, pos + 1)
    if u & _SIGN_MASK:
        u &= ~_SIGN_MASK & 0xFFFFFFFFFFFFFFFF
    else:
        u = ~u & 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", u))[0], pos + 9


# ---- bytes (8-byte-group escape encoding) ----------------------------------

_GROUP = 8
_PAD = 0x00
_MARKER_FULL = 0xFF


def encode_bytes(buf: bytearray, b: bytes) -> None:
    buf.append(BYTES_FLAG)
    for i in range(0, len(b) + 1, _GROUP):
        group = b[i:i + _GROUP]
        pad = _GROUP - len(group)
        buf += group + bytes([_PAD]) * pad
        buf.append(_MARKER_FULL - pad)


def decode_bytes(buf: bytes, pos: int) -> tuple[bytes, int]:
    if buf[pos] != BYTES_FLAG:
        raise ValueError(f"bytes flag expected at {pos}")
    pos += 1
    out = bytearray()
    while True:
        group = buf[pos:pos + _GROUP]
        marker = buf[pos + _GROUP]
        pos += _GROUP + 1
        pad = _MARKER_FULL - marker
        if pad == 0:
            out += group
        else:
            out += group[:_GROUP - pad]
            break
    return bytes(out), pos


# ---- null + dispatch --------------------------------------------------------

def encode_null(buf: bytearray) -> None:
    buf.append(NIL_FLAG)


def encode_value(buf: bytearray, v: Any) -> None:
    """Encode a physical value (int-encoded temporals/decimals, str, float,
    bytes, None) memcomparably."""
    if v is None:
        encode_null(buf)
    elif isinstance(v, bool):
        encode_int(buf, int(v))
    elif isinstance(v, int):
        encode_int(buf, v)
    elif isinstance(v, float):
        encode_float(buf, v)
    elif isinstance(v, str):
        encode_bytes(buf, v.encode("utf-8"))
    elif isinstance(v, bytes):
        encode_bytes(buf, v)
    else:
        raise TypeError(f"cannot encode {type(v).__name__}")


def encode_key(values: list[Any]) -> bytes:
    buf = bytearray()
    for v in values:
        encode_value(buf, v)
    return bytes(buf)


def decode_one(buf: bytes, pos: int) -> tuple[Any, int]:
    flag = buf[pos]
    if flag == NIL_FLAG:
        return None, pos + 1
    if flag == INT_FLAG:
        return decode_int(buf, pos)
    if flag == FLOAT_FLAG:
        return decode_float(buf, pos)
    if flag == BYTES_FLAG:
        v, pos = decode_bytes(buf, pos)
        return v, pos
    raise ValueError(f"unknown flag {flag:#x} at {pos}")


def decode_key(buf: bytes) -> list[Any]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = decode_one(buf, pos)
        out.append(v)
    return out
