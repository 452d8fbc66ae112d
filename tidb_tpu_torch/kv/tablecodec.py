"""Table/index KV key layout.

Counterpart of the reference's tablecodec (reference:
tablecodec/tablecodec.go:46-48 — `t{tableID}_r{handle}` row keys,
`t{tableID}_i{indexID}{encodedVals}` index keys, :89 EncodeRowKeyWithHandle).
Table IDs and handles use the memcomparable int format so ranges scan in
order; the 't' prefix keeps table data clustered and separable from the
meta prefix 'm'.

Port of `tidb_tpu/kv/tablecodec.py`, whole.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

from .codec import encode_key

TABLE_PREFIX = b"t"
ROW_SEP = b"_r"
INDEX_SEP = b"_i"
META_PREFIX = b"m"


def _eint(v: int) -> bytes:
    return struct.pack(">Q", (v + 0x8000000000000000) & 0xFFFFFFFFFFFFFFFF)


def _dint(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - 0x8000000000000000


def table_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + _eint(table_id)


def record_prefix(table_id: int) -> bytes:
    return table_prefix(table_id) + ROW_SEP


def record_key(table_id: int, handle: int) -> bytes:
    return record_prefix(table_id) + _eint(handle)


def decode_record_key(key: bytes) -> tuple[int, int]:
    if not key.startswith(TABLE_PREFIX) or key[9:11] != ROW_SEP:
        raise ValueError(f"not a record key: {key!r}")
    return _dint(key[1:9]), _dint(key[11:19])


def index_prefix(table_id: int, index_id: int) -> bytes:
    return table_prefix(table_id) + INDEX_SEP + _eint(index_id)


def index_key(table_id: int, index_id: int, values: list[Any],
              handle: Optional[int] = None) -> bytes:
    """Non-unique indexes append the handle (making keys unique); unique
    indexes omit it and store the handle as the value (reference:
    tablecodec EncodeIndexSeekKey + tables/index.go Create)."""
    k = index_prefix(table_id, index_id) + encode_key(values)
    if handle is not None:
        k += _eint(handle)
    return k


def table_range(table_id: int) -> tuple[bytes, bytes]:
    """[start, end) covering every key of one table."""
    p = table_prefix(table_id)
    return p, p + b"\xff"


def record_range(table_id: int) -> tuple[bytes, bytes]:
    p = record_prefix(table_id)
    return p, p + b"\xff"


def meta_key(name: bytes) -> bytes:
    return META_PREFIX + name
