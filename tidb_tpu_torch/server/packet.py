"""MySQL client/server protocol: packet framing + payload encoding.

Port of `tidb_tpu/server/packet.py`, whole. Counterpart of the
reference's packetIO + resultset writer (reference:
server/packetio.go — readPacket/writePacket with 3-byte length + sequence
framing; server/conn.go:1718 writeResultset, server/column.go column
definition encoding). Text protocol only for now; the binary (prepared
statement) protocol rides the same framing.
"""

from __future__ import annotations

import datetime as _dt
import struct
from typing import Any, Iterable, Optional

from ..types.field_type import FieldType, TypeKind
from ..types.value import Decimal

MAX_PACKET = 2**24 - 1

# ---- capability flags (subset; reference: mysql const pkg) ------------------
CLIENT_LONG_PASSWORD = 1 << 0
CLIENT_FOUND_ROWS = 1 << 1
CLIENT_LONG_FLAG = 1 << 2
CLIENT_CONNECT_WITH_DB = 1 << 3
CLIENT_PROTOCOL_41 = 1 << 9
CLIENT_SSL = 1 << 11
CLIENT_TRANSACTIONS = 1 << 13
CLIENT_SECURE_CONNECTION = 1 << 15
CLIENT_MULTI_STATEMENTS = 1 << 16
CLIENT_MULTI_RESULTS = 1 << 17
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_DEPRECATE_EOF = 1 << 24

SERVER_STATUS_AUTOCOMMIT = 0x0002
SERVER_STATUS_IN_TRANS = 0x0001

# ---- command bytes ----------------------------------------------------------
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A

# ---- MySQL protocol column types -------------------------------------------
T_TINY = 1
T_SHORT = 2
T_LONG = 3
T_FLOAT = 4
T_DOUBLE = 5
T_LONGLONG = 8
T_DATE = 10
T_DATETIME = 12
T_YEAR = 13
T_VAR_STRING = 253
T_NEWDECIMAL = 246

_CHARSET_UTF8MB4 = 255
_CHARSET_BINARY = 63


def mysql_type(ft: FieldType) -> tuple[int, int, int]:
    """(protocol type, display length, decimals) for a field type."""
    k = ft.kind
    if k == TypeKind.TINYINT or k == TypeKind.BOOLEAN:
        return T_TINY, 4, 0
    if k == TypeKind.SMALLINT:
        return T_SHORT, 6, 0
    if k == TypeKind.INT:
        return T_LONG, 11, 0
    if k == TypeKind.BIGINT:
        return T_LONGLONG, 20, 0
    if k == TypeKind.FLOAT:
        return T_FLOAT, 12, 31
    if k == TypeKind.DOUBLE:
        return T_DOUBLE, 22, 31
    if k == TypeKind.DECIMAL:
        return T_NEWDECIMAL, ft.flen + 2, ft.scale
    if k == TypeKind.DATE:
        return T_DATE, 10, 0
    if k in (TypeKind.DATETIME, TypeKind.TIMESTAMP):
        return T_DATETIME, 19, 0
    if k == TypeKind.YEAR:
        return T_YEAR, 4, 0
    return T_VAR_STRING, max(ft.flen, 0) * 4 or 1024, 0


# ---- length-encoded primitives ---------------------------------------------

def lenenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 2**16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 2**24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenenc_str(b: bytes) -> bytes:
    return lenenc_int(len(b)) + b


def read_lenenc_int(buf: bytes, pos: int) -> tuple[int, int]:
    first = buf[pos]
    if first < 251:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    if first == 0xFE:
        return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9
    raise ValueError(f"bad lenenc int prefix {first:#x}")


# ---- packet framing ---------------------------------------------------------

class PacketIO:
    """3-byte-length + 1-byte-sequence framed reader/writer over a socket
    file object (reference: server/packetio.go)."""

    def __init__(self, rfile, wfile) -> None:
        self.rfile = rfile
        self.wfile = wfile
        self.sequence = 0

    def read_packet(self) -> bytes:
        payload = b""
        while True:
            header = self.rfile.read(4)
            if len(header) < 4:
                raise ConnectionError("connection closed")
            length = int.from_bytes(header[:3], "little")
            seq = header[3]
            if seq != self.sequence:
                raise ConnectionError(
                    f"packet sequence mismatch: got {seq}, "
                    f"want {self.sequence}")
            self.sequence = (self.sequence + 1) % 256
            part = self.rfile.read(length)
            if len(part) < length:
                raise ConnectionError("connection closed mid-packet")
            payload += part
            if length < MAX_PACKET:
                return payload

    def write_packet(self, payload: bytes) -> None:
        pos = 0
        while True:
            chunk = payload[pos:pos + MAX_PACKET]
            header = len(chunk).to_bytes(3, "little") + bytes(
                [self.sequence])
            self.wfile.write(header + chunk)
            self.sequence = (self.sequence + 1) % 256
            pos += len(chunk)
            if len(chunk) < MAX_PACKET:
                break

    def flush(self) -> None:
        self.wfile.flush()

    def reset_sequence(self) -> None:
        self.sequence = 0


# ---- server->client payloads ------------------------------------------------

def ok_packet(affected: int = 0, last_insert_id: int = 0,
              status: int = SERVER_STATUS_AUTOCOMMIT,
              warnings: int = 0) -> bytes:
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id)
            + struct.pack("<HH", status, warnings))


def eof_packet(status: int = SERVER_STATUS_AUTOCOMMIT,
               warnings: int = 0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def err_packet(code: int, message: str, state: str = "HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" + state.encode()
            + message.encode("utf-8"))


def column_def(name: str, ft: Optional[FieldType],
               table: str = "", db: str = "") -> bytes:
    """Protocol::ColumnDefinition41 (reference: server/column.go Dump)."""
    if ft is None:
        tp, length, dec = T_VAR_STRING, 1024, 0
        charset = _CHARSET_UTF8MB4
    else:
        tp, length, dec = mysql_type(ft)
        charset = _CHARSET_UTF8MB4 if ft.is_string else _CHARSET_BINARY
    flags = 0
    nb = name.encode("utf-8")
    return (lenenc_str(b"def") + lenenc_str(db.encode())
            + lenenc_str(table.encode()) + lenenc_str(table.encode())
            + lenenc_str(nb) + lenenc_str(nb)
            + b"\x0c" + struct.pack("<HIBHB", charset, length, tp, flags, dec)
            + b"\x00\x00")


def render_text_value(v: Any) -> Optional[bytes]:
    """One value in the text resultset encoding; None => NULL byte."""
    if v is None:
        return None
    if isinstance(v, bool):
        return b"1" if v else b"0"
    if isinstance(v, Decimal):
        return str(v).encode()
    if isinstance(v, float):
        return repr(v).encode()
    if isinstance(v, _dt.datetime):
        return v.strftime("%Y-%m-%d %H:%M:%S").encode()
    if isinstance(v, _dt.date):
        return v.isoformat().encode()
    if isinstance(v, bytes):
        return v
    return str(v).encode("utf-8")


def text_row(values: Iterable[Any]) -> bytes:
    out = b""
    for v in values:
        r = render_text_value(v)
        out += b"\xfb" if r is None else lenenc_str(r)
    return out


# ---- prepared statements (binary protocol) ----------------------------------
# reference: server/conn_stmt.go (COM_STMT_PREPARE/EXECUTE), binary row
# encoding server/util.go dumpBinaryRow

def stmt_prepare_ok(stmt_id: int, n_cols: int, n_params: int) -> bytes:
    return (b"\x00" + struct.pack("<IHH", stmt_id, n_cols, n_params)
            + b"\x00" + struct.pack("<H", 0))


def decode_binary_params(payload: bytes, pos: int, n_params: int,
                         prev_types: Optional[list] = None):
    """Parse the COM_STMT_EXECUTE parameter block -> (python values, types).

    Layout: null-bitmap ((n+7)//8), new-params-bound flag, [types 2B each],
    values. Types persist across executions when the flag is 0."""
    from ..types.value import Decimal as _Dec

    nb = (n_params + 7) // 8
    null_bitmap = payload[pos:pos + nb]
    pos += nb
    new_bound = payload[pos]
    pos += 1
    if new_bound:
        types = []
        for _ in range(n_params):
            types.append((payload[pos], payload[pos + 1]))
            pos += 2
    else:
        if prev_types is None:
            raise ValueError("parameter types were never bound")
        types = prev_types
    values = []
    for i, (tp, flags) in enumerate(types):
        unsigned = bool(flags & 0x80)
        if null_bitmap[i // 8] & (1 << (i % 8)):
            values.append(None)
            continue
        if tp == T_TINY:
            values.append(struct.unpack_from(
                "<B" if unsigned else "<b", payload, pos)[0])
            pos += 1
        elif tp == T_SHORT or tp == T_YEAR:
            values.append(struct.unpack_from(
                "<H" if unsigned else "<h", payload, pos)[0])
            pos += 2
        elif tp in (T_LONG, 9):  # LONG / INT24
            values.append(struct.unpack_from(
                "<I" if unsigned else "<i", payload, pos)[0])
            pos += 4
        elif tp == T_LONGLONG:
            values.append(struct.unpack_from(
                "<Q" if unsigned else "<q", payload, pos)[0])
            pos += 8
        elif tp == T_FLOAT:
            values.append(struct.unpack_from("<f", payload, pos)[0])
            pos += 4
        elif tp == T_DOUBLE:
            values.append(struct.unpack_from("<d", payload, pos)[0])
            pos += 8
        elif tp in (T_DATE, T_DATETIME, 7):  # date / datetime / timestamp
            ln = payload[pos]
            pos += 1
            if ln == 0:
                values.append("0000-00-00")
            else:
                y, = struct.unpack_from("<H", payload, pos)
                mo, d = payload[pos + 2], payload[pos + 3]
                if ln >= 7:
                    h, mi, sec = payload[pos + 4], payload[pos + 5], \
                        payload[pos + 6]
                    values.append(
                        f"{y:04d}-{mo:02d}-{d:02d} "
                        f"{h:02d}:{mi:02d}:{sec:02d}")
                else:
                    values.append(f"{y:04d}-{mo:02d}-{d:02d}")
                pos += ln
        else:  # strings, blobs, NEWDECIMAL: length-encoded bytes
            v, pos = read_lenenc_str(payload, pos)
            if tp == T_NEWDECIMAL:
                values.append(_Dec.parse(v.decode()))
            else:
                values.append(v.decode("utf-8", "replace"))
    return values, types


def read_lenenc_str(buf: bytes, pos: int) -> tuple[bytes, int]:
    first = buf[pos]
    if first < 0xFB:
        ln, pos = first, pos + 1
    elif first == 0xFC:
        ln, pos = struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    elif first == 0xFD:
        ln = int.from_bytes(buf[pos + 1:pos + 4], "little")
        pos += 4
    else:
        ln, pos = struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9
    return buf[pos:pos + ln], pos + ln


def binary_row(values, ftypes) -> bytes:
    """Binary protocol resultset row (reference: server/util.go
    dumpBinaryRow): 0x00 header, null bitmap (offset 2), then values
    encoded per the advertised column type."""
    n = len(values)
    null_bitmap = bytearray((n + 9) // 8)
    out = bytearray()
    for i, (v, ft) in enumerate(zip(values, ftypes)):
        if v is None:
            null_bitmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
            continue
        tp = mysql_type(ft)[0] if ft is not None else T_VAR_STRING
        if tp == T_TINY:
            out += struct.pack("<b", int(v))
        elif tp in (T_SHORT, T_YEAR):
            out += struct.pack("<h", int(v))
        elif tp in (T_LONG, 9):
            out += struct.pack("<i", int(v))
        elif tp == T_LONGLONG:
            out += struct.pack("<q", int(v))
        elif tp == T_FLOAT:
            out += struct.pack("<f", float(v))
        elif tp == T_DOUBLE:
            out += struct.pack("<d", float(v))
        elif tp in (T_DATE, T_DATETIME, 7):
            out += _binary_time(v, tp)
        else:
            r = render_text_value(v)
            out += lenenc_str(r if r is not None else b"")
    return b"\x00" + bytes(null_bitmap) + bytes(out)


def _binary_time(v, tp: int) -> bytes:
    if isinstance(v, _dt.datetime):
        return bytes([7]) + struct.pack(
            "<HBBBBB", v.year, v.month, v.day, v.hour, v.minute, v.second)
    if isinstance(v, _dt.date):
        return bytes([4]) + struct.pack("<HBB", v.year, v.month, v.day)
    # string-rendered temporal
    txt = str(v)
    date, _, clock = txt.partition(" ")
    y, mo, d = (int(x) for x in date.split("-"))
    if clock:
        h, mi, sec = (int(float(x)) for x in clock.split(":"))
        return bytes([7]) + struct.pack("<HBBBBB", y, mo, d, h, mi, sec)
    return bytes([4]) + struct.pack("<HBB", y, mo, d)
