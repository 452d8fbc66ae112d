"""Length-prefixed frames + tagged binary payload encoding.

Port of `tidb_tpu/rpc/frame.py`, byte for byte on the wire: every
message is one frame — a little-endian u32 byte length followed by that
many payload bytes. The payload is a self-describing tagged encoding
rather than pickle: the server must never execute a peer's bytes, and
WAL records are raw byte strings that JSON would force through base64.

Supported values: None, bool, int (arbitrary precision — timestamps are
physical_ms<<18), float, bytes, str, list, dict (any supported value as
key). The network fault plane (`rpc/netfault.py`) hooks `send_frame` and
`recv_frame`. Every range-addressed request carries the range routing
context (`RANGE_KEY`, `make_range_ctx`, `get_range_ctx`).
"""

from __future__ import annotations

import socket
import struct
from typing import Any

# one frame must hold a WAL tail chunk; cap well above TAIL_CHUNK but
# low enough that a corrupt length prefix cannot balloon memory
MAX_FRAME = 64 << 20


class FrameError(Exception):
    """Malformed frame or payload (protocol violation, torn stream)."""


# ---- value encoding --------------------------------------------------------
def _enc(v: Any, out: list) -> None:
    if v is None:
        out.append(b"N")
    elif v is True:
        out.append(b"T")
    elif v is False:
        out.append(b"F")
    elif isinstance(v, int):
        b = v.to_bytes((v.bit_length() + 8) // 8 or 1, "little",
                       signed=True)
        out.append(b"I" + bytes([len(b)]) + b)
    elif isinstance(v, float):
        out.append(b"f" + struct.pack("<d", v))
    elif isinstance(v, (bytes, bytearray, memoryview)):
        v = bytes(v)
        out.append(b"B" + struct.pack("<I", len(v)) + v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(b"S" + struct.pack("<I", len(b)) + b)
    elif isinstance(v, (list, tuple)):
        out.append(b"L" + struct.pack("<I", len(v)))
        for item in v:
            _enc(item, out)
    elif isinstance(v, dict):
        out.append(b"D" + struct.pack("<I", len(v)))
        for k, val in v.items():
            _enc(k, out)
            _enc(val, out)
    else:
        raise FrameError(f"unencodable value type {type(v).__name__}")


def _dec(buf: bytes, off: int) -> tuple[Any, int]:
    tag = buf[off:off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"I":
        n = buf[off]
        off += 1
        return int.from_bytes(buf[off:off + n], "little", signed=True), \
            off + n
    if tag == b"f":
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if tag == b"B":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        return buf[off:off + n], off + n
    if tag == b"S":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        return buf[off:off + n].decode("utf-8"), off + n
    if tag == b"L":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        items = []
        for _ in range(n):
            item, off = _dec(buf, off)
            items.append(item)
        return items, off
    if tag == b"D":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            k, off = _dec(buf, off)
            v, off = _dec(buf, off)
            d[k] = v
        return d, off
    raise FrameError(f"bad tag {tag!r} at offset {off - 1}")


def encode(v: Any) -> bytes:
    out: list = []
    _enc(v, out)
    return b"".join(out)


def decode(buf: bytes) -> Any:
    try:
        v, off = _dec(buf, 0)
    except (IndexError, struct.error) as e:
        raise FrameError(f"truncated payload: {e}") from None
    if off != len(buf):
        raise FrameError(f"{len(buf) - off} trailing bytes in payload")
    return v


# ---- framing ---------------------------------------------------------------
# The network fault plane (rpc/netfault.py) hooks exactly here: every
# framed byte in the system crosses these two functions, so per-peer
# delay/drop/dup/partition schedules need no other seam. Unarmed cost
# is one module-attribute read per operation (netfault.ACTIVE).
from . import netfault  # noqa: E402 — after the codec it instruments


def send_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) > MAX_FRAME:
        raise FrameError(f"frame too large: {len(payload)}")
    data = struct.pack("<I", len(payload)) + payload
    if netfault.ACTIVE:
        copies = netfault.on_send(sock, len(data))
        for _ in range(copies):  # 0 = net/drop, 2 = net/dup
            sock.sendall(data)
        return
    sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    """One payload; raises ConnectionError on clean EOF between frames
    too — callers treat any tear identically (reconnect + retry)."""
    while True:
        hdr = _recv_exact(sock, 4)
        n = struct.unpack("<I", hdr)[0]
        if n > MAX_FRAME:
            raise FrameError(f"frame length {n} exceeds cap")
        payload = _recv_exact(sock, n)
        if netfault.ACTIVE and netfault.on_recv(sock, n):
            continue  # net/drop on the inbound path: frame vanishes
        return payload


# ---- trace context ---------------------------------------------------------
# Dapper-style propagation: a request issued under an active TRACE
# carries this key so the remote side can run its handler under a
# SpanCollector and return its span rows for stitching.
TRACE_KEY = "tc"


def make_trace_ctx(trace_id: str, parent_span_id: int) -> dict:
    return {"trace_id": str(trace_id),
            "parent_span_id": int(parent_span_id)}


def get_trace_ctx(req) -> Any:
    """The request's trace context, or None when absent/malformed."""
    if not isinstance(req, dict):
        return None
    tc = req.get(TRACE_KEY)
    if isinstance(tc, dict) and tc.get("trace_id"):
        return tc
    return None


# ---- addresses -------------------------------------------------------------
def parse_addr(addr) -> tuple[int, Any]:
    """'host:port' / ('host', port) -> AF_INET; 'unix:/path' or a bare
    path containing '/' -> AF_UNIX."""
    if isinstance(addr, (tuple, list)):
        return socket.AF_INET, (addr[0], int(addr[1]))
    addr = str(addr)
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[5:]
    if ":" not in addr and "/" in addr:
        return socket.AF_UNIX, addr
    host, _, port = addr.rpartition(":")
    return socket.AF_INET, (host or "127.0.0.1", int(port))


# ---- range routing context --------------------------------------------------
# Every range-addressed request carries this key: the client's cached
# view of (range id, routing-table epoch, leadership term). The server
# gates on it BEFORE touching data — a mismatch answers typed
# (EpochNotMatchError / NotLeaderError / StaleTermError) so stale
# routing can never produce a silently wrong result (reference: the
# kvrpcpb.Context every TiKV request carries — region_id, region_epoch,
# peer — checked by raftstore before proposing).
RANGE_KEY = "rc"


def make_range_ctx(range_id: int, epoch: int, term: int) -> dict:
    return {"range_id": int(range_id), "epoch": int(epoch),
            "term": int(term)}


def get_range_ctx(params) -> Any:
    """The request's range context, or None when absent/malformed."""
    if not isinstance(params, dict):
        return None
    rc = params.get(RANGE_KEY)
    if isinstance(rc, dict) and "range_id" in rc:
        return rc
    return None


__all__ = ["FrameError", "encode", "decode", "send_frame", "recv_frame",
           "parse_addr", "MAX_FRAME", "TRACE_KEY", "make_trace_ctx",
           "get_trace_ctx", "RANGE_KEY", "make_range_ctx",
           "get_range_ctx"]
