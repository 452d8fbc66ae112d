"""The RPC tier's wire format and typed errors on the port, held to the
reference's.

Seeded values of every supported type (None, bool, arbitrary-precision
int, float, bytes, str, nested list and dict) encode to the reference's
bytes, and decode back on both packages; malformed payloads fail with
`FrameError` on both, and a framed round trip over a socket pair gives
the same payload. The error classes keep the reference's names, errnos,
sqlstates and messages, and the wire envelope (`wire_error`,
`traced_response`, `get_trace_ctx`) answers the same dicts.
"""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest

import tidb_tpu.rpc.errors as RE
import tidb_tpu.rpc.frame as RF
import tidb_tpu_torch.rpc.errors as PE
import tidb_tpu_torch.rpc.frame as PF
from tidb_tpu.errno import CodedError as RefCodedError
from tidb_tpu_torch.errno import CodedError


def _titpu_threads() -> set:
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("titpu-")}


@pytest.fixture(autouse=True)
def _no_leaked_threads():
    before = _titpu_threads()
    yield
    left = _titpu_threads() - before
    assert not left, sorted(t.name for t in left)


def _value(rng, depth: int = 0):
    kind = int(rng.integers(0, 9 if depth < 3 else 7))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        bits = int(rng.integers(1, 200))
        v = int.from_bytes(rng.bytes((bits + 7) // 8), "little")
        return -v if rng.integers(0, 2) else v
    if kind == 3:
        return float(rng.normal() * 10 ** int(rng.integers(-5, 20)))
    if kind == 4:
        return rng.bytes(int(rng.integers(0, 64)))
    if kind == 5:
        return "".join(chr(int(c)) for c in
                       rng.integers(32, 0x2FF, int(rng.integers(0, 20))))
    if kind == 6:
        return int(rng.integers(-2 ** 62, 2 ** 62))
    if kind == 7:
        return [_value(rng, depth + 1)
                for _ in range(int(rng.integers(0, 5)))]
    return {f"k{i}" if i % 2 else i: _value(rng, depth + 1)
            for i in range(int(rng.integers(0, 5)))}


@pytest.mark.parametrize("seed", range(8))
def test_encode_bytes_equal_and_round_trip(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        v = _value(rng)
        want = RF.encode(v)
        got = PF.encode(v)
        assert got == want
        assert PF.decode(got) == RF.decode(want)
    # the edges of the int encoding: sign, byte boundaries, timestamps
    for v in (0, -1, 1, 127, 128, -128, -129, 255, 256, 2 ** 63,
              -2 ** 63, 469846890058350593, 10 ** 40, True, False,
              (1, "a"), b"", "", {}, []):
        assert PF.encode(v) == RF.encode(v)
        assert PF.decode(PF.encode(v)) == RF.decode(RF.encode(v))


@pytest.mark.parametrize("buf", [b"", b"I", b"I\x04ab", b"Zx", b"NN",
                                 b"S\x05\x00\x00\x00ab", b"L\x02\x00\x00\x00N",
                                 b"D\x01\x00\x00\x00N"])
def test_malformed_payload_fails_the_same(buf):
    outcomes = []
    for F in (RF, PF):
        try:
            F.decode(buf)
            outcomes.append("ok")
        except F.FrameError as e:
            outcomes.append(("FrameError", str(e)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1] != "ok"


def test_unencodable_value_and_constants():
    for F in (RF, PF):
        with pytest.raises(F.FrameError, match="unencodable value type set"):
            F.encode({1, 2})
    assert PF.MAX_FRAME == RF.MAX_FRAME == 64 << 20
    assert PF.TRACE_KEY == RF.TRACE_KEY
    for addr in ("127.0.0.1:4000", ":9", "unix:/tmp/x.sock", "/tmp/y",
                 ("h", "12")):
        assert PF.parse_addr(addr) == RF.parse_addr(addr)


def test_framed_round_trip_over_a_socket():
    payload = PF.encode({"id": 7, "m": "wal_tail", "p": {"offset": 3}})
    for send, recv in ((PF.send_frame, RF.recv_frame),
                       (RF.send_frame, PF.recv_frame)):
        a, b = socket.socketpair()
        try:
            send(a, payload)
            assert recv(b) == payload
            a.close()
            with pytest.raises(ConnectionError):
                recv(b)
        finally:
            a.close()
            b.close()


def test_trace_ctx_helpers():
    tc = PF.make_trace_ctx("abc", 5)
    assert tc == RF.make_trace_ctx("abc", 5)
    for req in ({"tc": tc}, {"tc": {"trace_id": ""}}, {"tc": 3}, None,
                {"x": 1}):
        assert PF.get_trace_ctx(req) == RF.get_trace_ctx(req)


ERROR_NAMES = ["RPCError", "LeaderUnavailable", "StaleLeaseError",
               "StaleTermError", "NotLeaderError", "EpochNotMatchError",
               "ResultUndetermined", "ReplicaStaleError",
               "WalOffsetMismatch"]


@pytest.mark.parametrize("name", ERROR_NAMES)
def test_errors_match_by_class_errno_and_message(name):
    rc, pc = getattr(RE, name), getattr(PE, name)
    assert issubclass(pc, CodedError) and issubclass(rc, RefCodedError)
    assert [c.__name__ for c in pc.__mro__[:3]] == \
        [c.__name__ for c in rc.__mro__[:3]]
    r, p = rc("leader gone: budget 3000ms"), pc("leader gone: budget 3000ms")
    assert (p.errno, p.sqlstate, str(p)) == (r.errno, r.sqlstate, str(r))
    assert PE.wire_error(7, p) == RE.wire_error(7, r)
    assert PE.WIRE_ERRORS[name].__name__ == RE.WIRE_ERRORS[name].__name__
    assert set(PE.WIRE_ERRORS) == set(RE.WIRE_ERRORS)


def test_leader_unavailable_is_9001():
    assert PE.LeaderUnavailable("x").errno == \
        RE.LeaderUnavailable("x").errno == 9001
    assert PE.StaleLeaseError("x").errno == RE.StaleLeaseError("x").errno


def test_traced_response_envelope():
    def ok():
        return {"ts": 5}

    for E in (RE, PE):
        assert E.traced_response(1, "tso_next", ok, None) == \
            {"id": 1, "r": {"ts": 5}}
    got = [E.traced_response(2, "m", ok, {"trace_id": "t1",
                                            "parent_span_id": 3})
           for E in (RE, PE)]
    for g in got:
        assert g["id"] == 2 and g["r"] == {"ts": 5}
        assert [r[0].split(" [")[0] for r in g["sp"]] == ["remote.m"]
        assert "trace_id=t1 parent_span_id=3" in g["sp"][0][0]

    def fenced(E):
        def fn():
            raise E.StaleLeaseError("wal append fenced: mutation lease "
                                    "lost (token 9)")
        return fn

    assert PE.traced_response(3, "wal_append", fenced(PE), None) == \
        RE.traced_response(3, "wal_append", fenced(RE), None)


def test_traced_response_keeps_a_foreign_error():
    """A non-survivable error (a torch or CUDA error, a bug) is not
    turned into a wire error on the port: it propagates to the
    listener. The reference answers it as an RPCError envelope."""
    def boom():
        raise RuntimeError("device-side assert")

    want = RE.traced_response(4, "diag_load", boom, None)
    assert want["err"]["type"] == "RPCError"
    with pytest.raises(RuntimeError, match="device-side assert"):
        PE.traced_response(4, "diag_load", boom, None)
