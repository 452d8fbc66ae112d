"""The port's ordered-KV engines against the reference's.

* `NativeOrderedKV` (the port's own copy of the C++ engine,
  `tidb_tpu_torch/csrc/kvstore.cpp`, built into `build/native/`) and
  `PyOrderedKV` give the gets, scans and `seek_prev` of the reference's two
  engines over one seeded stream of puts and deletes.
* The WAL + snapshot format is shared and holds no pickles: the port
  replays a directory that a reference engine wrote (snapshot, then more
  WAL) to equal scans, and the reference replays the port's.
* A torn tail (a crash mid-append) is truncated to the same valid prefix.
"""

import os
import random
import struct
from pathlib import Path

import pytest

from tidb_tpu.kv import mvcc as ref_mvcc
from tidb_tpu.kv import native as ref_native
from tidb_tpu_torch.kv import mvcc, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENGINES = {
    "port-native": lambda p=None, **kw: native.NativeOrderedKV(p, **kw),
    "port-py": lambda p=None, **kw: mvcc.PyOrderedKV(p, **kw),
    "ref-native": lambda p=None, **kw: ref_native.NativeOrderedKV(p, **kw),
    "ref-py": lambda p=None, **kw: ref_mvcc.PyOrderedKV(p, **kw),
}


def _ops(seed: int, n: int = 600) -> list:
    rng = random.Random(seed)
    keys = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 6)))
            for _ in range(120)]
    out = []
    for _ in range(n):
        cf = rng.randrange(3)
        k = rng.choice(keys)
        if rng.random() < 0.7:
            v = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 9)))
            out.append(("put", cf, k, v))
        else:
            out.append(("delete", cf, k, b""))
    return out


def _apply(eng, ops) -> None:
    for op, cf, k, v in ops:
        if op == "put":
            eng.put(cf, k, v)
        else:
            eng.delete(cf, k)


def _probes(seed: int) -> list:
    rng = random.Random(seed + 1)
    return [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 5)))
            for _ in range(40)]


def _view(eng, seed: int) -> dict:
    """Everything a reader can see: full scans, ranged and limited scans,
    gets and seek_prev at seeded probes."""
    probes = _probes(seed)
    out = {}
    for cf in range(3):
        out[("all", cf)] = list(eng.scan(cf, b"", b""))
        for i, a in enumerate(probes[:12]):
            b = max(a, probes[i + 12])
            out[("range", cf, a, b)] = list(eng.scan(cf, a, b))
            out[("limit", cf, a)] = list(eng.scan(cf, a, b"", limit=3))
        for p in probes:
            out[("get", cf, p)] = eng.get(cf, p)
            out[("seek_prev", cf, p)] = eng.seek_prev(cf, p)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_engines_agree_over_a_seeded_stream(seed):
    ops = _ops(seed)
    views = {}
    for name, make in ENGINES.items():
        eng = make()
        _apply(eng, ops)
        views[name] = _view(eng, seed)
        if hasattr(eng, "count"):
            assert eng.count(1) == len(views[name][("all", 1)])
    ref = views["ref-py"]
    assert any(ref[("all", cf)] for cf in range(3))
    for name, v in views.items():
        assert v == ref, name


@pytest.mark.parametrize("writer", ["ref-native", "ref-py"])
@pytest.mark.parametrize("reader", ["port-native", "port-py"])
def test_port_replays_a_reference_wal_and_snapshot(tmp_path, writer, reader):
    ops = _ops(7, 900)
    d = str(tmp_path / "kv")
    w = ENGINES[writer](d)
    _apply(w, ops[:500])
    w.checkpoint()          # snapshot.kv + an empty WAL
    _apply(w, ops[500:])    # then more WAL on top of the snapshot
    want = _view(w, 7)
    w.close()
    assert os.path.getsize(os.path.join(d, "snapshot.kv")) > 0
    assert os.path.getsize(os.path.join(d, "wal.log")) > 0
    r = ENGINES[reader](d)
    assert _view(r, 7) == want
    r.close()


@pytest.mark.parametrize("writer", ["port-native", "port-py"])
def test_reference_replays_the_port_files(tmp_path, writer):
    ops = _ops(11, 700)
    d = str(tmp_path / "kv")
    w = ENGINES[writer](d, sync_log="commit")
    _apply(w, ops[:300])
    w.checkpoint()
    _apply(w, ops[300:])
    w.sync()
    want = _view(w, 11)
    w.close()
    for reader in ("ref-native", "ref-py"):
        r = ENGINES[reader](d)
        assert _view(r, 11) == want, reader
        r.close()


def _record(op: int, cf: int, key: bytes, value: bytes) -> bytes:
    return struct.pack("<BBII", op, cf, len(key), len(value)) + key + value


@pytest.mark.parametrize("cut", [1, 9, 12, 17])
def test_torn_tail_truncates_like_the_reference(tmp_path, cut):
    """A WAL whose last record was cut `cut` bytes in: every engine drops
    exactly that record, truncates the file to the same valid prefix, and
    an append after reopening is seen by the next replay."""
    good = _record(1, 0, b"a", b"1") + _record(1, 1, b"bb", b"22") + \
        _record(2, 0, b"a", b"")
    torn = _record(1, 2, b"cccc", b"333333")[:cut]
    results = {}
    for name, make in ENGINES.items():
        d = tmp_path / name
        d.mkdir()
        (d / "wal.log").write_bytes(good + torn)
        eng = make(str(d))
        size = os.path.getsize(d / "wal.log")
        seen = [list(eng.scan(cf, b"", b"")) for cf in range(3)]
        eng.put(2, b"z", b"after")
        eng.close()
        eng = make(str(d))
        results[name] = (size, seen, [list(eng.scan(cf, b"", b""))
                                      for cf in range(3)])
        eng.close()
    assert results["port-native"][0] == len(good)
    assert results["port-native"][1] == [[], [(b"bb", b"22")], []]
    assert results["port-native"][2][2] == [(b"z", b"after")]
    for name, r in results.items():
        assert r == results["ref-py"], name


def test_native_engine_builds_from_the_port_source_into_build():
    assert native.native_available()
    assert native._SRC == Path(ROOT, "tidb_tpu_torch/csrc/kvstore.cpp")
    assert native.BUILD_DIR == Path(ROOT, "build/native")
    assert native._SO.parent == native.BUILD_DIR
    assert native._SO.is_file()


def test_storage_takes_the_engine_the_reference_takes(tmp_path, monkeypatch):
    """`_make_engine` keeps the reference's order: the native engine when
    it builds, in memory and durable; the Python twin otherwise (durable),
    or MVCCStore's default twin (in memory)."""
    from tidb_tpu.store import storage as ref_storage
    from tidb_tpu_torch.store import storage

    st = storage.Storage()
    assert isinstance(st.kv.kv, native.NativeOrderedKV)
    assert isinstance(ref_storage.Storage().kv.kv, ref_native.NativeOrderedKV)
    st = storage.Storage(str(tmp_path / "a"))
    assert isinstance(st.kv.kv, native.NativeOrderedKV)
    st.close()

    def unavailable():
        raise native.NativeUnavailable("no g++")

    monkeypatch.setattr(storage, "native_available", lambda: False)
    assert isinstance(storage.Storage().kv.kv, mvcc.PyOrderedKV)
    st = storage.Storage(str(tmp_path / "b"))
    assert type(st.kv.kv) is mvcc.PyOrderedKV and st.kv.kv._wal is not None
    st.close()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", unavailable)
    monkeypatch.setattr(native, "_SO", tmp_path / "missing.so")
    assert not native.native_available()
