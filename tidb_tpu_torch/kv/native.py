"""ctypes bindings for the C++ ordered-KV engine (csrc/kvstore.cpp).

Port of `tidb_tpu/kv/native.py`. The shared library builds with `g++` at
first use into `build/native/libtidbkv.so` at the root of the checkout
(a plain C ABI, no pybind11), from the port's own copy of the engine's
source. `NativeOrderedKV` is interface-identical to mvcc.PyOrderedKV, so
`MVCCStore(NativeOrderedKV())` swaps the substrate without touching
percolator logic. With `TIDB_TPU_NATIVE_SANITIZE=1` the engine loads its
ASan/UBSan build instead (`build/native/libtidbkv_asan.so`, the same
source under `SAN_FLAGS`), which needs libasan preloaded into the process.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

from ..analysis import lockcheck

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "kvstore.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
_SO = BUILD_DIR / "libtidbkv.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
# TIDB_TPU_NATIVE_SANITIZE=1: load the ASan/UBSan instrumented build
# instead. gcc links libasan dynamically into the shared object, so the
# process must have the runtime preloaded (LD_PRELOAD) — dlopen'ing an
# ASan object into a clean interpreter fails ("runtime does not come
# first"); the slow-marked torture test in tests/test_torch_analysis.py
# spawns a child with the right environment
SANITIZE_ENV = "TIDB_TPU_NATIVE_SANITIZE"
_SO_ASAN = BUILD_DIR / "libtidbkv_asan.so"
SAN_FLAGS = ["-O1", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-shared", "-fsanitize=address,undefined",
             "-fno-omit-frame-pointer", "-fno-sanitize-recover=undefined"]

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _sanitize_requested() -> bool:
    # same falsy spellings as lockcheck's env parsing
    return os.environ.get(SANITIZE_ENV, "") not in ("", "0", "false",
                                                    "off")


def _asan_preloaded() -> bool:
    try:
        with open("/proc/self/maps") as f:
            return "libasan" in f.read()
    except OSError:
        return False


def _build(so: Optional[Path] = None, flags: Optional[list] = None) -> None:
    """g++ into a private temporary name, then an atomic rename: processes
    that build at once (test workers) never load a half-written library.
    Without arguments, the plain build."""
    if so is None:
        so, flags = _SO, CXX_FLAGS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.{threading.get_ident()}.so"
    try:
        subprocess.run(["g++", *flags, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError) as e:
        raise NativeUnavailable(f"cannot build {so}: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        sanitize = _sanitize_requested()
        so = _SO_ASAN if sanitize else _SO
        # an ASan object dlopen'ed without the runtime preloaded ends
        # the process instead of failing the load: refuse it up front
        if sanitize and not _asan_preloaded():
            raise NativeUnavailable(
                f"cannot load {so.name}: libasan is not loaded — the "
                "ASan runtime must be preloaded (LD_PRELOAD=$(gcc "
                "-print-file-name=libasan.so))")
        if not so.exists() or so.stat().st_mtime < _SRC.stat().st_mtime:
            if sanitize:
                _build(_SO_ASAN, SAN_FLAGS)
            else:
                _build()
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeUnavailable(f"cannot load {so}: {e}") from e
        c = ctypes.c_char_p
        vp = ctypes.c_void_p
        sz = ctypes.c_size_t
        lib.kv_open.restype = vp
        lib.kv_open_at.argtypes = [c]
        lib.kv_open_at.restype = vp
        lib.kv_checkpoint.argtypes = [vp]
        lib.kv_checkpoint.restype = ctypes.c_int
        lib.kv_sync.argtypes = [vp]
        lib.kv_sync.restype = ctypes.c_int
        lib.kv_close.argtypes = [vp]
        lib.kv_put.argtypes = [vp, ctypes.c_int, c, sz, c, sz]
        lib.kv_delete.argtypes = [vp, ctypes.c_int, c, sz]
        lib.kv_get.argtypes = [vp, ctypes.c_int, c, sz,
                               ctypes.POINTER(ctypes.c_char_p)]
        lib.kv_get.restype = ctypes.c_long
        lib.kv_count.argtypes = [vp, ctypes.c_int]
        lib.kv_count.restype = sz
        lib.kv_scan.argtypes = [vp, ctypes.c_int, c, sz, c, sz,
                                ctypes.c_long]
        lib.kv_scan.restype = vp
        lib.kv_iter_next.argtypes = [
            vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(sz),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(sz)]
        lib.kv_iter_next.restype = ctypes.c_int
        lib.kv_iter_close.argtypes = [vp]
        lib.kv_seek_prev.argtypes = [
            vp, ctypes.c_int, c, sz, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(sz), ctypes.POINTER(ctypes.c_char_p)]
        lib.kv_seek_prev.restype = ctypes.c_long
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


class NativeOrderedKV:
    """C++-backed ordered KV; drop-in for mvcc.PyOrderedKV.

    With `path` the engine is durable: every mutation is WAL-appended
    before the in-memory map changes, and `checkpoint()` folds the state
    into a snapshot file (truncating the WAL). The file format is shared
    with the Python twin, so either engine reopens the other's directory."""

    def __init__(self, path: Optional[str] = None,
                 sync_log: str = "off",
                 sync_interval_ms: int = 100) -> None:
        self._lib = _load()
        if path is not None:
            Path(path).mkdir(parents=True, exist_ok=True)
            self._h = self._lib.kv_open_at(str(path).encode())
            if not self._h:
                raise NativeUnavailable(f"cannot open WAL dir {path}")
        else:
            self._h = self._lib.kv_open()
        self._mu = lockcheck.lock("NativeOrderedKV._mu", hot=True)
        # fsync-vs-close fence (see _fsync_native); writers never take it
        self._sync_mu = lockcheck.lock("NativeOrderedKV._sync_mu")
        self._durable = path is not None
        # the same storage.sync-log policy the Python twin honors, via the
        # same evaluator (mvcc.SyncPolicy); the C++ engine exposes one
        # kv_sync entry point, so dirtiness is tracked here (every
        # put/delete under a durable dir dirties)
        from .mvcc import SyncPolicy
        self.sync_log = sync_log
        self.sync_interval_ms = sync_interval_ms
        self._syncer = SyncPolicy(sync_log, sync_interval_ms,
                                  self._fsync_native)
        # cross-commit group fsync: the commit-boundary fsync moves out of
        # the mutation section into the commit path's rendezvous
        self._syncer.defer_commit = True

    def _fsync_native(self) -> None:
        # fsync OUTSIDE _mu: holding the write lock for the disk barrier
        # would serialize concurrent writers behind every fsync and
        # reduce the group-commit rendezvous to batches of one (kv_sync
        # itself flushes under the C++ lock and fsyncs lock-free).
        # _sync_mu serializes ONLY against close() and checkpoint():
        # kv_close frees the C++ Store, and an in-flight kv_sync on the
        # freed handle is a use-after-free.
        with self._sync_mu:
            with self._mu:
                h = self._h
            if h:
                # dynamic blocking probe: fires only if a caller holds
                # a HOT lock (the store mutex) into this fsync — the
                # deliberately-held _sync_mu close fence is not hot
                lockcheck.note_blocking("fsync", "native kv_sync")
                if self._lib.kv_sync(h) != 0:
                    raise OSError("kv_sync: fsync failed")

    def checkpoint(self) -> None:
        # _sync_mu: kv_checkpoint rotates the C++ WAL FILE*, and the
        # group fsync runs lock-free on that handle's fd
        with self._sync_mu, self._mu:
            if not self._h:
                return  # closed
            if self._lib.kv_checkpoint(self._h) != 0:
                raise OSError("kv_checkpoint failed")
        self._syncer.clean()

    def sync(self) -> None:
        self._syncer.flush()

    def maybe_sync(self) -> None:
        """Commit-boundary fsync per the sync-log policy (the same
        contract as mvcc.PyOrderedKV.maybe_sync)."""
        if self._durable:
            self._syncer.boundary()

    def commit_sync(self) -> None:
        """Commit-ack group-fsync rendezvous (PyOrderedKV contract)."""
        if self._durable:
            self._syncer.commit_sync()

    def close(self) -> None:
        self._syncer.close()
        # _sync_mu first (same order as _fsync_native): an in-flight
        # group fsync finishes before the C++ Store is freed
        with self._sync_mu, self._mu:
            if self._h:
                self._lib.kv_close(self._h)
                self._h = None

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.kv_close(h)
            self._h = None

    def put(self, cf: int, key: bytes, value: bytes) -> None:
        with self._mu:
            self._lib.kv_put(self._h, cf, key, len(key), value, len(value))
        if self._durable:
            self._syncer.mark_dirty()

    def delete(self, cf: int, key: bytes) -> None:
        with self._mu:
            self._lib.kv_delete(self._h, cf, key, len(key))
        if self._durable:
            self._syncer.mark_dirty()

    def get(self, cf: int, key: bytes) -> Optional[bytes]:
        out = ctypes.c_char_p()
        with self._mu:
            n = self._lib.kv_get(self._h, cf, key, len(key),
                                 ctypes.byref(out))
            if n < 0:
                return None
            return ctypes.string_at(out, n)

    def scan(self, cf: int, start: bytes, end: bytes,
             limit: int = -1) -> Iterator[tuple[bytes, bytes]]:
        with self._mu:
            it = self._lib.kv_scan(self._h, cf, start, len(start),
                                   end, len(end), limit)
        k = ctypes.c_char_p()
        v = ctypes.c_char_p()
        kl = ctypes.c_size_t()
        vl = ctypes.c_size_t()
        try:
            while self._lib.kv_iter_next(it, ctypes.byref(k),
                                         ctypes.byref(kl), ctypes.byref(v),
                                         ctypes.byref(vl)):
                yield (ctypes.string_at(k, kl.value),
                       ctypes.string_at(v, vl.value))
        finally:
            self._lib.kv_iter_close(it)

    def seek_prev(self, cf: int, key: bytes) -> Optional[tuple[bytes, bytes]]:
        outk = ctypes.c_char_p()
        outkl = ctypes.c_size_t()
        outv = ctypes.c_char_p()
        with self._mu:
            n = self._lib.kv_seek_prev(self._h, cf, key, len(key),
                                       ctypes.byref(outk),
                                       ctypes.byref(outkl),
                                       ctypes.byref(outv))
            if n < 0:
                return None
            return (ctypes.string_at(outk, outkl.value),
                    ctypes.string_at(outv, n))

    def count(self, cf: int) -> int:
        with self._mu:
            return int(self._lib.kv_count(self._h, cf))
