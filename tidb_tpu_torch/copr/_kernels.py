"""Build and bind the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into
`build/kernels/lib<name>.so` at the root of the checkout, at first use,
and binds through a plain C function loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). `build_all` starts one `nvcc` per
source, all at once.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with torch, launches on the current stream, raises
when the C function returns a CUDA error, and adds one to its entry in
`LAUNCHES` for each launch. There is no fallback: a wrapper that cannot
build or launch its kernel raises.

The first use of a library in a process (its build when stale, and its
load) is the `compile` dispatch stage (span `cuda.compile`): it shows at
most once per process, on the first launch of that kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .. import obs

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel wrapper; read (and reset) by chip_smoke.py to show
# that the main path went through each kernel
LAUNCHES: dict[str, int] = {"streamseg.rank_sums": 0}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
# C functions of each source: {function: argtypes}; each returns an int,
# a CUDA error code (0 = success) unless its comment in the source says
# otherwise
_SIGNATURES = {
    "streamseg": {
        "streamseg_rank_sums": [_VP, _VP, _VP, _VP, ctypes.c_int, _LL, _LL,
                                _LL, _LL, _VP],
        "streamseg_scratch_words": [ctypes.c_int, _LL],
        "streamseg_launch_config": [ctypes.c_int, _VP],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of tidb_tpu_torch "
                       "build with the CUDA toolkit on the card's machine")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = SRC_DIR / f"{name}.cu"
    return not lib.is_file() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names=None, force: bool = False) -> dict[str, str]:
    """Compile the named sources (default: every csrc/*.cu), those that are
    stale unless `force`, one nvcc process per source, all started
    together. Returns each built source's compiler output (ptxas register,
    spill and shared-memory report); raises if any build fails."""
    if names is None:
        names = [p.stem for p in sorted(SRC_DIR.glob("*.cu"))]
    if not force:
        names = [n for n in names if _stale(n)]
    if not names:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def loaded_count() -> int:
    """CUDA libraries loaded in this process (`tidb_jit_cache_entries`)."""
    with _lock:
        return len(_libs)


def _library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if its source is newer.
    Counted in `tidb_copr_jit_cache_total`: the first build and load is a
    miss, every later lookup a hit."""
    with _lock:
        lib = _libs.get(name)
        obs.JIT_CACHE.inc(result="hit" if lib is not None else "miss")
        if lib is None:
            with obs.stage("compile", span_name="cuda.compile") as sp:
                if sp:
                    sp.note = name
                if _stale(name):
                    build_all([name])
                lib = ctypes.CDLL(str(_lib_path(name)))
                for fn_name, argtypes in _SIGNATURES[name].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int,
           device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{what} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{what} must be {dim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def streamseg_launch_config(K: int, device=None) -> dict[str, int]:
    """The streamseg kernel's launch for K arrays on a CUDA device, for
    reports: blocks per SM, SM count, dynamic shared memory per block and
    rows per tile (the grid is blocks_per_sm * sms persistent blocks)."""
    lib = _library("streamseg")
    buf = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device("cuda" if device is None
                                        else device)):
        err = lib.streamseg_launch_config(K, ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"streamseg launch config for K={K} failed: "
                           f"CUDA error {err}")
    return dict(zip(("blocks_per_sm", "sms", "smem_bytes", "tile_rows"),
                    buf))


def streamseg_rank_sums(vals: torch.Tensor, f: torch.Tensor, nd: int,
                        nd_pad: int) -> torch.Tensor:
    """CUDA kernel for `streamseg.rank_sums`: vals f32[K, n],
    change flags f int32[nf] (rows >= nf have flag 0) -> f32[K, nd_pad]
    with out[k, r] = sum of vals[k, row] over rows of rank r < nd.

    One launch, after one zero fill of the look-back scratch (its size and
    layout are the kernel's: per tile a status word and K tail words, and
    the tile counter). The kernel writes every output element, so `out`
    starts empty. The library is looked up only after the checks and the
    empty case, so each lookup (`tidb_copr_jit_cache_total`) is followed
    by a launch or by the launch's error."""
    dev = vals.device
    _check(vals, "vals", torch.float32, 2, dev)
    _check(f, "f", torch.int32, 1, dev)
    K, n = vals.shape
    if not 1 <= K <= 8:
        raise ValueError(f"streamseg: K={K} arrays, the kernel takes 1..8")
    if n >= 2**31 or K * nd_pad >= 2**31:
        raise ValueError(f"streamseg: n={n} rows or K*nd_pad={K * nd_pad} "
                         f"exceeds int32 indices")
    if nd_pad % 4:
        raise ValueError(f"streamseg: nd_pad={nd_pad} is not a multiple of 4 "
                         f"(the kernel stores 16-byte groups of ranks)")
    if n == 0:
        return torch.zeros((K, nd_pad), dtype=torch.float32, device=dev)
    lib = _library("streamseg")
    out = torch.empty((K, nd_pad), dtype=torch.float32, device=dev)
    scratch = torch.zeros(lib.streamseg_scratch_words(K, n),
                          dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.streamseg_rank_sums(
            vals.data_ptr(), f.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), K, n, min(f.shape[0], n), nd, nd_pad,
            stream)
    if err != 0:
        raise RuntimeError(f"streamseg kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["streamseg.rank_sums"] += 1
    return out
