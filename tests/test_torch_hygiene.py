"""Rules of the PyTorch port that the other tests do not show.

* No module of `tidb_tpu_torch/`, and not `chip_smoke.py`, imports `jax`
  or anything of `tidb_tpu` (checked on the AST, so an import inside a
  function counts too).
* The entry points run on the card unless the caller asks for the CPU:
  `CopClient()` without CUDA raises, and so does a `Session()` at its
  first statement that needs the coprocessor; nothing moves to the CPU
  on its own.
* A kernel wrapper given a CUDA tensor launches its kernel or raises; it
  never takes the plain version. Here there is no CUDA and no nvcc, so a
  stand-in "CUDA tensor" must reach the build and fail there.
"""

import ast
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.copr import streamseg as TSS
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.device import resolve_device
from tidb_tpu_torch.session import Session

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tidb_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "tidb_tpu"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_has_the_kernel_sources():
    assert (ROOT / "tidb_tpu_torch/csrc/streamseg.cu").is_file()
    assert sorted(p.stem for p in _kernels.SRC_DIR.glob("*.cu")) == \
        sorted(_kernels._SIGNATURES)


def test_client_needs_cuda_unless_cpu_is_asked():
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            CopClient()
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            CopClient("cuda")
        assert CopClient("cpu").device == torch.device("cpu")
    with mock.patch.object(torch.cuda, "is_available", lambda: True):
        assert resolve_device() == torch.device("cuda")


def test_session_needs_cuda_unless_cpu_is_asked():
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        for dev in (None, "cuda"):
            s = Session(device=dev)
            s.execute("create table t (a int primary key)")
            with pytest.raises(RuntimeError, match="CUDA device requested"):
                s.query("select a from t")
            assert s._cop is None
        s = Session(device="cpu")
        s.execute("create table t (a int primary key)")
        assert s.query("select a from t") == []
        assert s.cop.device == torch.device("cpu")


def _cuda_like(dtype, shape, device):
    """A stand-in for a well-formed CUDA tensor: it passes the wrapper's
    checks, so the wrapper goes on to its library."""
    t = mock.MagicMock(spec=torch.Tensor)
    t.is_cuda = True
    t.device = device
    t.dtype = dtype
    t.shape = shape
    t.dim.return_value = len(shape)
    t.is_contiguous.return_value = True
    return t


def test_cuda_wrapper_raises_without_a_built_kernel(tmp_path, monkeypatch):
    # an empty build directory and no nvcc anywhere
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dev = torch.device("cuda", 0)
    cuda_vals = _cuda_like(torch.float32, (1, 6), dev)
    cuda_f = _cuda_like(torch.int32, (6,), dev)
    meta = TSS.rank_meta([np.array([0, 0, 1, 1, 1, 2])])
    assert not meta["identity"]
    before = dict(_kernels.LAUNCHES)
    with mock.patch.object(TSS, "rank_sums_plain",
                           side_effect=AssertionError("fell back")):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            TSS.rank_sums(cuda_vals, cuda_f, meta)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("case", ["bad dtype", "no rows"])
def test_cuda_wrapper_looks_up_its_library_only_to_launch(case, monkeypatch):
    """A library lookup is what `tidb_copr_jit_cache_total` counts: the
    wrapper makes none when its checks refuse the inputs or when there is
    nothing to launch, so a lookup always means a launch."""
    monkeypatch.setattr(_kernels, "_library",
                        mock.Mock(side_effect=AssertionError("looked up")))
    dev = torch.device("meta")
    if case == "bad dtype":
        with pytest.raises(ValueError, match="vals must be torch.float32"):
            _kernels.streamseg_rank_sums(
                _cuda_like(torch.float64, (1, 6), dev),
                _cuda_like(torch.int32, (6,), dev), 2, 4)
    else:
        out = _kernels.streamseg_rank_sums(
            _cuda_like(torch.float32, (2, 0), dev),
            _cuda_like(torch.int32, (0,), dev), 0, 4)
        assert out.shape == (2, 4)
    _kernels._library.assert_not_called()


def test_cpu_tensors_take_the_plain_version():
    meta = TSS.rank_meta([np.array([0, 0, 1, 1, 1, 2])])
    vals = torch.ones((2, 6))
    f = torch.from_numpy(meta["f"])
    with mock.patch.object(_kernels, "streamseg_rank_sums",
                           side_effect=AssertionError("kernel on CPU")):
        out = TSS.rank_sums(vals, f, meta)
    assert out[:, :3].tolist() == [[2.0, 3.0, 1.0]] * 2
