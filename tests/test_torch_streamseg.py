"""tidb_tpu_torch streamseg vs the JAX reference's.

`rank_meta` is host numpy in both packages; its dicts must be equal,
arrays included, because they decide the streamseg gates and shapes.
`rank_sums` on a CPU tensor runs the port's plain version; the reference
runs its `segment_sum` spec path on CPU (the way its own tests run it).
Tolerance: exact (`==`). Every value is an integer and every per-rank
total is below 2^24 under the MAX_ROWS_PER_KEY gate, so f32 sums are
exact in any order — the repo's device-vs-host standard.

The CUDA kernel itself runs only on the card: `test_kernel_matches_plain`
is marked `gpu` and skips where torch sees no CUDA device. The reference is
imported inside the tests that use it, so that the kernel test also runs
where JAX is not installed:
`python -m pytest tests/test_torch_streamseg.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.copr import streamseg as TSS


@pytest.fixture(scope="module")
def JSS():
    from tidb_tpu.copr import streamseg
    return streamseg


def _run_keys(rng, n, max_run):
    lens = rng.integers(1, max_run + 1, 2 * n // (max_run + 1) + 16)
    lens[0] = max_run
    while lens.sum() < n:
        lens = np.concatenate([lens, rng.integers(1, max_run + 1, 16)])
    return np.repeat(np.arange(len(lens)), lens)[:n].astype(np.int64)


# (rows, longest run, K, rows of padding past len(f))
SHAPES = [
    (1, 1, 1, 0), (2, 2, 2, 254), (1023, 5, 3, 1), (1025, 40, 4, 0),
    (5000, 1, 5, 7), (16385, 100, 6, 0), (20000, 4096, 7, 3),
    (33333, 17, 8, 111),
]


def _meta_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("n,max_run", [(1, 1), (7, 3), (4096, 1), (5000, 9),
                                       (70000, 4096), (12345, 300)])
def test_rank_meta_equal(JSS, n, max_run):
    keys = _run_keys(np.random.default_rng(n), n, max_run)
    _meta_equal(TSS.rank_meta([keys]), JSS.rank_meta([keys]))


def test_rank_meta_two_key_columns_equal(JSS):
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 50, 9000))
    b = np.zeros_like(a)
    for v in np.unique(a):  # second key sorted within each run of the first
        m = a == v
        b[m] = np.sort(rng.integers(0, 4, int(m.sum())))
    _meta_equal(TSS.rank_meta([a, b]), JSS.rank_meta([a, b]))


@pytest.mark.parametrize("keys", [np.zeros(0, np.int64),
                                  np.zeros(4097, np.int64),
                                  np.repeat(np.arange(3), [1, 5000, 2])],
                         ids=["empty", "one-run-over-gate", "middle-over"])
def test_rank_meta_gate_returns_none(JSS, keys):
    assert JSS.rank_meta([keys]) is None
    assert TSS.rank_meta([keys]) is None


@pytest.mark.parametrize("n,max_run,K,extra", SHAPES)
def test_rank_sums_plain_equals_jax(JSS, n, max_run, K, extra):
    import jax.numpy as jnp

    rng = np.random.default_rng(n + K)
    keys = _run_keys(rng, n, max_run)
    meta = TSS.rank_meta([keys])
    # 12-bit limbs (signed top limb) and 0/1 masks, as the hc path stages
    vals = np.zeros((K, n + extra), np.float32)
    vals[:, :n] = rng.integers(-2048, 4096, (K, n))
    vals[0, :n] = rng.integers(0, 2, n)
    want = np.asarray(JSS.rank_sums(jnp.asarray(vals),
                                    jnp.asarray(meta["f"]), meta))
    tv, tf = torch.from_numpy(vals), torch.from_numpy(meta["f"])
    got = TSS.rank_sums(tv, tf, meta)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    if not meta["identity"]:
        plain = TSS.rank_sums_plain(tv, tf, meta["nd"], meta["nd_pad"])
        assert np.array_equal(plain.numpy(), want)


def test_rank_sums_rejects_other_devices():
    meta = TSS.rank_meta([np.array([0, 0, 1, 2, 2])])
    vals = torch.zeros((1, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        TSS.rank_sums(vals, torch.zeros(5, dtype=torch.int32,
                                        device="meta"), meta)


@pytest.mark.gpu
@pytest.mark.parametrize("n,max_run,K,extra", SHAPES)
def test_kernel_matches_plain(n, max_run, K, extra):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(n + K)
    keys = _run_keys(rng, n, max_run)
    meta = TSS.rank_meta([keys])
    vals = np.zeros((K, n + extra), np.float32)
    vals[:, :n] = rng.integers(-2048, 4096, (K, n))
    v = torch.as_tensor(vals, device="cuda")
    f = torch.as_tensor(meta["f"], device="cuda")
    before = _kernels.LAUNCHES["streamseg.rank_sums"]
    got = _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"])
    assert _kernels.LAUNCHES["streamseg.rank_sums"] == before + 1
    want = TSS.rank_sums_plain(v, f, meta["nd"], meta["nd_pad"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
