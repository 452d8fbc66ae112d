"""tidb_tpu_torch streamseg vs the JAX reference's.

`rank_meta` is host numpy in both packages; its dicts must be equal,
arrays included, because they decide the streamseg gates and shapes.
`rank_sums` on a CPU tensor runs the port's plain version; the reference
runs its `segment_sum` spec path on CPU (the way its own tests run it).
Tolerance: exact (`==`). Every value is an integer and every per-rank
total is below 2^24 under the MAX_ROWS_PER_KEY gate, so f32 sums are
exact in any order — the repo's device-vs-host standard.

The CUDA kernel itself runs only on the card: the `gpu`-marked tests skip
where torch sees no CUDA device. The reference is imported inside the tests
that use it, so that the kernel tests also run where JAX is not installed:
`python -m pytest tests/test_torch_streamseg.py --noconftest -m gpu`.

SHAPES holds the edges of the kernel's design (1,024-row tiles, bulk
copies of 16-byte multiples, a carry passed between tiles): runs that
cross one or several tile boundaries, rows that start unaligned
(n % 4 != 0), a long tail of pad rows past len(f) with nonzero values
(they join the last rank), and an output padded far past nd.
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


def _run_keys(rng, n, max_run, lead=None):
    """Sorted keys of n rows in runs of 1..max_run rows. The first run is
    max_run long; with `lead`, the first run is `lead` rows and the second
    max_run, so that a longest run starts at row `lead`."""
    lens = rng.integers(1, max_run + 1, 2 * n // (max_run + 1) + 16)
    lens[0] = max_run
    if lead is not None:
        lens[:2] = lead, max_run
    while lens.sum() < n:
        lens = np.concatenate([lens, rng.integers(1, max_run + 1, 16)])
    return np.repeat(np.arange(len(lens)), lens)[:n].astype(np.int64)


def _shape(n, max_run, K, extra, lead=None, out_extra=0, id=None):
    return pytest.param(n, max_run, K, extra, lead, out_extra,
                        id=id or f"{n}-{max_run}-{K}-{extra}")


# (rows, longest run, K, rows of padding past len(f), first run's rows,
# output columns past rank_meta's nd_pad)
SHAPES = [
    _shape(1, 1, 1, 0), _shape(2, 2, 2, 254), _shape(1023, 5, 3, 1),
    _shape(1025, 40, 4, 0), _shape(5000, 1, 5, 7), _shape(16385, 100, 6, 0),
    _shape(20000, 4096, 7, 3), _shape(33333, 17, 8, 111),
    # a 4,096-row run from row 1,500 to 5,595: starts mid-tile, crosses
    # the tile boundaries at 2,048, 3,072, 4,096 and 5,120
    _shape(12000, 4096, 4, 0, lead=1500, id="run4096-mid-tile"),
    # runs up to 3,000 rows, most crossing one to three boundaries
    _shape(30000, 3000, 3, 4, id="runs-cross-tiles"),
    # n % 4 == 3 with K = 2: rows of vals start unaligned
    _shape(9999, 13, 2, 0, id="unaligned-rows"),
    # 3,500 pad rows past len(f), nonzero: three whole tiles in one rank
    _shape(6000, 7, 4, 3500, id="long-pad-tail"),
    # nd_pad - nd >= 256
    _shape(4321, 9, 3, 1, out_extra=256, id="wide-out-pad"),
]


def _case(n, max_run, K, extra, lead, out_extra):
    """Keys, meta and values of one SHAPES case: 12-bit limbs (signed top
    limb) and a 0/1 mask in array 0, as the hc path stages them; pad rows
    past len(f) get values too (they join the last rank)."""
    rng = np.random.default_rng(n + K)
    keys = _run_keys(rng, n, max_run, lead)
    meta = TSS.rank_meta([keys])
    if out_extra:
        meta = dict(meta, nd_pad=meta["nd_pad"] + out_extra)
    vals = np.zeros((K, n + extra), np.float32)
    vals[:, :n] = rng.integers(-2048, 4096, (K, n))
    vals[0, :n] = rng.integers(0, 2, n)
    vals[:, n:] = rng.integers(-2048, 4096, (K, extra))
    return meta, vals


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


@pytest.mark.parametrize("n,max_run,K,extra,lead,out_extra", SHAPES)
def test_rank_sums_plain_equals_jax(JSS, n, max_run, K, extra, lead,
                                    out_extra):
    import jax.numpy as jnp

    meta, vals = _case(n, max_run, K, extra, lead, out_extra)
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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _on_card(case):
    meta, vals = _case(*case)
    dev = _cuda()
    return (meta, torch.as_tensor(vals, device=dev),
            torch.as_tensor(meta["f"], device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("n,max_run,K,extra,lead,out_extra", SHAPES)
def test_kernel_matches_plain(n, max_run, K, extra, lead, out_extra):
    meta, v, f = _on_card((n, max_run, K, extra, lead, out_extra))
    before = _kernels.LAUNCHES["streamseg.rank_sums"]
    got = _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"])
    assert _kernels.LAUNCHES["streamseg.rank_sums"] == before + 1
    want = TSS.rank_sums_plain(v, f, meta["nd"], meta["nd_pad"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


EDGE = (30000, 3000, 3, 4, None, 256)  # crossing runs, pad, wide out


@pytest.mark.gpu
def test_kernel_writes_every_output_element():
    # the output starts as torch.empty: hand the kernel a block that the
    # caching allocator just freed full of NaN, so any element the kernel
    # skips shows
    meta, v, f = _on_card(EDGE)
    nan = torch.full((v.shape[0], meta["nd_pad"]), float("nan"),
                     device=v.device)
    nan_ptr = nan.data_ptr()
    del nan
    got = _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"])
    torch.cuda.synchronize()
    assert got.data_ptr() == nan_ptr  # the same block came back
    assert not torch.isnan(got).any()
    assert torch.equal(got, TSS.rank_sums_plain(v, f, meta["nd"],
                                                meta["nd_pad"]))


@pytest.mark.gpu
def test_kernel_twice_in_a_row_is_equal():
    # the look-back status words and the tile counter are reset per call
    meta, v, f = _on_card(EDGE)
    a = _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"])
    b = _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"])
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, TSS.rank_sums_plain(v, f, meta["nd"],
                                              meta["nd_pad"]))


@pytest.mark.gpu
def test_kernel_on_a_side_stream():
    meta, v, f = _on_card(EDGE)
    want = TSS.rank_sums_plain(v, f, meta["nd"], meta["nd_pad"])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_rejects_nd_pad_off_16_bytes():
    # the kernel stores ranks in 16-byte groups: nd_pad must be a multiple
    # of 4 (rank_meta's is a multiple of 128)
    meta, v, f = _on_card(EDGE)
    with pytest.raises(ValueError, match="multiple of 4"):
        _kernels.streamseg_rank_sums(v, f, meta["nd"], meta["nd_pad"] + 1)
