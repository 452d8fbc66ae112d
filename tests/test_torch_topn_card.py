"""The TopN tie rule and the sorted-run pieces on CUDA tensors.

`torch.topk` and `torch.sort` promise nothing about equal keys, and their
CUDA implementations are not the CPU's. The port's own rules must hold on
the card as on the CPU: `topnpack.topk_desc` ranks the larger score first
and, among equal scores, the lower row first; `hcagg.lexsort_perm` is
a total order with the position last; `hcagg.sort_by_keys` sorts the keys
as the CPU does (rows inside a segment may differ, their sums may not).
Then the four requests of this slice on a small TPC-H load, on the card and
on the CPU: the same chunks and tags.

Tolerance: exact. These tests need a CUDA device and skip elsewhere; the
reference is not imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_topn_card.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.copr import hcagg as PH
from tidb_tpu_torch.copr import topnpack as PT
from tidb_tpu_torch.copr.client import CopClient
from tidb_tpu_torch.copr.fragment import execute_fragment


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("k", [1, 100, 65_536])
def test_topk_desc_tie_rule_on_card(dtype, k):
    dev = _cuda()
    rng = np.random.default_rng(k)
    score = rng.integers(-5, 6, 1_000_003).astype(dtype)
    if dtype == "float32":
        score[::13] = -np.inf
    got = PT.topk_desc(torch.as_tensor(score, device=dev), k).cpu().numpy()
    want = np.lexsort((np.arange(len(score)), -score))[:k]
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_lexsort_perm_on_card():
    dev = _cuda()
    rng = np.random.default_rng(2)
    keys = [rng.integers(0, r, 200_000).astype(np.int32) for r in (3, 5, 2)]
    got = PH.lexsort_perm([torch.as_tensor(k, device=dev) for k in keys])
    want = np.lexsort([np.arange(200_000)] + keys[::-1])
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_sorted_segments_on_card_match_cpu(n_keys):
    dev = _cuda()
    rng = np.random.default_rng(n_keys)
    n = 300_007
    keys = [rng.integers(-5, 900, n).astype(np.int32) for _ in range(n_keys)]
    keys[0][::9] = PH._I32_MAX
    vals = rng.integers(-2048, 2048, n).astype(np.int32)
    iota = np.arange(n, dtype=np.int32)
    out = []
    for d in (torch.device("cpu"), dev):
        sk, perm = PH.sort_by_keys([torch.as_tensor(k, device=d)
                                    for k in keys])
        valid = sk[0] != PH._I32_MAX
        is_start, end = PH.segment_bounds(sk, valid)
        hi, lo = PH.seg_sum_pairs(torch.as_tensor(vals, device=d)[perm],
                                  torch.as_tensor(iota, device=d), end)
        s = is_start.cpu().numpy()
        out.append(([k.cpu().numpy() for k in sk], s,
                    hi.cpu().numpy()[s], lo.cpu().numpy()[s]))
    (k_cpu, s_cpu, hi_cpu, lo_cpu), (k_gpu, s_gpu, hi_gpu, lo_gpu) = out
    for a, b in zip(k_cpu, k_gpu):
        assert np.array_equal(a, b)
    assert np.array_equal(s_cpu, s_gpu)
    assert np.array_equal(hi_cpu * 4096 + lo_cpu, hi_gpu * 4096 + lo_gpu)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["q3", "q10", "join_topn", "cust_having"])
def test_topn_consumers_on_card_match_cpu(name):
    dev = _cuda()
    data = TD.generate_tpch(0.05, 7)
    tables, snaps = TR.load_tables(data, TR.JOIN_TABLES[name])
    frag = TR.JOIN_REQUESTS[name](tables)
    got = execute_fragment(CopClient(dev), frag, snaps)
    want = execute_fragment(CopClient("cpu"), frag, snaps)
    assert got.engine == want.engine
    if frag.agg is not None:
        assert TR.partial_rows(got.chunks) == TR.partial_rows(want.chunks)
        return
    for a, b in zip(TR.row_columns(got.chunks), TR.row_columns(want.chunks)):
        assert np.array_equal(a, b)
