"""The coprocessor's device families on the card.

`tidb_device_buffer_bytes` (the unique bytes of the live clients' column
and mask caches) grows when a card session first stages a table and
falls when `forget_table` frees it; the first streamseg launch of the
process is a `tidb_copr_jit_cache_total` miss exactly when its CUDA
library is not loaded yet, and every later launch is a hit, with
`tidb_jit_cache_entries` counting the loaded libraries.

These tests need a CUDA device and skip elsewhere; the reference is not
imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_observe_card.py --noconftest -m gpu`.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch import obs
from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.copr import streamseg as SS
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_buffer_gauge_grows_on_staging_and_falls_after_forget():
    _card()
    st = Storage()
    s = Session(st)
    s.execute("create table bg (a bigint primary key, b bigint, c bigint)")
    rng = np.random.default_rng(5)
    s.execute("insert into bg values " + ",".join(
        f"({i},{int(v)},{i % 9})"
        for i, v in enumerate(rng.integers(0, 1000, 5000))))
    info = st.catalog.schema("test").tables["bg"]
    st.flush()  # fold the deltas into a base epoch: staged and cached
    obs.run_gauge_probes()
    before = obs.DEVICE_BUFFER_BYTES.get()
    miss0 = obs.COL_CACHE.get(result="miss")
    assert s.query("select c, sum(b) from bg group by c order by c")
    obs.run_gauge_probes()
    staged = obs.DEVICE_BUFFER_BYTES.get()
    assert obs.COL_CACHE.get(result="miss") > miss0
    assert staged > before
    assert staged <= torch.cuda.memory_allocated()
    hit0 = obs.COL_CACHE.get(result="hit")
    s.query("select c, sum(b) from bg group by c order by c")
    assert obs.COL_CACHE.get(result="hit") > hit0
    s.cop.forget_table(info.id)
    obs.run_gauge_probes()
    assert obs.DEVICE_BUFFER_BYTES.get() < staged


@pytest.mark.gpu
def test_streamseg_jit_cache_miss_then_hit():
    dev = _card()
    keys = np.repeat(np.arange(700), 3)
    meta = SS.rank_meta([keys])
    assert meta is not None and not meta["identity"]
    vals = torch.ones((2, len(keys)), dtype=torch.float32, device=dev)
    f = torch.as_tensor(meta["f"], device=dev)
    loaded = "streamseg" in _kernels._libs
    hit0 = obs.JIT_CACHE.get(result="hit")
    miss0 = obs.JIT_CACHE.get(result="miss")
    SS.rank_sums(vals, f, meta)
    if loaded:
        assert obs.JIT_CACHE.get(result="hit") == hit0 + 1
        assert obs.JIT_CACHE.get(result="miss") == miss0
    else:
        assert obs.JIT_CACHE.get(result="miss") == miss0 + 1
        assert obs.JIT_CACHE.get(result="hit") == hit0
    SS.rank_sums(vals, f, meta)
    assert obs.JIT_CACHE.get(result="hit") == \
        hit0 + (2 if loaded else 1)
    obs.run_gauge_probes()
    assert obs.JIT_CACHE_ENTRIES.get() >= 1
