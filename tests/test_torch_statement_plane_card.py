"""EXPLAIN ANALYZE and TRACE on the card: TPC-H at SF0.1 (seed 42) in a
card `Session()` and a `Session(device="cpu")`, loaded alike.

Q6 and Q3 under EXPLAIN ANALYZE: plan text, `actRows` and engine tags
equal to the CPU session's (times excluded); each device leaf shows the
`kernel` and `device_get` stages, and the sum of a leaf's stages is at
most its `time_ms`. The first streamseg launch of the process (Q3's rank
path) is the `compile` stage exactly when the CUDA library was not loaded
yet, and a later launch never is. TRACE of Q6 holds `copr.execute`,
`device.dispatch` and `device.fetch`. Tolerance: exact, times excluded.

These tests need a CUDA device and skip elsewhere; the reference is not
imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_statement_plane_card.py --noconftest
-m gpu`.
"""

import pytest
import torch

from tidb_tpu_torch.bench.tpch_data import TPCH_DDL, generate_tpch, load_table
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.session import Session

RANK = "streamseg.rank_sums"


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    data = generate_tpch(0.1, 42)
    card, cpu = Session(), Session(device="cpu")
    for s in (card, cpu):
        for name in TPCH_DDL:
            load_table(s, name, data[name])
    return card, cpu


def _stages(cell: str) -> dict:
    out = {}
    for part in (cell or "").split():
        k, _, v = part.partition(":")
        out[k] = float(v.removesuffix("ms"))
    return out


def _untimed(rows) -> list:
    return [(r[0], r[1], r[3]) for r in rows]


@pytest.mark.gpu
@pytest.mark.parametrize("q", ["q6", "q3"])
def test_explain_analyze_device_leaves(sessions, q):
    card, cpu = sessions
    sql = "explain analyze " + TPCH_QUERIES[q]
    rows = card.query(sql)
    assert _untimed(rows) == _untimed(cpu.query(sql))
    leaves = [r for r in rows if r[3].startswith("device")]
    assert leaves, rows
    for r in leaves:
        st = _stages(r[4])
        assert "kernel" in st and "device_get" in st, r
        assert sum(st.values()) <= r[2] + 0.01 * len(st), r
        assert (r[5], r[6]) == ("", "")


@pytest.mark.gpu
def test_compile_only_at_the_first_launch(sessions):
    card, _ = sessions
    sql = "explain analyze " + TPCH_QUERIES["q3"]
    for first in (True, False):
        loaded = "streamseg" in _kernels._libs
        before = _kernels.LAUNCHES[RANK]
        rows = card.query(sql)
        assert _kernels.LAUNCHES[RANK] > before
        stages = set()
        for r in rows:
            stages |= set(_stages(r[4]))
        assert ("compile" in stages) == (not loaded), (first, stages)
        assert "streamseg" in _kernels._libs


@pytest.mark.gpu
def test_trace_q6_spans(sessions):
    card, _ = sessions
    ops = [r[0].strip() for r in card.query("trace " + TPCH_QUERIES["q6"])]
    for want in ("copr.execute", "device.dispatch", "device.fetch"):
        assert any(o.startswith(want) for o in ops), (want, ops)
