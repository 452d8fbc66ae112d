"""TPC-H Q6 and Q3 as SQL text through a card `Session()` and a
`Session(device="cpu")` at SF0.1 (seed 42), loaded alike.

Rows must be equal exactly (Q3 in its ORDER BY order), engine tags too
(`device`, `device[fat]`), and Q3 must launch the streamseg kernel on the
card. These tests need a CUDA device and skip elsewhere; the reference is
not imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_sql_card.py --noconftest -m gpu`.
"""

import pytest
import torch

from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_data import TPCH_DDL, generate_tpch, load_table
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.session import Session


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    data = generate_tpch(0.1, 42)
    card, cpu = Session(), Session(device="cpu")
    for s in (card, cpu):
        for name in TPCH_DDL:
            load_table(s, name, data[name])
    return data, card, cpu


@pytest.mark.gpu
@pytest.mark.parametrize("q,tag", [("q6", "device"), ("q3", "device[fat]")])
def test_card_session_matches_cpu_session(sessions, q, tag):
    data, card, cpu = sessions
    before = _kernels.LAUNCHES["streamseg.rank_sums"]
    rows = card.query(TPCH_QUERIES[q])
    launched = _kernels.LAUNCHES["streamseg.rank_sums"] - before
    assert card.cop.device.type == "cuda"
    want = cpu.query(TPCH_QUERIES[q])
    assert card.last_engines == cpu.last_engines == [tag]
    assert TR.sql_cells(rows) == TR.sql_cells(want) == TR.sql_oracle(q, data)
    if q == "q3":
        assert launched >= 1
