"""TPC-H RF1 and Q6 through a card `Session()` against a
`Session(device="cpu")` at SF0.1 (seed 42), loaded alike.

RF1's 150 orders and their lineitems go to both sessions as 100-row
INSERTs (orders first). Between the statements and after RF1, Q6 must
give equal rows on both sides, equal to the numpy answer over the arrays
as RF1 left them, with the tag `device` (the overlay batch on the card);
every INSERT must take the `point` fast path on both. These tests need a
CUDA device and skip elsewhere; the reference is not imported, so they
also run where JAX is not installed:
`python -m pytest tests/test_torch_refresh_card.py --noconftest -m gpu`.
"""

import pytest
import torch

from tidb_tpu_torch.bench import tpch_refresh as RF
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_data import generate_tpch, load_table
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.session import Session

SF, SEED = 0.1, 42


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    data = generate_tpch(SF, SEED)
    card, cpu = Session(), Session(device="cpu")
    for s in (card, cpu):
        for name in ("lineitem", "orders", "customer", "part", "supplier"):
            load_table(s, name, data[name])
    return data, card, cpu


@pytest.mark.gpu
def test_rf1_then_q6_card_matches_cpu(sessions):
    data, card, cpu = sessions
    new = RF.rf1_rows(data, SF, SEED + 1)
    stmts = RF.rf1_statements(new, batch=100)
    half = len(stmts) // 2 + 1
    for i, sql in enumerate(stmts):
        a, b = card.execute(sql), cpu.execute(sql)
        assert a.affected == b.affected
        assert card.last_engines == cpu.last_engines == ["point"]
        if i in (half, len(stmts) - 1):
            rows, want = (s.query(TPCH_QUERIES["q6"]) for s in (card, cpu))
            assert card.cop.device.type == "cuda"
            assert card.last_engines == cpu.last_engines == ["device"]
            assert TR.sql_cells(rows) == TR.sql_cells(want)
    assert TR.sql_cells(rows) == TR.sql_oracle(
        "q6", RF.apply_rf1(data, new))
