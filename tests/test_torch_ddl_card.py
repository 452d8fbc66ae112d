"""Online DDL read back on the card: TPC-H lineitem and orders at SF0.05
(seed 42) in a card `Session()` and a `Session(device="cpu")`, each over
its own in-memory store, through the same script: ADD COLUMN with a
default, MODIFY COLUMN l_quantity DECIMAL(18,4) (every stored value times
100), a unique index (its reorg batches over orders) and one that fails
with the validation's duplicate, an information_schema read, DROP COLUMN.
After each statement the two give equal outcomes, and Q1, Q6 and Q18 equal
rows and engine tags, the card's Q18 launching streamseg over the epoch
the DDL rewrote. Tolerance: none.

These tests need a CUDA device and skip elsewhere; the reference is not
imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_ddl_card.py --noconftest -m gpu`.
"""

import pytest
import torch

from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_data import generate_tpch, load_table
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

SF, SEED = 0.05, 42
RANK = "streamseg.rank_sums"

SCRIPT = [
    "ALTER TABLE lineitem ADD COLUMN l_tag INT DEFAULT 7",
    "SELECT sum(l_tag), count(*) FROM lineitem",
    "ALTER TABLE lineitem MODIFY COLUMN l_quantity DECIMAL(18,4)",
    "ANALYZE TABLE lineitem",
    "CREATE UNIQUE INDEX o_ck ON orders (o_custkey, o_orderkey)",
    "CREATE UNIQUE INDEX l_ok ON lineitem (l_orderkey)",
    "ADMIN SHOW DDL JOBS",
    "SHOW INDEX FROM orders",
    "SELECT column_name, column_type FROM information_schema.columns "
    "WHERE table_schema = 'test' AND table_name = 'lineitem' "
    "ORDER BY ordinal_position",
    "ALTER TABLE lineitem DROP COLUMN l_tag",
    "ADMIN CHECK TABLE lineitem, orders",
]


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    data = generate_tpch(SF, SEED)
    card, cpu = Session(Storage()), Session(Storage(), device="cpu")
    for s in (card, cpu):
        for name in ("lineitem", "orders", "customer"):
            load_table(s, name, data[name])
        s.execute("ANALYZE TABLE lineitem, orders, customer")
    return card, cpu


def _outcome(s, sql):
    try:
        rs = s.execute(sql)
    except Exception as e:  # the session error: errno and message
        return ("error", getattr(e, "errno", None), str(e))
    rows = rs.rows
    if sql.startswith("ADMIN SHOW DDL JOBS"):
        rows = [r[1:] for r in rows]  # job ids: a counter per process
    return (rs.affected, TR.sql_cells(rows))


def _reads(card, cpu) -> int:
    launched = 0
    for q in ("q1", "q6", "q18"):
        before = _kernels.LAUNCHES[RANK]
        rows = card.query(TPCH_QUERIES[q])
        launched += _kernels.LAUNCHES[RANK] - before
        want = cpu.query(TPCH_QUERIES[q])
        assert TR.sql_cells(rows) == TR.sql_cells(want), q
        assert card.last_engines == cpu.last_engines, q
    return launched


def _script(card, cpu) -> dict:
    """The script on both sessions: outcomes equal, and after each ALTER
    of lineitem a new epoch and the reads equal, streamseg launched."""
    assert _reads(card, cpu) > 0
    li = card.storage.table_store(card.catalog.table("test", "lineitem").id)
    out = {}
    for sql in SCRIPT:
        before = li.epoch.epoch_id
        out[sql] = _outcome(card, sql)
        assert out[sql] == _outcome(cpu, sql), sql
        if sql.startswith("ALTER TABLE lineitem"):
            assert li.epoch.epoch_id != before
            assert _reads(card, cpu) > 0  # streamseg over the new epoch
    return out


@pytest.mark.gpu
def test_ddl_script_card_equals_cpu(sessions):
    card, cpu = sessions
    out = _script(card, cpu)
    assert card.cop.device.type == "cuda"
    n = out[SCRIPT[1]][1][0]
    assert n[0] == 7 * n[1]
    # the failing unique index: the reference's errno for a rolled-back
    # job (its error re-raised by text), and no index left
    assert out[SCRIPT[5]][:2] == ("error", 1105)
    assert "Duplicate entry" in out[SCRIPT[5]][2]
    jobs = out["ADMIN SHOW DDL JOBS"][1]
    assert [(j[2], j[4]) for j in jobs[:2]] == [
        ("add_index", "rolled back"), ("add_index", "done")]
    assert "o_ck" in {r[2] for r in out["SHOW INDEX FROM orders"][1]}
    assert not any(ix.name == "l_ok" for ix in
                   card.catalog.table("test", "lineitem").indices)
