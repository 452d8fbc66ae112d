"""A durable port store reopened on the card: TPC-H lineitem and orders at
SF0.05 (seed 42) bulk-loaded into `Storage(path, sync_log="commit")`, RF1's
orders and lineitems INSERTed through SQL, the store dropped without a
checkpoint (a crash: the engine's files released), then reopened. The
reopened store must hold the native KV engine, serve Q6 through the card
with the tag `device`, exact against the numpy answer over the arrays as
RF1 left them, and equal a CPU session over the same reopened store.

These tests need a CUDA device and skip elsewhere; the reference is not
imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_durable_card.py --noconftest -m gpu`.
"""

import pytest
import torch

from tidb_tpu_torch.bench import tpch_refresh as RF
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_data import generate_tpch, load_table
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.kv.native import NativeOrderedKV
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

SF, SEED = 0.05, 42


@pytest.fixture(scope="module")
def reopened(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    path = str(tmp_path_factory.mktemp("durable") / "db")
    data = generate_tpch(SF, SEED)
    st = Storage(path, sync_log="commit")
    s = Session(st)
    for name in ("lineitem", "orders"):
        load_table(s, name, data[name])
    new = RF.rf1_rows(data, SF, SEED + 1)
    for sql in RF.rf1_statements(new, batch=100):
        s.execute(sql)
        assert s.last_engines == ["point"]
    st.kv.kv.close()  # a crash: no checkpoint
    st2 = Storage(path, sync_log="commit")
    yield st2, RF.apply_rf1(data, new)
    st2.close()


@pytest.mark.gpu
def test_reopened_store_holds_the_native_engine(reopened):
    st, _ = reopened
    assert isinstance(st.kv.kv, NativeOrderedKV)
    li = st.table_store(st.catalog.table("test", "lineitem").id)
    assert li.epoch.num_rows > 0 and len(li.deltas) > 0


@pytest.mark.gpu
def test_reopened_store_q6_exact_on_the_card(reopened):
    st, after = reopened
    card, cpu = Session(st), Session(st, device="cpu")
    rows = card.query(TPCH_QUERIES["q6"])
    assert card.cop.device.type == "cuda"
    assert card.last_engines == ["device"]
    assert TR.sql_cells(rows) == TR.sql_oracle("q6", after)
    assert TR.sql_cells(cpu.query(TPCH_QUERIES["q6"])) == \
        TR.sql_cells(rows)
    assert cpu.last_engines == card.last_engines
