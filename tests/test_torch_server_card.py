"""The port's server process on the card.

`python -m tidb_tpu_torch.server` (its default device, `cuda`) serves a
small durable store (TPC-H SF0.05 lineitem, orders and customer, seed 42,
loaded and analyzed by a CPU session first), with TLS from the test pair
under tests/data/ and a status port: TPC-H Q18 over TLS equals the CPU
session's answer, `/metrics` shows streamseg's library looked up (the
`tidb_copr_jit_cache_total` lookups grow across the query), and SIGTERM
ends the process with rc 0 and `shutting down...`.

This test needs a CUDA device and skips elsewhere; the reference is not
imported, so it also runs where JAX is not installed:
`python -m pytest tests/test_torch_server_card.py --noconftest -m gpu`.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import urllib.request

import pytest
import torch

from mysql_client import MiniClient
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _lookups(text: str) -> int:
    """streamseg's library lookups in a /metrics exposition (hits and the
    first load's miss)."""
    return sum(int(float(v)) for v in re.findall(
        r'^tidb_copr_jit_cache_total\{result="(?:hit|miss)"\} (\S+)$',
        text, re.M))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.gpu
def test_server_process_serves_q18_over_tls_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    path = str(tmp_path / "db")
    st = Storage(path, sync_log="commit")
    s = Session(st, device="cpu")
    TD.load_tpch(s, sf=0.05, seed=42,
                 tables=["lineitem", "orders", "customer"])
    for t in ("lineitem", "orders", "customer"):
        s.execute(f"analyze table {t}")
    from tidb_tpu_torch.server.packet import render_text_value
    want = [tuple(None if (v := render_text_value(x)) is None
                  else v.decode() for x in row)
            for row in s.execute(TPCH_QUERIES["q18"]).rows]
    st.close()
    status = _free_port()
    child = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.server", "--path", path,
         "-P", "0", "--host", "127.0.0.1", "--status", str(status),
         "--ssl-cert", os.path.join(DATA, "tls_test_cert.pem"),
         "--ssl-key", os.path.join(DATA, "tls_test_key.pem")],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = child.stdout.readline()
        assert line.startswith("tidb-tpu-server listening on"), line
        port = int(line.rsplit(":", 1)[1])

        def metrics() -> str:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{status}/metrics", timeout=60) as r:
                return r.read().decode()
        before = _lookups(metrics())
        cl = MiniClient("127.0.0.1", port, use_ssl=True)
        assert cl.tls
        assert cl.query(TPCH_QUERIES["q18"]) == want
        cl.close()
        assert _lookups(metrics()) > before
        child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=120) == 0
        assert child.stdout.read().splitlines()[-1] == "shutting down..."
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
