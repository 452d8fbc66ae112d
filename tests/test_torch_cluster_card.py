"""A leader and a socket follower of the port on the card.

`test_leader_and_follower_read_alike_on_the_card`: a leader
(`Storage(path, shared=True, rpc_listen=...)`) and a socket follower in
one process, their sessions on the default device (`cuda`). TPC-H
lineitem at SF0.01 (seed 42) is bulk-loaded on the leader; `o_li` gets
two bands of its rows through the KV (INSERT ... SELECT, statements of
fewer than 8,192 rows), which is all a follower replicates. The
follower's GROUP BY answers equal the leader's and the numpy answer;
after both stores compact their deltas (`Storage.flush`), the Q18-inner
shape `GROUP BY l_orderkey HAVING sum(l_quantity) > 150` takes the rank
path (`device[hc]`) on both and launches streamseg on the follower.

`test_follower_process_runs_on_the_card`: `python -m
tidb_tpu_torch.server` started as a follower without `--device` (so on
`cuda`), `election-timeout-ms = 0`, answers over the wire with the
leader's rows, its `/metrics` counts device requests, and SIGTERM ends
it with rc 0.

Both need a CUDA device and skip elsewhere; the reference is not
imported, so they run where JAX is not installed:
`python -m pytest tests/test_torch_cluster_card.py --noconftest -m gpu`.

`test_routed_read_served_on_a_cuda_follower`: a leader session with
`tidb_replica_read = 'follower'` sends its SELECTs (a sum and a GROUP BY
HAVING over 2,000 rows written through the KV) to the follower: the
rows equal the leader's own, the engine is `replica@...`, `served`
rises by one per read, and the follower's pooled serving session runs
on `cuda` with the `device` tags, the process's device request counter
rising.

`test_promotion_on_the_card`: a leader and two followers with a 1.5 s
election timeout, all on `cuda`; the leader's RPC server closes, one
follower promotes itself to term 2 and the other repoints, writes go
on through both, and every acknowledged write reads back on both on
the card.

`test_card_scan_heat_bytes_equal_the_cpu_scan`: the keyspace heat plane
on a durable store with four ranges (split at the record keys of ids
500, 1,000 and 1,500 of a 2,000-row table): the same scans through a
`cuda` session and a `Session(device="cpu")` note the same rows and
bytes per range on `tidb_hot_ranges`.

`test_range_aware_read_served_on_a_cuda_follower`: with the range plane
armed and `range-aware` on, a covered read is served by the follower's
`cuda` session; a wedge prewrite in the table's span makes the next
read fall back `stale_fallback` with the `uncovered ... range#` Note and
the leader's exact answer; after its rollback reads route again.

`test_follower_without_a_card_fails_to_start` needs no card: with no
device visible, a follower started without `--device cpu` fails before
it joins (nothing moves to the CPU on its own).
"""

import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from mysql_client import MiniClient  # noqa: E402

from tidb_tpu_torch import obs  # noqa: E402
from tidb_tpu_torch.bench import tpch_data as TD  # noqa: E402
from tidb_tpu_torch.copr import _kernels  # noqa: E402
from tidb_tpu_torch.rpc.client import RpcOptions  # noqa: E402
from tidb_tpu_torch.rpc.errors import LeaderUnavailable  # noqa: E402
from tidb_tpu_torch.session import Session  # noqa: E402
from tidb_tpu_torch.store.storage import Storage  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = RpcOptions(connect_timeout_ms=1000, request_timeout_ms=10000,
                  backoff_budget_ms=3000, lock_budget_ms=8000,
                  lease_ms=2000)
BANDS = ((0, 1000), (10000, 11000))
HAVING = ("select l_orderkey, sum(l_quantity) from o_li group by "
          "l_orderkey having sum(l_quantity) > 150 order by l_orderkey")
FLAGS = ("select l_returnflag, count(*), sum(l_quantity) from o_li "
         "group by l_returnflag order by l_returnflag")


def _load_o_li(s) -> dict:
    """lineitem bulk-loaded, o_li written through the KV -> lineitem's
    numpy columns."""
    data = TD.generate_tpch(0.01, 42)
    TD.load_table(s, "lineitem", data["lineitem"])
    s.execute(TD.TPCH_DDL["lineitem"].replace("create table lineitem",
                                              "create table o_li"))
    for lo, hi in BANDS:
        s.execute(f"insert into o_li select * from lineitem where "
                  f"l_orderkey >= {lo} and l_orderkey < {hi}")
    return data["lineitem"]


def _having_oracle(li) -> list:
    key = np.asarray(li["l_orderkey"])
    qty = np.asarray(li["l_quantity"]).astype(np.int64)  # cents
    sel = np.zeros(len(key), bool)
    for lo, hi in BANDS:
        sel |= (key >= lo) & (key < hi)
    keys, inv = np.unique(key[sel], return_inverse=True)
    sums = np.bincount(inv, weights=qty[sel]).astype(np.int64)
    return [(int(k), int(v)) for k, v in zip(keys, sums) if v > 15000]


def _cents(rows) -> list:
    return [(int(k), int(round(float(str(v)) * 100))) for k, v in rows]


@pytest.mark.gpu
def test_leader_and_follower_read_alike_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    leader = Storage(str(tmp_path / "leader"), shared=True,
                     rpc_listen="127.0.0.1:0", rpc_options=OPTS)
    try:
        sl = Session(leader)
        li = _load_o_li(sl)
        follower = Storage(str(tmp_path / "follower"),
                           remote=f"127.0.0.1:{leader.rpc_server.port}",
                           rpc_options=OPTS)
        try:
            sf = Session(follower)
            for q in (FLAGS, HAVING):
                assert sf.execute(q).rows == sl.execute(q).rows, q
            assert _cents(sf.execute(HAVING).rows) == _having_oracle(li)
            leader.flush()
            follower.flush()
            want = sl.execute(HAVING).rows
            assert sl.last_engines == ["device[hc]"]
            before = _kernels.LAUNCHES["streamseg.rank_sums"]
            assert sf.execute(HAVING).rows == want
            assert sf.last_engines == ["device[hc]"]
            assert _kernels.LAUNCHES["streamseg.rank_sums"] > before
        finally:
            follower.close()
    finally:
        leader.close()


FOLLOWER_TOML = """host = "127.0.0.1"
[status]
report-status = true
status-host = "127.0.0.1"
[transport]
remote = "{remote}"
election-timeout-ms = 0
backoff-budget-ms = 3000
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metric_sum(text: str, family: str, label_re: str) -> float:
    return sum(float(v) for v in re.findall(
        rf'^{family}\{{{label_re}\}} (\S+)$', text, re.M))


@pytest.mark.gpu
def test_follower_process_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import urllib.request

    leader = Storage(str(tmp_path / "leader"), shared=True,
                     rpc_listen="127.0.0.1:0", rpc_options=OPTS)
    try:
        sl = Session(leader)
        sl.execute("create table t (id bigint primary key, v bigint)")
        sl.execute("insert into t values " + ",".join(
            f"({i}, {i % 7})" for i in range(2000)))
        cfg = tmp_path / "f.toml"
        cfg.write_text(FOLLOWER_TOML.format(
            remote=f"127.0.0.1:{leader.rpc_server.port}"))
        status = _free_port()
        child = subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch.server", "--config",
             str(cfg), "--path", str(tmp_path / "follower"), "-P", "0",
             "--status", str(status)],
            cwd=REPO, stdout=subprocess.PIPE, text=True)
        try:
            line = child.stdout.readline()
            assert line.startswith("tidb-tpu-server listening on"), line
            c = MiniClient("127.0.0.1", int(line.rsplit(":", 1)[1]))
            got = c.query("select count(*), sum(v) from t")
            assert got == [("2000", str(sum(i % 7 for i in range(2000))))]
            c.close()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{status}/metrics", timeout=60) as r:
                text = r.read().decode()
            assert _metric_sum(text, "tidb_copr_requests_total",
                               'engine="device[^"]*"') > 0
            child.send_signal(signal.SIGTERM)
            assert child.wait(timeout=120) == 0
            assert child.stdout.read().splitlines()[-1] == \
                "shutting down..."
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
            child.stdout.close()
    finally:
        leader.close()


def _wait_serving(leader, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not any(m.get("serving") for m in leader.rpc_server.members()
                  if m["role"] == "follower"):
        assert time.monotonic() < deadline, leader.rpc_server.members()
        time.sleep(0.05)


@pytest.mark.gpu
def test_routed_read_served_on_a_cuda_follower(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    leader = Storage(str(tmp_path / "leader"), shared=True,
                     rpc_listen="127.0.0.1:0", rpc_options=OPTS)
    try:
        sl = Session(leader)
        sl.execute("create table t (id bigint primary key, k bigint, "
                   "g bigint)")
        sl.execute("insert into t values " + ",".join(
            f"({i}, {i * 3 % 101}, {i % 13})" for i in range(2000)))
        follower = Storage(str(tmp_path / "follower"),
                           remote=f"127.0.0.1:{leader.rpc_server.port}",
                           rpc_options=OPTS)
        try:
            assert follower.device is None  # the card
            _wait_serving(leader)
            queries = ["select sum(k), count(*) from t",
                       "select g, sum(k), count(*) from t group by g "
                       "having sum(k) > 7000 order by g"]
            want = [sl.execute(q).rows for q in queries]
            sl.execute("set tidb_replica_read = 'follower'")
            for i, q in enumerate(queries):
                dev = sum(obs.COPR_REQUESTS.get(engine=e)
                          for e in ("device", "device-fragment"))
                assert sl.execute(q).rows == want[i], q
                assert sl.last_engines[0].startswith("replica@")
                assert leader.obs.replica_reads.get(
                    outcome="served") == i + 1
                sess = follower._replica_pool[-1]
                assert sess._device is None and sess._cop is not None
                assert sess._cop.device.type == "cuda"
                assert sess.last_engines[0].startswith("device")
                assert sum(obs.COPR_REQUESTS.get(engine=e)
                           for e in ("device", "device-fragment")) > dev
        finally:
            follower.close()
    finally:
        leader.close()


def _range_rows(st) -> dict:
    """range_id -> (read_rows, read_bytes) of tidb_hot_ranges."""
    return {r[0]: (r[3], r[4]) for r in st.heat.table_rows()}


def _arm_four_ranges(st, tid) -> None:
    from tidb_tpu_torch.kv import tablecodec
    st.heat.configure(enabled=True, bucket_seconds=3600)
    st.arm_ranges(enabled=True, split_points=[
        tablecodec.record_key(int(tid), h) for h in (500, 1000, 1500)],
        lease_ms=300)


@pytest.mark.gpu
def test_card_scan_heat_bytes_equal_the_cpu_scan(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    st = Storage(str(tmp_path / "s"))
    try:
        card, cpu = Session(st), Session(st, device="cpu")
        card.execute("create table h (id bigint primary key, k bigint, "
                     "c varchar(32))")
        card.execute("insert into h values " + ",".join(
            f"({i}, {i * 7 % 97}, 'c{i % 50}')" for i in range(2000)))
        st.flush()
        _arm_four_ranges(st, st.catalog.table("test", "h").id)
        queries = ["select sum(k), count(*) from h",
                   "select k, count(*) from h group by k order by k"]
        for q in queries:
            deltas = []
            for s in (card, cpu):
                before = _range_rows(st)
                rows = s.execute(q).rows
                after = _range_rows(st)
                deltas.append((rows, {rid: (after[rid][0] - before.get(
                    rid, (0, 0))[0], after[rid][1] - before.get(
                        rid, (0, 0))[1]) for rid in after}))
            assert card.last_engines[0].startswith("device")
            assert card.cop.device.type == "cuda"
            assert deltas[0] == deltas[1], q
            # four ranges overlap the table's record span
            assert len(deltas[0][1]) == 4
            assert sum(v[0] for v in deltas[0][1].values()) == 2000
            assert sum(v[1] for v in deltas[0][1].values()) > 0
    finally:
        st.close()


@pytest.mark.gpu
def test_range_aware_read_served_on_a_cuda_follower(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from tidb_tpu_torch.kv.mvcc import OP_PUT, Mutation
    from tidb_tpu_torch.kv.tablecodec import table_range
    from tidb_tpu_torch.kv.tso import TimestampOracle

    leader = Storage(str(tmp_path / "leader"), shared=True,
                     rpc_listen="127.0.0.1:0", rpc_options=OPTS)
    try:
        sl = Session(leader)
        sl.execute("create table w (id bigint primary key, k bigint)")
        sl.execute("insert into w values " + ",".join(
            f"({i}, {i % 101})" for i in range(2000)))
        want = sl.execute("select sum(k), count(*) from w").rows
        tid = leader.catalog.table("test", "w").id
        follower = Storage(str(tmp_path / "follower"),
                           remote=f"127.0.0.1:{leader.rpc_server.port}",
                           rpc_options=OPTS)
        try:
            _arm_four_ranges(leader, tid)
            leader.replica_read.range_aware = True
            _wait_serving(leader)
            sl.execute("set tidb_replica_read = 'follower'")
            reads = leader.obs.replica_reads
            assert sl.execute("select sum(k), count(*) from w").rows \
                == want
            # a `ranges@covered(...)` tag leads when the gate waited
            assert any(e.startswith("replica@") for e in sl.last_engines)
            assert reads.get(outcome="served") == 1.0
            sess = follower._replica_pool[-1]
            assert sess._cop.device.type == "cuda"
            assert sess.last_engines[0].startswith("device")
            start, _end = table_range(int(tid))
            key = start + b"\x00wedge"
            wedge_ts = TimestampOracle().ts()
            router = leader.ranges.router(options=OPTS)
            try:
                h = router.locate(key)
                router.prewrite(h, [Mutation(OP_PUT, key, b"x")], key,
                                wedge_ts, ttl=60_000)
                time.sleep(0.01)
                assert sl.execute(
                    "select sum(k), count(*) from w").rows == want
                assert reads.get(outcome="served") == 1.0
                assert reads.get(outcome="stale_fallback") >= 1.0
                assert any(e.startswith("range#")
                           for e in sl.last_engines)
                assert any(e.startswith("device") for e in sl.last_engines)
                notes = [w for w in sl.warnings if "uncovered" in w[2]]
                assert notes and "range#" in notes[0][2]
                router.rollback(h, [key], wedge_ts)
            finally:
                router.close()
            deadline = time.monotonic() + 8.0
            while reads.get(outcome="served") < 2.0:
                assert time.monotonic() < deadline
                assert sl.execute(
                    "select sum(k), count(*) from w").rows == want
                time.sleep(0.1)
        finally:
            follower.close()
    finally:
        leader.close()


@pytest.mark.gpu
def test_promotion_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    fopts = RpcOptions(**{**OPTS.__dict__, "election_timeout_ms": 1500,
                          "lease_ms": 1000})
    leader = Storage(str(tmp_path / "leader"), shared=True,
                     rpc_listen="127.0.0.1:0", rpc_options=OPTS)
    followers = []
    try:
        for i in range(2):
            followers.append(Storage(
                str(tmp_path / f"f{i}"),
                remote=f"127.0.0.1:{leader.rpc_server.port}",
                rpc_options=fopts))
        sl = Session(leader)
        sl.execute("create table t (id bigint primary key, v bigint)")
        sl.execute("insert into t values " + ",".join(
            f"({i}, {i % 7})" for i in range(1000)))
        acked = set(range(1000))
        sess = [Session(f) for f in followers]
        for s in sess:
            assert s.execute("select count(*) from t").rows == [(1000,)]
        time.sleep(1.2)  # a failover tick refreshes the voter roll
        leader.rpc_server.close()
        deadline = time.monotonic() + 60
        while not any(not f.remote for f in followers):
            assert time.monotonic() < deadline, "no promotion"
            time.sleep(0.1)
        promoted = next(f for f in followers if not f.remote)
        survivor = next(f for f in followers if f.remote)
        assert promoted.rpc_server.term == 2
        while not (survivor._rpc_client.term == 2
                   and not survivor._rpc_client.degraded):
            assert time.monotonic() < deadline, "no repoint"
            time.sleep(0.1)
        for k, f in enumerate((promoted, survivor)):
            s, until = Session(f), time.monotonic() + 5
            while True:  # a 9001 just after the repoint is retried
                try:
                    s.execute(f"insert into t values ({2000 + k}, 1)")
                    break
                except LeaderUnavailable:
                    assert time.monotonic() < until
                    time.sleep(0.1)
            acked.add(2000 + k)
        want = sorted(acked)
        for f in (promoted, survivor):
            s = Session(f)
            deadline = time.monotonic() + 30
            while [r[0] for r in s.execute(
                    "select id from t order by id").rows] != want:
                assert time.monotonic() < deadline
                time.sleep(0.1)
            assert s.execute("select count(*), sum(v) from t").rows == \
                [(1002, sum(i % 7 for i in range(1000)) + 2)]
            assert s.last_engines[0].startswith("device")
    finally:
        for f in reversed(followers):
            f.close()
        leader.close()


def test_follower_without_a_card_fails_to_start(tmp_path):
    leader = Storage(str(tmp_path / "leader"), shared=True,
                     rpc_listen="127.0.0.1:0", rpc_options=OPTS)
    try:
        cfg = tmp_path / "f.toml"
        cfg.write_text(FOLLOWER_TOML.format(
            remote=f"127.0.0.1:{leader.rpc_server.port}"))
        proc = subprocess.run(
            [sys.executable, "-m", "tidb_tpu_torch.server", "--config",
             str(cfg), "--path", str(tmp_path / "follower"), "-P", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert "listening" not in proc.stdout
        assert "CUDA device requested" in proc.stderr
        assert leader.rpc_server.client_count() == 0
    finally:
        leader.close()
