"""Registry builtins, the session functions and a non-root user read on the
card: TPC-H lineitem, orders and part at SF0.05 (seed 42) in a card
`Session()` and a `Session(device="cpu")`, each over its own in-memory
store. Every statement of a short script (SUBSTRING_INDEX as a GROUP BY
key on the dictionary path, SOUNDEX over a derived table whose filter is
pushed, DATE_FORMAT row by row over a month of shipdates, SHA2, REGEXP_LIKE,
CONV, HEX and FORMAT over ORDER BY ... LIMIT reads, JSON over a table the
script creates, FROM_UNIXTIME under two time zones, Q1 with DATE_FORMAT in
its SELECT list) gives equal outcomes, engine tags and registry row-wise
counts on the two, and no request launches streamseg. Then, on the card's
store: GET_LOCK across two card sessions, SELECT SLEEP(20) over the port's
wire server ended by KILL QUERY from a second connection (errno 1317
within 2 s, the connection's next Q6 equal to the card session's), and a
user with a column grant and a role over the wire (Q6 read, 1142 for a
column and a table outside the grants, SET ROLE widening the checks).
Tolerance: none.

These tests need a CUDA device and skip elsewhere; the reference is not
imported, so they also run where JAX is not installed:
`python -m pytest tests/test_torch_functions_card.py --noconftest -m gpu`.
"""

import threading
import time

import pytest
import torch

from mysql_client import MiniClient, MySQLError
from tidb_tpu_torch import obs
from tidb_tpu_torch.bench import tpch_requests as TR
from tidb_tpu_torch.bench.tpch_data import generate_tpch, load_table
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.copr import _kernels
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server.packet import render_text_value
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage

SF, SEED = 0.05, 42
Q6 = TPCH_QUERIES["q6"]
SCRIPT = [
    "SELECT substring_index(l_shipmode, 'A', 1) AS k, count(*) "
    "FROM lineitem GROUP BY k ORDER BY k",
    "SELECT count(*) FROM (SELECT l_shipmode FROM lineitem "
    "WHERE l_quantity < 5) t WHERE soundex(l_shipmode) = 'M400'",
    "SELECT date_format(l_shipdate, '%Y-%m') AS m, sum(l_quantity) "
    "FROM lineitem WHERE l_shipdate >= '1994-03-01' "
    "AND l_shipdate < '1994-04-01' GROUP BY m ORDER BY m",
    "SELECT o_orderkey, sha2(o_comment, 256) FROM orders "
    "WHERE o_orderkey < 1000 ORDER BY o_orderkey LIMIT 100",
    "SELECT p_partkey, regexp_like(p_name, '^forest'), "
    "conv(p_partkey, 10, 36), hex(p_name), format(p_retailprice, 1) "
    "FROM part WHERE p_partkey <= 500 ORDER BY p_partkey LIMIT 100",
    "CREATE TABLE kj (id INT PRIMARY KEY, doc JSON)",
    "INSERT INTO kj VALUES " + ", ".join(
        f"({i}, '{{\"n\": {{\"v\": {i % 7}}}, \"t\": [\"x{i % 3}\"]}}')"
        for i in range(200)),
    "SELECT count(*) FROM kj WHERE json_contains(doc, '3', '$.n.v') = 1",
    "SELECT id, json_extract(doc, '$.t[0]') FROM kj ORDER BY id LIMIT 20",
    "DROP TABLE kj",
    "SET time_zone = '+08:00'",
    "SELECT o_orderkey, from_unixtime(o_orderkey) FROM orders "
    "WHERE o_orderkey < 100 ORDER BY o_orderkey",
    "SET time_zone = 'SYSTEM'",
    "SELECT o_orderkey, from_unixtime(o_orderkey) FROM orders "
    "WHERE o_orderkey < 100 ORDER BY o_orderkey",
    TPCH_QUERIES["q1"].replace(
        "count(*) as count_order",
        "count(*) as count_order, "
        "date_format(max(l_shipdate), '%W %M %Y') as last_ship"),
]


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    data = generate_tpch(SF, SEED)
    card, cpu = Session(Storage()), Session(Storage(), device="cpu")
    for s in (card, cpu):
        for name in ("lineitem", "orders", "part"):
            load_table(s, name, data[name])
        s.execute("ANALYZE TABLE lineitem, orders, part")
    return card, cpu, data


def _row_evals() -> dict:
    return {dict(k)["func"]: v for k, v in obs.REGISTRY_ROW_EVALS.samples()}


def _outcome(s, sql):
    before = _row_evals()
    try:
        rs = s.execute(sql)
    except Exception as e:  # the session error: errno and message
        out = ("error", getattr(e, "errno", None), str(e))
    else:
        out = (rs.affected, TR.sql_cells(rs.rows), list(s.last_engines))
    after = _row_evals()
    return out, {f: v - before.get(f, 0) for f, v in after.items()
                 if v != before.get(f, 0)}


@pytest.mark.gpu
def test_registry_script_card_equals_cpu(sessions):
    card, cpu, _ = sessions
    _kernels.reset_launches()
    out = []
    for sql in SCRIPT:
        out.append(_outcome(card, sql))
        assert out[-1] == _outcome(cpu, sql), sql
        assert out[-1][0][0] != "error", (sql, out[-1])
    assert card.cop.device.type == "cuda"
    assert _kernels.LAUNCHES["streamseg.rank_sums"] == 0
    # the dictionary path counts no rows; the row-wise paths count theirs
    assert out[0][1] == {}
    assert set(out[1][1]) == {"SOUNDEX"}
    assert set(out[2][1]) == {"DATE_FORMAT"}
    assert out[7][0][1] == [(sum(1 for i in range(200) if i % 7 == 3),)]
    east, utc = out[11][0][1], out[13][0][1]
    assert [r[1][11:13] for r in east] == \
        [f"{(int(r[1][11:13]) + 8) % 24:02d}" for r in utc]


@pytest.mark.gpu
def test_user_locks_sleep_kill_and_grants_over_the_wire(sessions):
    card, _, data = sessions
    a, b = Session(card.storage), Session(card.storage)
    assert a.query("SELECT get_lock('k', 0)") == [(1,)]
    assert b.query("SELECT get_lock('k', 0)") == [(0,)]
    assert a.query("SELECT release_all_locks()") == [(1,)]
    assert b.query("SELECT get_lock('k', 0), release_all_locks()") == \
        [(1, 1)]
    srv = Server(card.storage, port=0)
    srv.start()
    try:
        ca = MiniClient("127.0.0.1", srv.port)
        cb = MiniClient("127.0.0.1", srv.port)
        ida = int(ca.query("SELECT connection_id()")[0][0])
        box = {}

        def sleeper():
            try:
                box["rows"] = ca.query("SELECT SLEEP(20)")
            except MySQLError as e:
                box["err"] = e.code

        th = threading.Thread(target=sleeper)
        th.start()
        time.sleep(0.5)
        t0 = time.monotonic()
        cb.execute(f"KILL QUERY {ida}")
        th.join(timeout=10)
        assert not th.is_alive() and time.monotonic() - t0 < 2.0
        assert box == {"err": 1317}
        want = card.query(Q6)
        assert TR.sql_cells(want) == TR.sql_oracle("q6", data)
        got = ca.query(Q6)
        assert got == [tuple(render_text_value(v).decode()
                             for v in want[0])]
        ca.close()
        cb.close()
        root = MiniClient("127.0.0.1", srv.port)
        for sql in ("CREATE USER 'kc' IDENTIFIED BY 'pw'",
                    "GRANT SELECT (l_quantity, l_extendedprice, l_discount, "
                    "l_shipdate) ON lineitem TO 'kc'",
                    "CREATE ROLE 'kc_orders'",
                    "GRANT SELECT ON test.orders TO 'kc_orders'",
                    "GRANT 'kc_orders' TO 'kc'"):
            root.execute(sql)
        kc = MiniClient("127.0.0.1", srv.port, user="kc", password="pw")
        assert kc.query(Q6) == got
        for sql in ("SELECT l_comment FROM lineitem LIMIT 1",
                    "SELECT count(*) FROM orders"):
            with pytest.raises(MySQLError) as ei:
                kc.query(sql)
            assert ei.value.code == 1142
        kc.execute("SET ROLE 'kc_orders'")
        assert kc.query("SELECT count(*) FROM orders") == \
            [(str(len(data["orders"]["o_orderkey"])),)]
        kc.close()
        root.execute("DROP USER 'kc'")
        root.execute("DROP ROLE 'kc_orders'")
        root.close()
    finally:
        srv.close(drain_timeout=0.2)
        srv.storage.metrics_history.stop()
