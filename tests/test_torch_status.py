"""The port's HTTP status port against the reference's.

Each package's `Server` runs with `status_port=0` over its own store with
TPC-H at SF0.01 (seed 7) loaded, the planes armed by the same config
seeds (Top SQL, the wait profile, the workload history, a 1 s metrics
history); the same statements go to both over the wire (Q6, Q1, Q18, a
TRACE). Then every route is read from both: `/metrics` (the same
families, but the reference's that the port does not register,
`metrics_schema.UNPORTED_FAMILIES`), `/status` (the reference's sections
but those of unported planes: ranges and mesh; each section's keys),
`/slow-query`, `/statements-summary` (the same digests), the TRACE tree
of `/debug/trace/<conn>` (the same span names), and each `/debug/*`
route's keys; `/debug/failpoints` equal. The routes of unported planes
answer 501 with the queue item on the port. The status-port cases of
tests/test_observability.py, test_topsql.py, test_history.py,
test_inspection.py and test_trace.py read the same surfaces. Tolerance:
none on keys, digests, span names and codes (times are each process's).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from mysql_client import MiniClient
from test_torch_server import _close
from tidb_tpu import config as RC
from tidb_tpu.bench import tpch_data as RTD
from tidb_tpu.server import Server as RefServer
from tidb_tpu.session import Session as RefSession
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch import config as PC
from tidb_tpu_torch.bench import tpch_data as TD
from tidb_tpu_torch.bench.tpch_queries import TPCH_QUERIES
from tidb_tpu_torch.catalog.metrics_schema import UNPORTED_FAMILIES
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server.status import UNPORTED_ROUTES
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import Storage
from tidb_tpu_torch.util import failpoint as pfp
from tidb_tpu.util import failpoint as rfp

# hour-long Top SQL and history windows: the two stores' statements
# land in one window each, however slow the host
KNOBS = """
[performance]
topsql-enabled = true
topsql-window-seconds = 3600
wait-profile-enabled = true
metrics-history-interval = 1
[history]
enabled = true
window-seconds = 3600
"""


def _get(srv, route: str):
    """-> (HTTP code, body bytes)"""
    url = f"http://127.0.0.1:{srv.status_port}{route}"
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _json(srv, route: str):
    code, body = _get(srv, route)
    assert code == 200, (route, code)
    return json.loads(body)


# keys one side has by its backend or plane alone: the first-compile
# stage (the reference's XLA compile of a new program; the port compiles
# no program on the CPU) and Top SQL's per-operator mesh skew (the
# multi-device plane, ROADMAP queue 1 item 8)
_OWN_KEYS = {"compile", "op_mesh"}


def _keys(v):
    """The key structure of a JSON value: dict keys, recursively, with
    the structures of a list's elements merged, not the values."""
    if isinstance(v, dict):
        return {k: _keys(x) for k, x in v.items() if k not in _OWN_KEYS}
    if isinstance(v, list):
        out = None
        for x in v:
            out = _merge(out, _keys(x))
        return [out] if out is not None else []
    return type(v).__name__ if isinstance(v, (bool, str)) else "num"


def _merge(a, b):
    if a is None or a == []:
        return b
    if b is None or b == []:
        return a
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: _merge(a.get(k), b.get(k)) for k in a.keys() | b.keys()}
    if isinstance(a, list) and isinstance(b, list):
        return [_merge(a[0], b[0])]
    return a


def _entries(payload: dict, route: str) -> list:
    """Every digest entry of a /debug/topsql or /debug/history payload,
    whichever window holds it."""
    if route == "/debug/topsql":
        return [e for w in payload["windows"]
                for e in list(w["digests"].values()) + [w["other"]] if e]
    return payload["records"] + payload["live"]


def _servers(stores: dict) -> dict:
    return {"port": Server(stores["port"], port=0, device="cpu",
                           status_port=0, status_host="127.0.0.1"),
            "ref": RefServer(stores["ref"], port=0, status_port=0,
                             status_host="127.0.0.1")}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both stores after the wire statements (the servers that served
    them closed: each test opens its own, so no listener outlives it)."""
    path = tmp_path_factory.mktemp("status") / "knobs.toml"
    path.write_text(KNOBS)
    out = {"port": Storage(), "ref": RefStorage()}
    for name, C in (("port", PC), ("ref", RC)):
        cfg = C.Config.load(str(path))
        cfg.seed_observability(out[name])
        cfg.seed_history(out[name])
        cfg.seed_diagnostics(out[name])
    TD.load_tpch(Session(out["port"], device="cpu"), sf=0.01, seed=7,
                 tables=["lineitem", "orders", "customer"])
    RTD.load_tpch(RefSession(out["ref"]), sf=0.01, seed=7,
                  tables=["lineitem", "orders", "customer"])
    servers = _servers(out)
    for name, srv in servers.items():
        srv.start()
        c = MiniClient("127.0.0.1", srv.port)
        # every statement of this connection lands in the slow log
        c.execute("set tidb_slow_log_threshold = 0")
        answers = [c.query(TPCH_QUERIES[q]) for q in ("q6", "q1", "q18")]
        c.query("trace select count(*) from orders")
        out[name + "_wire"] = (answers, max(srv._conns),
                               srv.connection_count())
        c.close()
    _close(*servers.values())
    return out


@pytest.fixture()
def pair(stores):
    servers = _servers(stores)
    for srv in servers.values():
        srv.start()
    try:
        yield {**servers, "wire": {n: stores[n + "_wire"]
                                   for n in ("port", "ref")}}
    finally:
        _close(*servers.values())


def test_answers_equal(pair):
    port, ref = pair["wire"]["port"], pair["wire"]["ref"]
    assert port[0] == ref[0]
    assert port[1] == ref[1] and port[2] == ref[2] == 1


def test_metrics_families(pair):
    fams = []
    for name in ("ref", "port"):
        code, body = _get(pair[name], "/metrics")
        assert code == 200
        text = body.decode()
        fams.append({ln.split()[2] for ln in text.splitlines()
                     if ln.startswith("# TYPE ")})
        assert "tidb_queries_total" in text
    assert fams[1] == fams[0] - UNPORTED_FAMILIES
    assert "tidb_copr_requests_total" in fams[1]


def test_status_sections(pair):
    got = [_json(pair[n], "/status") for n in ("ref", "port")]
    assert set(got[1]) == set(got[0]) - {"mesh", "ranges"}
    for section in got[1]:
        assert _keys(got[1][section]) == _keys(got[0][section]), section
    assert got[1]["version"] == got[0]["version"]
    assert got[1]["connections"] == got[0]["connections"] == 0
    assert got[1]["top_sql"]["enabled"] is True
    digests = [{e["digest"] for e in g["top_sql"]["by_device_time"]}
               for g in got]
    assert digests[0] == digests[1] and len(digests[1]) == 5
    assert got[1]["inspection"]["rules"] == got[0]["inspection"]["rules"]


def test_statements_summary_and_slow_query(pair):
    ss = [_json(pair[n], "/statements-summary") for n in ("ref", "port")]
    assert _keys(ss[1]) == _keys(ss[0])
    assert {e["digest"] for e in ss[1]} == {e["digest"] for e in ss[0]}
    # the wire connection's statements (threshold 0); the loads' DDL
    # crosses the default 300 ms threshold on one host and not another
    wire = {TPCH_QUERIES[q] for q in ("q6", "q1", "q18")} | \
        {"trace select count(*) from orders"}
    slow = [[e for e in _json(pair[n], "/slow-query") if e["sql"] in wire]
            for n in ("ref", "port")]
    assert len(slow[0]) == len(slow[1]) == 4
    assert [e["sql"] for e in slow[0]] == [e["sql"] for e in slow[1]]
    for a, b in zip(slow[0], slow[1]):
        # the mesh skew of an entry comes with the multi-device plane
        # (ROADMAP queue 1 item 8)
        assert set(b) == set(a) - {"mesh_skew"}


def test_trace_route(pair):
    trees = []
    for n in ("ref", "port"):
        srv = pair[n]
        conn_id = pair["wire"][n][1]
        tr = _json(srv, f"/debug/trace/{conn_id}")
        assert set(tr) == {"ts", "spans"}
        # the first-compile span is each backend's own (xla.compile on
        # the reference's first run of a program)
        trees.append([r[0] for r in tr["spans"]
                      if r[0].strip().split(" ")[0] != "xla.compile"])
        assert _get(srv, "/debug/trace/9999")[0] == 404
        assert _get(srv, "/debug/trace/abc")[0] == 400
    assert trees[0] == trees[1]
    assert trees[1][0] == "session.run"


@pytest.mark.parametrize("route", [
    "/debug/metrics/history", "/debug/topsql", "/debug/waitprofile",
    "/debug/events", "/debug/inspection", "/debug/history",
    "/debug/profile?seconds=0.05&hz=200", "/debug/replicas",
])
def test_debug_route_keys(pair, route):
    got = [_json(pair[n], route) for n in ("ref", "port")]
    if route == "/debug/profile?seconds=0.05&hz=200":
        # sampled frames differ between two processes' stacks
        assert set(got[1]) == set(got[0])
        return
    if route == "/debug/metrics/history":
        # the port's sampled series are the reference's families but
        # those it does not register; labels and counts differ with
        # each process's traffic
        fams = [{k.split("{")[0] for smp in g["samples"]
                 for k in smp["values"]} for g in got]
        assert fams[1] and fams[1] <= fams[0] - UNPORTED_FAMILIES
        got = [dict(g, samples=[{k: None for k in smp}
                                for smp in g["samples"]]) for g in got]
    if route == "/debug/events":
        kinds = [{e["kind"] for e in g} for g in got]
        assert kinds[1] <= kinds[0] | {"checkpoint_stall"}
        got = [g[:1] for g in got]
    if route == "/debug/inspection":
        assert got[1]["rules"] == got[0]["rules"]
        assert [f["rule"] for f in got[1]["findings"]] == \
            [f["rule"] for f in got[0]["findings"]]
    if route == "/debug/replicas":
        # a local store: the router's knobs at their defaults, one
        # member, no routed read
        assert got[1] == got[0]
        assert got[1]["reads"] == {"served": 0.0, "stale_fallback": 0.0,
                                   "unreachable_fallback": 0.0}
    if route == "/debug/history":
        # each store's own directory (none: in memory)
        assert got[0]["dir"] == got[1]["dir"] is None
    if route in ("/debug/topsql", "/debug/history"):
        # the digests and the entries' keys, whichever window holds them
        ents = [_entries(g, route) for g in got]
        digests = [{e["digest"] for e in es} for es in ents]
        assert digests[0] == digests[1] and len(digests[1]) >= 5
        assert _keys(ents[1]) == _keys(ents[0])
        got = [{k: v for k, v in g.items()
                if k not in ("windows", "records", "live")} for g in got]
    assert _keys(got[1]) == _keys(got[0])


def test_failpoints_route(pair):
    # a declared site, armed and hit here, with a value its code never
    # reads: no statement runs a GC in this test
    for fp in (rfp, pfp):
        fp.enable("daemon/before-gc", 3)
        fp.inject("daemon/before-gc")
    try:
        got = [_json(pair[n], "/debug/failpoints") for n in ("ref", "port")]
        assert got[0]["daemon/before-gc"] == got[1]["daemon/before-gc"] \
            == {"armed": True, "value": "3", "hits": 1}
    finally:
        rfp.disable_all()
        pfp.disable_all()


# routes that answered 501 before their plane was ported: now served
# and compared with the reference's
SERVED_SINCE = {"/debug/keyviz": "the keyspace heat plane",
                "/debug/lockgraph": "the concurrency analysis plane"}


@pytest.mark.parametrize("route", sorted(set(UNPORTED_ROUTES)
                                         | set(SERVED_SINCE)))
def test_unported_routes_answer_501(pair, route):
    """The routes of unported planes answer 501 with their item; a
    route whose plane has been ported since answers the reference's
    payload."""
    if route == "/debug/lockgraph":
        # each process's checker is off here: the same keys and flag
        # (the lock registry is process-wide, so its rows are not
        # compared)
        got = [_json(pair[n], route) for n in ("ref", "port")]
        assert sorted(got[1]) == sorted(got[0]) == [
            "blocking", "cycles", "edges", "enabled", "held", "locks"]
        assert got[1]["enabled"] is got[0]["enabled"] is False
        assert got[1]["cycles"] == got[0]["cycles"] == []
        return
    if route in SERVED_SINCE:
        heats = [pair[n].storage.heat for n in ("ref", "port")]
        try:
            assert _json(pair["port"], route) == _json(pair["ref"], route)
            for h in heats:
                h.configure(enabled=True, bucket_seconds=3600)
                h.note_read(b"k", rows=3, nbytes=24)
                h.note_write([(b"k", 8), (b"m", 16)])
            got = [_json(pair[n], route) for n in ("ref", "port")]
            for g in got:
                # the bucket's start is the wall clock of each side's note
                for b in g["buckets"]:
                    b.pop("start")
            assert got[1] == got[0]
            assert got[1]["totals"] == {"1": [3, 24, 2, 24]}
            assert got[1]["heatmap"]
        finally:
            for h in heats:
                h.configure(enabled=False)
        return
    code, body = _get(pair["port"], route)
    assert code == 501
    payload = json.loads(body)
    assert payload["roadmap_item"] == UNPORTED_ROUTES[route][1]
    assert payload["route"] == route
    assert _get(pair["ref"], route)[0] == 200


def test_unknown_route_404(pair):
    for n in ("ref", "port"):
        assert _get(pair[n], "/nope")[0] == 404


def test_status_without_planes_armed():
    """A bare store: Top SQL off (an empty device view), inspection on
    with its rule count; the same keys on both."""
    port = Server(Storage(), port=0, device="cpu", status_port=0,
                  status_host="127.0.0.1")
    ref = RefServer(RefStorage(), port=0, status_port=0,
                    status_host="127.0.0.1")
    port.start()
    ref.start()
    try:
        got = [_json(s, "/status") for s in (ref, port)]
        assert got[1]["top_sql"] == got[0]["top_sql"] == \
            {"enabled": False, "by_device_time": []}
        assert got[1]["inspection"] == got[0]["inspection"]
        hist = [_json(s, "/debug/history") for s in (ref, port)]
        assert hist[0] == hist[1]
    finally:
        _close(port, ref)
    assert port._status_server is None
