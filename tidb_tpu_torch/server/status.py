"""HTTP status server: /status, /metrics, /slow-query, /debug/*.

Port of `tidb_tpu/server/status.py`, route for route, with the reference's
payload keys. Counterpart of the reference's status port (reference:
server/http_status.go:110-151 — /status JSON, /metrics Prometheus handler;
default port 10080, tidb-server/main.go:144; the pprof debug routes of
util/profile). Runs on a daemon thread beside the MySQL wire listener.

Routes:
  /metrics  this server's registry + the process-wide one (Prometheus)
  /status  version, connections, the admission gate and the governor,
      Top SQL's top digests by device time and the inspection counts
  /slow-query, /statements-summary  the slow-log ring and the digests
  /debug/trace/<conn_id>  last TRACE span tree of that connection (JSON)
  /debug/profile?seconds=0.5&hz=97  one-shot whole-process sampling
      profile: hot frames + flamegraph-style call tree (JSON)
  /debug/metrics/history  the MetricsHistory ring (JSON)
  /debug/failpoints  armed fault-injection points + hit counts (JSON)
  /debug/mesh  the mesh flight recorder: plane status, per-digest
      dispatch ring, program-build ring, per-slot memory ledger (JSON;
      never builds a mesh)
  /debug/lockgraph  the lock-order checker: instrumented locks, edges,
    cycles, blocking-under-hot-lock events, held locks (JSON)
  /debug/topsql  the Top SQL attribution windows (JSON)
  /debug/waitprofile  typed wait-state attribution windows, with the
      dominant state of each entry (JSON)
  /debug/events  the structured server event ring (JSON)
  /debug/inspection  every inspection rule over the live telemetry:
      findings + per-rule summary (JSON)
  /debug/history  the workload-history plane (JSON)
  /debug/keyviz  the keyspace heat plane ([heatmap] knobs): the time x
      range traffic matrix, per-range totals, an ASCII heatmap and the
      current hot-range / split-advisory findings (JSON; knobs only
      while heatmap.enabled is false)
  /debug/replicas  the follower read tier: router knobs, per-member
    serving/closed-timestamp state, the local apply engine, and the
    routed-read outcome counters (JSON)

Every route of the reference is served (`UNPORTED_ROUTES`, the routes
that would answer 501 with the ROADMAP item porting them, is empty).
/debug/lockgraph serves the lock-order checker's graph
(`analysis.lockcheck.debug_payload()`: enabled, locks, edges, cycles,
blocking, held). The /status sections `mesh` (`copr/mesh.status()`),
`ranges` (the range table and the hosted ranges, while [ranges] is
armed) and `transport`
(the storage's `transport_health`: mode, peer, breaker, members,
failover, replica apply) is served. Where the reference's handlers catch
every exception around a reader (the mesh section, the inspection
section and payload, the history payload, the replicas payload, the
keyviz payload), the
port does not: a reader's fault fails that request with its traceback
instead of answering with an error payload.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .. import obs

# the reference's routes whose planes are not ported: route prefix ->
# (plane, ROADMAP queue 1 item); none since the mesh plane was ported
UNPORTED_ROUTES: dict = {}


class StatusServer:
    def __init__(self, host: str, port: int, sql_server=None) -> None:
        self.sql_server = sql_server
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _bare(self, code: int) -> None:
                self.send_response(code)
                self.end_headers()

            def do_GET(self):
                for prefix, (plane, item) in UNPORTED_ROUTES.items():
                    if self.path.startswith(prefix):
                        self._send(501, json.dumps({
                            "error": "not in this slice",
                            "route": prefix, "plane": plane,
                            "roadmap_item": item}).encode(),
                            "application/json")
                        return
                server_obs = (outer.sql_server.storage.obs
                              if outer.sql_server else obs.DEFAULT)
                if self.path == "/metrics":
                    # this server's registry + the process-wide one
                    # (disjoint families: copr/device counters only);
                    # probes refresh the sampled gauges (device buffer
                    # bytes, jit entries, RSS) at scrape time
                    obs.run_gauge_probes()
                    body = (server_obs.render()
                            + obs.PROCESS_METRICS.render()).encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path == "/status":
                    body = json.dumps(outer.status(server_obs)).encode()
                    ctype = "application/json"
                elif self.path == "/slow-query":
                    body = json.dumps(server_obs.slow_queries()).encode()
                    ctype = "application/json"
                elif self.path == "/statements-summary":
                    body = json.dumps(
                        server_obs.statements.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/trace/"):
                    try:
                        conn_id = int(self.path.rsplit("/", 1)[-1])
                    except ValueError:
                        self._bare(400)
                        return
                    tr = server_obs.trace_for(conn_id)
                    if tr is None:
                        self._bare(404)
                        return
                    body = json.dumps(tr).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/metrics/history"):
                    if outer.sql_server is None:
                        self._bare(404)
                        return
                    hist = outer.sql_server.storage.metrics_history
                    body = json.dumps({
                        "interval_s": hist.interval_s,
                        "samples": hist.snapshot(),
                    }).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/topsql"):
                    # raw attribution windows (oldest first): per-digest
                    # entries with stage sums, per-operator wall/stage/
                    # transfer splits, and admission/governor outcomes
                    body = json.dumps({
                        "enabled": server_obs.topsql.enabled,
                        "window_s": server_obs.topsql.window_s,
                        "digest_cap": server_obs.topsql.digest_cap,
                        "windows": server_obs.topsql.snapshot(),
                    }).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/waitprofile"):
                    body = json.dumps(
                        _waitprofile_payload(server_obs.waitprofile)
                    ).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/events"):
                    body = json.dumps(
                        server_obs.events.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/inspection"):
                    if outer.sql_server is None:
                        self._bare(404)
                        return
                    from .. import obs_inspect
                    body = json.dumps(obs_inspect.debug_payload(
                        outer.sql_server.storage)).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/history"):
                    if outer.sql_server is None:
                        self._bare(404)
                        return
                    body = json.dumps(outer.sql_server.storage.history
                                      .debug_payload()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/keyviz"):
                    if outer.sql_server is None:
                        self._bare(404)
                        return
                    # keyspace heat plane: knobs, the time x range
                    # traffic matrix, per-range totals, the ASCII
                    # heatmap rendering, and the current hot-range /
                    # split-advisory findings
                    body = json.dumps(outer.sql_server.storage.heat
                                      .debug_payload()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/replicas"):
                    if outer.sql_server is None:
                        self._bare(404)
                        return
                    # follower read tier: router knobs, per-member
                    # serving/closed-ts state, the local apply engine,
                    # and the routed-read outcome counters
                    from ..rpc import replica as _replica
                    body = json.dumps(_replica.debug_payload(
                        outer.sql_server.storage)).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/failpoints"):
                    from ..util import failpoint
                    body = json.dumps(failpoint.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/mesh"):
                    # flight recorder + per-slot ledger; never builds a
                    # mesh as a scrape side effect
                    from ..copr import mesh as _mesh
                    body = json.dumps(_mesh.debug_payload()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/lockgraph"):
                    # the dynamic lock-order checker's graph: enabled
                    # flag, instrumented locks, observed edges, cycles,
                    # blocking-under-hot-lock events, held mirror
                    from ..analysis import lockcheck
                    body = json.dumps(lockcheck.debug_payload()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/debug/profile"):
                    q = parse_qs(urlparse(self.path).query)
                    prof = obs.profile_process(
                        seconds=_num(q, "seconds", 0.5, 0.05, 10.0),
                        hz=_num(q, "hz", 97.0, 1.0, 1000.0))
                    body = json.dumps(prof.to_dict()).encode()
                    ctype = "application/json"
                else:
                    self._bare(404)
                    return
                self._send(200, body, ctype)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def status(self, server_obs) -> dict:
        """The /status JSON: the reference's sections."""
        from . import conn as _conn
        srv = self.sql_server
        status = {
            "version": _conn.SERVER_VERSION,
            "connections": srv.connection_count() if srv else 0,
        }
        if srv is not None:
            # multi-process transport health: mode, peer, degraded flag,
            # retry counters, the rpc circuit-breaker state, members
            status["transport"] = srv.storage.transport_health()
            # overload-protection plane: admission gate occupancy/sheds
            # + governor limit/usage/kills
            status["admission"] = srv.storage.admission.stats()
            status["governor"] = srv.storage.governor.stats()
            # range-sharded write leadership: the range table plus every
            # range this process leads (id, term, closed_ts) — absent
            # while [ranges] is disabled
            plane = srv.storage.ranges
            if plane is not None:
                status["ranges"] = plane.status()
        # mesh data plane: slot count + per-slot sharded-epoch bytes
        # (never builds a mesh as a scrape side effect)
        from ..copr import mesh as _mesh
        status["mesh"] = _mesh.status()
        # top digests by device time from the continuous attribution
        # plane (empty while topsql disabled)
        status["top_sql"] = {
            "enabled": server_obs.topsql.enabled,
            "by_device_time": server_obs.topsql.top_by_device(5),
        }
        if srv is not None:
            # automated diagnosis: finding counts by severity (zero rule
            # work while diagnostics.enabled=false)
            from .. import obs_inspect
            status["inspection"] = obs_inspect.status_section(srv.storage)
        return status

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True,
                                        name="titpu-status")
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def _waitprofile_payload(wp) -> dict:
    """/debug/waitprofile: the windows (oldest first), each entry with
    its dominant wait state and that state's share of the wall."""
    wins = wp.snapshot()
    for w in wins:
        ents = list(w.get("digests", {}).values())
        if w.get("other"):
            ents.append(w["other"])
        for ent in ents:
            st, frac = wp.dominant(ent)
            ent["dominant_wait"] = st
            ent["dominant_frac"] = round(frac, 4)
    return {"enabled": wp.enabled, "window_s": wp.window_s,
            "digest_cap": wp.digest_cap, "windows": wins}


def _num(q: dict, key: str, default: float, lo: float, hi: float) -> float:
    """A finite query-string number clamped to [lo, hi], else default."""
    try:
        v = float(q[key][0])
    except (KeyError, ValueError, IndexError):
        return default
    if not math.isfinite(v):
        return default
    return min(max(v, lo), hi)
