"""RPC client: typed retries, timeouts, reconnect, failpoint edges.

Port of `tidb_tpu/rpc/client.py`, but for one race the reference has: a
heartbeat ping that was aimed at the old leader and fails after
`repoint` does not mark the client degraded.
Counterpart of the reference's RPC client + retry plumbing (reference:
store/tikv/client.go sendRequest, region_request.go sendReqToRegion —
every send runs under a Backoffer, transport errors reconnect and
retry as boTiKVRPC, and exhaustion surfaces the typed history). Four
failpoint sites cover the transport edges chaos tests sever:

  rpc/conn-drop      — the connection dies before the request is sent
  rpc/delay          — latency injection ahead of the send
  rpc/partial-write  — the frame tears mid-write (half a header on the
                       wire), then the connection dies
  rpc/stale-response — a duplicated earlier response arrives first and
                       must be discarded by request-id matching

Retryable failures are OS/socket errors and timeouts; application
errors (a CodedError raised by a handler) are re-raised typed and are
NEVER retried here — idempotency of the retried ops is the server's
contract (WAL appends dedup on a client-assigned sequence)."""

from __future__ import annotations

import socket
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional

from .. import obs
from ..errno import CodedError
from ..kv.backoff import BO_RPC, Backoffer, BackoffExhausted
from ..util import failpoint
from .errors import WIRE_ERRORS, LeaderUnavailable, RPCError, \
    StaleTermError
from .frame import (TRACE_KEY, FrameError, decode, encode, make_trace_ctx,
                    parse_addr, recv_frame, send_frame)


@dataclass
class RpcOptions:
    """Transport knobs (config [transport] section; reference: the
    tikv-client timeouts in config.go TiKVClient)."""

    connect_timeout_ms: int = 1000
    request_timeout_ms: int = 5000
    # per-call retry budget; exhaustion raises LeaderUnavailable with
    # the typed history
    backoff_budget_ms: int = 4000
    # mutation-lock acquisition budget (lock waits are long-lived and
    # budgeted separately from transport retries)
    lock_budget_ms: int = 30000
    # leader-granted lease horizon; heartbeats renew it, and a grant
    # whose holder missed it is force-released (fencing tokens protect
    # the WAL from the deposed holder)
    lease_ms: int = 3000
    # degraded mode: serve reads at the last replicated timestamp when
    # the leader is unreachable (writes always fail typed)
    stale_reads: bool = True
    # max bytes per wal_tail response
    tail_chunk: int = 4 << 20
    # address a follower's diag listener binds (the per-server
    # diagnostics endpoint peers query for cluster_* tables)
    diag_listen: str = "127.0.0.1:0"
    # automatic leader failover: a follower whose heartbeat has been
    # failing for this long runs the election (0 disables — followers
    # then degrade to read-only forever, the pre-failover behavior)
    election_timeout_ms: int = 0
    # address this follower serves coordination RPC on IF it wins an
    # election and promotes (the bound host:port is what surviving
    # peers repoint to, so on multi-host clusters use a routable host)
    promote_listen: str = "127.0.0.1:0"
    # circuit breaker: after this many CONSECUTIVE calls exhausted
    # their transport-retry budget, fail fast for breaker-cooldown-ms
    # instead of burning a full BO_RPC budget per call, then let ONE
    # half-open probe through — success closes the breaker, failure
    # re-opens it (0 disables; application errors never count)
    breaker_threshold: int = 3
    breaker_cooldown_ms: int = 2000


class RpcClient:
    """One logical peer connection with transparent reconnect.

    Thread-safe: one in-flight request at a time (the reference batches
    concurrent requests onto one stream, client_batch.go; serializing
    is the same correctness with less machinery). The heartbeat runs on
    its OWN socket so lease renewal never queues behind a slow call."""

    def __init__(self, addr, options: Optional[RpcOptions] = None,
                 client_id: Optional[str] = None,
                 _heartbeat: bool = True) -> None:
        self.addr = addr
        self.options = options or RpcOptions()
        self.client_id = client_id or uuid.uuid4().hex
        self._mu = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._req_id = 0
        self._last_resp: Optional[bytes] = None  # stale-response replay
        self._closed = False
        # transport health (surfaced on the status port)
        self.calls = 0
        self.retries = 0
        self.degraded = False
        self.last_contact = 0.0
        # circuit breaker state: consecutive budget-exhausted calls;
        # while >= threshold the breaker is OPEN until the cooldown
        # deadline, then HALF-OPEN (one probe call allowed through)
        self._bk_lock = threading.Lock()
        self._bk_streak = 0
        self._bk_open_until = 0.0
        self._bk_probe = False
        # structured event sink (obs.EventLog): the owning Storage
        # wires its per-server ring so trips/recoveries are queryable
        # via information_schema.tidb_events after the fact
        self.events = None
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._hb_client: Optional["RpcClient"] = None
        self._want_heartbeat = _heartbeat
        # highest cluster fencing term witnessed (hello/ping responses
        # carry it); fenced requests attach it, and a peer answering
        # with a LOWER term is a deposed leader — calls to it fail
        # typed so the caller re-resolves instead of split-braining
        self.term = 0
        # extra params the heartbeat ping carries on every beat — the
        # diag plane rides this to (re)register the follower's diag
        # listener with the leader's membership registry, so a leader
        # restart relearns the cluster shape within one lease interval
        self.ping_params: dict = {}

    # ---- connection management --------------------------------------------
    def _connect(self) -> socket.socket:
        fam, target = parse_addr(self.addr)
        s = socket.socket(fam, socket.SOCK_STREAM)
        s.settimeout(self.options.connect_timeout_ms / 1000.0)
        try:
            s.connect(target)
        except OSError:
            s.close()
            raise
        s.settimeout(self.options.request_timeout_ms / 1000.0)
        if fam == socket.AF_INET:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # ---- the call path -----------------------------------------------------
    def call(self, method: str, _budget_ms: Optional[int] = None,
             **params: Any) -> dict:
        """One request with typed-retry semantics. Transport failures
        reconnect and retry under BO_RPC until the budget is spent;
        exhaustion raises LeaderUnavailable carrying the history and
        flips the client into degraded mode."""
        self._breaker_gate(method)
        bo = Backoffer(budget_ms=_budget_ms
                       if _budget_ms is not None
                       else self.options.backoff_budget_ms)
        last: Optional[BaseException] = None
        while True:
            if self._closed:
                raise RPCError("rpc client closed")
            t0 = time.monotonic()
            try:
                try:
                    # rpc_net is the CATCH-ALL wait state: network time
                    # not already typed by a more specific enclosing
                    # frame (a 2PC phase, tso_wait, resolve_lock) —
                    # fallback=True keeps the frame a no-op under one,
                    # so the specific state owns its wire time
                    with obs.wait("rpc_net", fallback=True):
                        r = self._call_once(method, params)
                except (OSError, FrameError, FrameProtocolError):
                    raise
                except BaseException:
                    # an application error (typed handler error, stale
                    # term) rode a COMPLETED round-trip: the transport
                    # is healthy, so the breaker counts it as success
                    self._breaker_note(ok=True)
                    raise
                self.degraded = False
                self.last_contact = time.monotonic()
                self._breaker_note(ok=True)
                return r
            except (OSError, FrameError, FrameProtocolError) as e:
                # covers ConnectionError, socket.timeout, refused, reset
                last = e
                self._drop_conn()
                self.retries += 1
                try:
                    # time burned BLOCKED in connect/read timeouts
                    # counts against the same budget as the sleeps — a
                    # stalled (not refusing) leader must exhaust in
                    # ~budget wall time, not timeout x attempts
                    bo.charge(BO_RPC, time.monotonic() - t0)
                    bo.sleep(BO_RPC)
                except BackoffExhausted as exhausted:
                    self.degraded = True
                    self._breaker_note(ok=False)
                    raise LeaderUnavailable(
                        f"rpc {method} to {self.addr!r} failed: "
                        f"{last!r}; {exhausted}") from None

    # ---- circuit breaker ---------------------------------------------------
    # (reference: the client-go region-cache's store liveness slow-score
    # gate; classic Nygard breaker states). Counted per CALL, not per
    # attempt: one exhausted BO_RPC budget = one failure, so a transient
    # blip inside a single call's retry window never trips it.
    def _breaker_gate(self, method: str) -> None:
        """Raise LeaderUnavailable immediately while the breaker is
        open; claim the single half-open probe slot after cooldown."""
        if self.options.breaker_threshold <= 0:
            return
        with self._bk_lock:
            if self._bk_streak < self.options.breaker_threshold:
                return
            now = time.monotonic()
            if now < self._bk_open_until:
                wait_s = self._bk_open_until - now
            elif self._bk_probe:
                wait_s = None  # half-open, probe slot taken
            else:
                self._bk_probe = True  # this call IS the probe
                return
        obs.RPC_BREAKER_FAST_FAILS.inc()
        self.degraded = True
        if wait_s is not None:
            raise LeaderUnavailable(
                f"rpc {method} to {self.addr!r}: circuit breaker open "
                f"after {self._bk_streak} consecutive transport "
                f"failures; half-open probe in {wait_s:.2f}s")
        raise LeaderUnavailable(
            f"rpc {method} to {self.addr!r}: circuit breaker "
            f"half-open, probe already in flight")

    def _breaker_note(self, ok: bool) -> None:
        if self.options.breaker_threshold <= 0:
            return
        tripped = recovered = False
        with self._bk_lock:
            self._bk_probe = False
            if ok:
                recovered = \
                    self._bk_streak >= self.options.breaker_threshold
                self._bk_streak = 0
            else:
                self._bk_streak += 1
                if self._bk_streak >= self.options.breaker_threshold:
                    self._bk_open_until = time.monotonic() \
                        + self.options.breaker_cooldown_ms / 1000.0
                    if self._bk_streak == self.options.breaker_threshold:
                        obs.RPC_BREAKER_TRIPS.inc()
                        tripped = True
            streak = self._bk_streak  # snapshot: the event detail must
            # not re-read it unlocked (a racing call could have moved it)
        # event emission OUTSIDE the breaker lock (the sink takes its
        # own lock; no reason to nest them)
        if tripped and self.events is not None:
            self.events.record(
                "breaker_trip", severity="warn",
                detail=f"rpc to {self.addr}: {streak} "
                       f"consecutive transport failures; failing fast "
                       f"for {self.options.breaker_cooldown_ms}ms")
        elif recovered and self.events is not None:
            self.events.record(
                "breaker_recover",
                detail=f"rpc to {self.addr}: half-open probe "
                       "succeeded, breaker closed")

    def _breaker_reset(self) -> None:
        with self._bk_lock:
            self._bk_streak = 0
            self._bk_open_until = 0.0
            self._bk_probe = False

    @property
    def breaker_state(self) -> str:
        with self._bk_lock:
            if self.options.breaker_threshold <= 0 or \
                    self._bk_streak < self.options.breaker_threshold:
                return "closed"
            if time.monotonic() < self._bk_open_until:
                return "open"
            return "half-open"

    def _call_once(self, method: str, params: dict) -> dict:
        # cross-server trace propagation: under an active TRACE the
        # request carries (trace_id, parent_span_id) and the peer's span
        # rows come back in the response to be stitched under this rpc
        # span — the hop stops being an opaque wall-clock gap
        coll = obs.active_collector()
        spctx = obs.span(f"rpc.{method}")
        sp = spctx.__enter__()
        try:
            resp = self._roundtrip(method, params, coll, sp)
        finally:
            spctx.__exit__(None, None, None)
        if sp is not None and coll is not None:
            remote_rows = resp.get("sp")
            if remote_rows:
                obs.stitch_remote_rows(coll, sp, remote_rows)
        err = resp.get("err")
        if err is not None:
            cls = WIRE_ERRORS.get(err.get("type"), CodedError)
            raise cls(err.get("msg", "rpc error"),
                      errno=err.get("errno"))
        r = resp.get("r") or {}
        t = r.get("term") if isinstance(r, dict) else None
        if isinstance(t, int) and t > 0:
            if t < self.term:
                # the peer lives in a fenced epoch: a restarted deposed
                # leader. NOT retryable against this address — the
                # caller must re-resolve the current leader.
                raise StaleTermError(
                    f"peer {self.addr!r} serves term {t} but the "
                    f"cluster is at term {self.term} (deposed leader)")
            if t > self.term:
                self.term = t
        return r

    def _roundtrip(self, method: str, params: dict, coll, sp) -> dict:
        with self._mu:
            if self._sock is None:
                self._sock = self._connect()
            sock = self._sock
            # -- transport-edge failpoints (armed by chaos tests) --
            v = failpoint.inject("rpc/conn-drop")
            if v:
                self._drop_conn()
                raise ConnectionResetError("failpoint rpc/conn-drop")
            d = failpoint.inject("rpc/delay")
            if isinstance(d, (int, float)) and not isinstance(d, bool) \
                    and d > 0:
                time.sleep(float(d))
            self._req_id += 1
            req_id = self._req_id
            self.calls += 1
            req = {"id": req_id, "m": method, "p": params,
                   "c": self.client_id}
            if sp is not None and coll is not None:
                # the rpc span carries its Dapper span id; the remote
                # root notes the same id as parent_span_id, so the two
                # halves of the hop are linkable in the rendered tree
                span_id = coll.alloc_span_id()
                sp.note = f"span_id={span_id}"
                req[TRACE_KEY] = make_trace_ctx(coll.trace_id, span_id)
            payload = encode(req)
            self._send(sock, payload)
            # evaluated ONCE per request: a persistently-enabled point
            # must inject one duplicated response, not starve the real
            # read forever
            stale = failpoint.inject("rpc/stale-response")
            while True:
                if stale and self._last_resp is not None:
                    raw, stale = self._last_resp, None  # old response
                else:
                    raw = recv_frame(sock)
                try:
                    resp = decode(raw)
                except (FrameError, ValueError) as e:  # torn/corrupt
                    raise FrameProtocolError(str(e)) from None
                if not isinstance(resp, dict) \
                        or resp.get("id") != req_id:
                    # stale or duplicated response: discard and keep
                    # reading — request ids fence every reply
                    continue
                # retained only while the chaos point is armed: keeping
                # every response would pin a full tail chunk per client
                if failpoint.is_enabled("rpc/stale-response"):
                    self._last_resp = raw
                return resp

    def _send(self, sock: socket.socket, payload: bytes) -> None:
        cut = failpoint.inject("rpc/partial-write")
        if cut:
            import struct as _struct
            data = _struct.pack("<I", len(payload)) + payload
            try:
                sock.sendall(data[:max(1, len(data) // 2)])
            finally:
                self._drop_conn()
            raise ConnectionResetError("failpoint rpc/partial-write")
        send_frame(sock, payload)

    # ---- liveness ----------------------------------------------------------
    def start_heartbeat(self) -> None:
        """Lease keepalive on a dedicated socket (reference: the
        store's liveness probes; oracle lease renewal in pd.go). Ping
        failures flip `degraded`; the next success clears it — that
        transition is what lets a follower recover automatically."""
        if not self._want_heartbeat or self._hb_thread is not None:
            return
        hb = RpcClient(self.addr, self.options,
                       client_id=self.client_id, _heartbeat=False)
        self._hb_client = hb
        interval = max(0.2, self.options.lease_ms / 3000.0)

        def beat() -> None:
            while not self._hb_stop.wait(interval):
                try:
                    if hb.addr != self.addr:
                        # the parent repointed to a promoted leader:
                        # the keepalive must follow or the lease renews
                        # against the corpse
                        hb.addr = self.addr
                        hb._drop_conn()
                    hb.term = max(hb.term, self.term)
                    hb.call("ping", _budget_ms=min(
                        self.options.backoff_budget_ms, 500),
                        **self.ping_params)
                    self.term = max(self.term, hb.term)
                    self.degraded = False
                    self.last_contact = time.monotonic()
                except RPCError:
                    # covers StaleTermError too: a deposed leader's
                    # pings must read as leader loss, not liveness. A
                    # ping aimed at a leader the parent has repointed
                    # away from meanwhile says nothing about the new
                    # one: it leaves the flag alone (the reference
                    # flips it, and writes right after a repoint fail)
                    if hb.addr == self.addr:
                        self.degraded = True
            hb.close()

        self._hb_thread = threading.Thread(
            target=beat, name="titpu-rpc-heartbeat", daemon=True)
        self._hb_thread.start()

    def repoint(self, addr, term: int = 0) -> None:
        """Re-resolve this client to a newly promoted leader: swap the
        address, adopt the new term, drop the dead connection, and clear
        the degraded latch so the next call goes straight through."""
        with self._mu:
            self.addr = addr
            if term:
                self.term = max(self.term, int(term))
            self._drop_conn()
        # a fresh leader deserves a closed breaker: the open state was
        # earned by the corpse this client just stopped talking to
        self._breaker_reset()
        self.degraded = False

    def health(self) -> dict:
        return {
            "peer": str(self.addr),
            "degraded": self.degraded,
            "calls": self.calls,
            "retries": self.retries,
            "breaker": self.breaker_state,
            "breaker_fail_streak": self._bk_streak,
            "last_contact_age_s": round(
                time.monotonic() - self.last_contact, 3)
            if self.last_contact else None,
        }

    def close(self) -> None:
        self._closed = True
        self._hb_stop.set()
        hb, t = self._hb_client, self._hb_thread
        if hb is not None:
            # wake a beat blocked in connect/recv (the accept-waking
            # pattern the listeners use): mark closed and tear the
            # socket down under the hb client's own lock-free path —
            # shutdown() interrupts a blocked recv immediately
            hb._closed = True
            s = hb._sock
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        if t is not None:
            t.join(timeout=5.0)
            self._hb_thread = None
            self._hb_client = None
        with self._mu:
            self._drop_conn()


class FrameProtocolError(Exception):
    """Client-side wrapper for torn/corrupt payloads: retried like a
    connection failure (the stream is unusable either way)."""


__all__ = ["RpcClient", "RpcOptions", "FrameProtocolError"]
