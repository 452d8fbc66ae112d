"""Server-wide resource governor: global memory ledger + admission gate.

Port of `tidb_tpu/util/governor.py`, whole; the kill callback is called
bare (the session's only flips flags). Counterpart of the reference's server-level overload protection:
the connection token limiter (reference: server/server.go:141
tokenLimiter capping concurrently executing statements), the
server-memory-limit kill policy of later versions (reference:
util/memory GlobalMemoryController — when the tidb-server instance
crosses `server-memory-limit`, the statement with the highest memory
usage is cancelled, with a cooldown so one pressure spike does not
massacre the whole processlist), and `max-server-connections` /
ER_CON_COUNT_ERROR 1040.

Two cooperating pieces, both owned by the Storage (one per 'cluster',
like Observability) and both thread-only (no background workers — the
ledger is evaluated at statement admission and at tracker-consume
checkpoints, so shutdown joins nothing):

  MemoryGovernor — registers every live per-statement MemTracker root.
      When `server-memory-limit` is crossed (process RSS or the tracked
      sum, whichever is higher — or the synthetic usage injected by the
      `governor/mem-pressure` failpoint, which is what makes the chaos
      suite deterministic), it cancels the heaviest *cancellable*
      running statement through the per-statement interrupt plane
      (util/interrupt.py kill flag) and stamps a kill cooldown.

  AdmissionGate — a priority-aware token bucket bounding concurrently
      EXECUTING statements (`performance.token-limit`). Point gets and
      DML outrank large analytical scans (priority from the planner's
      cost estimate); waiters queue in (priority, FIFO) order and shed
      with a typed "server busy" error after
      `performance.admission-timeout-ms` instead of piling up.

Device staging in copr/client.py makes over-admission more expensive
than on the host alone (a statement admitted past the memory limit also
pins device column-cache tensors), so the gate sits *before*
run_physical, not inside it.
"""

from __future__ import annotations

import heapq
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Optional

from . import failpoint

# statement priorities for the admission gate: point lookups and DML
# (latency-sensitive, small working sets) outrank analytical scans
PRI_POINT = 10
PRI_DML = 10
PRI_SMALL = 5
PRI_SCAN = 0

# a small scan by the planner's estimate stays latency-class
SMALL_SCAN_ROWS = 10_000

# governor poll cadence on the tracker-consume hot path: re-evaluate
# the ledger every this-many bytes of root-tracker growth
GOV_POLL_BYTES = 4 << 20


class AdmissionTimeout(Exception):
    """Typed "server busy" shed: the statement waited
    admission-timeout-ms in the execution queue without getting a
    token (reference family: 9003 ER_TIKV_SERVER_BUSY — the backoffer's
    server-busy class, surfaced here at the admission edge)."""

    errno = 9003  # ER_TIKV_SERVER_BUSY
    sqlstate = "HY000"


def _total_ram_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import os
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return 16 << 30  # last resort: assume 16 GiB


def _rss_bytes() -> int:
    try:
        import os
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        import resource
        import sys
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024


def parse_mem_limit(spec: Any, total: Optional[int] = None) -> int:
    """`performance.server-memory-limit` forms -> bytes:

        0 / "0"        disabled
        8589934592     absolute bytes
        "80%"          fraction of physical RAM
        "0.8"          same fraction, decimal form

    Raises ValueError on anything else (config.validate maps it to a
    ConfigError so typos fail at startup, matching the strict decode)."""
    if spec is None:
        return 0
    if isinstance(spec, bool):
        raise ValueError(f"invalid server-memory-limit {spec!r}")
    if isinstance(spec, int):
        if spec < 0:
            raise ValueError("server-memory-limit must be >= 0")
        return spec
    s = str(spec).strip()
    if not s:
        return 0
    if s.endswith("%"):
        frac = float(s[:-1]) / 100.0
    else:
        v = float(s)
        if v >= 1 or v == 0:
            if v != int(v):
                raise ValueError(
                    f"server-memory-limit bytes must be integral: {s!r}")
            return int(v)
        frac = v  # negatives fall through to the range check below
    if not 0 < frac <= 1:
        raise ValueError(
            f"server-memory-limit fraction out of (0, 1]: {s!r}")
    return int(frac * (total if total is not None else _total_ram_bytes()))


def plan_priority(plan) -> int:
    """Admission priority of a physical plan: point gets highest, small
    estimated scans middle, everything else (large/unknown analytical
    work) lowest — the planner cost estimate is the tiebreaker the
    "point/DML outrank large scans" policy needs."""
    from ..plan.physical import PhysPointGet, PhysTableRead

    if isinstance(plan, PhysPointGet):
        return PRI_POINT
    total = 0.0
    stack = [plan]
    while stack:
        n = stack.pop()
        if isinstance(n, PhysTableRead):
            er = getattr(n, "est_rows", None)
            if er is None:
                return PRI_SCAN  # unknown cardinality: assume large
            total += float(er)
        stack.extend(getattr(n, "children", None) or [])
    return PRI_SMALL if total <= SMALL_SCAN_ROWS else PRI_SCAN


class _NullCounter:
    def inc(self, amount: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def get(self, **labels) -> float:
        return 0.0


class MemoryGovernor:
    """Global per-server memory ledger + kill policy.

    Sessions register their per-statement MemTracker ROOT at execution
    start and unregister at ExecContext.close; the tracker's consume
    path polls `check()` every GOV_POLL_BYTES of growth (plus once at
    registration), so pressure is evaluated exactly where memory is
    being acquired, with no background thread to leak."""

    def __init__(self, metrics=None, limit_bytes: int = 0,
                 cooldown_ms: int = 1000) -> None:
        self._lock = threading.Lock()
        self._entries: dict[int, dict] = {}
        self._next_token = 0
        self.limit_bytes = int(limit_bytes)
        self.cooldown_ms = int(cooldown_ms)
        self._last_kill = -1e18  # monotonic; epoch-distant past
        self._kill_count = 0     # metrics-independent (stats())
        self._last_usage = 0
        if metrics is not None:
            self.kills = metrics.counter(
                "tidb_governor_kills_total",
                "statements cancelled by the server memory governor")
            self.usage_gauge = metrics.gauge(
                "tidb_governor_memory_usage_bytes",
                "server memory usage at the governor's last evaluation")
            self.stmts_gauge = metrics.gauge(
                "tidb_governor_statements",
                "statements registered with the memory governor")
        else:
            self.kills = _NullCounter()
            self.usage_gauge = _NullCounter()
            self.stmts_gauge = _NullCounter()
        self.usage_gauge.set(0)
        self.stmts_gauge.set(0)
        # structured event sink (obs.EventLog) — the Storage wires its
        # per-server ring here so kills are explainable after the fact
        self.events = None

    def configure(self, limit_bytes: Optional[int] = None,
                  cooldown_ms: Optional[int] = None) -> None:
        if limit_bytes is not None:
            self.limit_bytes = int(limit_bytes)
        if cooldown_ms is not None:
            self.cooldown_ms = int(cooldown_ms)

    # ---- ledger ------------------------------------------------------------
    def register(self, tracker, kill: Callable[[], None],
                 label: str = "", conn_id: int = 0,
                 cancellable: bool = True) -> int:
        """Add a live statement's root tracker; returns the token for
        unregister(). `kill` runs OFF the statement's own thread (the
        thread that tripped the limit) — it must only flip flags, like
        Session._governor_kill does."""
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._entries[token] = {
                "token": token, "tracker": tracker, "kill": kill,
                "label": label, "conn_id": conn_id,
                "cancellable": bool(cancellable), "killed": False,
            }
            self.stmts_gauge.set(len(self._entries))
        tracker.governor = self
        # pressure is evaluated at admission too: a new statement
        # arriving into an already-over-limit server triggers the kill
        # without waiting for anyone to allocate more
        self.check()
        return token

    def unregister(self, token: int) -> None:
        with self._lock:
            e = self._entries.pop(token, None)
            self.stmts_gauge.set(len(self._entries))
        if e is not None:
            e["tracker"].governor = None

    @staticmethod
    def _weight(tracker) -> int:
        fp = getattr(tracker, "footprint", None)
        return int(fp()) if fp is not None \
            else max(int(tracker.consumed), 0)

    def tracked_bytes(self) -> int:
        with self._lock:
            entries = list(self._entries.values())
        return sum(self._weight(e["tracker"]) for e in entries)

    def current_usage(self) -> int:
        """Server memory usage: the `governor/mem-pressure` failpoint's
        synthetic value when armed (deterministic chaos), else the
        higher of process RSS and the tracked working-set sum."""
        v = failpoint.inject("governor/mem-pressure")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            usage = int(v)
        else:
            usage = max(_rss_bytes(), self.tracked_bytes())
        self._last_usage = usage
        self.usage_gauge.set(usage)
        return usage

    # ---- kill policy -------------------------------------------------------
    def check(self) -> bool:
        """Evaluate the ledger; cancel the heaviest cancellable
        statement when over limit and outside the kill cooldown.
        Returns True when a kill was issued."""
        if self.limit_bytes <= 0:
            return False
        usage = self.current_usage()
        if usage <= self.limit_bytes:
            return False
        now = time.monotonic()
        with self._lock:
            if (now - self._last_kill) * 1000.0 < self.cooldown_ms:
                return False
            cands = [e for e in self._entries.values()
                     if e["cancellable"] and not e["killed"]]
            if not cands:
                return False
            # heaviest first; ties go to the earliest-registered so the
            # choice is deterministic under equal mock trackers
            victim = max(cands,
                         key=lambda e: (self._weight(e["tracker"]),
                                        -e["token"]))
            victim["killed"] = True
            self._last_kill = now
            self._kill_count += 1
        self.kills.inc()
        if self.events is not None:
            self.events.record(
                "governor_kill", severity="warn",
                conn_id=victim["conn_id"],
                detail=f"usage {usage} > server-memory-limit "
                       f"{self.limit_bytes}; killed weight "
                       f"{self._weight(victim['tracker'])}: "
                       f"{victim['label']}")
        # the kill callback only flips the victim session's flags
        victim["kill"]()
        return True

    def stats(self) -> dict:
        with self._lock:
            n = len(self._entries)
            kills = self._kill_count
        return {
            "limit_bytes": self.limit_bytes,
            "usage_bytes": self._last_usage,
            "statements": n,
            "kills": kills,
            "cooldown_ms": self.cooldown_ms,
        }


class AdmissionGate:
    """Priority-aware token bucket over concurrently executing
    statements (reference: server/server.go:141 tokenLimiter, upgraded
    with a priority queue and a bounded wait).

    tokens <= 0 means unlimited (the embedded default — tests and
    benches construct thousands of stores; only the serving config
    arms the gate). Waiters park on one Condition and admit strictly
    in (priority desc, arrival) order; a waiter that outlives
    `timeout_ms` removes itself and sheds with AdmissionTimeout."""

    def __init__(self, metrics=None, tokens: int = 0,
                 timeout_ms: int = 10000) -> None:
        self._cv = threading.Condition()
        self.tokens = int(tokens)
        self.timeout_ms = int(timeout_ms)
        self._running = 0
        self._waiters: list[list] = []  # heap of [-pri, seq, alive]
        self._depth = 0
        self._seq = 0
        self._admitted_count = 0  # metrics-independent (stats())
        self._shed_count = 0
        if metrics is not None:
            self.admitted = metrics.counter(
                "tidb_admission_admitted_total",
                "statements admitted through the execution gate")
            self.shed = metrics.counter(
                "tidb_admission_shed_total",
                "statements shed at admission-timeout (server busy)")
            self.depth_gauge = metrics.gauge(
                "tidb_admission_queue_depth",
                "statements waiting for an execution token")
            self.running_gauge = metrics.gauge(
                "tidb_admission_running",
                "statements holding an execution token")
        else:
            self.admitted = _NullCounter()
            self.shed = _NullCounter()
            self.depth_gauge = _NullCounter()
            self.running_gauge = _NullCounter()
        self.depth_gauge.set(0)
        self.running_gauge.set(0)
        # structured event sink (obs.EventLog), wired by the Storage
        self.events = None

    def configure(self, tokens: Optional[int] = None,
                  timeout_ms: Optional[int] = None) -> None:
        with self._cv:
            if tokens is not None:
                self.tokens = int(tokens)
            if timeout_ms is not None:
                self.timeout_ms = int(timeout_ms)
            self._cv.notify_all()

    def _prune(self) -> None:
        while self._waiters and not self._waiters[0][2]:
            heapq.heappop(self._waiters)

    def acquire(self, priority: int = 0,
                timeout_s: Optional[float] = None,
                info: Optional[dict] = None) -> bool:
        """Returns True when a token is now held (release() owed),
        False when the gate is unlimited; raises AdmissionTimeout on
        shed. `info` ({conn_id, sql}) attributes the shed event to the
        statement that was turned away."""
        try:
            return self._acquire(priority, timeout_s)
        except AdmissionTimeout as e:
            # event emission OUTSIDE the gate's condition lock: a shed
            # storm is exactly when the gate is contended, and the
            # ring/counter work must not serialize admitters behind it
            if self.events is not None:
                sql = str((info or {}).get("sql", ""))[:128]
                self.events.record(
                    "admission_shed", severity="warn",
                    conn_id=int((info or {}).get("conn_id", 0) or 0),
                    detail=str(e) + (f"; shed: {sql}" if sql else ""))
            raise

    def _acquire(self, priority: int,
                 timeout_s: Optional[float]) -> bool:
        with self._cv:
            if self.tokens <= 0:
                return False
            if self._running < self.tokens and self._depth == 0:
                self._running += 1
                self._admitted_count += 1
                self.admitted.inc()
                self.running_gauge.set(self._running)
                return True
            self._seq += 1
            ent = [-int(priority), self._seq, True]
            heapq.heappush(self._waiters, ent)
            self._depth += 1
            self.depth_gauge.set(self._depth)
            budget = timeout_s if timeout_s is not None \
                else self.timeout_ms / 1000.0
            deadline = time.monotonic() + budget
            try:
                while True:
                    if self.tokens <= 0:
                        return False  # reconfigured to unlimited
                    self._prune()
                    if self._running < self.tokens and self._waiters \
                            and self._waiters[0] is ent:
                        heapq.heappop(self._waiters)
                        self._running += 1
                        self._admitted_count += 1
                        self.admitted.inc()
                        self.running_gauge.set(self._running)
                        # the next-highest waiter may also fit
                        self._cv.notify_all()
                        return True
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._shed_count += 1
                        self.shed.inc()
                        raise AdmissionTimeout(
                            f"Server is busy: no execution token within "
                            f"{int(budget * 1000)}ms (token-limit "
                            f"{self.tokens}, {self._running} executing, "
                            f"{self._depth} queued)")
                    self._cv.wait(remaining)
            finally:
                ent[2] = False
                self._prune()
                self._depth -= 1
                self.depth_gauge.set(self._depth)

    def release(self) -> None:
        with self._cv:
            if self._running > 0:
                self._running -= 1
            self.running_gauge.set(self._running)
            self._cv.notify_all()

    @contextmanager
    def admit(self, priority: int = 0,
              timeout_s: Optional[float] = None,
              info: Optional[dict] = None):
        held = self.acquire(priority, timeout_s, info)
        try:
            yield
        finally:
            if held:
                self.release()

    def stats(self) -> dict:
        with self._cv:
            return {
                "token_limit": self.tokens,
                "timeout_ms": self.timeout_ms,
                "running": self._running,
                "queue_depth": self._depth,
                "admitted": self._admitted_count,
                "shed": self._shed_count,
            }


__all__ = ["MemoryGovernor", "AdmissionGate", "AdmissionTimeout",
           "parse_mem_limit", "plan_priority",
           "PRI_POINT", "PRI_DML", "PRI_SMALL", "PRI_SCAN",
           "GOV_POLL_BYTES"]
