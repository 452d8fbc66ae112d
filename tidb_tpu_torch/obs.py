"""Observability: metrics, statement digests, the slow log, spans, stages.

Port of the statement half of `tidb_tpu/obs.py`, under the same names:

* the metrics registry (`Counter`, `Gauge`, `Histogram`, `Registry`, with
  the Prometheus text exposition and the duplicate-registration guards);
  one `Observability` per `Storage` holds the statement families
  (`tidb_queries_total`, `tidb_query_errors_total`,
  `tidb_query_duration_seconds`, commits, write conflicts, connections,
  rejected connections, slow queries), the plan cache's hit, miss and
  eviction counters and the group-commit histogram and counters; the
  process-wide `PROCESS_METRICS` holds the per-stage dispatch histogram
  and the function registry's row-wise evaluations
  (`REGISTRY_ROW_EVALS`, by `func`);
* the statement record: `StatementsSummary` (literal-normalized text,
  sha256 digest, the reference's capped table), the slow-log ring
  (`record_slow`, `slow_queries`) and the ring of the last TRACE per
  connection (`record_trace`, `trace_for`);
* spans (`Span`, `SpanCollector`, `span`, `active_collector`,
  `TRACE_SPAN_CAP`): a no-op TLS read unless a TRACE statement installed
  a collector;
* stages and operators: the session installs one `StageRecorder` per
  statement; `stage(name, span_name=)` times one named stage EXCLUSIVE of
  the stages nested in it (and opens a span under TRACE), `operator`
  records one plan operator's exclusive wall time and routes the stages
  and transfer bytes opened inside it to that operator (`ops`,
  `op_bytes`); `note_engine` appends a coprocessor read's engine tag;
  `RuntimeStatsColl` is EXPLAIN ANALYZE's per-plan-node record.

What the dispatch stages mean on the port (PyTorch on one CUDA device):

* `prepare`: the host-side resolution of a request (`_prepare`);
* `staging`: building the request's device inputs, with `transfer` the
  host-to-device copies inside it (cached per epoch: a warm run has none);
* `kernel`: the request's device program as the host runs it, torch ops
  and hand-written kernels. Launches are asynchronous, as JAX's dispatch
  is, but where a program reads a value back mid-way (a size, a count)
  the host waits there: `kernel` then holds the device time up to the
  program's last such read;
* `device_get`: the copy of the results to the host, which synchronizes
  and so absorbs the device time still queued;
* `merge`: the host merge of per-tile partials;
* `compile`: the first-use build and load of a CUDA library
  (`copr/_kernels._library`): at most once per process, on the first
  streamseg launch, never on the CPU;
* `host_fallback` and `ranged`: the host tier's answer.

No stage synchronizes the device: a stage costs two `perf_counter` reads
and a dict update, as in the reference.

Left out, with the planes they belong to: Top SQL, the wait profile and
its ledger, the event log, the metrics history, the sampling profiler,
the exposition lint, the remote and graft span helpers (the RPC plane),
and the replica and device-telemetry families.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import deque
from typing import Optional

log = logging.getLogger("tidb_tpu_torch.slowlog")


class Counter:
    """A labeled monotonic counter (Prometheus counter): `inc(amount,
    **labels)`, `get(**labels)`, `samples()`."""

    __slots__ = ("name", "help", "_values", "_lock")

    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self):
        with self._lock:
            return list(self._values.items())


class Gauge:
    """A value that can go up and down (Prometheus gauge), labeled like
    Counter; `set` overwrites, `inc`/`dec` adjust."""

    __slots__ = ("name", "help", "_values", "_lock")

    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def get(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def samples(self):
        with self._lock:
            return list(self._values.items())


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative), optionally
    labeled: `observe(v, stage="kernel")` keeps one bucket series per
    label set. The default ladder has sub-millisecond buckets, where the
    dispatch stages of cached requests live."""

    BUCKETS = (0.00001, 0.00005, 0.0001, 0.00025, 0.0005,
               0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)
    __slots__ = ("name", "help", "buckets", "_series", "_lock")

    def __init__(self, name: str, help_: str, buckets=None) -> None:
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets) if buckets else self.BUCKETS
        # label tuple -> [counts list, sum, total]
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [
                    [0] * (len(self.buckets) + 1), 0.0, 0]
            s[1] += v
            s[2] += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s[0][i] += 1
                    return
            s[0][-1] += 1

    def snapshot(self, **labels):
        """(per-bucket counts, the last one past the top bound; sum;
        total) for one label set (default: unlabeled)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return [0] * (len(self.buckets) + 1), 0.0, 0
            return list(s[0]), s[1], s[2]

    def series(self):
        with self._lock:
            if not self._series:
                # a never-observed histogram renders its zero series
                return [((), [0] * (len(self.buckets) + 1), 0.0, 0)]
            return [(key, list(s[0]), s[1], s[2])
                    for key, s in sorted(self._series.items())]


def _label_name(name: str, key: tuple) -> str:
    """'name{k="v",...}' (or the bare name) for a sorted label tuple."""
    lbl = ",".join(f'{k}="{val}"' for k, val in key)
    return f"{name}{{{lbl}}}" if lbl else name


def _fmt_value(v: float) -> str:
    """Integers render as integers, other floats at full precision."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Registry:
    """Metric families by name: `counter`, `gauge` and `histogram` return
    the one registered under a name, creating it on first use, and raise
    TypeError when the name holds another type."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, make):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name} already registered as "
                    f"{type(m).__name__}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "",
                  buckets=None) -> Histogram:
        return self._get(Histogram, name,
                         lambda: Histogram(name, help_, buckets=buckets))

    def families(self) -> list[str]:
        with self._lock:
            return list(self._metrics)

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            if isinstance(m, (Counter, Gauge)):
                out.append(f"# TYPE {m.name} "
                           f"{'gauge' if isinstance(m, Gauge) else 'counter'}")
                for key, v in sorted(m.samples()):
                    out.append(f"{_label_name(m.name, key)} "
                               f"{_fmt_value(v)}")
                continue
            out.append(f"# TYPE {m.name} histogram")
            for key, counts, total_sum, total in m.series():
                extra = "".join(f',{k}="{val}"' for k, val in key)
                acc = 0
                for b, c in zip(m.buckets, counts):
                    acc += c
                    out.append(f'{m.name}_bucket{{le="{b}"{extra}}} {acc}')
                out.append(f'{m.name}_bucket{{le="+Inf"{extra}}} {total}')
                sfx = _label_name("", key)
                out.append(f"{m.name}_sum{sfx} {_fmt_value(total_sum)}")
                out.append(f"{m.name}_count{sfx} {total}")
        return "\n".join(out) + "\n"


# ---- statement digests (statements_summary) ---------------------------------

class StatementsSummary:
    """Aggregated per-digest statement statistics (the reference's
    util/stmtsummary feeding INFORMATION_SCHEMA.STATEMENTS_SUMMARY).
    Digest = the first 32 hex digits of the sha256 of the
    literal-normalized text; the table is capped at MAX_DIGESTS."""

    MAX_DIGESTS = 200
    # raw text -> normalized text memo, bounded so random-literal floods
    # cannot grow it (process-wide: normalization is a pure function)
    NORM_CACHE_CAP = 512
    _norm_cache: dict = {}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}

    @classmethod
    def normalize(cls, sql: str) -> str:
        cached = cls._norm_cache.get(sql)
        if cached is not None:
            return cached
        norm = cls._normalize_uncached(sql)
        if len(cls._norm_cache) >= cls.NORM_CACHE_CAP:
            cls._norm_cache.clear()
        cls._norm_cache[sql] = norm
        return norm

    @staticmethod
    def _normalize_uncached(sql: str) -> str:
        """Literals -> '?' through the real lexer; keywords lower-cased
        (the reference's parser.Normalize)."""
        from .sql.lexer import Lexer, TokenKind

        out: list[str] = []
        try:
            for t in Lexer(sql).tokens():
                if t.kind == TokenKind.EOF:
                    break
                if t.kind in (TokenKind.INT, TokenKind.DECIMAL,
                              TokenKind.FLOAT, TokenKind.STRING):
                    out.append("?")
                else:
                    out.append(t.text.lower()
                               if t.kind == TokenKind.KEYWORD else t.text)
        except Exception:  # a text the lexer refuses digests as itself
            return sql.strip()[:256]
        return " ".join(out)

    @classmethod
    def digest(cls, sql: str) -> tuple[str, str]:
        """(digest, normalized text) of one statement's text."""
        norm = cls.normalize(sql)
        return hashlib.sha256(norm.encode()).hexdigest()[:32], norm

    def record(self, sql: str, db: str, duration_s: float,
               rows: int = 0, failed: bool = False,
               mem_peak: int = 0, spill_count: int = 0) -> None:
        digest, norm = self.digest(sql)
        now = time.strftime("%Y-%m-%d %H:%M:%S")
        ms = duration_s * 1e3
        with self._lock:
            ent = self._entries.get(digest)
            if ent is None:
                if len(self._entries) >= self.MAX_DIGESTS:
                    # evict the least-executed digest
                    victim = min(self._entries,
                                 key=lambda k: self._entries[k]["exec_count"])
                    del self._entries[victim]
                ent = self._entries[digest] = {
                    "digest": digest, "schema_name": db,
                    "digest_text": norm[:512],
                    "sample_text": sql[:512],
                    "exec_count": 0, "errors": 0,
                    "sum_latency_ms": 0.0, "max_latency_ms": 0.0,
                    "sum_rows": 0,
                    "max_mem_bytes": 0, "sum_spill_count": 0,
                    "first_seen": now, "last_seen": now,
                }
            ent["exec_count"] += 1
            ent["errors"] += 1 if failed else 0
            ent["sum_latency_ms"] += ms
            ent["max_latency_ms"] = max(ent["max_latency_ms"], ms)
            ent["sum_rows"] += rows
            ent["max_mem_bytes"] = max(ent["max_mem_bytes"], int(mem_peak))
            ent["sum_spill_count"] += int(spill_count)
            ent["last_seen"] = now

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries.values()]


# ---- per-storage observability state -----------------------------------------

SLOW_LOG_MAX = 512
TRACE_RING_MAX = 64
DEFAULT_SLOW_THRESHOLD_MS = 300


class Observability:
    """One storage's metrics, slow log, statement summaries and TRACE
    ring, so two servers in one process keep their own counters."""

    def __init__(self) -> None:
        self.metrics = Registry()
        self.queries = self.metrics.counter(
            "tidb_queries_total", "statements executed, by type")
        self.query_errors = self.metrics.counter(
            "tidb_query_errors_total", "statements that raised")
        self.query_seconds = self.metrics.histogram(
            "tidb_query_duration_seconds", "statement wall time")
        self.commits = self.metrics.counter(
            "tidb_commits_total", "transaction commits")
        self.conflicts = self.metrics.counter(
            "tidb_write_conflicts_total", "commit-time write conflicts")
        self.connections = self.metrics.counter(
            "tidb_connections_total", "wire connections accepted")
        self.conn_rejects = self.metrics.counter(
            "tidb_server_connections_rejected_total",
            "connections rejected at the gate with errno 1040")
        self.slow_counter = self.metrics.counter(
            "tidb_slow_queries_total",
            "statements over the slow-log threshold")
        self.plan_cache_hits = self.metrics.counter(
            "tidb_plan_cache_hits_total",
            "plan cache lookups answered from the LRU (point fast "
            "plans and full physical plans)")
        self.plan_cache_misses = self.metrics.counter(
            "tidb_plan_cache_misses_total",
            "plan cache lookups that (re)planned — cold key, stale "
            "schema/stats generation, or cache disabled for the "
            "statement shape")
        self.plan_cache_evictions = self.metrics.counter(
            "tidb_plan_cache_evictions_total",
            "plan cache entries evicted at capacity "
            "(performance.plan-cache-size), least-recently-used first")
        # cross-commit group fsync (kv/mvcc.py SyncPolicy.commit_sync):
        # the mean batch size is the durable-QPS amplification over one
        # fsync
        self.group_commit_batch = self.metrics.histogram(
            "tidb_group_commit_batch_size",
            "commits made durable by one WAL fsync under "
            "sync-log=commit (group-commit rendezvous batch size)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self.group_commit_fsyncs = self.metrics.counter(
            "tidb_group_commit_fsyncs_total",
            "WAL fsync barriers paid at commit boundaries "
            "(sync-log=commit group rendezvous leaders)")
        self.group_commit_commits = self.metrics.counter(
            "tidb_group_commit_commits_total",
            "commits made durable through the group rendezvous; "
            "divided by tidb_group_commit_fsyncs_total this is the "
            "amortization factor")
        self._slow_log: deque = deque(maxlen=SLOW_LOG_MAX)
        self._slow_lock = threading.Lock()
        self.statements = StatementsSummary()
        # conn_id -> last TRACE span tree
        self._traces: dict[int, dict] = {}

    def record_slow(self, sql: str, db: str, duration_s: float,
                    plan_digest: str = "",
                    stages: Optional[dict[str, float]] = None,
                    mem_peak: int = 0, spill_count: int = 0,
                    op_wall: Optional[dict[str, float]] = None) -> None:
        """One slow-log entry (the reference's shape without the shard
        skew and the typed waits: no mesh and no wait plane here)."""
        self.slow_counter.inc()
        ent = {
            "ts": time.strftime("%Y-%m-%d %H:%M:%S"),
            "db": db,
            "duration_ms": round(duration_s * 1e3, 1),
            "sql": sql if len(sql) <= 4096 else sql[:4096] + "...",
            "plan_digest": plan_digest,
            "stages": {k: round(v * 1e3, 3)
                       for k, v in (stages or {}).items()},
            "operators": {k: round(v * 1e3, 3)
                          for k, v in (op_wall or {}).items()},
            "mem_max": int(mem_peak),
            "spill_count": int(spill_count),
        }
        with self._slow_lock:
            self._slow_log.append(ent)
        log.warning("slow query (%.1fms) db=%s: %s",
                    duration_s * 1e3, db, ent["sql"][:400],
                    extra={"slow_entry": ent})

    def slow_queries(self) -> list[dict]:
        with self._slow_lock:
            return list(self._slow_log)

    def record_trace(self, conn_id: int, rows: list) -> None:
        """Keep the last TRACE span tree per connection (the ring holds
        TRACE_RING_MAX connections, least recently traced out first)."""
        with self._slow_lock:
            self._traces.pop(conn_id, None)
            self._traces[conn_id] = {
                "ts": time.strftime("%Y-%m-%d %H:%M:%S"),
                "spans": [list(r) for r in rows],
            }
            while len(self._traces) > TRACE_RING_MAX:
                self._traces.pop(next(iter(self._traces)))

    def trace_for(self, conn_id: int) -> Optional[dict]:
        with self._slow_lock:
            return self._traces.get(conn_id)

    def render(self) -> str:
        return self.metrics.render()


# process-global metrics (one device per process), in their own registry
# so a server's exposition can concatenate both without duplicates
PROCESS_METRICS = Registry()
DISPATCH_STAGE_SECONDS = PROCESS_METRICS.histogram(
    "tidb_dispatch_stage_duration_seconds",
    "per-stage dispatch wall time (staging, compile, transfer, kernel, "
    "device_get, host_fallback), labeled by stage")
REGISTRY_ROW_EVALS = PROCESS_METRICS.counter(
    "tidb_registry_row_eval_total",
    "rows evaluated by the per-row scalar-function registry fallback "
    "(copr/funcs.py), by function — nonzero means an expression left "
    "the vectorized path (the registry-row-eval inspection rule reads "
    "this)")


# ---- cross-layer span trees (TRACE) -----------------------------------------

class Span:
    """One timed span with children; times in seconds from the
    collector's origin."""

    __slots__ = ("name", "start", "end", "children", "note")

    def __init__(self, name: str, start: float) -> None:
        self.name = name
        self.start = start
        self.end = start
        self.children: list["Span"] = []
        self.note: Optional[str] = None


_span_tls = threading.local()

TRACE_SPAN_CAP = 4096  # default; sessions override via tidb_trace_span_cap


class SpanCollector:
    """Hierarchical span collection across layers: spans are opened by
    the layer doing the work (session, planner, executor, coprocessor,
    2PC, the KV engine) and nest through a thread-local stack. Bounded:
    past `cap` spans further ones are dropped and counted."""

    def __init__(self, name: str = "trace",
                 cap: Optional[int] = None) -> None:
        self.t0 = time.perf_counter()
        self.root = Span(name, 0.0)
        self._stack = [self.root]
        self.cap = cap if cap is not None else TRACE_SPAN_CAP
        self.count = 1
        self.dropped = 0
        self._lock = threading.Lock()

    def _admit(self) -> bool:
        with self._lock:
            if self.count >= self.cap:
                self.dropped += 1
                return False
            self.count += 1
            return True

    def __enter__(self) -> "SpanCollector":
        _span_tls.coll = self
        return self

    def __exit__(self, *exc) -> None:
        self.root.end = time.perf_counter() - self.t0
        if self.dropped:
            self.root.note = f"{self.dropped} span(s) dropped at cap"
        _span_tls.coll = None

    def rows(self) -> list[tuple]:
        """(indented name, start_ms, duration_ms), depth first."""
        out: list[tuple] = []

        def walk(s: Span, depth: int) -> None:
            label = "  " * depth + s.name + (
                f" [{s.note}]" if s.note else "")
            out.append((label, round(s.start * 1e3, 3),
                        round((s.end - s.start) * 1e3, 3)))
            for c in s.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return out


class _SpanCtx:
    __slots__ = ("name", "coll", "sp")

    def __init__(self, name: str) -> None:
        self.name = name
        self.coll = getattr(_span_tls, "coll", None)
        self.sp: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        c = self.coll
        if c is None or not c._admit():
            return None
        self.sp = Span(self.name, time.perf_counter() - c.t0)
        c._stack[-1].children.append(self.sp)
        c._stack.append(self.sp)
        return self.sp

    def __exit__(self, *exc) -> None:
        c = self.coll
        if c is not None and self.sp is not None:
            self.sp.end = time.perf_counter() - c.t0
            c._stack.pop()


def span(name: str) -> _SpanCtx:
    """`with obs.span("copr.execute"):` — nests under the active
    collector's current span; a no-op (yielding None) without one."""
    return _SpanCtx(name)


def active_collector() -> Optional[SpanCollector]:
    return getattr(_span_tls, "coll", None)


# ---- dispatch-stage accounting ----------------------------------------------

_stage_tls = threading.local()
_op_tls = threading.local()


class _OpCtx:
    """One plan-operator frame: tags the thread with the operator label
    (stages and transfer bytes recorded inside attribute to it) and
    records the frame's EXCLUSIVE wall seconds (nested operator frames
    subtracted) on the active recorder."""

    __slots__ = ("label", "prev", "t0", "rec")

    def __init__(self, label: str) -> None:
        self.label = label
        self.prev = None
        self.t0 = 0.0
        self.rec = None

    def __enter__(self) -> "_OpCtx":
        self.prev = getattr(_op_tls, "label", None)
        _op_tls.label = self.label
        rec = getattr(_stage_tls, "rec", None)
        self.rec = rec
        if rec is not None:
            stack = getattr(_op_tls, "stack", None)
            if stack is None:
                stack = _op_tls.stack = []
            stack.append(0.0)  # accumulates nested-frame wall time
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _op_tls.label = self.prev
        rec = self.rec
        if rec is not None:
            dt = time.perf_counter() - self.t0
            stack = _op_tls.stack
            child = stack.pop()
            if stack:
                stack[-1] += dt
            rec.add_op_wall(self.label,
                            dt - child if dt > child else 0.0)


def operator(label: str) -> _OpCtx:
    """`with obs.operator("join"):` — attribute the enclosed work (wall
    time, dispatch stages, transfer bytes) to one plan operator."""
    return _OpCtx(label)


def note_op_bytes(nbytes: int) -> None:
    """Attribute host-to-device transfer bytes to the active operator on
    the statement's recorder (a no-op without one)."""
    rec = getattr(_stage_tls, "rec", None)
    if rec is not None:
        rec.note_bytes(nbytes)


class StageRecorder:
    """One statement's attribution. `totals` and `counts`: seconds and
    entries per stage, EXCLUSIVE of nested stages, so they add up to at
    most the instrumented wall time; `op_wall`: exclusive wall seconds
    per plan operator; `ops`: each operator's per-stage split (stages
    outside any operator frame land under '(session)'); `op_bytes`:
    host-to-device bytes per operator; `op_mesh`: per-operator shard
    balance (empty on one device); `engines`: the engine tag of each
    coprocessor read, in call order."""

    __slots__ = ("totals", "counts", "op_wall", "ops", "op_bytes",
                 "op_mesh", "engines")

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.op_wall: dict[str, float] = {}
        self.ops: dict[str, dict[str, float]] = {}
        self.op_bytes: dict[str, int] = {}
        self.op_mesh: dict[str, list] = {}
        self.engines: list[str] = []

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def add_op_wall(self, op: str, seconds: float) -> None:
        self.op_wall[op] = self.op_wall.get(op, 0.0) + seconds

    def add_op_stage(self, op: str, stage: str, seconds: float) -> None:
        d = self.ops.get(op)
        if d is None:
            d = self.ops[op] = {}
        d[stage] = d.get(stage, 0.0) + seconds

    def note_bytes(self, nbytes: int) -> None:
        op = getattr(_op_tls, "label", None) or "(session)"
        self.op_bytes[op] = self.op_bytes.get(op, 0) + int(nbytes)

    def snapshot(self) -> dict[str, float]:
        return dict(self.totals)

    def delta_since(self, before: dict[str, float]) -> dict[str, float]:
        out = {}
        for k, v in self.totals.items():
            d = v - before.get(k, 0.0)
            if d > 0:
                out[k] = d
        return out


def note_engine(tag: Optional[str]) -> None:
    """Record which engine served a coprocessor read on the statement's
    recorder."""
    if not tag:
        return
    rec = getattr(_stage_tls, "rec", None)
    if rec is not None:
        rec.engines.append(tag)


def install_stage_recorder(rec: Optional[StageRecorder]) -> None:
    _stage_tls.rec = rec


def active_stage_recorder() -> Optional[StageRecorder]:
    return getattr(_stage_tls, "rec", None)


class _StageCtx:
    """Times one stage EXCLUSIVE of the stages nested in it (a per-thread
    stack subtracts them) into the per-stage histogram and the active
    recorder, and opens a span when a TRACE collector is active (no Span
    is built otherwise)."""

    __slots__ = ("stage", "spanctx", "t0", "rec")

    def __init__(self, stage: str, span_name: Optional[str]) -> None:
        self.stage = stage
        self.spanctx = _SpanCtx(span_name or stage)
        self.rec = getattr(_stage_tls, "rec", None)
        self.t0 = 0.0

    def __enter__(self) -> Optional[Span]:
        stack = getattr(_stage_tls, "stack", None)
        if stack is None:
            stack = _stage_tls.stack = []
        stack.append(0.0)  # accumulates nested-stage wall time
        self.t0 = time.perf_counter()
        return self.spanctx.__enter__()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        self.spanctx.__exit__(*exc)
        stack = _stage_tls.stack
        child = stack.pop()
        if stack:
            stack[-1] += dt
        excl = dt - child if dt > child else 0.0
        DISPATCH_STAGE_SECONDS.observe(excl, stage=self.stage)
        if self.rec is not None:
            self.rec.add(self.stage, excl)
            self.rec.add_op_stage(
                getattr(_op_tls, "label", None) or "(session)",
                self.stage, excl)


def stage(name: str, span_name: Optional[str] = None) -> _StageCtx:
    """`with obs.stage("kernel", span_name="device.dispatch"):` — one
    named stage; a span (named `span_name`, or the stage) only under an
    active TRACE."""
    return _StageCtx(name, span_name)


_STAGE_ORDER = ("parse", "plan_build", "prepare", "staging", "transfer",
                "compile", "kernel", "device_get", "host_fallback",
                "ranged")


def fmt_stages(stages: Optional[dict[str, float]]) -> str:
    """stage dict (seconds) -> 'staging:0.12ms kernel:5.3ms ...' in a
    stable order."""
    if not stages:
        return ""
    keys = [k for k in _STAGE_ORDER if k in stages] + \
        sorted(k for k in stages if k not in _STAGE_ORDER)
    return " ".join(f"{k}:{stages[k] * 1e3:.3g}ms" for k in keys)


def fmt_stages_ms(stages_ms: Optional[dict[str, float]]) -> str:
    """fmt_stages for dicts already in milliseconds (the slow-log form)."""
    if not stages_ms:
        return ""
    return fmt_stages({k: v / 1e3 for k, v in stages_ms.items()})


def fmt_ops_ms(ops_ms: Optional[dict[str, float]]) -> str:
    """operator -> ms dict -> 'join:5.2ms scan:1.1ms ...' heaviest first."""
    if not ops_ms:
        return ""
    return " ".join(f"{k}:{v:.3g}ms" for k, v in
                    sorted(ops_ms.items(), key=lambda kv: -kv[1]))


def fmt_mesh(note: Optional[dict]) -> str:
    """A sharded dispatch's note -> the EXPLAIN ANALYZE `mesh` cell; ""
    on one device, where no dispatch leaves a note."""
    if not note:
        return ""
    rows = note.get("rows") or note.get("in") or []
    s = (f"shards={int(note.get('shards', 0))} "
         f"skew={float(note.get('skew', 0.0)):.2f} "
         f"rows=[{','.join(str(int(r)) for r in rows)}]")
    if note.get("routed"):
        s += f" routed={int(note['routed'])}"
    return s


# ---- per-statement runtime stats (EXPLAIN ANALYZE) --------------------------

class RuntimeStatsColl:
    """Per-plan-node runtime stats: inclusive wall time, output rows,
    loops, the engine that served a leaf (with the gate's reason), the
    inclusive per-stage seconds, and the shard note (None on one
    device)."""

    def __init__(self) -> None:
        self.nodes: dict[int, dict] = {}

    def record(self, plan, seconds: float, rows: int,
               engine: Optional[str] = None,
               stages: Optional[dict[str, float]] = None,
               mesh: Optional[dict] = None) -> None:
        ent = self.nodes.setdefault(id(plan), {
            "time": 0.0, "rows": 0, "loops": 0, "engine": None,
            "stages": {}, "mesh": None})
        ent["time"] += seconds
        ent["rows"] += rows
        ent["loops"] += 1
        if engine:
            ent["engine"] = engine
        if stages:
            st = ent["stages"]
            for k, v in stages.items():
                st[k] = st.get(k, 0.0) + v
        if mesh:
            ent["mesh"] = dict(mesh)

    def for_plan(self, plan) -> Optional[dict]:
        return self.nodes.get(id(plan))
