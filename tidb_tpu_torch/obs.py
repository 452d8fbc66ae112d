"""Observability: metrics, statement digests, the slow log, spans, stages,
the attribution planes, the metrics history and the profiler.

Port of `tidb_tpu/obs.py`, under the same names:

* the metrics registry (`Counter`, `Gauge`, `Histogram`, `Registry`, with
  the Prometheus text exposition, the duplicate-registration guards and
  `flat_samples`, whose 'name{k="v"}' keys `split_sample_name` parses);
  one `Observability` per `Storage` holds the statement families
  (`tidb_queries_total`, `tidb_query_errors_total`,
  `tidb_query_duration_seconds`, commits, write conflicts, connections,
  rejected connections, slow queries), the plan cache's hit, miss and
  eviction counters, the group-commit histogram and counters, and three
  planes, each off by default and free while off (`record()` returns
  before it takes a lock): Top SQL (`TopSQL`, windowed per-digest
  attribution of wall time, stages, operators, bytes, sheds and kills),
  the wait profile (`WaitProfile`, windowed per-digest typed waits) and
  the structured event ring (`EventLog`, always on, with
  `tidb_server_events_total`);
* the process-wide `PROCESS_METRICS`: the dispatch-stage histogram, the
  coprocessor's requests by engine, fragment fallbacks by reason,
  column-cache and jit-cache lookups, the registry's row-wise
  evaluations (`REGISTRY_ROW_EVALS`), the wait and backoff families,
  profiler samples, and the device-telemetry gauges, which the gauge
  probes (`register_gauge_probe`, `run_gauge_probes`) refresh before
  every sample; `MetricsHistory` keeps a bounded ring of those samples
  (one per Storage, its thread started by the server and joined by
  `Storage.close`);
* the statement record: `StatementsSummary` (literal-normalized text,
  sha256 digest, the reference's capped table), the slow-log ring
  (`record_slow`, `slow_queries`, with the statement's typed waits) and
  the ring of the last TRACE per connection (`record_trace`,
  `trace_for`);
* spans (`Span`, `SpanCollector`, `span`, `active_collector`,
  `TRACE_SPAN_CAP`): a no-op TLS read unless a TRACE statement installed
  a collector;
* stages and operators: the session installs one `StageRecorder` per
  statement; `stage(name, span_name=)` times one named stage EXCLUSIVE of
  the stages nested in it (and opens a span under TRACE), `operator`
  records one plan operator's exclusive wall time and routes the stages
  and transfer bytes opened inside it to that operator (`ops`,
  `op_bytes`); `note_engine` appends a coprocessor read's engine tag;
  `RuntimeStatsColl` is EXPLAIN ANALYZE's per-plan-node record;
* the wait ledger: `wait(state)` frames and `note_wait` charges, with
  exclusive accounting, feed `tidb_wait_seconds` and its counter twin
  always and the statement's `WaitLedger` while the wait profile is on
  (`fmt_waits` renders EXPLAIN ANALYZE's `wait_profile` cell);
* the host sampling profiler (`Profile`, `SamplingProfiler`,
  `profile_process`) behind @@profiling, and the exposition lint
  (`lint_metrics`).

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

What the device families mean on the port:

* `tidb_copr_jit_cache_total` counts lookups of a hand-written kernel's
  CUDA library in `copr/_kernels._library`: the first build and load of
  a library is a miss, every later lookup a hit (the port has no program
  cache; this is the meaning the `compile` stage has), and
  `tidb_jit_cache_entries` is the number of libraries loaded;
* `tidb_device_transfer_bytes` adds up the bytes the coprocessor client
  uploads (`CopClient._upload`);
* `tidb_device_buffer_bytes` is the unique bytes of every live client's
  column and mask caches, each tensor counted by its storage's
  `untyped_storage().nbytes()` once per storage pointer.

The RPC plane's pieces live here as in the reference: the Dapper-style
trace identity of a collector (`trace_id`, `alloc_span_id`), the remote
span helpers (`run_remote_traced` on the serving side,
`stitch_remote_rows` on the calling side, `graft_collector` for the
cluster fan-out's worker threads), the RPC breaker counters and the
follower read tier's families (`replica_reads`, `apply_lag`) and the
range plane's (`RANGE_LEADERS`, `RANGE_TRANSFERS`,
`RANGE_ORPHAN_RESOLUTIONS`, `RANGE_SPLITS`; the heat families are the
storage's, `obs_heat.py`).

Left out, with the plane it belongs to: the mesh families, and the
per-device label of the buffer gauge (one device).
"""

from __future__ import annotations

import copy
import hashlib
import logging
import os
import threading
import time
import uuid
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


def split_sample_name(name: str, family: str) -> Optional[str]:
    """Inverse of _label_name for one family: 'fam{k="v"}' -> 'k="v"',
    bare 'fam' -> '', a sample of any other family -> None. The one
    parser of the flattened-sample convention: metrics_schema and the
    inspection rules both read `flat_samples` through it."""
    if name == family:
        return ""
    if name.startswith(family + "{") and name.endswith("}"):
        return name[len(family) + 1:-1]
    return None


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

    def flat_samples(self) -> list[tuple[str, float]]:
        """Counter and gauge samples flattened to ('name{l="v"}', value)
        pairs: what the metrics history samples (histograms stay on the
        exposition)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: list[tuple[str, float]] = []
        for m in metrics:
            if isinstance(m, (Counter, Gauge)):
                out.extend((_label_name(m.name, key), v)
                           for key, v in m.samples())
        return out

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

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# ---- Top SQL: continuous per-digest resource attribution --------------------

class TopSQL:
    """Windowed per-digest resource attribution (reference: TiDB's Top
    SQL — util/topsql collecting per-statement CPU/exec metrics into
    time buckets keyed by SQL digest, resource attribution that runs in
    PRODUCTION, not only under EXPLAIN ANALYZE).

    Shape: a ring of `n_windows` time buckets, each holding a digest ->
    entry map capped at `digest_cap`; statements past the cap fold into
    one "(other)" overflow entry so a digest storm cannot grow the map.
    Every completed statement feeds one record() with its wall time,
    per-stage dispatch seconds (the statement's StageRecorder), per-operator
    wall/stage/transfer attribution, rows, and admission/governor
    outcomes.

    Disabled (the default) it is ZERO allocation on the statement path:
    record() returns before touching the lock or building anything, and
    the session call site checks `enabled` before assembling arguments.
    Thread-safe: one lock guards the ring; entries are plain dicts
    mutated under it."""

    DEFAULT_WINDOW_S = 60
    DEFAULT_WINDOWS = 6
    DEFAULT_DIGEST_CAP = 50
    OTHER = "(other)"
    STMT = "(stmt)"
    SESSION_OP = "(session)"

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 n_windows: int = DEFAULT_WINDOWS,
                 digest_cap: int = DEFAULT_DIGEST_CAP,
                 enabled: bool = False) -> None:
        self.enabled = bool(enabled)
        self.window_s = max(float(window_s), 1.0)
        self.digest_cap = max(int(digest_cap), 1)
        self._lock = threading.Lock()
        self._buckets: deque = deque(maxlen=max(int(n_windows), 1))

    def configure(self, enabled: Optional[bool] = None,
                  window_s: Optional[float] = None,
                  digest_cap: Optional[int] = None,
                  n_windows: Optional[int] = None) -> None:
        """Apply the performance.topsql-* config knobs (safe while
        running; a shrunk ring drops the oldest windows)."""
        if enabled is not None:
            self.enabled = bool(enabled)
        if window_s is not None:
            self.window_s = max(float(window_s), 1.0)
        if digest_cap is not None:
            self.digest_cap = max(int(digest_cap), 1)
        if n_windows is not None:
            with self._lock:
                self._buckets = deque(self._buckets,
                                      maxlen=max(int(n_windows), 1))

    def _bucket_locked(self, now: float) -> dict:
        win = int(now - (now % self.window_s))
        for b in reversed(self._buckets):
            if b["start"] == win:
                return b
        last = self._buckets[-1] if self._buckets else None
        if last is not None and win < last["start"]:
            # clock went backwards past the ring: charge the newest
            # window rather than resurrecting evicted history
            return last
        b = {"start": win, "digests": {}, "other": None}
        self._buckets.append(b)
        return b

    @staticmethod
    def _new_entry(digest: str, digest_text: str, db: str) -> dict:
        return {"digest": digest, "digest_text": digest_text,
                "schema_name": db, "exec_count": 0, "errors": 0,
                "sum_wall_s": 0.0, "max_wall_s": 0.0, "sum_rows": 0,
                "sheds": 0, "kills": 0,
                "stages": {}, "op_wall": {}, "op_stages": {},
                "op_bytes": {}, "waits": {}}

    def record(self, digest: str, digest_text: str, db: str,
               wall_s: float, stages: Optional[dict] = None,
               op_wall: Optional[dict] = None,
               op_stages: Optional[dict] = None,
               op_bytes: Optional[dict] = None,
               rows: int = 0, failed: bool = False, shed: bool = False,
               killed: bool = False,
               waits: Optional[dict] = None,
               now: Optional[float] = None) -> None:
        if not self.enabled:
            return
        ts = time.time() if now is None else float(now)
        with self._lock:
            b = self._bucket_locked(ts)
            ent = b["digests"].get(digest)
            if ent is None:
                if len(b["digests"]) < self.digest_cap:
                    ent = b["digests"][digest] = self._new_entry(
                        digest, digest_text, db)
                else:
                    # overflow: fold into the bucket's "(other)" entry
                    if b["other"] is None:
                        b["other"] = self._new_entry(
                            self.OTHER, self.OTHER, "")
                    ent = b["other"]
            ent["exec_count"] += 1
            ent["errors"] += 1 if failed else 0
            ent["sheds"] += 1 if shed else 0
            ent["kills"] += 1 if killed else 0
            ent["sum_wall_s"] += wall_s
            ent["max_wall_s"] = max(ent["max_wall_s"], wall_s)
            ent["sum_rows"] += int(rows)
            if stages:
                st = ent["stages"]
                for k, v in stages.items():
                    st[k] = st.get(k, 0.0) + v
            if op_wall:
                ow = ent["op_wall"]
                for k, v in op_wall.items():
                    ow[k] = ow.get(k, 0.0) + v
            if op_stages:
                target = ent["op_stages"]
                for op, d in op_stages.items():
                    td = target.setdefault(op, {})
                    for k, v in d.items():
                        td[k] = td.get(k, 0.0) + v
            if op_bytes:
                ob = ent["op_bytes"]
                for k, v in op_bytes.items():
                    ob[k] = ob.get(k, 0) + int(v)
            if waits:
                # typed wait-state split — what makes a window
                # attributable to its dominant wait state
                tw = ent.setdefault("waits", {})
                for k, v in waits.items():
                    tw[k] = tw.get(k, 0.0) + v

    def snapshot(self) -> list[dict]:
        """Deep-copied buckets, oldest first."""
        with self._lock:
            return [copy.deepcopy(b) for b in self._buckets]

    def clear(self) -> None:
        with self._lock:
            self._buckets.clear()

    @staticmethod
    def attributed_seconds(ent: dict) -> float:
        """Statement seconds attributed to SOMETHING named: exclusive
        per-operator wall plus the dispatch stages recorded outside any
        operator frame (plan_build et al under '(session)'). Operator
        wall and op-stage splits overlap by construction (the stages
        are the split OF the operator wall), so only the session-scoped
        stages add."""
        return sum(ent["op_wall"].values()) + sum(
            ent["op_stages"].get(TopSQL.SESSION_OP, {}).values())

    def table_rows(self) -> list[list]:
        """information_schema.tidb_top_sql rows: newest window first,
        digests by total wall desc; per digest one '(stmt)' summary row
        then one row per operator (heaviest first)."""
        rows: list[list] = []
        for b in reversed(self.snapshot()):
            win = time.strftime("%Y-%m-%d %H:%M:%S",
                                time.localtime(b["start"]))
            ents = sorted(b["digests"].values(),
                          key=lambda e: -e["sum_wall_s"])
            if b["other"] is not None:
                ents.append(b["other"])
            for e in ents:
                attributed = self.attributed_seconds(e)
                # dominant wait state of the digest's window: which
                # typed wait (if any) owned the wall — 'state:frac'
                dst, dfrac = WaitProfile.dominant(e)
                dom = f"{dst}:{dfrac:.2f}" if dst else ""
                rows.append([
                    win, e["digest"], e["digest_text"], self.STMT,
                    e["exec_count"], round(e["sum_wall_s"] * 1e3, 3),
                    round(attributed * 1e3, 3),
                    sum(e["op_bytes"].values()),
                    fmt_stages(e["stages"])[:256], e["sum_rows"],
                    e["sheds"], e["kills"],
                    0.0, dom])
                ops = dict(e["op_wall"])
                sess = e["op_stages"].get(self.SESSION_OP)
                if sess:
                    ops[self.SESSION_OP] = sum(sess.values())
                for op in sorted(ops, key=lambda o: -ops[o]):
                    rows.append([
                        win, e["digest"], e["digest_text"], op,
                        e["exec_count"], round(e["sum_wall_s"] * 1e3, 3),
                        round(ops[op] * 1e3, 3),
                        e["op_bytes"].get(op, 0),
                        fmt_stages(e["op_stages"].get(op))[:256],
                        e["sum_rows"], e["sheds"], e["kills"],
                        0.0, ""])
        return rows

    def top_by_device(self, n: int = 5) -> list[dict]:
        """Top digests by device time (kernel + device_get stage sums)
        across the whole ring — the /status quick view. Reduces to
        scalars directly under the lock instead of deep-copying the
        ring: monitoring pollers hit this every few seconds and must
        not lengthen the lock hold against the statement feed."""
        acc: dict[str, dict] = {}
        with self._lock:
            for b in self._buckets:
                ents = list(b["digests"].values())
                if b["other"] is not None:
                    ents.append(b["other"])
                for e in ents:
                    dev = e["stages"].get("kernel", 0.0) + \
                        e["stages"].get("device_get", 0.0)
                    a = acc.get(e["digest"])
                    if a is None:
                        a = acc[e["digest"]] = {
                            "digest": e["digest"],
                            "digest_text": e["digest_text"],
                            "exec_count": 0, "device_ms": 0.0,
                            "wall_ms": 0.0, "transfer_bytes": 0}
                    a["exec_count"] += e["exec_count"]
                    a["device_ms"] += dev * 1e3
                    a["wall_ms"] += e["sum_wall_s"] * 1e3
                    a["transfer_bytes"] += sum(e["op_bytes"].values())
        out = sorted(acc.values(), key=lambda a: -a["device_ms"])[:n]
        for a in out:
            a["device_ms"] = round(a["device_ms"], 3)
            a["wall_ms"] = round(a["wall_ms"], 3)
        return out


# ---- wait-state profile: windowed per-digest wait attribution ---------------

class WaitProfile:
    """Windowed per-digest typed-wait attribution — the continuous
    (production, not only EXPLAIN ANALYZE) aggregation of WaitLedger
    totals, same ring shape as TopSQL: `n_windows` time buckets, each a
    digest -> entry map capped at `digest_cap` with an "(other)"
    overflow fold. Feeds information_schema.tidb_wait_profile, the
    /debug/waitprofile endpoint and the dominant-wait inspection rule.

    Disabled (the default) it is ZERO cost on the statement path:
    record() returns before the lock, and the session neither installs
    a WaitLedger nor assembles arguments (performance.wait-profile-
    enabled arms it, SIGHUP-hot-reloadable)."""

    DEFAULT_WINDOW_S = 60
    DEFAULT_WINDOWS = 6
    DEFAULT_DIGEST_CAP = 50
    OTHER = "(other)"

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 n_windows: int = DEFAULT_WINDOWS,
                 digest_cap: int = DEFAULT_DIGEST_CAP,
                 enabled: bool = False) -> None:
        self.enabled = bool(enabled)
        self.window_s = max(float(window_s), 1.0)
        self.digest_cap = max(int(digest_cap), 1)
        self._lock = threading.Lock()
        self._buckets: deque = deque(maxlen=max(int(n_windows), 1))

    def configure(self, enabled: Optional[bool] = None,
                  window_s: Optional[float] = None,
                  digest_cap: Optional[int] = None,
                  n_windows: Optional[int] = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if window_s is not None:
            self.window_s = max(float(window_s), 1.0)
        if digest_cap is not None:
            self.digest_cap = max(int(digest_cap), 1)
        if n_windows is not None:
            with self._lock:
                self._buckets = deque(self._buckets,
                                      maxlen=max(int(n_windows), 1))

    def _bucket_locked(self, now: float) -> dict:
        win = int(now - (now % self.window_s))
        for b in reversed(self._buckets):
            if b["start"] == win:
                return b
        last = self._buckets[-1] if self._buckets else None
        if last is not None and win < last["start"]:
            return last
        b = {"start": win, "digests": {}, "other": None}
        self._buckets.append(b)
        return b

    @staticmethod
    def _new_entry(digest: str, digest_text: str, db: str) -> dict:
        return {"digest": digest, "digest_text": digest_text,
                "schema_name": db, "exec_count": 0,
                "sum_wall_s": 0.0, "waits": {}}

    def record(self, digest: str, digest_text: str, db: str,
               wall_s: float, waits: dict,
               now: Optional[float] = None) -> None:
        if not self.enabled:
            return
        ts = time.time() if now is None else float(now)
        with self._lock:
            b = self._bucket_locked(ts)
            ent = b["digests"].get(digest)
            if ent is None:
                if len(b["digests"]) < self.digest_cap:
                    ent = b["digests"][digest] = self._new_entry(
                        digest, digest_text, db)
                else:
                    if b["other"] is None:
                        b["other"] = self._new_entry(
                            self.OTHER, self.OTHER, "")
                    ent = b["other"]
            ent["exec_count"] += 1
            ent["sum_wall_s"] += wall_s
            w = ent["waits"]
            for k, v in waits.items():
                w[k] = w.get(k, 0.0) + v

    def snapshot(self) -> list[dict]:
        """Deep-copied buckets, oldest first."""
        with self._lock:
            return [copy.deepcopy(b) for b in self._buckets]

    def clear(self) -> None:
        with self._lock:
            self._buckets.clear()

    @staticmethod
    def dominant(ent: dict) -> tuple[str, float]:
        """(state, fraction-of-wall) of the entry's heaviest wait state
        — what the dominant-wait inspection rule and the TopSQL
        attribution column read. ('', 0.0) when nothing waited."""
        waits = ent.get("waits") or {}
        if not waits or ent.get("sum_wall_s", 0.0) <= 0:
            return "", 0.0
        state = max(waits, key=lambda k: waits[k])
        return state, min(waits[state] / ent["sum_wall_s"], 1.0)

    def table_rows(self) -> list[list]:
        """information_schema.tidb_wait_profile rows: newest window
        first, digests by total wall desc, one row per wait state
        (heaviest first)."""
        rows: list[list] = []
        for b in reversed(self.snapshot()):
            win = time.strftime("%Y-%m-%d %H:%M:%S",
                                time.localtime(b["start"]))
            ents = sorted(b["digests"].values(),
                          key=lambda e: -e["sum_wall_s"])
            if b["other"] is not None:
                ents.append(b["other"])
            for e in ents:
                wall = e["sum_wall_s"]
                waits = e["waits"]
                for st in sorted(waits, key=lambda k: -waits[k]):
                    frac = waits[st] / wall if wall > 0 else 0.0
                    rows.append([
                        win, e["digest"], e["digest_text"],
                        e["schema_name"], e["exec_count"],
                        round(wall * 1e3, 3), st,
                        round(waits[st] * 1e3, 3),
                        round(min(frac, 1.0), 4)])
        return rows


# ---- structured server event log --------------------------------------------

class EventLog:
    """Bounded ring of structured server events (reference: TiDB logs
    these as structured log lines; here they are queryable after the
    fact): governor kills, admission sheds, rpc breaker trips,
    elections/promotions, checkpoint/fsync stalls — each with conn and
    digest attribution where the producer has it, so the governor's
    and the admission gate's protective actions are explainable after
    the fact."""

    DEFAULT_CAP = 512

    def __init__(self, cap: int = DEFAULT_CAP, metrics=None) -> None:
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(cap), 1))
        self._seq = 0
        if metrics is not None:
            self.counter = metrics.counter(
                "tidb_server_events_total",
                "structured server events recorded, by kind")
        else:
            self.counter = None

    def configure(self, cap: Optional[int] = None) -> None:
        if cap:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(int(cap), 1))

    def record(self, kind: str, detail: str = "",
               severity: str = "info", conn_id: int = 0,
               digest: str = "") -> None:
        ent = {
            "ts": time.strftime("%Y-%m-%d %H:%M:%S"),
            "unix": round(time.time(), 3),
            "kind": str(kind)[:32],
            "severity": str(severity)[:8],
            "conn_id": int(conn_id),
            "digest": str(digest)[:32],
            "detail": str(detail)[:512],
        }
        with self._lock:
            self._seq += 1
            ent["id"] = self._seq
            self._ring.append(ent)
        if self.counter is not None:
            self.counter.inc(kind=ent["kind"])

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# ---- per-storage observability state -----------------------------------------

SLOW_LOG_MAX = 512
TRACE_RING_MAX = 64
DEFAULT_SLOW_THRESHOLD_MS = 300


class Observability:
    """One storage's metrics, slow log, statement summaries, TRACE ring,
    Top SQL, wait profile and event ring, so two servers in one process
    keep their own counters."""

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
        # follower read tier (rpc/apply.py): routed-read outcomes on
        # the router's server, apply lag on the replica's (leaders
        # report 0 lag)
        self.replica_reads = self.metrics.counter(
            "tidb_replica_reads_total",
            "snapshot reads routed to follower replicas, by outcome "
            "(served / stale_fallback / unreachable_fallback)")
        self.apply_lag = self.metrics.gauge(
            "tidb_follower_apply_lag_seconds",
            "age of this follower's applied/closed timestamp (how far "
            "behind the leader the serving replica runs; feeds the "
            "follower-apply-lag inspection rule)")
        self._slow_log: deque = deque(maxlen=SLOW_LOG_MAX)
        self._slow_lock = threading.Lock()
        self.statements = StatementsSummary()
        # conn_id -> last TRACE span tree
        self._traces: dict[int, dict] = {}
        # continuous per-digest resource attribution, off by default
        self.topsql = TopSQL()
        # structured server event ring (governor kills, admission sheds,
        # checkpoint and fsync stalls, plan changes)
        self.events = EventLog(metrics=self.metrics)
        # windowed per-digest typed-wait attribution, off by default
        self.waitprofile = WaitProfile()

    def record_slow(self, sql: str, db: str, duration_s: float,
                    plan_digest: str = "",
                    stages: Optional[dict[str, float]] = None,
                    mem_peak: int = 0, spill_count: int = 0,
                    op_wall: Optional[dict[str, float]] = None,
                    waits: Optional[dict[str, float]] = None) -> None:
        """One slow-log entry, in the reference's shape less the shard
        skew (no mesh here): digest, stages, operator walls, working-set
        peak and spills, and the typed waits (ms)."""
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
            "waits": {k: round(v * 1e3, 3)
                      for k, v in (waits or {}).items()},
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
COPR_REQUESTS = PROCESS_METRICS.counter(
    "tidb_copr_requests_total",
    "coprocessor executions, by engine (device / host fallback)")
FRAG_FALLBACKS = PROCESS_METRICS.counter(
    "tidb_copr_fragment_fallbacks_total",
    "device-fragment gate rejections, by reason")
DISPATCH_STAGE_SECONDS = PROCESS_METRICS.histogram(
    "tidb_dispatch_stage_duration_seconds",
    "per-stage dispatch wall time (staging, compile, transfer, kernel, "
    "device_get, host_fallback), labeled by stage")
COL_CACHE = PROCESS_METRICS.counter(
    "tidb_copr_column_cache_total",
    "device column-staging cache lookups, by result (hit / miss)")
JIT_CACHE = PROCESS_METRICS.counter(
    "tidb_copr_jit_cache_total",
    "compiled-kernel cache lookups, by result (hit / miss)")
PROFILER_SAMPLES = PROCESS_METRICS.counter(
    "tidb_profiler_samples_total",
    "stack samples taken by the host sampling profiler")
REGISTRY_ROW_EVALS = PROCESS_METRICS.counter(
    "tidb_registry_row_eval_total",
    "rows evaluated by the per-row scalar-function registry fallback "
    "(copr/funcs.py), by function — nonzero means an expression left "
    "the vectorized path (the registry-row-eval inspection rule reads "
    "this)")
# rpc circuit breaker (rpc/client.py): process-wide like the copr
# counters — every RpcClient in this process reports here, and the
# breaker state itself is per-client on /status transport_health
RPC_BREAKER_TRIPS = PROCESS_METRICS.counter(
    "tidb_rpc_breaker_trips_total",
    "circuit-breaker opens after consecutive transport failures")
RPC_BREAKER_FAST_FAILS = PROCESS_METRICS.counter(
    "tidb_rpc_breaker_fast_failures_total",
    "calls failed fast by an open rpc circuit breaker")

# range-sharded write leadership (rpc/ranged.py): process-wide like the
# breaker counters — a process may host several RangeServers (tests do),
# so the gauge moves by inc/dec per leadership open/drop rather than set
RANGE_LEADERS = PROCESS_METRICS.gauge(
    "tidb_range_leaders",
    "ranges whose write leadership this process currently holds")
RANGE_TRANSFERS = PROCESS_METRICS.counter(
    "tidb_range_transfers_total",
    "range leadership acquisitions that deposed a different owner "
    "(term bumps; steady renewal never counts)")
RANGE_ORPHAN_RESOLUTIONS = PROCESS_METRICS.counter(
    "tidb_range_orphan_resolutions_total",
    "orphan percolator locks rolled forward or back via primary-status "
    "check after a coordinator crash")
RANGE_SPLITS = PROCESS_METRICS.counter(
    "tidb_range_splits_total",
    "online range splits completed, by trigger (manual = operator "
    "range_split RPC, auto = heat-advisory actuator)")

# the wait-state plane: process-wide, as the Backoffer and the sync
# policy have no Storage in reach. The histogram carries the
# distribution per typed state; its counter twin is the metrics_schema
# view of accumulated wait seconds (histograms stay on the exposition)
WAIT_SECONDS = PROCESS_METRICS.histogram(
    "tidb_wait_seconds",
    "exclusive statement wait time by typed state (tso_wait, "
    "lease_wait, backoff.{kind}, rpc_net, prewrite, commit_primary, "
    "commit_secondary, resolve_lock, fsync_wait)")
WAIT_SECONDS_TOTAL = PROCESS_METRICS.counter(
    "tidb_wait_total_seconds",
    "accumulated exclusive wait seconds by typed state — the "
    "SQL-queryable twin of the tidb_wait_seconds histogram (named "
    "total_seconds, not seconds_total, so the counter family never "
    "prefix-collides with the histogram's sample names)")
BACKOFF_SECONDS = PROCESS_METRICS.histogram(
    "tidb_backoff_seconds",
    "Backoffer sleep time by backoff kind (txnLock, txnConflict, "
    "regionMiss, metaConflict, tsoWait, tikvRPC)")
BACKOFF_EVENTS = PROCESS_METRICS.counter(
    "tidb_backoff_events_total",
    "Backoffer sleeps taken, by backoff kind — each typed sleep "
    "reports here instead of silently time.sleep-ing")

# device telemetry (one device per process): transfer bytes accumulate
# on the dispatch path; buffer bytes, loaded kernel libraries and RSS
# are set by the gauge probes right before every sample
DEVICE_TRANSFER_BYTES = PROCESS_METRICS.gauge(
    "tidb_device_transfer_bytes",
    "cumulative host->device bytes staged by the coprocessor client")
DEVICE_BUFFER_BYTES = PROCESS_METRICS.gauge(
    "tidb_device_buffer_bytes",
    "live device bytes pinned by the column/mask staging caches")
JIT_CACHE_ENTRIES = PROCESS_METRICS.gauge(
    "tidb_jit_cache_entries",
    "compiled kernels resident in the jit cache")
PROCESS_RSS_BYTES = PROCESS_METRICS.gauge(
    "tidb_process_rss_bytes", "resident set size of this process")

# probes recomputing the sampled gauges from live state, run by
# MetricsHistory.sample_now() so the gauges are current at read time
# without taxing the dispatch path
_GAUGE_PROBES: list = []


def register_gauge_probe(fn) -> None:
    _GAUGE_PROBES.append(fn)


def run_gauge_probes() -> None:
    """Run every probe. A probe's own host errors (a file it cannot
    read, a value it cannot parse) leave its gauge as it was; anything
    else, a device error among them, raises."""
    for fn in list(_GAUGE_PROBES):
        try:
            fn()
        except (OSError, ValueError):
            pass


def _rss_probe() -> None:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        PROCESS_RSS_BYTES.set(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        import resource
        import sys
        # best-effort fallback (peak, not live); ru_maxrss is KiB on
        # Linux but already bytes on macOS
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        PROCESS_RSS_BYTES.set(rss if sys.platform == "darwin"
                              else rss * 1024)


register_gauge_probe(_rss_probe)


# ---- metrics time-series ring (metrics_summary / history route) -------------

class MetricsHistory:
    """Background sampler keeping a bounded ring of counter/gauge
    snapshots (reference: the in-cluster metrics schema behind
    INFORMATION_SCHEMA.METRICS_SUMMARY — TiDB 4.0 reads Prometheus; the
    embedded analog samples its own registries). One per Storage,
    started at open and joined at close like the sampling profiler, so
    no thread outlives its store."""

    DEFAULT_INTERVAL_S = 15.0
    DEFAULT_CAP = 240  # one hour at the default cadence

    def __init__(self, registries, interval_s: Optional[float] = None,
                 cap: Optional[int] = None) -> None:
        self.registries = list(registries)
        self.interval_s = float(interval_s or self.DEFAULT_INTERVAL_S)
        self._ring: deque = deque(maxlen=int(cap or self.DEFAULT_CAP))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def configure(self, interval_s: Optional[float] = None,
                  cap: Optional[int] = None) -> None:
        """Apply the performance.metrics-history-* config knobs (the
        server calls this after loading config; safe while running)."""
        if interval_s:
            self.interval_s = max(float(interval_s), 0.1)
        if cap:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(int(cap), 1))

    def sample_now(self, record: bool = True) -> dict:
        """One sample of every counter/gauge. record=False computes the
        point without touching the ring — the metrics_summary read path
        uses it so reading the time-series never mutates it."""
        run_gauge_probes()
        values: dict[str, float] = {}
        for reg in self.registries:
            values.update(reg.flat_samples())
        ent = {"ts": time.time(), "values": values}
        if record:
            with self._lock:
                self._ring.append(ent)
        return ent

    def _run(self) -> None:
        self.sample_now()  # first point at start, not one interval in
        while not self._stop.wait(self.interval_s):
            self.sample_now()

    def start(self) -> "MetricsHistory":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="titpu-metrics-history")
            self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def summary(self, extra: Optional[dict] = None) -> dict[str, dict]:
        """metric -> {samples, min, avg, max, last} over the ring (the
        information_schema.metrics_summary rows); `extra` folds in a
        transient point (e.g. sample_now(record=False)) for 'now'."""
        out: dict[str, dict] = {}
        points = self.snapshot()
        if extra is not None:
            points.append(extra)
        for ent in points:
            for name, v in ent["values"].items():
                st = out.get(name)
                if st is None:
                    out[name] = {"samples": 1, "min": v, "max": v,
                                 "sum": v, "last": v}
                else:
                    st["samples"] += 1
                    st["min"] = min(st["min"], v)
                    st["max"] = max(st["max"], v)
                    st["sum"] += v
                    st["last"] = v
        for st in out.values():
            st["avg"] = st.pop("sum") / st["samples"]
        return out




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
        # Dapper-style identity: every RPC issued under this collector
        # carries (trace_id, parent_span_id) so the remote side's spans
        # come back attributable to this tree (rpc/frame.py trace ctx)
        self.trace_id = uuid.uuid4().hex
        self._next_span_id = 1

    def alloc_span_id(self) -> int:
        with self._lock:
            self._next_span_id += 1
            return self._next_span_id

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
    """The thread's live TRACE collector, if any (the RPC client reads
    this to decide whether to propagate trace context)."""
    return getattr(_span_tls, "coll", None)


def run_remote_traced(tc, name: str, fn):
    """Server side of cross-process trace propagation: when the request
    carried a trace context, run the handler under its own SpanCollector
    and hand the span rows back for the caller to stitch. Returns
    (result, rows-or-None)."""
    if not isinstance(tc, dict):
        return fn(), None
    with SpanCollector(name) as coll:
        coll.trace_id = str(tc.get("trace_id") or coll.trace_id)
        coll.root.note = (f"trace_id={coll.trace_id[:16]} "
                          f"parent_span_id={tc.get('parent_span_id')}")
        result = fn()
    return result, coll.rows()


def graft_collector(parent: SpanCollector, into: Span,
                    child: SpanCollector) -> None:
    """Merge a worker thread's child collector into the caller's tree
    (re-based by the collectors' perf_counter origins): the span stack
    is thread-local, so parallel fan-out workers each run under their
    own collector, and the tree stays what sequential execution would
    have produced."""
    offset = child.t0 - parent.t0

    def walk(src: Span, dst_children: list) -> bool:
        if not parent._admit():
            return False
        sp = Span(src.name, src.start + offset)
        sp.end = src.end + offset
        sp.note = src.note
        dst_children.append(sp)
        for c in src.children:
            if not walk(c, sp.children):
                return False
        return True

    for c in child.root.children:
        if not walk(c, into.children):
            break


def stitch_remote_rows(coll: SpanCollector, parent: Span, rows) -> None:
    """Client side: graft a peer's span rows (indented-label form, ms
    offsets relative to the remote handler start) under the local RPC
    span, re-based onto this collector's clock. Remote spans count
    against the collector's cap like local ones."""
    base = parent.start
    stack: list[tuple[int, Span]] = [(-1, parent)]
    for r in rows:
        try:
            label, start_ms, dur_ms = str(r[0]), float(r[1]), float(r[2])
        except (TypeError, ValueError, IndexError):
            continue  # a malformed peer row must not kill the trace
        name = label.lstrip(" ")
        depth = (len(label) - len(name)) // 2
        if not coll._admit():
            break
        sp = Span(name, base + start_ms / 1e3)
        sp.end = sp.start + dur_ms / 1e3
        while len(stack) > 1 and stack[-1][0] >= depth:
            stack.pop()
        stack[-1][1].children.append(sp)
        stack.append((depth, sp))


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
    host-to-device bytes per operator; `engines`: the engine tag of each
    coprocessor read, in call order."""

    __slots__ = ("totals", "counts", "op_wall", "ops", "op_bytes",
                 "engines")

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.op_wall: dict[str, float] = {}
        self.ops: dict[str, dict[str, float]] = {}
        self.op_bytes: dict[str, int] = {}
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


# ---- typed wait-state ledger (critical-path attribution) --------------------

_wait_tls = threading.local()


class WaitLedger:
    """Per-statement typed wait totals, EXCLUSIVE of nested wait frames
    (same additive guarantee as StageRecorder: summing the states never
    exceeds the instrumented wall). One ledger per statement, installed
    by the session ONLY while performance.wait-profile-enabled is on —
    disabled, nothing on the statement path allocates or touches one
    (the zero-allocation contract). The states are
    the write path's blocking taxonomy: tso_wait, lease_wait,
    backoff.{kind}, rpc_net, prewrite, commit_primary,
    commit_secondary, resolve_lock, fsync_wait (reference: TiDB's
    execution-stage runtime stats feeding slow log and Top SQL)."""

    __slots__ = ("totals", "counts")

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, state: str, seconds: float) -> None:
        self.totals[state] = self.totals.get(state, 0.0) + seconds
        self.counts[state] = self.counts.get(state, 0) + 1

    def snapshot(self) -> dict[str, float]:
        return dict(self.totals)


def install_wait_ledger(led: Optional[WaitLedger]) -> None:
    _wait_tls.led = led


def active_wait_ledger() -> Optional[WaitLedger]:
    return getattr(_wait_tls, "led", None)


class _WaitCtx:
    """Times one typed wait frame: always feeds the tidb_wait_seconds
    histogram (+ its counter twin) with EXCLUSIVE time — a per-thread
    nesting stack subtracts inner wait frames and note_wait charges,
    so the per-state sums are additive — and feeds the active
    WaitLedger when one is installed. With `fallback=True` the frame
    is a full no-op when ANY wait frame is already open: the enclosed
    time stays attributed to the more specific enclosing state
    (rpc_net is the catch-all for network time not already typed as a
    2PC phase or tso_wait). Optionally opens a TRACE span (span_name),
    allocating no Span when tracing is off."""

    __slots__ = ("state", "spanctx", "t0", "skip")

    def __init__(self, state: str, span_name: Optional[str],
                 fallback: bool) -> None:
        self.state = state
        self.skip = bool(fallback and getattr(_wait_tls, "stack", None))
        self.spanctx = _SpanCtx(span_name) if (
            span_name and not self.skip) else None
        self.t0 = 0.0

    def __enter__(self) -> "_WaitCtx":
        if self.skip:
            return self
        stack = getattr(_wait_tls, "stack", None)
        if stack is None:
            stack = _wait_tls.stack = []
        stack.append(0.0)  # accumulates nested-frame wall time
        if self.spanctx is not None:
            self.spanctx.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.skip:
            return
        dt = time.perf_counter() - self.t0
        if self.spanctx is not None:
            self.spanctx.__exit__(*exc)
        stack = _wait_tls.stack
        child = stack.pop()
        if stack:
            stack[-1] += dt
        excl = dt - child if dt > child else 0.0
        WAIT_SECONDS.observe(excl, state=self.state)
        WAIT_SECONDS_TOTAL.inc(excl, state=self.state)
        led = getattr(_wait_tls, "led", None)
        if led is not None:
            led.add(self.state, excl)


def wait(state: str, span_name: Optional[str] = None,
         fallback: bool = False) -> _WaitCtx:
    """`with obs.wait("prewrite"):` — one typed wait frame. Histogram +
    active ledger always (exclusive time); a span only when span_name
    is given AND a TRACE collector is active."""
    return _WaitCtx(state, span_name, fallback)


def note_wait(state: str, seconds: float) -> None:
    """Charge externally-timed wait seconds (a Backoffer sleep, a
    transport-timeout block) to the typed state: histogram + counter
    twin + the active ledger, and the enclosing wait frame's exclusive
    accounting (the charge is subtracted from the enclosing frame, so
    a backoff sleep inside a prewrite frame never double-counts)."""
    if seconds <= 0:
        return
    stack = getattr(_wait_tls, "stack", None)
    if stack:
        stack[-1] += seconds
    WAIT_SECONDS.observe(seconds, state=state)
    WAIT_SECONDS_TOTAL.inc(seconds, state=state)
    led = getattr(_wait_tls, "led", None)
    if led is not None:
        led.add(state, seconds)


def fmt_waits(waits: Optional[dict[str, float]]) -> str:
    """wait dict (seconds) -> 'prewrite:3.2ms rpc_net:1.1ms ...'
    heaviest first — the EXPLAIN ANALYZE / slow-log wait_profile cell."""
    if not waits:
        return ""
    return " ".join(f"{k}:{v * 1e3:.3g}ms" for k, v in
                    sorted(waits.items(), key=lambda kv: -kv[1]))


def fmt_waits_ms(waits_ms: Optional[dict[str, float]]) -> str:
    """fmt_waits for dicts already in milliseconds (the slow-log entry
    form written by record_slow)."""
    if not waits_ms:
        return ""
    return fmt_waits({k: v / 1e3 for k, v in waits_ms.items()})


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


# ---- sampling host-CPU profiler ---------------------------------------------

class Profile:
    """Aggregated stack samples: {stack tuple -> count}. A stack is a
    tuple of 'func (file:line)' strings, outermost first."""

    __slots__ = ("stacks", "hz", "duration_s")

    def __init__(self, stacks: dict[tuple, int], hz: float,
                 duration_s: float) -> None:
        self.stacks = stacks
        self.hz = hz
        self.duration_s = duration_s

    @property
    def total_samples(self) -> int:
        return sum(self.stacks.values())

    def hot_frames(self, limit: int = 20) -> list[tuple[str, int]]:
        """Frames ranked by SELF samples (innermost frame of a stack)."""
        own: dict[str, int] = {}
        for stack, n in self.stacks.items():
            if stack:
                own[stack[-1]] = own.get(stack[-1], 0) + n
        return sorted(own.items(), key=lambda kv: -kv[1])[:limit]

    def tree_rows(self, max_rows: int = 512) -> list[tuple[str, float, int]]:
        """Flamegraph-style rows: (indented frame, est. seconds,
        samples), depth-first, heaviest subtree first."""
        root: dict = {}
        counts: dict[int, int] = {}

        for stack, n in self.stacks.items():
            node = root
            for frame in stack:
                node = node.setdefault(frame, {})
                counts[id(node)] = counts.get(id(node), 0) + n

        per_sample = 1.0 / self.hz if self.hz > 0 else 0.0
        rows: list[tuple[str, float, int]] = []

        def walk(node: dict, depth: int) -> None:
            for frame, child in sorted(
                    node.items(), key=lambda kv: -counts[id(kv[1])]):
                if len(rows) >= max_rows:
                    return
                n = counts[id(child)]
                rows.append(("  " * depth + frame,
                             round(n * per_sample, 6), n))
                walk(child, depth + 1)

        walk(root, 0)
        return rows

    def to_dict(self) -> dict:
        return {
            "hz": self.hz,
            "duration_s": round(self.duration_s, 6),
            "total_samples": self.total_samples,
            "hot_frames": self.hot_frames(),
            "tree": [{"frame": f, "seconds": s, "samples": n}
                     for f, s, n in self.tree_rows()],
        }


def _format_frame(frame) -> str:
    co = frame.f_code
    return f"{co.co_name} ({co.co_filename.rsplit('/', 1)[-1]}" \
        f":{frame.f_lineno})"


class SamplingProfiler:
    """Wall-clock stack sampler over sys._current_frames() (reference:
    util/profile serving pprof CPU profiles through SQL and the status
    port). `thread_ids=None` samples every thread (the /debug/profile
    whole-process view); a set restricts to those threads (the
    per-statement SHOW PROFILE view). start()/stop() own the sampler
    thread's lifecycle — stop() joins it, so no sampler leaks past the
    statement that started it."""

    MAX_DEPTH = 48
    MAX_STACKS = 4096

    def __init__(self, hz: float = 97.0,
                 thread_ids: Optional[set] = None) -> None:
        self.hz = max(float(hz), 1.0)
        self.thread_ids = thread_ids
        self._stacks: dict[tuple, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self._elapsed = 0.0

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            raise RuntimeError("profiler already running")
        self._t0 = time.perf_counter()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="titpu-profiler")
        self._thread.start()
        return self

    def _run(self) -> None:
        import sys

        me = threading.get_ident()
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            frames = sys._current_frames()
            for tid, frame in frames.items():
                if tid == me:
                    continue
                if self.thread_ids is not None and \
                        tid not in self.thread_ids:
                    continue
                stack: list[str] = []
                f = frame
                while f is not None and len(stack) < self.MAX_DEPTH:
                    stack.append(_format_frame(f))
                    f = f.f_back
                stack.reverse()
                key = tuple(stack)
                if key in self._stacks or \
                        len(self._stacks) < self.MAX_STACKS:
                    self._stacks[key] = self._stacks.get(key, 0) + 1
                PROFILER_SAMPLES.inc()
            del frames

    def stop(self) -> Profile:
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
            self._thread = None
        self._elapsed = time.perf_counter() - self._t0
        return Profile(dict(self._stacks), self.hz, self._elapsed)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


def profile_process(seconds: float = 0.5, hz: float = 97.0) -> Profile:
    """Block for `seconds` sampling every thread — the /debug/profile
    handler's one-shot whole-process view."""
    p = SamplingProfiler(hz=hz).start()
    time.sleep(max(min(seconds, 10.0), 0.01))
    return p.stop()


# ---- metric-hygiene lint -----------------------------------------------------

_METRIC_NAME_RE = None  # compiled lazily (re import stays off hot paths)


def lint_metrics(registries, device_label_cap: Optional[int] = None
                 ) -> list[str]:
    """Walk registries + their rendered exposition and return hygiene
    findings (empty list = clean). Checks: every metric carries help
    text; names are tidb_-prefixed snake_case; no family is registered
    in more than one of the given registries (their /metrics outputs
    concatenate); `device`/`shard` label families stay bounded by the
    mesh size (`device_label_cap`, default 8) so per-device telemetry
    cannot turn into unbounded cardinality; and the rendered Prometheus
    text exposition is well-formed (HELP/TYPE precede samples, label
    syntax and values parse, histogram buckets are cumulative and
    _count-consistent), so a metric added later cannot silently break
    the scrape."""
    import re
    global _METRIC_NAME_RE
    if _METRIC_NAME_RE is None:
        _METRIC_NAME_RE = re.compile(r"^tidb_[a-z0-9_]+$")
    if device_label_cap is None:
        # one device: the reference's floor of 8 (its default is the
        # live mesh width, at least 8)
        device_label_cap = 8
    findings: list[str] = []
    seen: dict[str, int] = {}
    label_vals: dict[tuple[str, str], set] = {}
    for ri, reg in enumerate(registries):
        with reg._lock:
            metrics = list(reg._metrics.values())
        for m in metrics:
            if not getattr(m, "help", ""):
                findings.append(f"metric {m.name}: missing help text")
            if not _METRIC_NAME_RE.match(m.name):
                findings.append(
                    f"metric {m.name}: name must match tidb_[a-z0-9_]+")
            if m.name in seen and seen[m.name] != ri:
                findings.append(
                    f"metric {m.name}: registered in more than one "
                    "concatenated registry (duplicate family on "
                    "/metrics)")
            seen[m.name] = ri
            if isinstance(m, (Counter, Gauge)):
                keys = [k for k, _ in m.samples()]
            else:
                keys = [k for k, _, _, _ in m.series()]
            for key in keys:
                for lk, lv in key:
                    if lk in ("device", "shard"):
                        label_vals.setdefault((m.name, lk),
                                              set()).add(lv)
        findings.extend(_lint_exposition(reg.render()))
    for (mname, lk), vals in sorted(label_vals.items()):
        if len(vals) > device_label_cap:
            findings.append(
                f"metric {mname}: label {lk!r} has {len(vals)} values, "
                f"over the mesh-size cap {device_label_cap} (unbounded "
                "per-device/per-shard cardinality)")
    return findings


def _lint_exposition(text: str) -> list[str]:
    """Validate one registry's Prometheus text exposition."""
    import re
    findings: list[str] = []
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
        r'(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*")'
        r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*")*)?\})? (\S+)$')
    helped: set[str] = set()
    typed: dict[str, str] = {}
    bucket_acc: dict[str, int] = {}  # series label-part -> last cum count
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# HELP "):
            parts = ln.split(" ", 3)
            if len(parts) < 4 or not parts[3].strip():
                findings.append(f"exposition: HELP without text: {ln!r}")
            helped.add(parts[2])
            continue
        if ln.startswith("# TYPE "):
            parts = ln.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary"):
                findings.append(f"exposition: malformed TYPE: {ln!r}")
                continue
            if parts[2] in typed:
                findings.append(
                    f"exposition: duplicate TYPE for {parts[2]}")
            typed[parts[2]] = parts[3]
            continue
        if ln.startswith("#"):
            continue
        m = sample_re.match(ln)
        if m is None:
            findings.append(f"exposition: malformed sample line: {ln!r}")
            continue
        name, labels, value = m.group(1), m.group(2), m.group(3)
        family = name
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and name[:-len(sfx)] in typed:
                family = name[:-len(sfx)]
                break
        if family not in typed:
            findings.append(
                f"exposition: sample {name} precedes (or lacks) its "
                "TYPE line")
        elif family not in helped:
            findings.append(f"exposition: {family} lacks a HELP line")
        try:
            float(value)
        except ValueError:
            findings.append(
                f"exposition: non-numeric value {value!r} on {name}")
            continue
        if name.endswith("_bucket") and labels:
            series = re.sub(r'le="[^"]*",?', "", labels)
            key = family + "{" + series + "}"
            cum = int(float(value))
            if cum < bucket_acc.get(key, 0):
                findings.append(
                    f"exposition: non-cumulative buckets on {key}")
            if 'le="+Inf"' in labels:
                bucket_acc.pop(key, None)  # series complete; reset
            else:
                bucket_acc[key] = cum
    return findings
