"""Per-statement attribution: dispatch stages, operator wall time, engines.

The part of the reference's observability plane (`tidb_tpu/obs.py`) that
the SQL read path calls, under the same names: `stage` times one named
stage EXCLUSIVE of the stages nested in it, `operator` records one plan
operator's exclusive wall time, `note_engine` appends a coprocessor read's
engine tag, and the session installs one `StageRecorder` per statement
(`install_stage_recorder` / `active_stage_recorder`). Of the metrics
registry, the histogram of group commit's batch sizes (`Observability`,
one per `Storage`, under the reference's metric name) and, in the
process-wide registry (`PROCESS_METRICS`), the counter of rows the
function registry evaluated row by row (`REGISTRY_ROW_EVALS`, by `func`).
Spans, the slow log and the rest of the plane are not ported.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_stage_tls = threading.local()
_op_tls = threading.local()


class StageRecorder:
    """One statement's attribution: `totals` (exclusive seconds per
    stage), `op_wall` (exclusive wall seconds per plan operator) and
    `engines` (the engine tag of each coprocessor read, in call order)."""

    __slots__ = ("totals", "op_wall", "engines")

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.op_wall: dict[str, float] = {}
        self.engines: list[str] = []

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds

    def add_op_wall(self, op: str, seconds: float) -> None:
        self.op_wall[op] = self.op_wall.get(op, 0.0) + seconds

    def snapshot(self) -> dict[str, float]:
        return dict(self.totals)

    def delta_since(self, before: dict[str, float]) -> dict[str, float]:
        out = {}
        for k, v in self.totals.items():
            d = v - before.get(k, 0.0)
            if d > 0:
                out[k] = d
        return out


def install_stage_recorder(rec: Optional[StageRecorder]) -> None:
    _stage_tls.rec = rec


def active_stage_recorder() -> Optional[StageRecorder]:
    return getattr(_stage_tls, "rec", None)


def note_engine(tag: Optional[str]) -> None:
    """Record which engine served a coprocessor read on the statement's
    recorder."""
    if not tag:
        return
    rec = getattr(_stage_tls, "rec", None)
    if rec is not None:
        rec.engines.append(tag)


class _OpCtx:
    """One plan-operator frame: records its EXCLUSIVE wall seconds
    (nested operator frames are subtracted) on the active recorder."""

    __slots__ = ("label", "t0", "rec")

    def __init__(self, label: str) -> None:
        self.label = label
        self.t0 = 0.0
        self.rec = None

    def __enter__(self) -> "_OpCtx":
        self.rec = getattr(_stage_tls, "rec", None)
        if self.rec is not None:
            stack = getattr(_op_tls, "stack", None)
            if stack is None:
                stack = _op_tls.stack = []
            stack.append(0.0)  # accumulates nested-frame wall time
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.rec is not None:
            dt = time.perf_counter() - self.t0
            stack = _op_tls.stack
            child = stack.pop()
            if stack:
                stack[-1] += dt
            self.rec.add_op_wall(self.label, max(dt - child, 0.0))


def operator(label: str) -> _OpCtx:
    """`with obs.operator("join"):` — attribute the enclosed wall time
    to one plan operator."""
    return _OpCtx(label)


class _StageCtx:
    """Times one stage, EXCLUSIVE of the stages nested in it, onto the
    active recorder."""

    __slots__ = ("stage", "t0", "rec")

    def __init__(self, stage: str) -> None:
        self.stage = stage
        self.rec = getattr(_stage_tls, "rec", None)
        self.t0 = 0.0

    def __enter__(self) -> None:
        stack = getattr(_stage_tls, "stack", None)
        if stack is None:
            stack = _stage_tls.stack = []
        stack.append(0.0)  # accumulates nested-stage wall time
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        stack = _stage_tls.stack
        child = stack.pop()
        if stack:
            stack[-1] += dt
        if self.rec is not None:
            self.rec.add(self.stage, max(dt - child, 0.0))


def stage(name: str) -> _StageCtx:
    """`with obs.stage("plan_build"):` — one named stage."""
    return _StageCtx(name)


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


class Registry:
    """Metric families by name; `counter` returns the one registered
    under a name, creating it on first use."""

    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, help_)
                self._metrics[name] = m
            elif not isinstance(m, Counter):
                raise TypeError(
                    f"metric {name} already registered as "
                    f"{type(m).__name__}")
            return m


class Histogram:
    """Fixed-bucket histogram (Prometheus-style); `snapshot()` gives
    (per-bucket counts, the last one past the top bound; sum; total)."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_total",
                 "_lock")

    def __init__(self, name: str, help_: str, buckets) -> None:
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._total += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._total


class Observability:
    """One storage's metrics: the cross-commit group fsync
    (kv/mvcc.py SyncPolicy.commit_sync) — commits amortized per disk
    barrier under sync-log=commit; the mean batch size is the durable-QPS
    amplification over one fsync."""

    def __init__(self) -> None:
        self.group_commit_batch = Histogram(
            "tidb_group_commit_batch_size",
            "commits made durable by one WAL fsync under "
            "sync-log=commit (group-commit rendezvous batch size)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))


# process-global metrics (one device per process)
PROCESS_METRICS = Registry()
REGISTRY_ROW_EVALS = PROCESS_METRICS.counter(
    "tidb_registry_row_eval_total",
    "rows evaluated by the per-row scalar-function registry fallback "
    "(copr/funcs.py), by function — nonzero means an expression left "
    "the vectorized path (the registry-row-eval inspection rule reads "
    "this)")
