"""Workload history plane: persistent per-digest plan/perf history.

Port of `tidb_tpu/obs_history.py`, whole. Top SQL windows rotate away
and the metrics history dies with the process; this module is the
memory: the counterpart of the reference's eviction-safe
`statements_summary_history` (util/stmtsummary's windowed persistence
behind INFORMATION_SCHEMA.STATEMENTS_SUMMARY_HISTORY) plus the
plan-digest tracking its SPM/plan-binding tier uses to notice a plan
flip (bindinfo's baseline capture keys on (sql_digest, plan_digest)).

Shape: one `WorkloadHistory` per Storage. While `enabled` is false it is
ZERO work on the statement path — the session call site gates on
`.enabled` before hashing anything (the Top SQL contract). Enabled,
every completed statement feeds `observe()` with its SQL digest, wall
time, stage split, engine tags (`Session.last_engines` — the device/host
path decision with the fragment mode embedded), rows and shard skew;
observations aggregate into the LIVE window keyed by (sql_digest,
plan_digest), and a closed window rotates into the bounded durable
record list, persisted under `<storage-dir>/history/` with the storage's
crash-atomic discipline (tmp + fsync + rename + directory fsync) so the
records survive kill -9 and read back verbatim on reopen.

The plan digest is derived from the statement's engine-tag set: the
same query re-planned onto a different execution path (device[group] ->
host(...), point -> full dispatch) gets a new plan digest, which is
exactly the event the detection tier watches for. The port's engine
tags equal the reference's, so its plan digests do too:

* plan_change — a throttled structured event the first time a digest
  executes with a plan digest (or a DEGRADED engine class) different
  from its history; severity `warn` when the engine class degraded
  (device -> host, fast path -> full dispatch), `info` otherwise.
* plan-regression / stmt-perf-regression — inspection rules
  (obs_inspect.py) over `regression_findings()`: a new plan at least
  `regression_ratio` slower than the historical p50 of the plan it
  replaced, and a same-plan sustained latency drift against the
  digest's own baseline records.

Surfaces: information_schema.statements_summary_history (one row per
rotated window x digest x plan) and tidb_plan_history (one row per
digest x plan, the "which plan won" view), and the tidb_history_*
metric families, and the status port's /debug/history
(`debug_payload`). The cluster_ variants wait for the diagnostics RPC
plane.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional

RECORDS_FILE = "records.json"
FORMAT_VERSION = 1

# engine classes, best first: the DEGRADATION detector compares the
# best class a digest's history reached against the class it just ran
# with. 3 = the OLTP point fast path (plan/fastpath.py bypass),
# 2 = device/coprocessor paths (mesh and replica-routed reads too),
# 1 = host-side ranged index reads, 0 = the host interpreter fallback.
_CLASS_HOST = 0
_CLASS_RANGED = 1
_CLASS_DEVICE = 2
_CLASS_POINT = 3


def engine_class(engines) -> int:
    """Collapse a statement's engine-tag list to one ordinal class.
    Statements without a coprocessor read (DDL, SET, metadata) class
    as device — there is no path to regress off."""
    if not engines:
        return _CLASS_DEVICE
    tags = list(engines)
    if any(str(t).startswith("host(") for t in tags):
        return _CLASS_HOST
    if all(str(t) == "point" for t in tags):
        return _CLASS_POINT
    if any(str(t).startswith(("device", "replica@", "point"))
           for t in tags):
        return _CLASS_DEVICE
    return _CLASS_RANGED


def plan_digest_of(engines) -> str:
    """Plan identity from the statement's engine-tag set: stable under
    plan-node enumeration order (sorted unique tags), sensitive to the
    execution path + fragment mode (`device[group]` vs `host(...)` vs
    `point`) — which is the granularity the plan-flip detector needs."""
    key = "|".join(sorted(set(str(t) for t in (engines or ()))))
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def fragment_modes(engines) -> list[str]:
    """The bracketed device fragment modes of a tag set
    (['group', 'rows+semi'] from device[group]@mesh8 ...) — the
    strategy record an adaptive placement would learn from."""
    out = set()
    for t in engines or ():
        t = str(t)
        if not t.startswith("device"):
            continue
        i = t.find("[")
        j = t.find("]", i)
        if 0 <= i < j:
            out.add(t[i + 1:j])
    return sorted(out)


class WorkloadHistory:
    """Per-storage windowed (sql_digest, plan_digest) history with
    crash-safe persistence and plan-change detection. Thread-safe: one
    lock guards the live window, the record list and the plan-seen
    index; persistence happens outside the statement's observe() call
    only at window rotation (one atomic file write per closed window)."""

    DEFAULT_WINDOW_S = 60
    DEFAULT_CAP = 512
    DEFAULT_RATIO = 1.5
    # at most one plan_change event per digest per window — a flapping
    # plan must not flood the event ring
    _THROTTLE_CAP = 512

    def __init__(self, path: Optional[str] = None, metrics=None,
                 events=None) -> None:
        self.enabled = False
        self.window_seconds = float(self.DEFAULT_WINDOW_S)
        self.history_cap = int(self.DEFAULT_CAP)
        self.regression_ratio = float(self.DEFAULT_RATIO)
        self.dir = os.path.join(path, "history") if path else None
        self.events = events
        self._lock = threading.Lock()
        # serializes the FILE write only (tmp+rename pair), never held
        # with _lock: persistence must not block the statement path.
        # The generation pair orders concurrent rotation writes — a
        # preempted older snapshot must never overwrite a newer one.
        self._persist_lock = threading.Lock()
        self._gen = 0
        self._persisted_gen = 0
        self._records: list[dict] = []   # rotated windows, oldest first
        self._live: dict[tuple, dict] = {}
        self._win_start: Optional[int] = None
        self._loaded = False
        # sql_digest -> (last plan_digest, best engine class seen)
        self._plan_seen: dict[str, tuple] = {}
        # sql_digest -> window start of the last plan_change event
        self._change_fired: dict[str, int] = {}
        if metrics is not None:
            self.records_gauge = metrics.gauge(
                "tidb_history_records",
                "durable workload-history records retained (rotated "
                "(sql_digest, plan_digest) windows, bounded by "
                "history.history-cap)")
            self.rotations = metrics.counter(
                "tidb_history_rotations_total",
                "workload-history windows closed and rotated into the "
                "durable record list")
            self.plan_changes = metrics.counter(
                "tidb_history_plan_changes_total",
                "statements that executed with a plan digest (or a "
                "degraded engine class) different from their recorded "
                "history, by kind (changed / degraded)")
            self.persist_failures = metrics.counter(
                "tidb_history_persist_failures_total",
                "workload-history persistence attempts that failed "
                "(records stay in memory; the next rotation retries)")
        else:
            self.records_gauge = None
            self.rotations = None
            self.plan_changes = None
            self.persist_failures = None

    # ==================== config ====================
    def configure(self, enabled: Optional[bool] = None,
                  window_seconds: Optional[float] = None,
                  history_cap: Optional[int] = None,
                  regression_ratio: Optional[float] = None) -> None:
        """Apply the [history] config knobs (startup + SIGHUP hot
        reload; safe while running — a shrunk cap drops the oldest
        records at the next rotation)."""
        if window_seconds is not None:
            self.window_seconds = max(float(window_seconds), 1.0)
        if history_cap is not None:
            self.history_cap = max(int(history_cap), 1)
        if regression_ratio is not None:
            self.regression_ratio = max(float(regression_ratio), 1.0)
        if enabled is not None:
            was = self.enabled
            self.enabled = bool(enabled)
            if self.enabled and not was:
                self._ensure_loaded()

    # ==================== persistence ====================
    def _records_path(self) -> Optional[str]:
        return os.path.join(self.dir, RECORDS_FILE) if self.dir else None

    def _ensure_loaded(self) -> None:
        """Read the durable records back (once, at first enable): a
        corrupt or missing file degrades to empty history, never an
        error — history is derived data with a fresh start as the
        worst case."""
        if self._loaded:
            # unlocked fast path: set-once flag, checked per statement
            # on the enabled path — observe() must not pay a second
            # mutex round-trip just to learn the load already happened
            return
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
            path = self._records_path()
            if path is None:
                return
            try:
                with open(path, encoding="utf-8") as f:
                    raw = json.load(f)
            except (OSError, ValueError):
                return
            recs = raw.get("records") if isinstance(raw, dict) else None
            if not isinstance(recs, list):
                return
            self._records = [r for r in recs if isinstance(r, dict)
                             and r.get("digest")][-self.history_cap:]
            for r in self._records:  # oldest first: last write wins
                cls = int(r.get("engine_class", _CLASS_DEVICE))
                prev = self._plan_seen.get(r["digest"])
                best = cls if prev is None else max(prev[1], cls)
                self._plan_seen[r["digest"]] = (
                    str(r.get("plan_digest", "")), best)
            if self.records_gauge is not None:
                self.records_gauge.set(len(self._records))

    def _persist(self, gen: int, records: list[dict]) -> None:
        """Atomic tmp + fsync + rename + dir-fsync write of a record
        snapshot (the crash-atomic discipline): a reader after
        kill -9 sees the previous complete file or the new complete
        file, never a torn one. Runs OUTSIDE the statement-path lock —
        the fsync must not block concurrent observes (the lock-held
        fsync would serialize every committer behind it); _persist_lock
        serializes the tmp+rename pair between concurrent rotations,
        and the generation check drops a snapshot that lost the race
        to a NEWER one (an older write landing last would silently
        un-persist the newest window)."""
        path = self._records_path()
        if path is None:
            return
        from .kv.mvcc import fsync_dir
        try:
            with self._persist_lock:
                if gen <= self._persisted_gen:
                    return  # a newer snapshot already reached disk
                os.makedirs(self.dir, exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump({"version": FORMAT_VERSION,
                               "saved": round(time.time(), 3),
                               "records": records}, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                fsync_dir(self.dir)
                self._persisted_gen = gen
        except OSError:
            if self.persist_failures is not None:
                self.persist_failures.inc()

    # ==================== the statement feed ====================
    def observe(self, digest: str, digest_text: str, db: str,
                wall_s: float, engines=None,
                stages: Optional[dict] = None, rows: int = 0,
                failed: bool = False,
                op_mesh: Optional[dict] = None,
                now: Optional[float] = None) -> None:
        """One completed statement. The session gates on `.enabled`
        before computing the digest, so this is never reached while
        disabled; the internal guard keeps direct callers honest."""
        if not self.enabled:
            return
        self._ensure_loaded()
        ts = time.time() if now is None else float(now)
        if failed:
            # an interrupted/failed statement has neither a trustworthy
            # plan (note_engine stops at the dispatch that died — a
            # truncated tag set would derive a bogus plan digest and
            # fire spurious plan_change events) nor a representative
            # latency (it must not pollute the regression baselines):
            # count the error against the digest's KNOWN plan, if any
            with self._lock:
                persist = self._rotate_locked(ts)
                seen = self._plan_seen.get(digest)
                if seen is not None:
                    ent = self._live.get((digest, seen[0]))
                    if ent is not None:
                        ent["errors"] += 1
            if persist is not None:
                self._persist(*persist)
            return
        plan = plan_digest_of(engines)
        cls = engine_class(engines)
        modes = fragment_modes(engines)
        change = None
        with self._lock:
            persist = self._rotate_locked(ts)
            seen = self._plan_seen.get(digest)
            if seen is not None and seen[0] != plan:
                degraded = cls < seen[1]
                win = self._win_start or 0
                if self._change_fired.get(digest) != win:
                    if len(self._change_fired) >= self._THROTTLE_CAP:
                        self._change_fired.clear()
                    self._change_fired[digest] = win
                    change = ("degraded" if degraded else "changed",
                              seen[0])
            best = cls if seen is None else max(seen[1], cls)
            self._plan_seen[digest] = (plan, best)
            key = (digest, plan)
            ent = self._live.get(key)
            if ent is None:
                ent = self._live[key] = {
                    "window_start": self._win_start,
                    "digest": digest, "digest_text": digest_text[:512],
                    "schema_name": db, "plan_digest": plan,
                    "engines": sorted(set(str(t)
                                          for t in (engines or ()))),
                    "modes": modes, "engine_class": cls,
                    "exec_count": 0, "errors": 0,
                    "sum_wall_ms": 0.0, "max_wall_ms": 0.0,
                    "sum_rows": 0, "stages_ms": {},
                    "max_skew": 0.0, "max_shard_share": 0.0,
                    "last_ts": 0.0,
                }
            # last-execution order: an intra-window plan flap must
            # leave the LAST-run plan as the digest's current one on
            # every read surface, not the first-seen one
            ent["last_ts"] = max(ent.get("last_ts", 0.0),
                                 round(ts, 3))
            ent["exec_count"] += 1
            ms = wall_s * 1e3
            ent["sum_wall_ms"] += ms
            ent["max_wall_ms"] = max(ent["max_wall_ms"], ms)
            ent["sum_rows"] += int(rows)
            if stages:
                st = ent["stages_ms"]
                for k, v in stages.items():
                    st[k] = round(st.get(k, 0.0) + v * 1e3, 3)
            if op_mesh:
                for share, skew in op_mesh.values():
                    ent["max_shard_share"] = max(ent["max_shard_share"],
                                                 float(share))
                    ent["max_skew"] = max(ent["max_skew"], float(skew))
        if persist is not None:
            self._persist(*persist)
        if change is not None:
            kind, old_plan = change
            if self.plan_changes is not None:
                self.plan_changes.inc(kind=kind)
            if self.events is not None:
                self.events.record(
                    "plan_change",
                    severity="warn" if kind == "degraded" else "info",
                    digest=digest,
                    detail=f"plan {old_plan} -> {plan} "
                           f"({kind}; engines "
                           f"{','.join(sorted(set(str(t) for t in (engines or ())))) or '(none)'}): "
                           f"{digest_text[:200]}")

    def _rotate_locked(self, ts: float) -> Optional[tuple]:
        """Close the live window if `ts` has moved past it. Returns a
        (generation, records snapshot) pair to persist (caller writes
        it AFTER releasing the lock) or None when nothing rotated."""
        win = int(ts - (ts % self.window_seconds))
        if self._win_start is None:
            self._win_start = win
            return None
        if win <= self._win_start:
            return None
        closed_start = self._win_start
        self._win_start = win
        if not self._live:
            return None
        end = time.strftime(
            "%Y-%m-%d %H:%M:%S",
            time.localtime(closed_start + self.window_seconds))
        for ent in sorted(self._live.values(),
                          key=lambda e: e.get("last_ts", 0.0)):
            ent["window_end"] = end
            self._records.append(ent)
        self._live = {}
        del self._records[:-self.history_cap]
        if self.rotations is not None:
            self.rotations.inc()
        if self.records_gauge is not None:
            self.records_gauge.set(len(self._records))
        self._gen += 1
        return (self._gen, [dict(r) for r in self._records])

    def flush(self, now: Optional[float] = None) -> None:
        """Rotate the live window (if any) into the records and
        persist — Storage.close() calls this so a clean shutdown keeps
        the newest partial window too."""
        if not self.enabled:
            return
        with self._lock:
            if self._live:
                # force-close regardless of wall clock: the window is
                # over because the server is
                persist = self._rotate_locked(
                    (self._win_start or 0) + self.window_seconds
                    if now is None else float(now))
            else:
                self._gen += 1
                persist = (self._gen, [dict(r) for r in self._records])
        if persist is not None:
            self._persist(*persist)

    # ==================== read surfaces ====================
    def snapshot(self) -> dict:
        """Copies safe to read unlocked: rotated records are immutable
        after rotation (shallow copy suffices), but LIVE entries keep
        mutating under the lock — their nested dicts (stages_ms) must
        be deep-copied or a reader iterating them races a concurrent
        observe()'s insert."""
        import copy
        with self._lock:
            return {
                "records": [dict(r) for r in self._records],
                "live": [copy.deepcopy(e) for e in self._live.values()],
                "window_start": self._win_start,
            }

    @staticmethod
    def _fmt_win(win) -> str:
        return time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(int(win or 0)))

    def table_rows(self) -> list[list]:
        """information_schema.statements_summary_history rows: durable
        records oldest first, then the live (still-open) window."""
        snap = self.snapshot()
        rows = []
        for r in snap["records"] + snap["live"]:
            n = max(int(r.get("exec_count", 0)), 1)
            rows.append([
                self._fmt_win(r.get("window_start")),
                r.get("window_end", ""),
                r.get("digest", ""), r.get("schema_name", ""),
                str(r.get("digest_text", ""))[:512],
                r.get("plan_digest", ""),
                ",".join(r.get("engines", ())),
                ",".join(r.get("modes", ())),
                int(r.get("exec_count", 0)), int(r.get("errors", 0)),
                round(float(r.get("sum_wall_ms", 0.0)) / n, 3),
                round(float(r.get("max_wall_ms", 0.0)), 3),
                int(r.get("sum_rows", 0)),
                _fmt_stages_ms(r.get("stages_ms")),
                round(float(r.get("max_skew", 0.0)), 2),
            ])
        return rows

    def plan_rows(self) -> list[list]:
        """information_schema.tidb_plan_history rows: one row per
        (digest, plan_digest) across the whole retained history —
        execs, avg/p50 latency, engine tags/modes, first/last window,
        and whether this is the digest's CURRENT plan."""
        snap = self.snapshot()
        agg: dict[tuple, dict] = {}
        latest: dict[str, tuple] = {}  # digest -> (order key, plan)
        for r in snap["records"] + snap["live"]:
            key = (r.get("digest", ""), r.get("plan_digest", ""))
            okey = _order_key(r)
            if okey >= latest.get(key[0], ((-1, -1.0), ""))[0]:
                latest[key[0]] = (okey, key[1])
            a = agg.get(key)
            if a is None:
                a = agg[key] = {
                    "digest_text": r.get("digest_text", ""),
                    "engines": r.get("engines", ()),
                    "modes": r.get("modes", ()),
                    "windows": 0, "exec_count": 0, "errors": 0,
                    "sum_ms": 0.0, "max_ms": 0.0, "avgs": [],
                    "first": r.get("window_start"),
                    "last": r.get("window_start"),
                }
            n = max(int(r.get("exec_count", 0)), 1)
            a["windows"] += 1
            a["exec_count"] += int(r.get("exec_count", 0))
            a["errors"] += int(r.get("errors", 0))
            a["sum_ms"] += float(r.get("sum_wall_ms", 0.0))
            a["max_ms"] = max(a["max_ms"],
                              float(r.get("max_wall_ms", 0.0)))
            a["avgs"].append(float(r.get("sum_wall_ms", 0.0)) / n)
            a["last"] = r.get("window_start")
        rows = []
        for (digest, plan), a in sorted(agg.items()):
            n = max(a["exec_count"], 1)
            rows.append([
                digest, plan, str(a["digest_text"])[:512],
                ",".join(a["engines"]), ",".join(a["modes"]),
                a["windows"], a["exec_count"], a["errors"],
                round(a["sum_ms"] / n, 3),
                round(_median(a["avgs"]), 3),
                round(a["max_ms"], 3),
                self._fmt_win(a["first"]), self._fmt_win(a["last"]),
                1 if latest.get(digest, (None, None))[1] == plan else 0,
            ])
        return rows

    def debug_payload(self) -> dict:
        out = {
            "enabled": self.enabled,
            "window_seconds": self.window_seconds,
            "history_cap": self.history_cap,
            "regression_ratio": self.regression_ratio,
            "dir": self.dir,
        }
        if not self.enabled:
            return out
        out.update(self.snapshot())
        out["regressions"] = self.regression_findings()
        return out

    # ==================== regression detection ====================
    def regression_findings(self) -> list[dict]:
        """The rule bodies behind the plan-regression and
        stmt-perf-regression inspection rules, computed over one
        snapshot: each finding is a plain dict {rule, item, severity,
        value, details} obs_inspect converts. Empty while disabled."""
        if not self.enabled:
            return []
        snap = self.snapshot()
        ratio = self.regression_ratio
        by_digest: dict[str, list[dict]] = {}
        for r in snap["records"] + snap["live"]:
            if r.get("exec_count"):
                by_digest.setdefault(r["digest"], []).append(r)
        out: list[dict] = []
        for digest, recs in sorted(by_digest.items()):
            # "current" = the LAST-executed plan, not first-seen-in-
            # window order (an intra-window plan flap must not grade
            # the wrong plan against the wrong history)
            recs = sorted(recs, key=_order_key)
            cur = recs[-1]
            cur_plan = cur.get("plan_digest", "")
            cur_entries = [r for r in recs
                           if r.get("plan_digest") == cur_plan]
            cur_avg = _avg_ms(cur_entries[-1])
            base = [r for r in recs if r.get("plan_digest") != cur_plan]
            text = str(cur.get("digest_text", ""))[:160]
            if base:
                # the digest switched plans: new plan's latest window
                # vs the REPLACED plans' p50 over their history
                p50 = _median([_avg_ms(r) for r in base])
                if p50 > 0 and cur_avg >= ratio * p50:
                    sev = "critical" if cur_avg >= 2 * ratio * p50 \
                        else "warning"
                    out.append({
                        "rule": "plan-regression", "item": digest,
                        "severity": sev,
                        "value": f"{cur_avg / p50:.1f}x",
                        "details":
                            f"new plan {cur_plan} runs {cur_avg:.1f}ms "
                            f"vs {p50:.1f}ms historical p50 of the "
                            f"replaced plan "
                            f"({cur_avg / p50:.1f}x >= "
                            f"{ratio:g}; engines "
                            f"{','.join(cur.get('engines', ())) or '(none)'}): "
                            f"{text}"})
            if len(cur_entries) >= 3:
                # same plan, sustained drift: the newest window vs the
                # digest's own earlier windows on this plan
                baseline = _median([_avg_ms(r)
                                    for r in cur_entries[:-1]])
                if baseline > 0 and cur_avg >= ratio * baseline:
                    sev = "critical" \
                        if cur_avg >= 2 * ratio * baseline else "warning"
                    out.append({
                        "rule": "stmt-perf-regression", "item": digest,
                        "severity": sev,
                        "value": f"{cur_avg / baseline:.1f}x",
                        "details":
                            f"plan {cur_plan} drifted to "
                            f"{cur_avg:.1f}ms vs its own "
                            f"{baseline:.1f}ms baseline p50 over "
                            f"{len(cur_entries) - 1} windows "
                            f"({cur_avg / baseline:.1f}x >= {ratio:g}): "
                            f"{text}"})
        return out


def _order_key(rec: dict) -> tuple:
    """Execution-recency order of a history entry: window first, then
    the entry's last observation inside it."""
    return (int(rec.get("window_start") or 0),
            float(rec.get("last_ts") or 0.0))


def _avg_ms(rec: dict) -> float:
    return float(rec.get("sum_wall_ms", 0.0)) / \
        max(int(rec.get("exec_count", 0)), 1)


def _median(vals: list[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def _fmt_stages_ms(stages_ms) -> str:
    from . import obs
    return obs.fmt_stages_ms(stages_ms)[:256] if stages_ms else ""


__all__ = ["WorkloadHistory", "engine_class", "plan_digest_of",
           "fragment_modes"]
