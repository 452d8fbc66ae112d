"""Rules-driven inspection engine: the system diagnoses itself.

Port of `tidb_tpu/obs_inspect.py`. Counterpart of the reference's
SQL-queryable diagnostics tier (TiDB 4.0's executor/inspection_result.go
— a registry of named inspection rules evaluated over the metrics schema
and the server's state, surfaced as INFORMATION_SCHEMA.INSPECTION_RESULT
/ INSPECTION_SUMMARY). It reads:

  * the MetricsHistory ring and a live counter/gauge sample
  * the structured EventLog (governor kills, admission sheds, fsync and
    checkpoint stalls, plan changes)
  * Top SQL and the wait profile
  * the governor's and the admission gate's state
  * the storage's transport health and cluster membership
  * the workload history's regression findings

Every rule is registered with a name, a default severity and reference
text (what knob or surface explains the finding) and is a PURE FUNCTION
over one bounded InspectionContext snapshot — no thread, no lock held
across rules. `DiagnosticsState.enabled = False` short-circuits before
the snapshot is built, so a read does zero inspection work.

Every rule of the reference is registered under its own name, severity
and reference text. The rules over planes the port does not have return
no finding, which is what the reference returns with that plane off:
mesh-shard-skew, mesh-recompile-storm and mesh-hbm-watermark (no mesh
client). lock-order-inversion reads the lock-order checker
(`analysis/lockcheck.py`) and returns nothing while it is off. The range
rules (range-leader-flap, range-split-flap, range-closed-ts-stall) read
the range plane's events and hosted ranges, and the heat rules
(hot-range, range-split-advisory) the keyspace heat plane's findings,
as the reference's do.

Surfaces: information_schema.inspection_result / inspection_summary and
an edge-triggered `inspection_finding` event the first time a rule
crosses severity=critical for an item; the cluster_inspection_result
fan-out runs them on every member. The status port reads `status_section` (the
/status `inspection` counts, cached for 5 s) and `debug_payload`
(/debug/inspection).
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import obs

SEVERITIES = ("info", "warning", "critical")
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}


@dataclass
class DiagnosticsState:
    """Per-storage diagnostics settings + the edge-trigger memory.
    Field names/defaults mirror the reference's config.DiagnosticsConfig
    for the rules the port evaluates; the threshold of the rule whose
    plane the port lacks (mesh skew) comes with that plane. Config.seed_diagnostics
    copies the knobs in; embedded callers set them directly."""

    enabled: bool = True
    # how many MetricsHistory samples a windowed rule considers (the
    # window in SECONDS is this times metrics-history-interval)
    history_windows: int = 8
    fsync_stall_threshold: int = 3       # stalls in the window
    host_fallback_fraction: float = 0.5  # of a digest's stage split
    governor_kill_threshold: int = 1     # kills in the window
    admission_shed_threshold: int = 1    # sheds in the window
    row_eval_threshold: int = 1          # per-row registry rows/window
    # dominant-wait: a digest spending at least this fraction of its
    # wall blocked in backoff.* or lease_wait is a finding (needs
    # performance.wait-profile-enabled for the data to exist)
    dominant_wait_threshold: float = 0.5
    heartbeat_stale_ms: int = 10000      # member hb age past this
    # follower-apply-lag: a serving follower whose applied/closed ts is
    # more than this far behind leader time (0 disables the rule)
    apply_lag_warn_ms: int = 2000
    # one range changing write leadership this many times in the
    # window is flapping (a clean failover is ONE transfer)
    range_flap_threshold: int = 3
    # one range SPLITTING this many times inside split-flap-window-s
    # is flapping: the advisory keeps firing without draining the
    # heat — the salted/monotonic hot-key symptom splits cannot fix
    split_flap_threshold: int = 3
    # seconds of range_split history the split-flap rule considers
    # (its own window, not history-windows: splits are rare and
    # cooldown-paced, so the shared window is usually too short)
    split_flap_window_s: int = 300
    # a range whose published closed_ts has not advanced for this long
    # WHILE its write counters moved is range-closed-ts-stall
    # (warning; critical at 3x — every range-aware replica read over
    # it is falling back to the leader); 0 disables the rule
    closed_ts_stall_ms: int = 10000
    # range-closed-ts-stall memory: range_id -> (closed_ts, wall_ms
    # first seen at that value, write mark) — the rule needs history
    # to tell "static" from "just observed" (edge memory like
    # seen_critical, surviving reseeds)
    closed_progress: dict = field(default_factory=dict)
    # (rule, item) pairs already reported critical: inspection_finding
    # events fire on NEW members only (edge-triggered, not level)
    seen_critical: set = field(default_factory=set)
    # serializes the edge-trigger update between concurrent inspections
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    # /status scrape cache: (monotonic ts, severity counts) — a
    # monitoring poller hitting /status every few seconds must not run
    # the full rule engine per scrape
    _status_cache: Optional[tuple] = field(default=None, repr=False)


STATUS_CACHE_TTL_S = 5.0


@dataclass(frozen=True)
class Finding:
    rule: str
    item: str        # what the finding is about (digest, device, peer)
    severity: str    # info | warning | critical
    value: str       # the observed value that crossed the threshold
    details: str     # human-readable diagnosis


class Rule:
    """One named diagnosis: metadata + the pure evaluation function."""

    __slots__ = ("name", "severity", "reference", "fn")

    def __init__(self, name: str, severity: str, reference: str,
                 fn: Callable) -> None:
        self.name = name
        self.severity = severity
        self.reference = reference
        self.fn = fn


RULES: dict[str, Rule] = {}


def rule(name: str, severity: str, reference: str):
    """Register one inspection rule. The metadata is mandatory and
    validated at import (lint_rules re-checks it in tier-1): a rule
    without a reference is a finding an operator cannot act on."""
    def deco(fn: Callable) -> Callable:
        if not name or not reference:
            raise ValueError(
                f"inspection rule needs name+reference, got {name!r}")
        if severity not in SEVERITIES:
            raise ValueError(
                f"inspection rule {name}: severity {severity!r} not in "
                f"{SEVERITIES}")
        if name in RULES:
            raise ValueError(f"inspection rule {name} already registered")
        RULES[name] = Rule(name, severity, reference, fn)
        return fn
    return deco


def lint_rules(rules: Optional[dict] = None) -> list[str]:
    """Registry hygiene (run by tests/test_metric_lint.py): every rule
    declares a kebab-case name, a valid severity and reference text."""
    findings: list[str] = []
    for name, r in (RULES if rules is None else rules).items():
        if not name or name != name.lower() or " " in name \
                or "_" in name:
            findings.append(f"rule {name!r}: name must be kebab-case")
        if getattr(r, "severity", None) not in SEVERITIES:
            findings.append(
                f"rule {name}: severity {getattr(r, 'severity', None)!r} "
                f"not in {SEVERITIES}")
        if not getattr(r, "reference", ""):
            findings.append(f"rule {name}: missing reference text")
        if not callable(getattr(r, "fn", None)):
            findings.append(f"rule {name}: fn is not callable")
    return findings


# ---- the snapshot rules evaluate over --------------------------------------

class InspectionContext:
    """One bounded point-in-time snapshot of every telemetry plane a
    rule may read. Built once per inspection run; rules never touch
    live state directly, so they stay pure and cheaply testable."""

    def __init__(self, storage) -> None:
        self.storage = storage
        self.cfg: DiagnosticsState = storage.diagnostics
        self.now = time.time()
        hist = storage.metrics_history
        ring = hist.snapshot()
        if self.cfg.history_windows > 0:
            ring = ring[-self.cfg.history_windows:]
        # the "now" point: live counters/gauges after a probe pass,
        # computed WITHOUT touching the ring (reads never mutate it)
        self.now_point = hist.sample_now(record=False)
        self.points = ring + [self.now_point]
        # exactly what the knobs document: window seconds =
        # history-windows x metrics-history-interval (no hidden floor)
        self.window_s = \
            float(self.cfg.history_windows) * float(hist.interval_s)
        self.events = storage.obs.events.snapshot()
        self.topsql = storage.obs.topsql
        self.waitprofile = storage.obs.waitprofile
        gov = getattr(storage, "governor", None)
        self.governor = gov.stats() if gov is not None else {}
        gate = getattr(storage, "admission", None)
        self.admission = gate.stats() if gate is not None else {}
        self.transport = storage.transport_health()
        # workload-history regression findings, computed ONCE per
        # snapshot (both history rules read this list; an absent or
        # disabled history plane contributes nothing)
        hist = getattr(storage, "history", None)
        self.history_findings = hist.regression_findings() \
            if hist is not None and hist.enabled else []
        # keyspace heat findings, computed ONCE per snapshot (both heat
        # rules read this list; a disabled heat plane contributes
        # nothing — the [heatmap] zero-work contract)
        heat = getattr(storage, "heat", None)
        self.heat_findings = heat.findings() \
            if heat is not None and heat.enabled else []
        # hosted range rows (closed_ts / max_commit_ts / traffic), one
        # snapshot per inspection; no range plane armed = no rows = the
        # range rules stay silent on a healthy single-range server
        plane = getattr(storage, "ranges", None)
        self.ranges = plane.server.describe() if plane is not None else []

    # ---- helpers rules share -------------------------------------------
    def metric(self, labeled_name: str) -> float:
        """Current value of one flattened sample ('name{k="v"}')."""
        return float(self.now_point["values"].get(labeled_name, 0.0))

    def metric_family(self, family: str) -> dict[str, float]:
        """Current samples of one family: labeled name -> value."""
        out = {}
        for name, v in self.now_point["values"].items():
            if obs.split_sample_name(name, family) is not None:
                out[name] = float(v)
        return out

    def metric_delta(self, family: str) -> dict[str, float]:
        """Per-sample growth of a (cumulative) family across the
        considered history window. Needs at least one RING point as the
        baseline — with no history the delta is unknowable (process-
        global counters carry other servers' past), so it reports
        nothing rather than guessing."""
        if len(self.points) < 2:
            return {}
        base = self.points[0]["values"]
        out: dict[str, float] = {}
        for name, v in self.metric_family(family).items():
            d = float(v) - float(base.get(name, 0.0))
            if d > 0:
                out[name] = d
        return out

    def window_events(self, kind: str) -> list[dict]:
        """Ring events of one kind inside the rule window."""
        cutoff = self.now - self.window_s
        return [e for e in self.events
                if e["kind"] == kind and e.get("unix", 0.0) >= cutoff]

    def members(self) -> list[dict]:
        return [m for m in self.transport.get("members", [])
                if isinstance(m, dict)]


# ---- the shipped rules ------------------------------------------------------

def _labels_of(name: str) -> str:
    """'fam{k="v"}' -> 'k="v"' (the item text for labeled samples);
    family-agnostic cousin of obs.split_sample_name."""
    i = name.find("{")
    return name[i + 1:-1] if i >= 0 else ""


@rule("mesh-shard-skew", "warning",
      "mesh.skew-warn-ratio — sustained shard-row imbalance; rebalance "
      "the hot range or lower shard-threshold-rows "
      "(information_schema.tidb_mesh_shards)")
def _r_mesh_skew(ctx: InspectionContext) -> list[Finding]:
    # no mesh client on one device
    return []


@rule("mesh-recompile-storm", "warning",
      "kernel signature re-entering XLA compile (bucket/placement-mode "
      "churn); pin tile sizes or placement (/debug/mesh compile ring)")
def _r_recompile_storm(ctx: InspectionContext) -> list[Finding]:
    # no mesh flight recorder on one device
    return []


@rule("mesh-hbm-watermark", "critical",
      "mesh.hbm-watermark-fraction — device HBM near capacity; shed "
      "resident epochs or raise mesh.hbm-bytes "
      "(information_schema.tidb_mesh_storage)")
def _r_hbm_watermark(ctx: InspectionContext) -> list[Finding]:
    # no mesh plane: no device watermark ledger and no
    # mesh_hbm_watermark event
    return []


@rule("wal-fsync-stall", "warning",
      "storage.sync-log — WAL fsyncs stalling >=100ms; check disk "
      "contention or switch to sync-log=interval "
      "(tidb_events kind=fsync_stall)")
def _r_fsync_stall(ctx: InspectionContext) -> list[Finding]:
    stalls = ctx.window_events("fsync_stall")
    if len(stalls) < ctx.cfg.fsync_stall_threshold:
        return []
    return [Finding(
        "wal-fsync-stall", "wal", "warning", str(len(stalls)),
        f"{len(stalls)} fsync stalls inside {ctx.window_s:.0f}s "
        f"(threshold {ctx.cfg.fsync_stall_threshold}); last: "
        f"{stalls[-1]['detail']}")]


@rule("governor-kill", "warning",
      "performance.server-memory-limit — the memory governor killed "
      "statements; raise the limit or reduce concurrency "
      "(tidb_events kind=governor_kill)")
def _r_governor_kill(ctx: InspectionContext) -> list[Finding]:
    kills = ctx.window_events("governor_kill")
    if len(kills) < ctx.cfg.governor_kill_threshold:
        return []
    sev = "critical" if len(kills) >= 3 * ctx.cfg.governor_kill_threshold \
        else "warning"
    return [Finding(
        "governor-kill", "memory", sev, str(len(kills)),
        f"{len(kills)} governor kills inside {ctx.window_s:.0f}s "
        f"(limit {ctx.governor.get('limit_bytes', 0)} bytes, last "
        f"usage {ctx.governor.get('usage_bytes', 0)}); last victim: "
        f"{kills[-1]['detail'][:200]}")]


@rule("admission-shed", "warning",
      "performance.token-limit / admission-timeout-ms — waiters shed "
      "with errno 9003; raise token-limit or spread the workload "
      "(tidb_events kind=admission_shed)")
def _r_admission_shed(ctx: InspectionContext) -> list[Finding]:
    sheds = ctx.window_events("admission_shed")
    if len(sheds) < ctx.cfg.admission_shed_threshold:
        return []
    return [Finding(
        "admission-shed", "admission", "warning", str(len(sheds)),
        f"{len(sheds)} statements shed inside {ctx.window_s:.0f}s "
        f"(token limit {ctx.admission.get('token_limit', 0)}, queue "
        f"depth {ctx.admission.get('queue_depth', 0)}); last: "
        f"{sheds[-1]['detail'][:200]}")]


@rule("rpc-breaker-open", "critical",
      "transport.breaker-threshold — the RPC circuit breaker is open: "
      "the leader is unreachable and calls fail fast "
      "(/status transport breaker)")
def _r_breaker_open(ctx: InspectionContext) -> list[Finding]:
    state = str(ctx.transport.get("breaker", "closed"))
    if state == "closed":
        return []
    sev = "critical" if state == "open" else "warning"
    return [Finding(
        "rpc-breaker-open", str(ctx.transport.get("peer", "leader")),
        sev, state,
        f"circuit breaker {state} after "
        f"{ctx.transport.get('breaker_fail_streak', 0)} consecutive "
        f"budget-exhausted calls; last contact "
        f"{ctx.transport.get('last_contact_age_s')}s ago")]


@rule("follower-heartbeat-stale", "warning",
      "transport.lease-ms — a member's heartbeat is stale or down; "
      "check the peer process/network (/status transport members)")
def _r_heartbeat_stale(ctx: InspectionContext) -> list[Finding]:
    out = []
    thr_s = ctx.cfg.heartbeat_stale_ms / 1000.0
    for m in ctx.members():
        inst = str(m.get("addr") or m.get("role") or "?")
        down = m.get("down")
        if down:
            out.append(Finding(
                "follower-heartbeat-stale", inst, "critical",
                "down", f"member unreachable: {down}"))
            continue
        age = m.get("hb_age_s")
        if age is None or thr_s <= 0:
            continue
        if float(age) >= thr_s:
            sev = "critical" if float(age) >= 3 * thr_s else "warning"
            out.append(Finding(
                "follower-heartbeat-stale", inst, sev,
                f"{float(age):.1f}s",
                f"{m.get('role', 'member')} heartbeat age "
                f"{float(age):.1f}s >= "
                f"diagnostics.heartbeat-stale-ms {thr_s * 1000:.0f}ms"))
    return out


@rule("follower-apply-lag", "warning",
      "replica-read.apply-interval-ms — a serving replica's closed/"
      "applied timestamp is falling behind the leader; past 3x the "
      "warn threshold it has effectively stopped advancing and every "
      "routed read falls back to the leader (/debug/replicas, "
      "tidb_follower_apply_lag_seconds)")
def _r_follower_apply_lag(ctx: InspectionContext) -> list[Finding]:
    thr = float(ctx.cfg.apply_lag_warn_ms)
    if thr <= 0:
        return []
    out = []
    for m in ctx.members():
        if m.get("role") != "follower" or not m.get("serving"):
            continue
        lag = m.get("apply_lag_ms")
        if lag is None or float(lag) < thr:
            continue
        lag = float(lag)
        inst = str(m.get("addr") or "?")
        sev = "critical" if lag >= 3 * thr else "warning"
        out.append(Finding(
            "follower-apply-lag", inst, sev, f"{lag:.0f}ms",
            f"serving replica's applied ts is {lag:.0f}ms behind the "
            f"leader (warn threshold "
            f"{ctx.cfg.apply_lag_warn_ms}ms"
            + ("; the replica has stopped advancing — routed reads "
               "are falling back to the leader" if sev == "critical"
               else "") + ")"))
    return out


@rule("range-leader-flap", "warning",
      "ranges.lease-ms — one range's write leadership changed hands "
      "repeatedly inside the window (a clean failover is ONE "
      "transfer); leaders cannot hold their lease — check lease-ms "
      "against renewal latency and crash-looping hosts "
      "(tidb_events kind=range_transfer, tidb_range_transfers_total)")
def _r_range_leader_flap(ctx: InspectionContext) -> list[Finding]:
    moves = ctx.window_events("range_transfer")
    if len(moves) < ctx.cfg.range_flap_threshold:
        return []
    # every range_transfer detail leads with "r<id> " (rpc/ranged.py)
    per: dict = {}
    for e in moves:
        rid = str(e.get("detail", "")).split(" ", 1)[0] or "?"
        per.setdefault(rid, []).append(e)
    out = []
    for rid, evs in sorted(per.items()):
        if len(evs) < ctx.cfg.range_flap_threshold:
            continue
        out.append(Finding(
            "range-leader-flap", rid, "warning", str(len(evs)),
            f"range {rid} changed write leadership {len(evs)} times "
            f"inside {ctx.window_s:.0f}s (threshold "
            f"{ctx.cfg.range_flap_threshold}); last: "
            f"{evs[-1]['detail'][:200]}"))
    return out


@rule("range-split-flap", "warning",
      "diagnostics.split-flap-threshold / split-flap-window-s — one "
      "range kept splitting inside the window: the heat advisory "
      "keeps firing without the split draining the hotspot (the "
      "salted/monotonic hot-key symptom); splitting cannot help — "
      "fix the key design or raise ranges.split-cooldown-ms "
      "(tidb_events kind=range_split, tidb_range_splits_total)")
def _r_range_split_flap(ctx: InspectionContext) -> list[Finding]:
    thr = int(ctx.cfg.split_flap_threshold)
    if thr <= 0:
        return []
    # splits are cooldown-paced, so the rule carries its OWN window
    # (split-flap-window-s) instead of the shared history window
    win = float(ctx.cfg.split_flap_window_s) or ctx.window_s
    cutoff = ctx.now - win
    splits = [e for e in ctx.events
              if e["kind"] == "range_split"
              and e.get("unix", 0.0) >= cutoff]
    if len(splits) < thr:
        return []
    # every range_split detail leads with "r<parent> " (rpc/ranged.py)
    per: dict = {}
    for e in splits:
        rid = str(e.get("detail", "")).split(" ", 1)[0] or "?"
        per.setdefault(rid, []).append(e)
    out = []
    for rid, evs in sorted(per.items()):
        if len(evs) < thr:
            continue
        out.append(Finding(
            "range-split-flap", rid, "warning", str(len(evs)),
            f"range {rid} split {len(evs)} times inside {win:.0f}s "
            f"(threshold {thr}); last: {evs[-1]['detail'][:200]}"))
    return out


@rule("range-closed-ts-stall", "warning",
      "diagnostics.closed-ts-stall-ms — one range's published closed "
      "timestamp stopped advancing while its writes kept landing: a "
      "pending-commit ledger entry or an unresolved orphan lock is "
      "pinning it, and every range-aware replica read touching the "
      "range falls back to the leader (cluster_info range rows, "
      "/debug/ranges; tidb_events kind=orphan_resolved shows the "
      "resolver working the backlog)")
def _r_range_closed_ts_stall(ctx: InspectionContext) -> list[Finding]:
    thr = float(ctx.cfg.closed_ts_stall_ms)
    if thr <= 0 or not ctx.ranges:
        return []
    mem = ctx.cfg.closed_progress
    now_ms = ctx.now * 1000.0
    out = []
    live = set()
    for row in ctx.ranges:
        rid = str(row.get("range_id", "?"))
        live.add(rid)
        closed = int(row.get("closed_ts") or 0)
        # write progress independent of closed_ts: the commit floor
        # (always present) plus heat traffic (when armed). An IDLE
        # range with a static closed_ts is not a stall — there is
        # nothing to close past.
        mark = (int(row.get("max_commit_ts") or 0),
                int(row.get("write_rows") or 0))
        prev = mem.get(rid)
        if prev is None or closed != prev[0]:
            mem[rid] = (closed, now_ms, mark)
            continue
        stalled_ms = now_ms - float(prev[1])
        if mark == prev[2] or stalled_ms < thr:
            continue
        sev = "critical" if stalled_ms >= 3 * thr else "warning"
        out.append(Finding(
            "range-closed-ts-stall", rid, sev, f"{stalled_ms:.0f}ms",
            f"range {rid} closed_ts {closed} static for "
            f"{stalled_ms:.0f}ms while writes advanced "
            f"(commit floor {prev[2][0]} -> {mark[0]}, threshold "
            f"{ctx.cfg.closed_ts_stall_ms}ms"
            + ("; the range cannot close any newer timestamp — "
               "range-aware replica reads over it are all falling "
               "back to the leader" if sev == "critical" else "")
            + "); check for an orphaned lock or a lost txn_done "
            f"({row.get('pending', 0)} ledger entries pending)"))
    for rid in [r for r in mem if r not in live]:
        del mem[rid]
    return out


@rule("top-sql-host-fallback", "warning",
      "device-fragment gate — a digest's stage split is dominated by "
      "host_fallback (de-deviced query); see Session.last_engines / "
      "tests/test_device_path_lint.py for the gate reason")
def _r_host_fallback(ctx: InspectionContext) -> list[Finding]:
    if not ctx.topsql.enabled:
        return []
    frac = float(ctx.cfg.host_fallback_fraction)
    worst: dict[str, tuple] = {}
    for b in ctx.topsql.snapshot():
        # windowed like the event rules: Top SQL buckets only rotate
        # when statements arrive, so on an idle server an old bucket
        # (and its long-fixed de-deviced digest) survives indefinitely
        if b["start"] + ctx.topsql.window_s < ctx.now - ctx.window_s:
            continue
        ents = list(b["digests"].values())
        if b.get("other") is not None:
            ents.append(b["other"])
        for e in ents:
            host = float(e["stages"].get("host_fallback", 0.0))
            total = float(sum(e["stages"].values()))
            if host <= 0 or total <= 0 or host / total < frac:
                continue
            prev = worst.get(e["digest"])
            if prev is None or host / total > prev[0]:
                worst[e["digest"]] = (host / total, host,
                                      e["digest_text"])
    return [Finding(
        "top-sql-host-fallback", digest, "warning", f"{share:.0%}",
        f"host_fallback is {share:.0%} of the stage split "
        f"({host_s * 1e3:.1f}ms): {text[:200]}")
        for digest, (share, host_s, text) in sorted(worst.items())]


@rule("dominant-wait", "warning",
      "performance.wait-profile-enabled — a digest spends most of its "
      "wall time blocked in lock/lease contention (backoff.* or "
      "lease_wait), not executing; "
      "information_schema.tidb_wait_profile has the full typed split, "
      "diagnostics.dominant-wait-threshold tunes the cutoff")
def _r_dominant_wait(ctx: InspectionContext) -> list[Finding]:
    wp = ctx.waitprofile
    if not wp.enabled:
        return []
    thr = float(ctx.cfg.dominant_wait_threshold)
    worst: dict[str, tuple] = {}
    for b in wp.snapshot():
        # windowed like top-sql-host-fallback: wait buckets only
        # rotate when statements arrive, so an idle server would keep
        # reporting a long-fixed contention storm forever
        if b["start"] + wp.window_s < ctx.now - ctx.window_s:
            continue
        ents = list(b["digests"].values())
        if b.get("other") is not None:
            ents.append(b["other"])
        for e in ents:
            wall = float(e.get("sum_wall_s", 0.0))
            if wall <= 0:
                continue
            blocked = {k: v for k, v in e["waits"].items()
                       if k == "lease_wait" or k.startswith("backoff.")}
            share = min(sum(blocked.values()) / wall, 1.0)
            if not blocked or share < thr:
                continue
            top = max(blocked, key=lambda k: blocked[k])
            prev = worst.get(e["digest"])
            if prev is None or share > prev[0]:
                worst[e["digest"]] = (share, top,
                                      blocked[top], wall,
                                      e["digest_text"])
    return [Finding(
        "dominant-wait", digest, "warning", f"{share:.0%}",
        f"{share:.0%} of {wall * 1e3:.1f}ms wall spent blocked in "
        f"contention waits (heaviest: {top} {top_s * 1e3:.1f}ms): "
        f"{text[:200]}")
        for digest, (share, top, top_s, wall, text)
        in sorted(worst.items())]


@rule("registry-row-eval", "warning",
      "copr/funcs.py registry fallback — a scalar function "
      "de-vectorized onto the per-row path "
      "(tidb_registry_row_eval_total{func})")
def _r_registry_row_eval(ctx: InspectionContext) -> list[Finding]:
    out = []
    for name, d in sorted(ctx.metric_delta(
            "tidb_registry_row_eval_total").items()):
        if d < ctx.cfg.row_eval_threshold:
            continue
        item = _labels_of(name) or "(unlabeled)"
        out.append(Finding(
            "registry-row-eval", item, "warning", str(int(d)),
            f"{int(d)} rows evaluated per-row by the scalar-function "
            f"registry inside the window ({name}) — the expression "
            "left the vectorized path"))
    return out


@rule("metric-cardinality", "warning",
      "obs.lint_metrics — metric-hygiene finding at runtime (family "
      "wider than the mesh, malformed exposition, duplicate family)")
def _r_metric_lint(ctx: InspectionContext) -> list[Finding]:
    findings = obs.lint_metrics(
        [ctx.storage.obs.metrics, obs.PROCESS_METRICS])
    out = []
    for f in findings[:32]:  # bounded: a broken registry, not a flood
        item = f.split(":", 1)[0].removeprefix("metric ").strip()[:128]
        out.append(Finding("metric-cardinality", item or "(registry)",
                           "warning", "", f[:500]))
    return out


@rule("lock-order-inversion", "critical",
      "TIDB_TPU_LOCK_CHECK / [analysis] lock-check — the instrumented "
      "lock wrapper observed a lock-order cycle (potential deadlock) "
      "or a blocking syscall under a hot lock; /debug/lockgraph has "
      "the edges and sample stacks")
def _r_lock_order_inversion(ctx: InspectionContext) -> list[Finding]:
    # reads the PROCESS-wide lock graph, not the snapshot: the checker
    # is opt-in instrumentation (zero overhead when off), and its
    # findings are cumulative facts about this process's execution —
    # exactly what an inspection read should surface
    from .analysis import lockcheck
    if not lockcheck.enabled():
        return []
    out = []
    for f in lockcheck.findings():
        if f["kind"] == "lock-order-inversion":
            out.append(Finding(
                "lock-order-inversion", f["item"], "critical", "cycle",
                f"lock-order cycle observed at runtime: {f['item']} — "
                f"two threads acquiring these locks in opposite "
                f"orders can deadlock"))
        else:  # blocking-under-hot-lock
            out.append(Finding(
                "lock-order-inversion", f["item"], "warning",
                str(f.get("count", 1)),
                f"blocking syscall with a hot lock held "
                f"({f['item']}, x{f.get('count', 1)}): every peer of "
                f"that lock serializes behind the syscall"))
    return out


@rule("plan-regression", "warning",
      "history.regression-ratio — a digest executes a NEW plan at "
      "least this many times slower than the historical p50 of the "
      "plan it replaced (information_schema.tidb_plan_history names "
      "both plans; Session.last_engines / the plan_change event name "
      "the path that changed)")
def _r_plan_regression(ctx: InspectionContext) -> list[Finding]:
    out = []
    for f in ctx.history_findings:
        if f["rule"] == "plan-regression":
            out.append(Finding("plan-regression", f["item"],
                               f["severity"], f["value"], f["details"]))
    return out


@rule("stmt-perf-regression", "warning",
      "history.regression-ratio — a digest's latency drifted past the "
      "ratio against its own baseline windows ON THE SAME plan "
      "(information_schema.statements_summary_history has the "
      "window-by-window trajectory)")
def _r_stmt_perf_regression(ctx: InspectionContext) -> list[Finding]:
    out = []
    for f in ctx.history_findings:
        if f["rule"] == "stmt-perf-regression":
            out.append(Finding("stmt-perf-regression", f["item"],
                               f["severity"], f["value"], f["details"]))
    return out


@rule("config-sync-log", "warning",
      "storage.sync-log — off on a leader with live followers: acked "
      "commits can die with the machine while replicas follow them")
def _r_config_sync_log(ctx: InspectionContext) -> list[Finding]:
    if ctx.storage.sync_log != "off":
        return []
    if ctx.transport.get("mode") != "socket-leader":
        return []
    followers = [m for m in ctx.members()
                 if m.get("role") == "follower"]
    if not followers:
        return []
    return [Finding(
        "config-sync-log", "storage.sync-log", "warning", "off",
        f"leader runs sync-log=off with {len(followers)} live "
        "follower(s); a power loss can drop acked commits that "
        "followers already replicated")]


@rule("hot-range", "warning",
      "heatmap.hot-ratio / heatmap.sustained-buckets — one range "
      "serves at least hot-ratio x the fleet-median traffic for "
      "sustained-buckets consecutive heat buckets "
      "(information_schema.tidb_hot_ranges has the per-range matrix; "
      "/debug/keyviz renders it)")
def _r_hot_range(ctx: InspectionContext) -> list[Finding]:
    out = []
    for f in ctx.heat_findings:
        if f["rule"] == "hot-range":
            out.append(Finding("hot-range", f["item"],
                               f["severity"], f["value"], f["details"]))
    return out


@rule("range-split-advisory", "info",
      "heatmap.key-sample-cap — the within-range key that best halves "
      "a hot range's observed write traffic (its weighted-median "
      "sampled key); advisory only — add it to ranges.split-points "
      "to act on it")
def _r_range_split_advisory(ctx: InspectionContext) -> list[Finding]:
    out = []
    for f in ctx.heat_findings:
        if f["rule"] == "range-split-advisory":
            out.append(Finding("range-split-advisory", f["item"],
                               f["severity"], f["value"], f["details"]))
    return out


# ---- the engine -------------------------------------------------------------

def inspect(storage) -> list[Finding]:
    """Evaluate every registered rule over one snapshot of the given
    storage. Returns [] — WITHOUT building the snapshot or touching any
    rule — while diagnostics.enabled is false (the zero-work contract).
    A rule that raises degrades to an info finding naming itself; it
    never fails the query."""
    st: Optional[DiagnosticsState] = getattr(storage, "diagnostics",
                                             None)
    if st is None or not st.enabled:
        return []
    ctx = InspectionContext(storage)
    findings: list[Finding] = []
    for r in RULES.values():
        try:
            findings.extend(r.fn(ctx) or ())
        except Exception as e:  # noqa: BLE001 — diagnosis must not fail
            findings.append(Finding(
                r.name, "(rule)", "info", "error",
                f"rule raised {type(e).__name__}: {str(e)[:200]}"))
    _edge_trigger(storage, st, findings)
    return findings


def _edge_trigger(storage, st: DiagnosticsState,
                  findings: list[Finding]) -> None:
    """Record one inspection_finding event per (rule, item) the FIRST
    time it reports critical; a finding that clears and re-fires
    re-triggers. Level-triggered events would flood the ring on every
    inspection read."""
    crit = {(f.rule, f.item): f for f in findings
            if f.severity == "critical"}
    with st._lock:
        new = set(crit) - st.seen_critical
        st.seen_critical = set(crit)
    for key in sorted(new):
        f = crit[key]
        storage.obs.events.record(
            "inspection_finding", severity="critical",
            detail=f"{f.rule}: {f.item} {f.value} — "
                   f"{f.details}"[:500])


def _result_rows_of(findings: list[Finding]) -> list[list]:
    ordered = sorted(findings,
                     key=lambda f: (-_SEV_ORDER.get(f.severity, 0),
                                    f.rule, f.item))
    return [[f.rule, f.item, f.severity, f.value,
             RULES[f.rule].reference if f.rule in RULES else "",
             f.details] for f in ordered]


def _summary_rows_of(findings: list[Finding]) -> list[list]:
    by_rule: dict[str, list[Finding]] = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    rows = []
    for name, r in sorted(RULES.items()):
        fs = by_rule.get(name, [])
        worst = max((f.severity for f in fs),
                    key=lambda s: _SEV_ORDER.get(s, 0), default="")
        items = ",".join(sorted({f.item for f in fs}))[:256]
        rows.append([name, worst, len(fs), items, r.reference[:256]])
    return rows


def result_rows(storage) -> list[list]:
    """information_schema.inspection_result rows: (rule, item,
    severity, value, reference, details), worst severity first."""
    return _result_rows_of(inspect(storage))


def summary_rows(storage) -> list[list]:
    """information_schema.inspection_summary: one row per REGISTERED
    rule (finding count, worst observed severity, sample items) — the
    SQL-queryable view of the registry itself. Empty while disabled."""
    st = getattr(storage, "diagnostics", None)
    if st is None or not st.enabled:
        return []
    return _summary_rows_of(inspect(storage))


def result_and_summary_rows(storage) -> tuple[list[list], list[list]]:
    """Both inspection tables from ONE rule run — a statement that
    touches inspection_result AND inspection_summary must not pay two
    snapshot builds, and the two tables it reads must agree."""
    st = getattr(storage, "diagnostics", None)
    if st is None or not st.enabled:
        return [], []
    findings = inspect(storage)
    return _result_rows_of(findings), _summary_rows_of(findings)


def status_section(storage) -> dict:
    """The /status `inspection` section: enabled flag, rule count, and
    finding counts by severity. Zero rule work while disabled; counts
    are cached for STATUS_CACHE_TTL_S so a monitoring poller never
    turns the liveness endpoint into a per-scrape rule run."""
    st = getattr(storage, "diagnostics", None)
    enabled = bool(st is not None and st.enabled)
    out = {"enabled": enabled, "rules": len(RULES)}
    if not enabled:
        return out
    cached = st._status_cache
    now = time.monotonic()
    if cached is not None and now - cached[0] < STATUS_CACHE_TTL_S:
        out["findings"] = dict(cached[1])
        return out
    counts = {s: 0 for s in SEVERITIES}
    for f in inspect(storage):
        counts[f.severity] = counts.get(f.severity, 0) + 1
    st._status_cache = (now, dict(counts))
    out["findings"] = counts
    return out


def debug_payload(storage) -> dict:
    """The /debug/inspection JSON: settings + full findings + the
    per-rule summary — derived from ONE inspection run so the two
    sections of one payload can never disagree."""
    st = getattr(storage, "diagnostics", None)
    out: dict = {
        "enabled": bool(st is not None and st.enabled),
        "rules": sorted(RULES),
    }
    if not out["enabled"]:
        return out
    findings = inspect(storage)
    out["findings"] = [
        {"rule": r[0], "item": r[1], "severity": r[2], "value": r[3],
         "reference": r[4], "details": r[5]}
        for r in _result_rows_of(findings)]
    out["summary"] = [
        {"rule": r[0], "severity": r[1], "findings": r[2],
         "items": r[3], "reference": r[4]}
        for r in _summary_rows_of(findings)]
    return out


# ---- process-wide storage tracking -----------------------------------------

# every live Storage, weakly held (the reference's post-mortem report of
# a dying benchmark child reads them; its reader waits for the port's
# benchmark runner)
_STORAGES: "weakref.WeakSet" = weakref.WeakSet()


def track(storage) -> None:
    _STORAGES.add(storage)


__all__ = ["DiagnosticsState", "Finding", "Rule", "RULES", "rule",
           "lint_rules", "InspectionContext", "inspect", "result_rows",
           "summary_rows", "status_section", "debug_payload", "track"]
