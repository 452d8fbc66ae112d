"""Keyspace heat plane: per-range traffic histograms + hot-range
detection + load-based split advisories.

Counterpart of the reference's Key Visualizer (reference: PD's keyviz
heatmap — a rolling time x region matrix of per-region read/write
traffic — plus the load-based split checker that turns a sustained hot
region into a split point; store/tikv/region_cache.go is the client
copy of the region table the heatmap is keyed on). Range-sharded
write leadership alone leaves the plane blind: nothing records WHERE
in the keyspace traffic lands, so a hot range is invisible until it
surfaces as tail latency. This module is the sensor; the actuator that
acts on its advisory is the range server's auto-split tick
(`rpc/ranged.py`).

Shape: one `RangeHeatRecorder` per Storage. A bounded ring of time
buckets (`ring-buckets` x `bucket-seconds`), each bucket a map of
range-id -> [read_rows, read_bytes, write_rows, write_bytes, stmts],
fed from the four traffic sites:

  * plan/fastpath.py   — OLTP point reads (`_exec_get`)
  * copr/client.py     — coprocessor scans (every `execute()` entry)
  * kv/twopc.py        — 2PC commits through the LOCAL region tier
                         (the storage's committer carries the recorder)
  * rpc/ranged.py      — range-leader apply (`range_prewrite` on the
                         leader; the range tier's committers carry NO
                         recorder, so a routed write is counted exactly
                         once, leader-side)

Zero-work contract (the Top SQL / history precedent): while
`[heatmap] enabled = false` every `note_*` returns before touching a
key, a lock, or an allocation, and the call sites gate on `.enabled`
before computing arguments — tests/test_heatmap.py poisons the
recorder's internals to pin it.

On top of the matrix:

  * hot-range detection — per closed bucket, each range's activity is
    compared against the FLEET MEDIAN across all known ranges (zeros
    included: skew to one of four ranges reads as median 0); a range
    at `hot-ratio` x median for `sustained-buckets` consecutive closed
    buckets fires ONE edge-triggered `hot_range` event (re-armed when
    it cools).
  * split advisory — per range, a bounded counter-replacement key
    sample (cap `key-sample-cap`, deterministic, no RNG) accumulates
    observed write keys with weights; a hot range's advisory is the
    weighted-median sampled key (the within-range point that best
    halves observed traffic), surfaced as a finding only when it falls
    strictly inside the observed span.

Surfaces: information_schema.tidb_hot_ranges + cluster_hot_ranges
(diag fan-out, per-peer degradation), /debug/keyviz (JSON matrix + an
ASCII heatmap), tidb_range_{read,write}_{rows,bytes}_total{range} +
tidb_hot_range_ratio metrics, the hot-range / range-split-advisory
inspection rules (obs_inspect.py), and heat columns on the /status
ranges block + cluster_info type='range' rows.

Port of `tidb_tpu/obs_heat.py`, whole. The recorder's lock is declared
hot for the lock-order checker (analysis/registry.py HOT_LOCKS). Buckets
rotate on `time.time()`, as in the reference.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from .analysis import lockcheck
from .kv.rangemeta import RangeSpec, locate_spec, split_keyspace

# cell layout: one list per (bucket, range) — indexed, not a dataclass,
# because the note path appends to it per statement
_READ_ROWS, _READ_BYTES, _WRITE_ROWS, _WRITE_BYTES, _STMTS = range(5)

# ASCII heatmap shade ramp, cold -> hot
_SHADES = " .:-=+*#%@"


class RangeHeatRecorder:
    """Per-storage keyspace heat matrix: time buckets x range cells.

    Thread-safe: one hot lock guards the ring, the totals and the key
    samples; every critical section is dict/list arithmetic (no
    blocking call — the lock is HOT_LOCKS-declared because the 2PC
    commit path feeds it). No thread of its own: bucket rotation is
    lazy, performed by whichever note() first lands in a new window
    (the TopSQL ring idiom), and hot detection runs only at rotation —
    once per bucket-seconds, not per statement."""

    DEFAULT_BUCKET_S = 10
    DEFAULT_RING = 36
    DEFAULT_HOT_RATIO = 8.0
    DEFAULT_SUSTAINED = 2
    DEFAULT_KEY_SAMPLE_CAP = 64

    def __init__(self, metrics=None, events=None) -> None:
        self.enabled = False
        self.bucket_seconds = int(self.DEFAULT_BUCKET_S)
        self.ring_buckets = int(self.DEFAULT_RING)
        self.hot_ratio = float(self.DEFAULT_HOT_RATIO)
        self.sustained_buckets = int(self.DEFAULT_SUSTAINED)
        self.key_sample_cap = int(self.DEFAULT_KEY_SAMPLE_CAP)
        self.events = events
        # guards ring/totals/samples; every section is pure arithmetic
        # (HOT_LOCKS-declared: the commit path holds it per note)
        self._mu = lockcheck.lock("RangeHeatRecorder._mu", hot=True)
        # the range table the router notes resolve against; a store
        # without an armed range plane is one whole-keyspace range
        self._specs: list[RangeSpec] = split_keyspace(1)
        # ring of {"start": win, "cells": {rid: [r_rows, r_bytes,
        # w_rows, w_bytes, stmts]}}, oldest first
        self._ring: deque = deque(maxlen=self.ring_buckets)
        # lifetime per-range totals [r_rows, r_bytes, w_rows, w_bytes]
        # — the cheap read for describe()/table_rows()
        self._totals: dict[int, list] = {}
        # per-range bounded write-key sample: rid -> {"keys": {key:
        # weight}, "n": seen-counter, "order": [keys by slot]}
        self._samples: dict[int, dict] = {}
        # rid -> consecutive closed buckets at/over hot-ratio
        self._streak: dict[int, int] = {}
        # ranges currently flagged hot (edge-trigger memory)
        self._fired: set = set()
        if metrics is not None:
            self.read_rows_total = metrics.counter(
                "tidb_range_read_rows_total",
                "rows served by point reads and scans, by range "
                "(the keyspace heatmap's read axis; empty while "
                "heatmap.enabled is false)")
            self.read_bytes_total = metrics.counter(
                "tidb_range_read_bytes_total",
                "bytes served by point reads and scans, by range")
            self.write_rows_total = metrics.counter(
                "tidb_range_write_rows_total",
                "mutations committed through 2PC, by range (the "
                "keyspace heatmap's write axis)")
            self.write_bytes_total = metrics.counter(
                "tidb_range_write_bytes_total",
                "mutation value bytes committed through 2PC, by range")
            self.hot_ratio_gauge = metrics.gauge(
                "tidb_hot_range_ratio",
                "last closed bucket's activity ratio vs the fleet "
                "median, by range (>= heatmap.hot-ratio sustained for "
                "heatmap.sustained-buckets buckets = hot)")
        else:
            self.read_rows_total = None
            self.read_bytes_total = None
            self.write_rows_total = None
            self.write_bytes_total = None
            self.hot_ratio_gauge = None

    # ==================== config ====================
    def configure(self, enabled: Optional[bool] = None,
                  bucket_seconds: Optional[int] = None,
                  ring_buckets: Optional[int] = None,
                  hot_ratio: Optional[float] = None,
                  sustained_buckets: Optional[int] = None,
                  key_sample_cap: Optional[int] = None) -> None:
        """Apply the [heatmap] knobs (startup + SIGHUP hot reload;
        every knob reloads live — a shrunk ring drops oldest buckets
        at the next rotation, a shrunk sample cap applies to new
        samples)."""
        if bucket_seconds is not None:
            self.bucket_seconds = max(int(bucket_seconds), 1)
        if ring_buckets is not None:
            cap = max(int(ring_buckets), 2)
            if cap != self.ring_buckets:
                self.ring_buckets = cap
                with self._mu:
                    self._ring = deque(self._ring, maxlen=cap)
        if hot_ratio is not None:
            self.hot_ratio = max(float(hot_ratio), 1.0)
        if sustained_buckets is not None:
            self.sustained_buckets = max(int(sustained_buckets), 1)
        if key_sample_cap is not None:
            self.key_sample_cap = max(int(key_sample_cap), 2)
        if enabled is not None:
            self.enabled = bool(enabled)

    def set_specs(self, specs) -> None:
        """Adopt the authoritative range table (arm_ranges calls this
        when the range plane boots; cells recorded under the old table
        keep their ids — range ids are stable across epoch bumps)."""
        if not specs:
            return
        with self._mu:
            self._specs = sorted(specs, key=lambda s: s.start_key)

    def on_split(self, parent_rid: int, specs) -> None:
        """Cell migration for one completed range split: adopt the
        post-split table and retire the parent's recorded state —
        its cells/totals/samples span the PRE-split bounds, which no
        live range has, so carrying them forward would hand one child
        phantom heat (and keyviz/hot-range phantom parent rows). Both
        children start with a clean window; the hot workload refills
        it within a bucket. Runs on the maintenance path (split/lease
        tick), never per statement — and touches none of the note-path
        internals, so it is safe even on a disabled recorder."""
        parent_rid = int(parent_rid)
        with self._mu:
            if specs:
                self._specs = sorted(specs, key=lambda s: s.start_key)
            live = {s.id for s in self._specs}
            doomed = ({rid for rid in self._totals if rid not in live}
                      | {parent_rid})
            for rid in doomed:
                self._totals.pop(rid, None)
                self._samples.pop(rid, None)
                self._streak.pop(rid, None)
                self._fired.discard(rid)
            for bucket in self._ring:
                for rid in doomed:
                    bucket["cells"].pop(rid, None)

    # ==================== the note hot path ====================
    def note_read(self, key: bytes, rows: int, nbytes: int) -> None:
        """One point read: route the key, account one cell."""
        if not self.enabled:
            return
        with self._mu:
            rid = locate_spec(self._specs, key).id
            cell = self._cell(rid)
            cell[_READ_ROWS] += rows
            cell[_READ_BYTES] += nbytes
            cell[_STMTS] += 1
            tot = self._totals.setdefault(rid, [0, 0, 0, 0])
            tot[0] += rows
            tot[1] += nbytes
        if self.read_rows_total is not None:
            self.read_rows_total.inc(rows, range=str(rid))
            self.read_bytes_total.inc(nbytes, range=str(rid))

    def note_scan(self, table_id: int, rows: int, nbytes: int) -> None:
        """One coprocessor scan over a whole table: split the traffic
        evenly across the ranges overlapping the table's record span
        (honest for full scans — every overlapped range served its
        share of the fold)."""
        if not self.enabled:
            return
        from .kv import tablecodec
        start, end = tablecodec.record_range(table_id)
        with self._mu:
            rids = [s.id for s in self._specs
                    if s.start_key < end
                    and (not s.end_key or start < s.end_key)]
            if not rids:
                return
            r_share = rows // len(rids)
            b_share = nbytes // len(rids)
            # remainder lands on the first overlapped range so totals
            # stay exact
            r_rem = rows - r_share * len(rids)
            b_rem = nbytes - b_share * len(rids)
            for i, rid in enumerate(rids):
                r = r_share + (r_rem if i == 0 else 0)
                b = b_share + (b_rem if i == 0 else 0)
                cell = self._cell(rid)
                cell[_READ_ROWS] += r
                cell[_READ_BYTES] += b
                cell[_STMTS] += 1
                tot = self._totals.setdefault(rid, [0, 0, 0, 0])
                tot[0] += r
                tot[1] += b
            shares = [(rid,
                       r_share + (r_rem if i == 0 else 0),
                       b_share + (b_rem if i == 0 else 0))
                      for i, rid in enumerate(rids)]
        if self.read_rows_total is not None:
            for rid, r, b in shares:
                self.read_rows_total.inc(r, range=str(rid))
                self.read_bytes_total.inc(b, range=str(rid))

    def note_write(self, items) -> None:
        """One committed transaction's mutations: (key, value_bytes)
        pairs, routed per key; keys also feed the per-range split
        sample (weight = 1 + value bytes)."""
        if not self.enabled:
            return
        per_range: dict[int, list] = {}
        with self._mu:
            for key, nbytes in items:
                rid = locate_spec(self._specs, key).id
                acc = per_range.setdefault(rid, [0, 0])
                acc[0] += 1
                acc[1] += nbytes
                self._sample(rid, key, 1 + nbytes)
            for rid, (rows, nbytes) in per_range.items():
                cell = self._cell(rid)
                cell[_WRITE_ROWS] += rows
                cell[_WRITE_BYTES] += nbytes
                cell[_STMTS] += 1
                tot = self._totals.setdefault(rid, [0, 0, 0, 0])
                tot[2] += rows
                tot[3] += nbytes
        if self.write_rows_total is not None:
            for rid, (rows, nbytes) in per_range.items():
                self.write_rows_total.inc(rows, range=str(rid))
                self.write_bytes_total.inc(nbytes, range=str(rid))

    def note_range(self, rid: int, read_rows: int = 0,
                   read_bytes: int = 0, write_rows: int = 0,
                   write_bytes: int = 0, keys=None) -> None:
        """Direct cell feed for a caller that already knows the range
        (the range LEADER: rpc/ranged.py notes its applied prewrites
        here — no key routing, the fencing gate already resolved it)."""
        if not self.enabled:
            return
        with self._mu:
            cell = self._cell(int(rid))
            cell[_READ_ROWS] += read_rows
            cell[_READ_BYTES] += read_bytes
            cell[_WRITE_ROWS] += write_rows
            cell[_WRITE_BYTES] += write_bytes
            cell[_STMTS] += 1
            tot = self._totals.setdefault(int(rid), [0, 0, 0, 0])
            tot[0] += read_rows
            tot[1] += read_bytes
            tot[2] += write_rows
            tot[3] += write_bytes
            for key in keys or ():
                self._sample(int(rid), key, 1)
        if self.read_rows_total is not None:
            if read_rows or read_bytes:
                self.read_rows_total.inc(read_rows, range=str(rid))
                self.read_bytes_total.inc(read_bytes, range=str(rid))
            if write_rows or write_bytes:
                self.write_rows_total.inc(write_rows, range=str(rid))
                self.write_bytes_total.inc(write_bytes,
                                           range=str(rid))

    # ---- internals (call with _mu held) ----
    def _cell(self, rid: int) -> list:
        """The live bucket's cell for one range, rotating the ring
        when the wall clock crossed a bucket boundary."""
        now = time.time()
        win = int(now - (now % self.bucket_seconds))
        if not self._ring or self._ring[-1]["start"] != win:
            self._rotate(win)
        return self._ring[-1]["cells"].setdefault(
            rid, [0, 0, 0, 0, 0])

    def _rotate(self, win: int) -> None:
        """Close the previous bucket (hot detection runs HERE — once
        per bucket, not per note) and open the new one. Events are
        queued and emitted by note_* after the lock drops? No: the
        event ring's record() is pure list arithmetic (obs.EventLog),
        safe under the hot lock, and rotation is off the per-statement
        path by construction."""
        if self._ring:
            self._detect(self._ring[-1])
        self._ring.append({"start": win, "cells": {}})

    def _detect(self, bucket: dict) -> None:
        """Hot-cell detection over one CLOSED bucket: activity vs the
        fleet median (every known range counted, zeros included),
        streak bookkeeping, and the edge-triggered hot_range event."""
        cells = bucket["cells"]
        acts = {s.id: self._activity(cells.get(s.id))
                for s in self._specs}
        med = _median(list(acts.values()))
        floor = max(med, 1.0)
        for rid, act in acts.items():
            ratio = act / floor
            if self.hot_ratio_gauge is not None and act > 0:
                self.hot_ratio_gauge.set(round(ratio, 3),
                                         range=str(rid))
            if ratio >= self.hot_ratio and act > 0:
                self._streak[rid] = self._streak.get(rid, 0) + 1
                if self._streak[rid] >= self.sustained_buckets \
                        and rid not in self._fired:
                    self._fired.add(rid)
                    if self.events is not None:
                        self.events.record(
                            "hot_range", severity="warning",
                            detail=f"r{rid} at {ratio:.1f}x the fleet "
                                   f"median for {self._streak[rid]} "
                                   f"buckets (activity {int(act)} "
                                   f"rows/bucket)")
            else:
                self._streak[rid] = 0
                self._fired.discard(rid)

    @staticmethod
    def _activity(cell) -> float:
        if not cell:
            return 0.0
        return float(cell[_READ_ROWS] + cell[_WRITE_ROWS])

    def _sample(self, rid: int, key: bytes, weight: int) -> None:
        """Bounded per-range key sketch: grow to the cap, then replace
        the slot at (seen % cap) — deterministic (no RNG: bench runs
        must reproduce), biased toward recency, which is what a split
        advisory wants. Re-observing a sampled key adds weight."""
        s = self._samples.get(rid)
        if s is None:
            s = self._samples[rid] = {"keys": {}, "order": [], "n": 0}
        s["n"] += 1
        key = bytes(key)
        if key in s["keys"]:
            s["keys"][key] += weight
            return
        if len(s["order"]) < self.key_sample_cap:
            s["order"].append(key)
            s["keys"][key] = weight
            return
        victim = s["order"][s["n"] % len(s["order"])]
        del s["keys"][victim]
        s["order"][s["n"] % len(s["order"])] = key
        s["keys"][key] = weight

    # ==================== read surfaces ====================
    def range_totals(self, rid: int) -> tuple:
        """(read_rows, read_bytes, write_rows, write_bytes) served by
        one range over the recorder's lifetime — the heat columns of
        describe()/cluster_info."""
        with self._mu:
            t = self._totals.get(int(rid))
            return tuple(t) if t else (0, 0, 0, 0)

    def split_advisory(self, rid: int) -> Optional[bytes]:
        """The within-range key that best halves observed write
        traffic: the weighted median of the range's sampled keys.
        None without at least two distinct sampled keys (a one-key
        hotspot cannot be split — that is the salted-key case)."""
        with self._mu:
            return self._split_advisory_locked(int(rid))

    def _split_advisory_locked(self, rid: int) -> Optional[bytes]:
        s = self._samples.get(rid)
        if s is None or len(s["keys"]) < 2:
            return None
        keys = sorted(s["keys"])
        weights = [s["keys"][k] for k in keys]
        total = sum(weights)
        acc = 0
        idx = 0
        for i, w in enumerate(weights):
            acc += w
            if acc * 2 >= total:
                idx = i
                break
        # a split AT the smallest observed key moves nothing; advance
        # so the advisory always partitions the observed span
        if idx == 0:
            idx = 1
        return keys[idx]

    def _trailing_hot(self) -> dict[int, tuple]:
        """rid -> (ratio, activity) for ranges hot across the trailing
        `sustained-buckets` buckets INCLUDING the live one — the
        on-demand view findings()/table_rows() use (the per-rotation
        detector feeds the event ring; this one answers 'is it hot
        RIGHT NOW' without waiting out a bucket)."""
        need = self.sustained_buckets
        buckets = list(self._ring)[-need:]
        if len(buckets) < need:
            return {}
        out: dict[int, tuple] = {}
        for i, b in enumerate(buckets):
            cells = b["cells"]
            acts = {s.id: self._activity(cells.get(s.id))
                    for s in self._specs}
            floor = max(_median(list(acts.values())), 1.0)
            hot = {rid: (act / floor, act)
                   for rid, act in acts.items()
                   if act > 0 and act / floor >= self.hot_ratio}
            if i == 0:
                out = hot
            else:
                out = {rid: v for rid, v in hot.items() if rid in out}
            if not out:
                return {}
        return out

    def findings(self) -> list[dict]:
        """Current heat findings, finding-dict shaped like the history
        plane's (the hot-range / range-split-advisory inspection rules
        lift these into Finding rows verbatim)."""
        if not self.enabled:
            return []
        out: list[dict] = []
        with self._mu:
            hot = self._trailing_hot()
            for rid in sorted(hot):
                ratio, act = hot[rid]
                spec = next((s for s in self._specs if s.id == rid),
                            None)
                span = (f"[{spec.start_key.hex() or '-inf'}, "
                        f"{spec.end_key.hex() or '+inf'})"
                        if spec is not None else "?")
                out.append({
                    "rule": "hot-range", "item": f"r{rid}",
                    "severity": "warning",
                    "value": f"{ratio:.1f}x",
                    "details": f"range {rid} {span} at {ratio:.1f}x "
                               f"the fleet median ({int(act)} "
                               f"rows/bucket) for "
                               f"{self.sustained_buckets}+ buckets"})
                split = self._split_advisory_locked(rid)
                if split is not None:
                    s = self._samples.get(rid, {}).get("keys", {})
                    lo = min(s) if s else b""
                    hi = max(s) if s else b""
                    out.append({
                        "rule": "range-split-advisory",
                        "item": f"r{rid}",
                        "severity": "info",
                        "value": split.hex()[:48],
                        "details": f"splitting range {rid} at key "
                                   f"{split.hex()[:48]} best halves "
                                   f"its observed write traffic "
                                   f"(sampled span "
                                   f"[{lo.hex()[:24]}, "
                                   f"{hi.hex()[:24]}]); not acted on "
                                   f"— add it to ranges.split-points"})
        return out

    def table_rows(self) -> list[list]:
        """information_schema.tidb_hot_ranges rows (the cluster fan-out
        adds instance/error): one row per known range with lifetime
        traffic, the live hot ratio, and the split advisory. Empty —
        zero work — while disabled."""
        if not self.enabled:
            return []
        rows: list[list] = []
        with self._mu:
            hot = self._trailing_hot()
            for spec in self._specs:
                t = self._totals.get(spec.id, [0, 0, 0, 0])
                ratio = hot.get(spec.id, (0.0, 0.0))[0]
                split = self._split_advisory_locked(spec.id) \
                    if spec.id in hot else None
                rows.append([
                    int(spec.id),
                    spec.start_key.hex(), spec.end_key.hex(),
                    int(t[0]), int(t[1]), int(t[2]), int(t[3]),
                    round(float(ratio), 3),
                    1 if spec.id in hot else 0,
                    split.hex()[:48] if split is not None else None])
        return rows

    def debug_payload(self) -> dict:
        """The /debug/keyviz JSON: knobs, the time x range matrix
        (oldest bucket first), per-range totals, an ASCII heatmap, and
        the current findings."""
        out: dict = {
            "enabled": self.enabled,
            "bucket_seconds": self.bucket_seconds,
            "ring_buckets": self.ring_buckets,
            "hot_ratio": self.hot_ratio,
            "sustained_buckets": self.sustained_buckets,
            "key_sample_cap": self.key_sample_cap,
        }
        if not self.enabled:
            return out
        with self._mu:
            specs = list(self._specs)
            buckets = [{"start": b["start"],
                        "cells": {str(rid): list(c)
                                  for rid, c in sorted(
                                      b["cells"].items())}}
                       for b in self._ring]
            totals = {str(rid): list(t)
                      for rid, t in sorted(self._totals.items())}
        out["ranges"] = [{"id": s.id, "start": s.start_key.hex(),
                          "end": s.end_key.hex()} for s in specs]
        out["buckets"] = buckets
        out["totals"] = totals
        out["heatmap"] = _ascii_heatmap(specs, buckets)
        out["findings"] = self.findings()
        return out


def _median(vals: list) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    if n % 2:
        return float(vals[mid])
    return (vals[mid - 1] + vals[mid]) / 2.0


def _ascii_heatmap(specs, buckets) -> list[str]:
    """Render the time x range matrix as shade-ramp lines, one per
    range (rows) over the ring's buckets (columns, oldest left) —
    the keyviz picture in a terminal."""
    if not buckets:
        return []
    peak = 1.0
    acts: dict[int, list] = {s.id: [] for s in specs}
    for b in buckets:
        for s in specs:
            cell = b["cells"].get(str(s.id))
            act = float(cell[_READ_ROWS] + cell[_WRITE_ROWS]) \
                if cell else 0.0
            acts[s.id].append(act)
            peak = max(peak, act)
    lines = []
    ramp = len(_SHADES) - 1
    for s in specs:
        row = "".join(
            _SHADES[min(int(a / peak * ramp + (0 if a == 0 else 1)),
                        ramp)]
            for a in acts[s.id])
        start = s.start_key.hex()[:8] or "-inf"
        lines.append(f"r{s.id:<3} {start:>8} |{row}|")
    return lines


__all__ = ["RangeHeatRecorder"]
