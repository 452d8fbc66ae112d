"""Stats handle: per-table statistics registry + cardinality estimation.

Counterpart of the reference's statistics/handle (handle.go load/save,
update.go delta-driven auto-analyze) and selectivity.go estimation entry.
Single-process: stats live in memory keyed by table id; the delta feed is
the TableStore's modify counter (the reference accumulates per-session
deltas into mysql.stats_meta).

Estimation hierarchy per predicate, mirroring the reference's order:
exact TopN -> CM sketch point query (eq) / histogram interpolation
(ranges) -> pseudo rates when stats are missing (the reference's
PseudoTable path, statistics/table.go).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..catalog.schema import TableInfo
from .histogram import Histogram
from .sketch import CMSketch, FMSketch

# pseudo rates for columns without stats (reference: statistics/table.go
# pseudoEqualRate / pseudoLessRate)
PSEUDO_EQ_RATE = 1.0 / 1000
PSEUDO_RANGE_RATE = 1.0 / 3
SAMPLE_CAP = 1 << 20  # build from at most ~1M rows, extrapolated




@dataclass
class ColumnStats:
    null_count: float
    ndv: int
    histogram: Optional[Histogram]  # numeric/temporal only
    cmsketch: Optional[CMSketch]
    total: float  # non-null rows (scaled)
    # string columns: the table's append-only dictionary (codes are stable
    # across epochs) — planner predicates carry raw strings, the sketch is
    # keyed on codes
    dictionary: Any = None
    # observed per-value row counts from actual executions, overriding
    # the sketch estimate (reference: feedback.go point feedback)
    eq_feedback: dict = field(default_factory=dict)

    MAX_EQ_FEEDBACK = 128

    def eq_rows(self, value) -> float:
        if value is None:
            return self.null_count
        if isinstance(value, str):
            if self.dictionary is None:
                return self.total / self.ndv if self.ndv else 0.0
            code = self.dictionary.lookup(value)
            if code < 0:
                return 0.0
            value = code
        fb = self.eq_feedback.get(_fb_key(value))
        if fb is not None:
            return fb
        if self.cmsketch is not None:
            return float(self.cmsketch.query(value))
        if self.ndv > 0:
            return self.total / self.ndv
        return 0.0

    def note_eq_feedback(self, value, actual: float) -> None:
        if value is None:
            return
        if isinstance(value, str):
            # key on the dictionary code, exactly as eq_rows looks up —
            # raw-string keys would never be hit and numeric-looking
            # strings would collide with codes
            if self.dictionary is None:
                return
            code = self.dictionary.lookup(value)
            if code < 0:
                return
            value = code
        key = _fb_key(value)
        if key not in self.eq_feedback and \
                len(self.eq_feedback) >= self.MAX_EQ_FEEDBACK:
            self.eq_feedback.pop(next(iter(self.eq_feedback)))
        self.eq_feedback[key] = float(actual)

    def range_rows(self, lo, hi, lo_incl: bool, hi_incl: bool) -> float:
        if self.histogram is None:
            return self.total * PSEUDO_RANGE_RATE
        return self.histogram.range_count(lo, hi, lo_incl, hi_incl)


def _fb_key(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return value


@dataclass
class TableStats:
    table_id: int
    row_count: float
    columns: dict[int, ColumnStats]  # keyed by column offset
    version: int = 0
    built_at: float = field(default_factory=time.time)


class StatsHandle:
    """All tables' stats + auto-analyze bookkeeping."""

    AUTO_ANALYZE_RATIO = 0.5  # reference: tidb_auto_analyze_ratio default

    def __init__(self) -> None:
        self.tables: dict[int, TableStats] = {}
        # bumped whenever stats materially change (ANALYZE/load/drop);
        # plan-cache entries key on it for invalidation
        self.generation = 0
        # modify counts at last ANALYZE, per table id
        self._analyzed_at_modify: dict[int, int] = {}
        # (table_id, condition digest) -> observed row count from actual
        # executions (reference: statistics/feedback.go — scan-count
        # feedback correcting the histogram-based estimate)
        self.feedback: dict[tuple[int, str], float] = {}

    # ---- build ------------------------------------------------------------
    # full-column device reductions replace the host scans above this
    # many rows (ANALYZE pushdown; copr/analyze.py)
    DEVICE_ANALYZE_MIN = 2_000_000

    def build_table(self, info: TableInfo, snap, cop=None) -> TableStats:
        """ANALYZE: build stats from a snapshot's visible rows
        (reference: executor/analyze.go over pushdown sample collectors).
        With a coprocessor client and a big table, the full-column pass
        (counts, min/max, NDV) runs as device reduction kernels over the
        query path's tiles; histograms/CM build from a host sample."""
        n = snap.num_visible_rows
        rng = np.random.default_rng(info.id)
        dev_stats = {}
        if cop is not None and n >= self.DEVICE_ANALYZE_MIN and \
                len(snap.overlay_handles) == 0:
            # no catch: on a CUDA client the device pass works or raises
            from ..copr.analyze import device_column_stats
            dev_stats = device_column_stats(
                cop, snap, list(range(info.num_columns)))
        cols: dict[int, ColumnStats] = {}
        for off in range(info.num_columns):
            col = snap.column(off)
            data, valid = col.data, col.validity
            nn = data[valid] if valid is not None else data
            scale = 1.0
            if len(nn) > SAMPLE_CAP:
                scale = len(nn) / SAMPLE_CAP
                nn = rng.choice(nn, SAMPLE_CAP, replace=False)
            null_count = float(n - (len(nn) * scale))
            ft = info.columns[off].ftype
            hist = None
            if not ft.is_string and len(nn):
                hist = Histogram.build(nn, scale)
            cm = CMSketch.build(nn, scale) if len(nn) else None
            if off in dev_stats:
                nonnull, _mn, _mx, ndv = dev_stats[off]
                null_count = float(n - nonnull)
            elif scale == 1.0:
                ndv = (int(len(np.unique(nn))) if len(nn) <= FMSketch.MAX_SIZE
                       * 16 else FMSketch.build(nn).ndv)
            else:
                # GEE-style scale-up: values seen once in the sample predict
                # the unseen mass (reference samples feed fmsketch merges,
                # statistics/builder.go)
                u, c = np.unique(nn, return_counts=True)
                f1 = int((c == 1).sum())
                ndv = min(int(len(u) + (scale - 1.0) * f1),
                          int(len(nn) * scale))
            cols[off] = ColumnStats(
                null_count, ndv, hist, cm, float(len(nn)) * scale,
                dictionary=snap.dictionaries[off] if ft.is_string else None)
        ts = TableStats(info.id, float(n), cols,
                        version=self.tables.get(info.id).version + 1
                        if info.id in self.tables else 1)
        self.tables[info.id] = ts
        return ts

    def analyze_one(self, info: TableInfo, store, storage,
                    cop=None) -> TableStats:
        """Analyze one table from a fresh snapshot and record the modify
        watermark — shared by ANALYZE TABLE and auto-analyze."""
        txn = storage.begin()
        try:
            ts = self.build_table(info, txn.snapshot(info.id), cop=cop)
            self.generation += 1  # invalidates cached plans (cache key)
            self._analyzed_at_modify[info.id] = store.modify_count
            # fresh stats supersede stale observation feedback
            self.clear_feedback(info.id)
            # no catch (the reference's is best-effort): a statistics
            # write that fails fails the ANALYZE
            self.save_to_kv(storage, info.id)
            return ts
        finally:
            txn.rollback()

    # ---- persistence (reference: statistics/handle/handle.go saves to
    # mysql.stats_* tables; here the meta-KV plane) ----------------------
    def save_to_kv(self, storage, table_id: int) -> None:
        import pickle

        ts = self.tables.get(table_id)
        if ts is None:
            return
        payload = (ts, self._analyzed_at_modify.get(table_id, 0))
        storage.put_meta(b"stats:%d" % table_id, pickle.dumps(payload))

    def load_from_kv(self, storage, catalog) -> int:
        """Restore persisted stats for every known table; returns count.
        The analog of the stats handle's boot-time load
        (statistics/handle/bootstrap.go)."""
        import pickle

        n = 0
        for schema in catalog.schemas.values():
            for info in schema.tables.values():
                raw = storage.get_meta(b"stats:%d" % info.id)
                if raw is not None:
                    ts, watermark = pickle.loads(raw)
                    self.tables[info.id] = ts
                    # restore the analyze watermark too, else auto-analyze
                    # immediately rebuilds what the reload just restored
                    self._analyzed_at_modify[info.id] = watermark
                    n += 1
        return n

    # ---- execution feedback --------------------------------------------
    FEEDBACK_CAP = 4096  # distinct conjunct sets retained (process-wide)

    def record_condition_feedback(self, table_id: int,
                                  col_offsets: list[int],
                                  conditions, actual: float) -> None:
        """Merge an actual scan count back into column-level stats when
        the conjunct set is attributable to one column: a single
        equality updates the point-feedback table, an interval rescales
        the histogram buckets (reference: statistics/feedback.go +
        handle/update.go:551 merging range feedback)."""
        ts = self.tables.get(table_id)
        if ts is None:
            return
        from ..plan.expr import Call
        from ..plan.physical import _expr_cols
        from ..plan.ranger import _eq_values, extract_interval

        col_map = {i: off for i, off in enumerate(col_offsets)}
        if len(conditions) == 1:
            hit = _eq_values(conditions[0], col_map)
            if hit is not None and len(hit[1]) == 1:
                cs = ts.columns.get(hit[0])
                if cs is not None:
                    cs.note_eq_feedback(hit[1][0], actual)
                return
        # interval feedback is sound only when EVERY conjunct bounds the
        # same column (extra predicates would shrink `actual` and the
        # correction would wrongly deflate the histogram)
        offs: set[int] = set()
        for c in conditions:
            cols: set[int] = set()
            _expr_cols(c, cols)
            if not (isinstance(c, Call)
                    and c.op in ("lt", "le", "gt", "ge")):
                return
            offs.update(col_map.get(i, -1) for i in cols)
        if len(offs) != 1 or -1 in offs:
            return
        off = next(iter(offs))
        cs = ts.columns.get(off)
        if cs is None or cs.histogram is None:
            return
        interval = extract_interval(off, conditions, col_map)
        if interval is None:
            return
        lo, hi, lo_incl, hi_incl = interval
        cs.histogram.apply_range_feedback(lo, hi, lo_incl, hi_incl,
                                          actual)

    def record_feedback(self, table_id: int, digest: str,
                        actual_rows: float) -> None:
        if len(self.feedback) >= self.FEEDBACK_CAP:
            # drop the oldest observation (insertion-ordered dict)
            self.feedback.pop(next(iter(self.feedback)))
        self.feedback[(table_id, digest)] = actual_rows

    def feedback_rows(self, table_id: int, digest: str):
        return self.feedback.get((table_id, digest))

    def clear_feedback(self, table_id: int) -> None:
        for k in [k for k in self.feedback if k[0] == table_id]:
            del self.feedback[k]

    def drop_table(self, table_id: int) -> None:
        self.generation += 1
        self.clear_feedback(table_id)
        self.tables.pop(table_id, None)
        self._analyzed_at_modify.pop(table_id, None)

    # ---- estimation -------------------------------------------------------
    def table_stats(self, table_id: int) -> Optional[TableStats]:
        return self.tables.get(table_id)

    def est_eq_rows(self, table_id: int, offset: int, value,
                    fallback_rows: float) -> float:
        ts = self.tables.get(table_id)
        if ts is None or offset not in ts.columns:
            return fallback_rows * PSEUDO_EQ_RATE
        return ts.columns[offset].eq_rows(value)

    def est_range_rows(self, table_id: int, offset: int, lo, hi,
                       lo_incl: bool, hi_incl: bool,
                       fallback_rows: float) -> float:
        ts = self.tables.get(table_id)
        if ts is None or offset not in ts.columns:
            return fallback_rows * PSEUDO_RANGE_RATE
        return ts.columns[offset].range_rows(lo, hi, lo_incl, hi_incl)

    # ---- auto analyze -----------------------------------------------------
    def needs_auto_analyze(self, info: TableInfo, store,
                           ratio: Optional[float] = None) -> bool:
        """Delta-driven trigger (reference: handle/update.go:860
        HandleAutoAnalyze, ratio of modify count to row count)."""
        if ratio is None:
            ratio = self.AUTO_ANALYZE_RATIO
        modified = store.modify_count
        ts = self.tables.get(info.id)
        if ts is None:
            return modified > 0
        done = self._analyzed_at_modify.get(info.id, 0)
        delta = modified - done
        return delta > max(ts.row_count, 1) * ratio and delta >= 64

    def auto_analyze(self, storage, catalog) -> list[str]:
        """Run pending auto-analyzes; returns analyzed table names.
        The trigger ratio honors SET GLOBAL tidb_auto_analyze_ratio."""
        try:
            ratio = float(storage.sysvars.get_global(
                "tidb_auto_analyze_ratio"))
        except (TypeError, ValueError):
            ratio = self.AUTO_ANALYZE_RATIO
        out = []
        for schema in list(catalog.schemas.values()):
            for info in list(schema.tables.values()):
                part = getattr(info, "partition", None)
                if part is not None:
                    targets = [(storage.child_table_info(info, d), d.id)
                               for d in part.defs]
                else:
                    targets = [(info, info.id)]
                for tinfo, tid in targets:
                    try:
                        store = storage.table_store(tid)
                    except KeyError:
                        continue
                    if not self.needs_auto_analyze(tinfo, store, ratio):
                        continue
                    self.analyze_one(tinfo, store, storage)
                    out.append(info.name)
        return out
