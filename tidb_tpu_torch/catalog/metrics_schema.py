"""metrics_schema: every registered metric family as a SQL memtable.

Port of `tidb_tpu/catalog/metrics_schema.py`, whole; its tables are the
families the port registers, which are the reference's less those of the
planes it does not have (`UNPORTED_FAMILIES`). Counterpart of the reference's metrics schema (reference: TiDB 4.0's
infoschema/metrics_schema.go — a `metrics_schema` database with one
virtual table per metric, each reading the Prometheus time series so
operators and the inspection rules share ONE query surface). The
embedded analog reads its own registries: every counter/gauge family
registered in the server registry or the process-wide registry becomes
a table named after the family, whose rows are the bounded
MetricsHistory ring (time-range) plus one live sample taken at read
time (point-in-time).

    SELECT time, labels, value FROM metrics_schema.tidb_queries_total;
    SELECT max(value) FROM metrics_schema.tidb_process_rss_bytes;

Row shape per table: (time, ts, labels, value) — `labels` is the
flattened label part of the sample ('stage="kernel"', '' when
unlabeled), so one table serves every series of its family.
Histograms stay on /metrics only, exactly like MetricsHistory's
flat_samples. Tables never persist (derived data) and rebuild on
demand like the information_schema memtables.
"""

from __future__ import annotations

import time

from .. import obs
from ..types.field_type import FieldType, TypeKind
from .schema import Catalog, ColumnInfo, SchemaInfo, TableInfo

DB_NAME = "metrics_schema"

# the reference's families that the port does not register, with the
# plane they wait for: the mesh plane (item 8)
UNPORTED_FAMILIES = frozenset({
    # mesh plane and its flight recorder
    "tidb_mesh_devices", "tidb_mesh_reshard_bytes_total",
    "tidb_mesh_skew_ratio", "tidb_mesh_skew_warnings_total",
    "tidb_mesh_compiles_total", "tidb_mesh_compile_seconds_total",
    "tidb_mesh_recompile_storms_total", "tidb_mesh_hbm_watermark_total",
})

_COLS = [
    ("time", FieldType(TypeKind.VARCHAR, flen=20)),
    ("ts", FieldType(TypeKind.DOUBLE)),
    ("labels", FieldType(TypeKind.VARCHAR, flen=160)),
    ("value", FieldType(TypeKind.DOUBLE)),
]


def _registries(storage) -> list:
    return [storage.obs.metrics, obs.PROCESS_METRICS]


def families(storage) -> dict[str, str]:
    """Live counter/gauge families -> help text (the table universe).
    Registration order is preserved; cross-registry duplicates are a
    lint error upstream (obs.lint_metrics), first one wins here."""
    fams: dict[str, str] = {}
    for reg in _registries(storage):
        with reg._lock:
            metrics = list(reg._metrics.values())
        for m in metrics:
            if isinstance(m, (obs.Counter, obs.Gauge)) \
                    and m.name not in fams:
                fams[m.name] = m.help
    return fams


def ensure_schema(storage) -> None:
    """Create the metrics_schema database and one table per live
    metric family. Idempotent and incremental: families registered
    after the first call get their tables on the next one. Catalog
    mutation runs under storage.infoschema_lock — unlike the
    information_schema's one-shot ensure, this check-then-insert
    re-opens every time a family registers, and two first-touch
    sessions racing alloc_id would alias two families onto one table
    id."""
    cat: Catalog = storage.catalog
    with storage.infoschema_lock:
        if DB_NAME not in cat.schemas:
            cat.schemas[DB_NAME] = SchemaInfo(DB_NAME)
        schema = cat.schemas[DB_NAME]
        for fam in families(storage):
            if fam in schema.tables:
                continue
            info = TableInfo(
                id=cat.alloc_id(),
                name=fam,
                columns=[ColumnInfo(cat.alloc_id(), cn, ft, offset=i)
                         for i, (cn, ft) in enumerate(_COLS)],
            )
            schema.tables[fam] = info
            store = storage.register_table(info)
            store.on_epoch = None  # derived data: never persist


def _rows_for(storage, family: str) -> list[list]:
    """The family's time-range rows (every MetricsHistory ring point)
    plus one live point-in-time sample — oldest first, the live point
    last. The read never mutates the ring (sample_now(record=False))."""
    hist = storage.metrics_history
    points = hist.snapshot()
    points.append(hist.sample_now(record=False))
    rows: list[list] = []
    for ent in points:
        ts = float(ent["ts"])
        when = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ts))
        for name, v in ent["values"].items():
            labels = obs.split_sample_name(name, family)
            if labels is None:
                continue
            rows.append([when, round(ts, 3), labels, float(v)])
    return rows


def refresh(storage, names: set[str]) -> None:
    """Rebuild the named metrics_schema stores (the per-statement hook
    session._refresh_infoschema drives, exactly like information_schema;
    unknown names fall through to the planner's normal 'table doesn't
    exist')."""
    ensure_schema(storage)
    from .infoschema import publish_store

    schema = storage.catalog.schemas[DB_NAME]
    for tname in names:
        info = schema.tables.get(tname)
        if info is None:
            continue
        publish_store(storage, info, _rows_for(storage, tname))


def lint(storage) -> list[str]:
    """Hygiene for the metrics_schema tier (tier-1 via
    tests/test_metric_lint.py): every table maps to a live registered
    counter/gauge family — a dangling table would serve empty rows
    forever and read as 'metric gone' instead of 'table stale'."""
    findings: list[str] = []
    schema = storage.catalog.schemas.get(DB_NAME)
    if schema is None:
        return findings
    fams = families(storage)
    for tname in schema.tables:
        if tname not in fams:
            findings.append(
                f"metrics_schema.{tname}: no live registered metric "
                "family backs this table (dangling)")
    return findings


__all__ = ["DB_NAME", "UNPORTED_FAMILIES", "families", "ensure_schema", "refresh", "lint"]
