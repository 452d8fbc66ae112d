"""INFORMATION_SCHEMA virtual tables, materialized on demand.

Port of `tidb_tpu/catalog/infoschema.py`. The tables are ordinary columnar
TableStores rebuilt from the live catalog right before a query touches
them: the coprocessor then scans them like any other table, so filters,
joins and aggregations over metadata need no special executor. They never
persist (derived data) and never ride the KV plane: refresh replaces the
whole store in place.

Every table of the reference is defined (`_DEFS`, so table ids, SHOW
TABLES and the catalog match the reference's). The catalog-backed ones
are served: schemata, tables, columns, statistics, engines, collations,
character_sets, key_column_usage, referential_constraints, sequences,
partitions, views and user_privileges; from the storage's
`Observability`, statements_summary (the digest table), slow_query (the
slow-log ring), tidb_top_sql, tidb_wait_profile and tidb_events; from
the workload history (`obs_history.py`), statements_summary_history and
tidb_plan_history; from the inspection engine (`obs_inspect.py`),
inspection_result and inspection_summary (one rule run when a statement
reads both; a critical finding also lands in SHOW WARNINGS); from the
metrics history, metrics_summary; and from the reading session's
@@profiling ring, profiling; from the serving server's connections (or
the reading session alone, embedded), processlist; from the diagnostics
fan-out over the cluster's members (`rpc/diag.cluster_rows`, a member
that does not answer degrading to an error row and a warning), the
cluster_* tables over ported planes; from the keyspace heat plane
(`obs_heat.py`), tidb_hot_ranges and cluster_hot_ranges. A statement
that touches one of the others (the mesh recorder's tidb_mesh_shards,
tidb_mesh_storage and their cluster_* twins, item 8) raises
`NotInSlice(<table>)`: they read a plane the port does not have yet.
"""

from __future__ import annotations

import numpy as np

from ..errors import NotInSlice
from ..types.field_type import FieldType, TypeKind
from .schema import Catalog, ColumnInfo, SchemaInfo, TableInfo

DB_NAME = "information_schema"


def _vc(n: int = 64) -> FieldType:
    return FieldType(TypeKind.VARCHAR, flen=n)


def _bigint() -> FieldType:
    return FieldType(TypeKind.BIGINT)


# table name -> [(column name, ftype)]
_DEFS: dict[str, list[tuple[str, FieldType]]] = {
    "schemata": [
        ("catalog_name", _vc()), ("schema_name", _vc()),
        ("default_character_set_name", _vc(32)),
        ("default_collation_name", _vc(32)), ("sql_path", _vc()),
    ],
    "tables": [
        ("table_catalog", _vc()), ("table_schema", _vc()),
        ("table_name", _vc()), ("table_type", _vc(32)),
        ("engine", _vc(32)), ("version", _bigint()),
        ("row_format", _vc(16)), ("table_rows", _bigint()),
        ("avg_row_length", _bigint()), ("data_length", _bigint()),
        ("index_length", _bigint()), ("auto_increment", _bigint()),
        ("table_collation", _vc(32)), ("create_options", _vc()),
        ("table_comment", _vc(128)),
    ],
    "columns": [
        ("table_catalog", _vc()), ("table_schema", _vc()),
        ("table_name", _vc()), ("column_name", _vc()),
        ("ordinal_position", _bigint()), ("column_default", _vc(128)),
        ("is_nullable", _vc(8)), ("data_type", _vc(32)),
        ("character_maximum_length", _bigint()),
        ("numeric_precision", _bigint()), ("numeric_scale", _bigint()),
        ("character_set_name", _vc(32)), ("collation_name", _vc(32)),
        ("column_type", _vc(64)), ("column_key", _vc(8)),
        ("extra", _vc(32)), ("column_comment", _vc(128)),
    ],
    "statistics": [
        ("table_catalog", _vc()), ("table_schema", _vc()),
        ("table_name", _vc()), ("non_unique", _bigint()),
        ("index_schema", _vc()), ("index_name", _vc()),
        ("seq_in_index", _bigint()), ("column_name", _vc()),
        ("cardinality", _bigint()), ("index_type", _vc(16)),
    ],
    "engines": [
        ("engine", _vc(32)), ("support", _vc(8)), ("comment", _vc(128)),
        ("transactions", _vc(8)), ("xa", _vc(8)), ("savepoints", _vc(8)),
    ],
    "collations": [
        ("collation_name", _vc(32)), ("character_set_name", _vc(32)),
        ("id", _bigint()), ("is_default", _vc(8)), ("is_compiled", _vc(8)),
        ("sortlen", _bigint()),
    ],
    "character_sets": [
        ("character_set_name", _vc(32)), ("default_collate_name", _vc(32)),
        ("description", _vc(64)), ("maxlen", _bigint()),
    ],
    # aggregated statement digests (reference: util/stmtsummary feeding
    # infoschema statements_summary, statement_summary.go)
    "statements_summary": [
        ("digest", _vc(32)), ("schema_name", _vc()),
        ("digest_text", _vc(512)), ("query_sample_text", _vc(512)),
        ("exec_count", _bigint()), ("sum_errors", _bigint()),
        ("sum_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("avg_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("max_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("sum_result_rows", _bigint()),
        # per-digest working-set high-water / spill totals (reference:
        # stmtsummary MAX_MEM / SUM_DISK) — governor-kill forensics
        ("max_mem_bytes", _bigint()), ("sum_spill_count", _bigint()),
        ("first_seen", _vc(20)), ("last_seen", _vc(20)),
    ],
    # workload-history plane (reference: util/stmtsummary's windowed
    # persistence behind STATEMENTS_SUMMARY_HISTORY): one row per
    # rotated window x (sql_digest, plan_digest) — wall/stage split,
    # engine tags + fragment strategy, rows, mesh skew — read back
    # from <path>/history/ across restarts. Empty (zero work) while
    # history.enabled is false.
    "statements_summary_history": [
        ("summary_begin_time", _vc(20)), ("summary_end_time", _vc(20)),
        ("digest", _vc(32)), ("schema_name", _vc()),
        ("digest_text", _vc(512)), ("plan_digest", _vc(32)),
        ("engines", _vc(256)), ("plan_strategy", _vc(64)),
        ("exec_count", _bigint()), ("sum_errors", _bigint()),
        ("avg_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("max_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("sum_rows", _bigint()), ("stages", _vc(256)),
        ("mesh_skew", FieldType(TypeKind.DOUBLE)),
    ],
    # per-(digest, plan) rollup of the whole retained history — the
    # "which plan won" view the plan-regression rule and ROADMAP item
    # 5's adaptive fragment-strategy choice read
    "tidb_plan_history": [
        ("digest", _vc(32)), ("plan_digest", _vc(32)),
        ("digest_text", _vc(512)), ("engines", _vc(256)),
        ("plan_strategy", _vc(64)), ("windows", _bigint()),
        ("exec_count", _bigint()), ("sum_errors", _bigint()),
        ("avg_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("p50_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("max_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("first_seen", _vc(20)), ("last_seen", _vc(20)),
        ("current_plan", _bigint()),
    ],
    # the queryable slow log (reference: executor/slow_query.go parsing
    # the slow-log file back into INFORMATION_SCHEMA.SLOW_QUERY)
    "slow_query": [
        ("time", _vc(20)), ("db", _vc()),
        ("query_time_ms", FieldType(TypeKind.DOUBLE)),
        ("query", _vc(4096)),
        ("plan_digest", _vc(32)), ("stages", _vc(256)),
        # statement working-set peak + spills (reference: slow_query's
        # Mem_max / Disk_max columns)
        ("mem_max", _bigint()), ("spill_count", _bigint()),
        # per-operator exclusive wall split ('join:42ms scan:7ms ...')
        # — which operator of this digest spent the time
        ("operators", _vc(256)),
        # worst max/mean shard-row ratio of the statement's sharded
        # dispatches (0 = no sharded dispatch) — mesh flight recorder
        ("mesh_skew", FieldType(TypeKind.DOUBLE)),
        # typed exclusive wait split ('prewrite:8.2ms tso_wait:1.1ms
        # ...') — where this statement BLOCKED, heaviest state first;
        # empty while performance.wait-profile-enabled is off
        ("wait_profile", _vc(256)),
    ],
    # continuous per-digest resource attribution (reference: TiDB's
    # Top SQL / util/topsql): one '(stmt)' summary row per (window,
    # digest) plus one row per plan operator with its exclusive wall
    # time, stage split, and host->device transfer bytes. Fed on every
    # statement completion while performance.topsql-enabled is on.
    "tidb_top_sql": [
        ("window_start", _vc(20)), ("digest", _vc(32)),
        ("digest_text", _vc(512)), ("operator", _vc(64)),
        ("exec_count", _bigint()),
        ("sum_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("op_time_ms", FieldType(TypeKind.DOUBLE)),
        ("op_transfer_bytes", _bigint()), ("stages", _vc(256)),
        ("sum_rows", _bigint()), ("admission_sheds", _bigint()),
        ("governor_kills", _bigint()),
        # worst max-shard share of the operator's sharded dispatches
        # (1/shards = balanced, 1.0 = one device did everything)
        ("max_shard_share", FieldType(TypeKind.DOUBLE)),
        # dominant typed wait state of the (window, digest) as
        # 'state:frac' ('backoff.txnLock:0.73'); empty on operator
        # rows and while the wait profile is off
        ("dominant_wait", _vc(64)),
    ],
    # per-(window, digest, wait-state) exclusive wait attribution —
    # the SQL face of the WaitProfile ring (one row per typed state a
    # digest spent blocked in, newest window first). Empty (zero
    # ledger work) while performance.wait-profile-enabled is false.
    "tidb_wait_profile": [
        ("window_start", _vc(20)), ("digest", _vc(32)),
        ("digest_text", _vc(512)), ("schema_name", _vc()),
        ("exec_count", _bigint()),
        ("sum_wall_ms", FieldType(TypeKind.DOUBLE)),
        ("state", _vc(32)),
        ("wait_ms", FieldType(TypeKind.DOUBLE)),
        ("wait_frac", FieldType(TypeKind.DOUBLE)),
    ],
    # mesh flight recorder: per-plan-digest per-shard dispatch
    # accounting (input rows, post-filter survivors, skew, exchange
    # routing bytes), bounded by mesh.shard-ring-cap
    "tidb_mesh_shards": [
        ("digest", _vc(32)), ("kind", _vc(16)), ("operator", _vc(64)),
        ("dispatches", _bigint()), ("shards", _bigint()),
        ("last_shard_rows", _vc(256)),
        ("last_skew", FieldType(TypeKind.DOUBLE)),
        ("max_skew", FieldType(TypeKind.DOUBLE)),
        ("in_rows", _bigint()), ("out_rows", _bigint()),
        ("routed_bytes", _bigint()), ("last_seen", _vc(20)),
    ],
    # per-device HBM provenance ledger: every cached placed array
    # classified by (table/epoch, kind), plus one '(device)' total row
    # per device with live + peak bytes (live totals equal
    # tidb_device_buffer_bytes{device})
    "tidb_mesh_storage": [
        ("device", _vc(64)), ("table_name", _vc(64)),
        ("epoch_id", _bigint()), ("kind", _vc(16)),
        ("arrays", _bigint()), ("bytes", _bigint()),
        ("peak_bytes", _bigint()),
    ],
    # structured server event ring: governor kills, admission sheds,
    # breaker trips, elections/promotions, checkpoint/fsync stalls —
    # with conn/digest attribution where the producer has it
    "tidb_events": [
        ("id", _bigint()), ("ts", _vc(20)), ("kind", _vc(32)),
        ("severity", _vc(8)), ("conn_id", _bigint()),
        ("digest", _vc(32)), ("detail", _vc(512)),
    ],
    # per-statement sampling-profiler frames of THIS session's
    # @@profiling ring (reference: INFORMATION_SCHEMA.PROFILING fed by
    # the session profile history)
    "profiling": [
        ("query_id", _bigint()), ("seq", _bigint()),
        ("state", _vc(256)),
        ("duration", FieldType(TypeKind.DOUBLE)),
        ("samples", _bigint()),
    ],
    # rules-driven automated diagnosis (reference: TiDB 4.0's
    # executor/inspection_result.go feeding
    # INFORMATION_SCHEMA.INSPECTION_RESULT / INSPECTION_SUMMARY):
    # every registered rule in tidb_tpu/obs_inspect.py evaluated over
    # the live telemetry planes. Empty — with ZERO rule work — while
    # diagnostics.enabled is false.
    "inspection_result": [
        ("rule", _vc(64)), ("item", _vc(128)), ("severity", _vc(16)),
        ("value", _vc(64)), ("reference", _vc(256)),
        ("details", _vc(512)),
    ],
    # one row per REGISTERED rule: finding count, worst observed
    # severity, sample items — the registry itself, SQL-queryable
    "inspection_summary": [
        ("rule", _vc(64)), ("severity", _vc(16)),
        ("findings", _bigint()), ("items", _vc(256)),
        ("reference", _vc(256)),
    ],
    # keyspace heat plane (obs_heat.py): one row per known range with
    # lifetime served traffic, the live hot ratio vs the fleet median,
    # and the load-based split advisory (reference: PD's hot-region
    # tables behind INFORMATION_SCHEMA.TIDB_HOT_REGIONS). Empty — with
    # zero recorder work — while [heatmap] is disabled.
    "tidb_hot_ranges": [
        ("range_id", _bigint()), ("start_key", _vc(64)),
        ("end_key", _vc(64)), ("read_rows", _bigint()),
        ("read_bytes", _bigint()), ("write_rows", _bigint()),
        ("write_bytes", _bigint()),
        ("hot_ratio", FieldType(TypeKind.DOUBLE)),
        ("hot", _bigint()), ("split_advisory", _vc(64)),
    ],
    # counter/gauge time-series rollup from the MetricsHistory ring
    # (reference: TiDB 4.0's metrics schema summarized into
    # INFORMATION_SCHEMA.METRICS_SUMMARY)
    "metrics_summary": [
        ("metric_name", _vc(160)), ("samples", _bigint()),
        ("min_value", FieldType(TypeKind.DOUBLE)),
        ("avg_value", FieldType(TypeKind.DOUBLE)),
        ("max_value", FieldType(TypeKind.DOUBLE)),
        ("last_value", FieldType(TypeKind.DOUBLE)),
    ],
    # cluster-wide memtables: one sub-request per live member over the
    # diag RPC plane (reference: infoschema/cluster.go CLUSTER_* tables
    # served by executor/memtable_reader.go fan-out). Every table leads
    # with the member's instance address and ends with an error column:
    # an unreachable peer contributes [instance, NULLs..., error] plus a
    # session warning instead of failing the query.
    "cluster_info": [
        ("instance", _vc()), ("type", _vc(16)), ("server_id", _bigint()),
        ("version", _vc()), ("pid", _bigint()), ("start_time", _vc(20)),
        ("uptime_s", FieldType(TypeKind.DOUBLE)),
        # follower read tier: the member's applied/closed timestamp,
        # how far behind the leader it runs, and whether it serves
        # routed replica reads (leaders: newest issued ts / 0 / 0)
        ("applied_ts", _bigint()),
        ("apply_lag_ms", FieldType(TypeKind.DOUBLE)),
        ("serving", _bigint()),
        # range-sharded write leadership: a member hosting range
        # leaders contributes one extra type='range' row per hosted
        # range with these filled (NULL on server rows, and no range
        # rows at all while [ranges] is disabled)
        ("range_id", _bigint()), ("range_leader", _vc()),
        ("range_term", _bigint()), ("range_closed_ts", _bigint()),
        # keyspace heat plane: lifetime traffic served by the hosted
        # range (NULL on server rows; zeros while [heatmap] disabled)
        ("range_read_rows", _bigint()), ("range_read_bytes", _bigint()),
        ("range_write_rows", _bigint()),
        ("range_write_bytes", _bigint()),
        ("error", _vc(256)),
    ],
    "cluster_processlist": [
        ("instance", _vc()), ("id", _bigint()), ("user", _vc()),
        ("host", _vc()), ("db", _vc()), ("command", _vc(16)),
        ("time", _bigint()), ("state", _vc(16)), ("info", _vc(512)),
        ("error", _vc(256)),
    ],
    "cluster_slow_query": [
        ("instance", _vc()), ("time", _vc(20)), ("db", _vc()),
        ("query_time_ms", FieldType(TypeKind.DOUBLE)),
        ("query", _vc(4096)), ("plan_digest", _vc(32)),
        ("stages", _vc(256)), ("mem_max", _bigint()),
        ("spill_count", _bigint()), ("operators", _vc(256)),
        ("mesh_skew", FieldType(TypeKind.DOUBLE)),
        ("wait_profile", _vc(256)),
        ("error", _vc(256)),
    ],
    # cluster-wide mesh flight recorder over the diag RPC fan-out
    "cluster_mesh_shards": [
        ("instance", _vc()), ("digest", _vc(32)), ("kind", _vc(16)),
        ("operator", _vc(64)), ("dispatches", _bigint()),
        ("shards", _bigint()), ("last_shard_rows", _vc(256)),
        ("last_skew", FieldType(TypeKind.DOUBLE)),
        ("max_skew", FieldType(TypeKind.DOUBLE)),
        ("in_rows", _bigint()), ("out_rows", _bigint()),
        ("routed_bytes", _bigint()), ("last_seen", _vc(20)),
        ("error", _vc(256)),
    ],
    "cluster_mesh_storage": [
        ("instance", _vc()), ("device", _vc(64)),
        ("table_name", _vc(64)), ("epoch_id", _bigint()),
        ("kind", _vc(16)), ("arrays", _bigint()), ("bytes", _bigint()),
        ("peak_bytes", _bigint()), ("error", _vc(256)),
    ],
    # cluster-wide Top SQL: every member's attribution windows under
    # one roof, degrading per-peer like the other cluster_* tables
    "cluster_top_sql": [
        ("instance", _vc()), ("window_start", _vc(20)),
        ("digest", _vc(32)), ("digest_text", _vc(512)),
        ("operator", _vc(64)), ("exec_count", _bigint()),
        ("sum_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("op_time_ms", FieldType(TypeKind.DOUBLE)),
        ("op_transfer_bytes", _bigint()), ("stages", _vc(256)),
        ("sum_rows", _bigint()), ("admission_sheds", _bigint()),
        ("governor_kills", _bigint()),
        ("max_shard_share", FieldType(TypeKind.DOUBLE)),
        ("dominant_wait", _vc(64)),
        ("error", _vc(256)),
    ],
    # cluster-wide typed wait attribution over the diag RPC fan-out
    "cluster_tidb_wait_profile": [
        ("instance", _vc()), ("window_start", _vc(20)),
        ("digest", _vc(32)), ("digest_text", _vc(512)),
        ("schema_name", _vc()), ("exec_count", _bigint()),
        ("sum_wall_ms", FieldType(TypeKind.DOUBLE)),
        ("state", _vc(32)),
        ("wait_ms", FieldType(TypeKind.DOUBLE)),
        ("wait_frac", FieldType(TypeKind.DOUBLE)),
        ("error", _vc(256)),
    ],
    "cluster_statements_summary": [
        ("instance", _vc()), ("digest", _vc(32)), ("schema_name", _vc()),
        ("digest_text", _vc(512)), ("query_sample_text", _vc(512)),
        ("exec_count", _bigint()), ("sum_errors", _bigint()),
        ("sum_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("max_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("sum_result_rows", _bigint()), ("last_seen", _vc(20)),
        ("error", _vc(256)),
    ],
    # cluster-wide workload history: every member's rotated windows /
    # plan rollups under one roof, degrading per peer
    "cluster_statements_summary_history": [
        ("instance", _vc()), ("summary_begin_time", _vc(20)),
        ("summary_end_time", _vc(20)), ("digest", _vc(32)),
        ("schema_name", _vc()), ("digest_text", _vc(512)),
        ("plan_digest", _vc(32)), ("engines", _vc(256)),
        ("plan_strategy", _vc(64)), ("exec_count", _bigint()),
        ("sum_errors", _bigint()),
        ("avg_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("max_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("sum_rows", _bigint()), ("stages", _vc(256)),
        ("mesh_skew", FieldType(TypeKind.DOUBLE)),
        ("error", _vc(256)),
    ],
    "cluster_plan_history": [
        ("instance", _vc()), ("digest", _vc(32)),
        ("plan_digest", _vc(32)), ("digest_text", _vc(512)),
        ("engines", _vc(256)), ("plan_strategy", _vc(64)),
        ("windows", _bigint()), ("exec_count", _bigint()),
        ("sum_errors", _bigint()),
        ("avg_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("p50_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("max_latency_ms", FieldType(TypeKind.DOUBLE)),
        ("first_seen", _vc(20)), ("last_seen", _vc(20)),
        ("current_plan", _bigint()), ("error", _vc(256)),
    ],
    # cluster-wide automated diagnosis: every member's inspection
    # findings under one roof, degrading per peer like the other
    # cluster_* tables
    "cluster_inspection_result": [
        ("instance", _vc()), ("rule", _vc(64)), ("item", _vc(128)),
        ("severity", _vc(16)), ("value", _vc(64)),
        ("reference", _vc(256)), ("details", _vc(512)),
        ("error", _vc(256)),
    ],
    # cluster-wide keyspace heat: every member's tidb_hot_ranges under
    # one roof, degrading per peer like the other cluster_* tables
    "cluster_hot_ranges": [
        ("instance", _vc()), ("range_id", _bigint()),
        ("start_key", _vc(64)), ("end_key", _vc(64)),
        ("read_rows", _bigint()), ("read_bytes", _bigint()),
        ("write_rows", _bigint()), ("write_bytes", _bigint()),
        ("hot_ratio", FieldType(TypeKind.DOUBLE)),
        ("hot", _bigint()), ("split_advisory", _vc(64)),
        ("error", _vc(256)),
    ],
    # device/host telemetry per member (live gauges + counters), for
    # correlating dispatch-latency regressions with device-memory
    # pressure across the whole cluster
    "cluster_load": [
        ("instance", _vc()), ("device_type", _vc(16)),
        ("name", _vc(160)), ("value", FieldType(TypeKind.DOUBLE)),
        ("error", _vc(256)),
    ],
    "key_column_usage": [
        ("constraint_catalog", _vc()), ("constraint_schema", _vc()),
        ("constraint_name", _vc()), ("table_catalog", _vc()),
        ("table_schema", _vc()), ("table_name", _vc()),
        ("column_name", _vc()), ("ordinal_position", _bigint()),
        ("position_in_unique_constraint", _bigint()),
        ("referenced_table_schema", _vc()),
        ("referenced_table_name", _vc()),
        ("referenced_column_name", _vc()),
    ],
    "referential_constraints": [
        ("constraint_catalog", _vc()), ("constraint_schema", _vc()),
        ("constraint_name", _vc()),
        ("unique_constraint_schema", _vc()),
        ("update_rule", _vc(16)), ("delete_rule", _vc(16)),
        ("table_name", _vc()), ("referenced_table_name", _vc()),
    ],
    "sequences": [
        ("sequence_schema", _vc()), ("sequence_name", _vc()),
        ("start_value", _bigint()), ("increment", _bigint()),
        ("min_value", _bigint()), ("max_value", _bigint()),
        ("cycle", _bigint()),
    ],
    "partitions": [
        ("table_catalog", _vc()), ("table_schema", _vc()),
        ("table_name", _vc()), ("partition_name", _vc()),
        ("partition_ordinal_position", _bigint()),
        ("partition_method", _vc(16)),
        ("partition_expression", _vc(64)),
        ("partition_description", _vc(32)), ("table_rows", _bigint()),
    ],
    # live connections (reference: infoschema_reader.go PROCESSLIST fed
    # by the server's client connections)
    "processlist": [
        ("id", _bigint()), ("user", _vc()), ("host", _vc()),
        ("db", _vc()), ("command", _vc(16)), ("time", _bigint()),
        ("state", _vc(16)), ("info", _vc(512)),
        # working-set peak of the live (else last) statement + its
        # spill count (reference: TiDB's PROCESSLIST MEM column) — how
        # an operator sees WHICH connection the governor would kill
        ("mem_max", _bigint()), ("spill_count", _bigint()),
    ],
    "views": [
        ("table_catalog", _vc()), ("table_schema", _vc()),
        ("table_name", _vc()), ("view_definition", _vc(1024)),
        ("check_option", _vc(8)), ("is_updatable", _vc(8)),
        ("definer", _vc()), ("security_type", _vc(16)),
    ],
    "user_privileges": [
        ("grantee", _vc()), ("table_catalog", _vc()),
        ("privilege_type", _vc(32)), ("is_grantable", _vc(8)),
    ],
}


# the tables this port serves; the rest of _DEFS raise NotInSlice
SERVED = frozenset({
    "schemata", "tables", "columns", "statistics", "engines", "collations",
    "character_sets", "key_column_usage", "referential_constraints",
    "sequences", "partitions", "views", "user_privileges",
    "statements_summary", "slow_query", "tidb_top_sql",
    "tidb_wait_profile", "tidb_events", "statements_summary_history",
    "tidb_plan_history", "inspection_result", "inspection_summary",
    "metrics_summary", "profiling", "processlist",
    "cluster_info", "cluster_processlist", "cluster_slow_query",
    "cluster_statements_summary", "cluster_statements_summary_history",
    "cluster_plan_history", "cluster_top_sql", "cluster_tidb_wait_profile",
    "cluster_inspection_result", "cluster_load",
    "tidb_hot_ranges", "cluster_hot_ranges",
})


def table_names() -> set[str]:
    return set(_DEFS)


def ensure_schema(storage) -> None:
    """Create the information_schema tables once (no data yet)."""
    cat: Catalog = storage.catalog
    if DB_NAME in cat.schemas and \
            all(t in cat.schemas[DB_NAME].tables for t in _DEFS):
        return
    if DB_NAME not in cat.schemas:
        cat.schemas[DB_NAME] = SchemaInfo(DB_NAME)
    schema = cat.schemas[DB_NAME]
    for tname, cols in _DEFS.items():
        if tname in schema.tables:
            continue
        info = TableInfo(
            id=cat.alloc_id(),
            name=tname,
            columns=[ColumnInfo(cat.alloc_id(), cn, ft, offset=i)
                     for i, (cn, ft) in enumerate(cols)],
        )
        schema.tables[tname] = info
        store = storage.register_table(info)
        store.on_epoch = None  # derived data: never persist


def _store_rows(storage, table_id: int) -> int:
    """LIVE row count: a delete/update delta must not count as a row
    (epoch.num_rows + len(deltas) would inflate until compaction)."""
    store = storage.tables.get(table_id)
    if store is None:
        return 0
    if not store.deltas:
        return store.epoch.num_rows
    # current() is read-only: all committed deltas are <= the last
    # issued ts, so no TSO allocation on this read path
    return store.snapshot(storage.tso.current()).num_visible_rows


def _rows_for(storage, catalog: Catalog, tname: str,
              viewer=None) -> list[list]:
    user_schemas = [s for k, s in sorted(catalog.schemas.items())
                    if k != DB_NAME]
    rows: list[list] = []
    if tname == "schemata":
        for s in user_schemas:
            rows.append(["def", s.name, "utf8mb4", "utf8mb4_bin", None])
    elif tname == "tables":
        for s in user_schemas:
            for t in sorted(s.tables.values(), key=lambda t: t.name):
                part = getattr(t, "partition", None)
                if part is not None:
                    nrows = sum(_store_rows(storage, d.id)
                                for d in part.defs)
                else:
                    nrows = _store_rows(storage, t.id)
                rows.append(["def", s.name, t.name, "BASE TABLE", "TiTPU",
                             10, "Fixed", nrows, 0, 0, 0, None,
                             "utf8mb4_bin", "", ""])
            for v in sorted(getattr(s, "views", {}).values(),
                            key=lambda v: v.name):
                # views list here too (MySQL: table_type='VIEW')
                rows.append(["def", s.name, v.name, "VIEW", None, 10,
                             None, None, None, None, None, None, None,
                             "", "VIEW"])
    elif tname == "columns":
        for s in user_schemas:
            for t in sorted(s.tables.values(), key=lambda t: t.name):
                for c in t.columns:
                    ft = c.ftype
                    key = "PRI" if c.is_primary else (
                        "UNI" if any(ix.unique and ix.col_offsets ==
                                     [c.offset] for ix in t.indices) else "")
                    rows.append([
                        "def", s.name, t.name, c.name, c.offset + 1,
                        None if c.default is None else str(c.default),
                        "YES" if c.nullable else "NO",
                        ft.kind.name.lower(),
                        ft.flen if ft.is_string else None,
                        ft.flen if ft.is_decimal else None,
                        ft.scale if ft.is_decimal else None,
                        "utf8mb4" if ft.is_string else None,
                        "utf8mb4_bin" if ft.is_string else None,
                        repr(ft), key,
                        "auto_increment" if c.auto_increment else "", ""])
    elif tname == "statistics":
        for s in user_schemas:
            for t in sorted(s.tables.values(), key=lambda t: t.name):
                for ix in t.indices:
                    if not ix.visible:
                        continue
                    for seq, off in enumerate(ix.col_offsets):
                        rows.append([
                            "def", s.name, t.name,
                            0 if ix.unique or ix.primary else 1,
                            s.name, ix.name, seq + 1,
                            t.columns[off].name, 0, "BTREE"])
    elif tname == "engines":
        rows.append(["InnoDB", "DEFAULT",
                     "TiTPU columnar engine (InnoDB-compatible surface)",
                     "YES", "NO", "NO"])
    elif tname == "collations":
        rows.append(["utf8mb4_bin", "utf8mb4", 46, "Yes", "Yes", 1])
        rows.append(["utf8mb4_general_ci", "utf8mb4", 45, "", "Yes", 1])
    elif tname == "character_sets":
        rows.append(["utf8mb4", "utf8mb4_bin", "UTF-8 Unicode", 4])
    elif tname == "key_column_usage":
        for s in user_schemas:
            for t in sorted(s.tables.values(), key=lambda t: t.name):
                for ix in t.indices:
                    if not (ix.unique or ix.primary):
                        continue
                    cname = "PRIMARY" if ix.primary else ix.name
                    for seq, off in enumerate(ix.col_offsets):
                        rows.append(["def", s.name, cname, "def", s.name,
                                     t.name, t.columns[off].name, seq + 1,
                                     None, None, None, None])
                for fk in getattr(t, "foreign_keys", []) or []:
                    for seq, off in enumerate(fk.col_offsets):
                        ref_col = fk.ref_cols[seq] \
                            if seq < len(fk.ref_cols) else None
                        rows.append(["def", s.name, fk.name, "def",
                                     s.name, t.name, t.columns[off].name,
                                     seq + 1, seq + 1, fk.ref_db,
                                     fk.ref_table, ref_col])
    elif tname == "referential_constraints":
        for s in user_schemas:
            for t in sorted(s.tables.values(), key=lambda t: t.name):
                for fk in getattr(t, "foreign_keys", []) or []:
                    rows.append(["def", s.name, fk.name, fk.ref_db,
                                 fk.on_update, fk.on_delete, t.name,
                                 fk.ref_table])
    elif tname == "sequences":
        for s in user_schemas:
            for seq in sorted((getattr(s, "sequences", {}) or {})
                              .values(), key=lambda x: x.name):
                rows.append([s.name, seq.name, seq.start, seq.increment,
                             seq.min_value, seq.max_value,
                             1 if seq.cycle else 0])
    elif tname == "partitions":
        for s in user_schemas:
            for t in sorted(s.tables.values(), key=lambda t: t.name):
                part = getattr(t, "partition", None)
                if part is None:
                    rows.append(["def", s.name, t.name, None, None,
                                 None, None, None, _store_rows(storage,
                                                               t.id)])
                    continue
                for i, d in enumerate(part.defs):
                    desc = "MAXVALUE" if part.kind == "range" and \
                        d.less_than is None else (
                        str(d.less_than) if part.kind == "range" else "")
                    rows.append([
                        "def", s.name, t.name, d.name, i + 1,
                        part.kind.upper(),
                        t.columns[part.col_offset].name, desc,
                        _store_rows(storage, d.id)])
    elif tname == "statements_summary":
        for e in sorted(storage.obs.statements.snapshot(),
                        key=lambda e: -e["sum_latency_ms"]):
            rows.append([
                e["digest"], e["schema_name"], e["digest_text"],
                e["sample_text"], e["exec_count"], e["errors"],
                round(e["sum_latency_ms"], 3),
                round(e["sum_latency_ms"] / max(e["exec_count"], 1), 3),
                round(e["max_latency_ms"], 3), e["sum_rows"],
                e["max_mem_bytes"], e["sum_spill_count"],
                e["first_seen"], e["last_seen"]])
    elif tname == "slow_query":
        from .. import obs
        for e in storage.obs.slow_queries():
            rows.append([e["ts"], e["db"], float(e["duration_ms"]),
                         e["sql"], e["plan_digest"],
                         obs.fmt_stages_ms(e["stages"]),
                         int(e["mem_max"]), int(e["spill_count"]),
                         obs.fmt_ops_ms(e["operators"]),
                         0.0,
                         obs.fmt_waits_ms(e["waits"])])
    elif tname == "tidb_top_sql":
        rows = storage.obs.topsql.table_rows()
    elif tname == "tidb_wait_profile":
        rows = storage.obs.waitprofile.table_rows()
    elif tname == "tidb_events":
        for e in storage.obs.events.snapshot():
            rows.append([int(e["id"]), e["ts"], e["kind"], e["severity"],
                         int(e["conn_id"]), e["digest"], e["detail"]])
    elif tname == "tidb_hot_ranges":
        # the producer of diag_hot_ranges (the cluster fan-out adds
        # instance/error)
        rows = storage.heat.table_rows()
    elif tname == "statements_summary_history":
        h = storage.history
        rows = h.table_rows() if h.enabled else []
    elif tname == "tidb_plan_history":
        h = storage.history
        rows = h.plan_rows() if h.enabled else []
    elif tname == "inspection_result":
        from .. import obs_inspect
        rows = obs_inspect.result_rows(storage)
        _warn_critical_inspections(rows, viewer)
    elif tname == "inspection_summary":
        from .. import obs_inspect
        rows = obs_inspect.summary_rows(storage)
    elif tname == "metrics_summary":
        hist = storage.metrics_history
        # the ring plus a transient point for "now": a read must not
        # append to the time-series
        now = hist.sample_now(record=False)
        for name, st in sorted(hist.summary(extra=now).items()):
            rows.append([name, st["samples"], st["min"], st["avg"],
                         st["max"], st["last"]])
    elif tname.startswith("cluster_"):
        from ..rpc import diag as _diag
        rows = _diag.cluster_rows(storage, tname,
                                  len(_DEFS[tname]), viewer)
    elif tname == "profiling":
        for p in (getattr(viewer, "_profiles", None) or []):
            prof = p["profile"]
            for seq, (frame, secs, samples) in enumerate(
                    prof.tree_rows(), 1):
                rows.append([p["query_id"], seq, frame, secs, samples])
    elif tname == "processlist":
        provider = getattr(storage, "processlist", None)
        plist = list(provider()) if provider is not None else []
        if not plist and viewer is not None:
            # embedded session (no wire server): own row, matching the
            # SHOW PROCESSLIST fallback
            import time as _t
            info = viewer.in_flight_sql
            t = int(_t.time() - viewer.in_flight_since) \
                if info and viewer.in_flight_since else 0
            live = getattr(viewer, "_live_mem", None)
            plist = [(getattr(viewer, "conn_id", 0) or 0,
                      viewer.user or "root", "localhost",
                      viewer.current_db, "Query", t, "executing", info,
                      int(live.peak_footprint()) if live is not None
                      else int(getattr(viewer, "last_mem_peak", 0)),
                      int(live.spill_count) if live is not None
                      else int(getattr(viewer, "last_spill_count", 0)))]
        if viewer is not None and viewer.user is not None and not \
                storage.privileges.check(viewer.user, "PROCESS", "*",
                                         "*", roles=viewer.active_roles):
            # without PROCESS only your own connections are visible
            # (same rule SHOW PROCESSLIST applies)
            plist = [r for r in plist if r[1] == viewer.user]
        for r in plist:
            rows.append([int(r[0]), r[1], r[2], r[3], r[4], int(r[5]),
                         r[6], r[7],
                         int(r[8]) if len(r) > 8 else 0,
                         int(r[9]) if len(r) > 9 else 0])
    elif tname == "views":
        for s in user_schemas:
            for v in sorted(getattr(s, "views", {}).values(),
                            key=lambda v: v.name):
                rows.append(["def", s.name, v.name, v.sql, "NONE", "NO",
                             getattr(v, "definer", "root@%"), "DEFINER"])
    elif tname == "user_privileges":
        pm = storage.privileges
        names = pm.account_names()
        if viewer is not None and viewer.user is not None and \
                not pm.check(viewer.user, "ALL", "*", "*",
                             roles=viewer.active_roles):
            # non-admins see their own grants only (MySQL scopes this
            # to accounts the caller can administer)
            names = [n for n in names if n == viewer.user]
        for name in names:
            globals_ = [p for p, db, tbl in pm.grants_for(name)
                        if db == "*" and tbl == "*"]
            if "ALL" in globals_:
                # MySQL expands ALL into one row per privilege
                from ..session.privileges import PRIVS
                globals_ = sorted(PRIVS - {"ALL", "USAGE"})
            for p in (globals_ or ["USAGE"]):
                rows.append([f"'{name}'@'%'", "def", p, "NO"])
    return rows


def publish_store(storage, info: TableInfo, rows: list[list]) -> None:
    """Build a fresh memtable store COMPLETELY from `rows`, then publish
    in one assignment — concurrent readers either see the old rows or
    the new ones, never an empty/missing table mid-refresh. Shared by
    the information_schema and metrics_schema refresh paths."""
    from ..store.table_store import TableStore

    store = TableStore(info)
    store.on_epoch = None
    n = len(rows)
    columns: list[np.ndarray] = []
    valids: list = []
    for ci, c in enumerate(info.columns):
        ft = c.ftype
        data = np.zeros(n, dtype=ft.np_dtype)
        valid = np.ones(n, dtype=bool)
        d = store.dictionaries[ci]
        for ri, row in enumerate(rows):
            v = row[ci]
            if v is None:
                valid[ri] = False
            elif d is not None:
                data[ri] = d.encode(str(v))
            else:
                data[ri] = v
        columns.append(data)
        valids.append(None if valid.all() else valid)
    store.bulk_load(columns, valids)
    storage.tables[info.id] = store  # atomic publish


def _warn_critical_inspections(rows: list[list], viewer) -> None:
    """Critical inspection findings ALSO land in SHOW WARNINGS, so the
    operator who just SELECTed sees the red ones without re-filtering."""
    if viewer is None or not hasattr(viewer, "add_warning"):
        return
    for r in rows:
        if r[2] == "critical":
            viewer.add_warning(
                f"inspection: {r[0]} critical on {r[1]} "
                f"({r[5][:160]})")


def refresh(storage, names: set[str], viewer=None) -> None:
    """Rebuild the named information_schema stores from the live catalog.
    `viewer` is the reading Session for the tables whose contents are
    per-viewer (USER_PRIVILEGES scope, the profiling ring)."""
    ensure_schema(storage)
    cat: Catalog = storage.catalog
    schema = cat.schemas[DB_NAME]
    for tname in sorted(names):
        if tname in _DEFS and tname not in SERVED:
            raise NotInSlice(tname)
    # a statement touching BOTH inspection tables gets one rule run (and
    # one edge-trigger update) shared by the pair: the two tables agree
    precomputed: dict[str, list[list]] = {}
    if {"inspection_result", "inspection_summary"} <= names:
        from .. import obs_inspect
        res_rows, sum_rows = obs_inspect.result_and_summary_rows(storage)
        precomputed["inspection_result"] = res_rows
        precomputed["inspection_summary"] = sum_rows
        _warn_critical_inspections(res_rows, viewer)
    for tname in names:
        if tname not in _DEFS:
            continue
        info = schema.tables[tname]
        rows = precomputed.get(tname)
        if rows is None:
            rows = _rows_for(storage, cat, tname, viewer)
        publish_store(storage, info, rows)
