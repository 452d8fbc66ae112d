"""System-variable framework: registry, scopes, persistence.

Counterpart of the reference's sysvar subsystem (reference:
sessionctx/variable/sysvar.go — ~400 vars with scope flags;
session/session.go:1048 loads GLOBAL values from mysql.global_variables;
SET handling in executor/set.go). Scaled to the variables real clients,
ORMs and BI tools actually touch on connect, plus the engine's own knobs.

GLOBAL writes persist through the meta keyspace of the storage (the
mysql.global_variables analog), so SET GLOBAL survives restarts on a
durable store. SESSION reads fall back GLOBAL -> default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

SCOPE_GLOBAL = 1
SCOPE_SESSION = 2
SCOPE_BOTH = SCOPE_GLOBAL | SCOPE_SESSION


@dataclass(frozen=True)
class SysVar:
    name: str
    default: Any
    scope: int = SCOPE_BOTH
    read_only: bool = False


def _v(name, default, scope=SCOPE_BOTH, read_only=False):
    return SysVar(name, default, scope, read_only)


# the connect-time surface of MySQL clients/ORMs + engine knobs
_VARS = [
    _v("version", "5.7.25-TiDB-TPU", read_only=True),
    _v("version_comment", "TiDB-TPU Server (tidb_tpu)", read_only=True),
    _v("version_compile_os", "linux", read_only=True),
    _v("version_compile_machine", "tpu", read_only=True),
    _v("protocol_version", 10, read_only=True),
    _v("license", "Apache License 2.0", read_only=True),
    _v("port", 4000, scope=SCOPE_GLOBAL, read_only=True),
    _v("socket", "", scope=SCOPE_GLOBAL, read_only=True),
    _v("datadir", "/tmp/tidb_tpu", scope=SCOPE_GLOBAL, read_only=True),
    _v("hostname", "localhost", scope=SCOPE_GLOBAL, read_only=True),
    _v("autocommit", 1),
    _v("sql_mode", "ONLY_FULL_GROUP_BY,STRICT_TRANS_TABLES,"
       "NO_ZERO_IN_DATE,NO_ZERO_DATE,ERROR_FOR_DIVISION_BY_ZERO,"
       "NO_AUTO_CREATE_USER,NO_ENGINE_SUBSTITUTION"),
    _v("sql_select_limit", 2 ** 64 - 1),
    _v("max_allowed_packet", 67108864),
    _v("net_buffer_length", 16384),
    _v("net_write_timeout", 60),
    _v("net_read_timeout", 30),
    _v("interactive_timeout", 28800),
    _v("wait_timeout", 28800),
    _v("lock_wait_timeout", 31536000),
    _v("innodb_lock_wait_timeout", 50),
    _v("max_execution_time", 0),
    _v("character_set_client", "utf8mb4"),
    _v("character_set_connection", "utf8mb4"),
    _v("character_set_results", "utf8mb4"),
    _v("character_set_server", "utf8mb4"),
    _v("character_set_database", "utf8mb4"),
    _v("character_set_system", "utf8", read_only=True),
    _v("collation_connection", "utf8mb4_bin"),
    _v("collation_server", "utf8mb4_bin"),
    _v("collation_database", "utf8mb4_bin"),
    _v("init_connect", "", scope=SCOPE_GLOBAL),
    _v("time_zone", "SYSTEM"),
    _v("system_time_zone", "UTC", read_only=True),
    _v("lower_case_table_names", 2, scope=SCOPE_GLOBAL, read_only=True),
    _v("explicit_defaults_for_timestamp", 1),
    _v("foreign_key_checks", 0),
    _v("unique_checks", 1),
    _v("auto_increment_increment", 1),
    _v("auto_increment_offset", 1),
    _v("last_insert_id", 0, scope=SCOPE_SESSION),
    _v("identity", 0, scope=SCOPE_SESSION),
    _v("warning_count", 0, scope=SCOPE_SESSION, read_only=True),
    _v("error_count", 0, scope=SCOPE_SESSION, read_only=True),
    _v("tx_isolation", "REPEATABLE-READ"),
    _v("transaction_isolation", "REPEATABLE-READ"),
    _v("tx_read_only", 0),
    _v("transaction_read_only", 0),
    _v("performance_schema", 0, scope=SCOPE_GLOBAL, read_only=True),
    _v("query_cache_type", "OFF", scope=SCOPE_GLOBAL, read_only=True),
    _v("query_cache_size", 0, scope=SCOPE_GLOBAL, read_only=True),
    _v("have_openssl", "DISABLED", read_only=True),
    _v("have_ssl", "DISABLED", read_only=True),
    # default mirrors config max-connections (the config-knob-drift
    # rule pins registry default == config-seeded default, so SHOW
    # VARIABLES on an embedded store matches a default server's)
    _v("max_connections", 512, scope=SCOPE_GLOBAL),
    _v("default_storage_engine", "InnoDB", read_only=True),
    _v("default_authentication_plugin", "mysql_native_password",
       scope=SCOPE_GLOBAL, read_only=True),
    # engine knobs (reference: sessionctx/variable/tidb_vars.go)
    _v("tidb_slow_log_threshold", 300),
    _v("tidb_snapshot", ""),
    _v("tidb_distsql_scan_concurrency", 15),
    _v("tidb_index_lookup_concurrency", 4),
    _v("tidb_mem_quota_query", 1 << 30),
    _v("tidb_mem_oom_action", "SPILL"),  # SPILL | CANCEL (action.go:28)
    _v("tidb_enable_plan_cache", 1),
    # session plan-cache LRU capacity (physical plans + point
    # FastPlans); config performance.plan-cache-size seeds the default
    _v("tidb_plan_cache_size", 128),
    # the TryFastPlan point bypass (plan/fastpath.py): autocommit point
    # SELECT/DML executes against the KV layer with zero planner and
    # zero coprocessor work. Off forces every statement down the full
    # pipeline (debug/AB escape hatch).
    _v("tidb_enable_fast_path", 1),
    _v("tidb_txn_mode", "optimistic"),
    _v("tidb_retry_limit", 10),
    # follower read tier (rpc/replica.py): "follower" routes eligible
    # snapshot SELECTs to serving replicas; "leader" (default) keeps
    # every read local. Config [replica-read] prefer-follower seeds the
    # global default (reference: tidb_replica_read, tidb_vars.go)
    _v("tidb_replica_read", "leader"),
    # bounded-staleness reads: a NEGATIVE number of seconds (-5 = read
    # up to 5s stale, the reference's tidb_read_staleness semantics),
    # capped by replica-read.max-staleness-ms; relaxes the closed-ts
    # fence so a lagging replica can still serve. 0 = exact snapshot.
    _v("tidb_read_staleness", 0),
    _v("tidb_tile_rows", 1 << 22),
    _v("tidb_gc_life_time", "10m0s", scope=SCOPE_GLOBAL),
    _v("tidb_gc_run_interval", "10m0s", scope=SCOPE_GLOBAL),
    _v("tidb_auto_analyze_ratio", 0.5, scope=SCOPE_GLOBAL),
    # ---- file / transport security ------------------------------------
    _v("secure_file_priv", "", scope=SCOPE_GLOBAL, read_only=True),
    # LOAD DATA LOCAL INFILE opt-in: OFF keeps the typed 1235 rejection
    # (no wire sub-protocol). ON accepts LOCAL as a SERVER-side read:
    # authenticated users need FILE or a configured secure_file_priv
    # (which always confines the path); dup errors degrade to IGNORE
    _v("local_infile", 0, scope=SCOPE_GLOBAL),
    _v("require_secure_transport", 0, scope=SCOPE_GLOBAL),
    _v("ssl_ca", "", scope=SCOPE_GLOBAL, read_only=True),
    _v("ssl_cert", "", scope=SCOPE_GLOBAL, read_only=True),
    _v("ssl_key", "", scope=SCOPE_GLOBAL, read_only=True),
    # ---- SQL behavior toggles (accepted; engine behavior noted) -------
    _v("div_precision_increment", 4),
    _v("group_concat_max_len", 1024),
    _v("max_sort_length", 1024),
    _v("sql_safe_updates", 0),
    _v("sql_log_bin", 1),
    _v("sql_notes", 1),
    _v("sql_warnings", 0),
    _v("sql_quote_show_create", 1),
    _v("sql_auto_is_null", 0),
    _v("sql_big_selects", 1),
    _v("sql_buffer_result", 0),
    _v("timestamp", 0, scope=SCOPE_SESSION),
    _v("insert_id", 0, scope=SCOPE_SESSION),
    _v("pseudo_thread_id", 0, scope=SCOPE_SESSION),
    _v("rand_seed1", 0, scope=SCOPE_SESSION),
    _v("rand_seed2", 0, scope=SCOPE_SESSION),
    _v("default_week_format", 0),
    _v("lc_time_names", "en_US"),
    _v("lc_messages", "en_US"),
    _v("big_tables", 0),
    _v("low_priority_updates", 0),
    _v("completion_type", "NO_CHAIN"),
    _v("concurrent_insert", "AUTO", scope=SCOPE_GLOBAL, read_only=True),
    _v("delay_key_write", "ON", scope=SCOPE_GLOBAL, read_only=True),
    _v("character_set_filesystem", "binary"),
    # ---- buffers / limits (accepted for client compat) ----------------
    _v("max_heap_table_size", 16777216),
    _v("tmp_table_size", 16777216),
    _v("sort_buffer_size", 262144),
    _v("join_buffer_size", 262144),
    _v("read_buffer_size", 131072),
    _v("read_rnd_buffer_size", 262144),
    _v("bulk_insert_buffer_size", 8388608),
    _v("max_join_size", 2 ** 64 - 1),
    _v("max_seeks_for_key", 2 ** 64 - 1),
    _v("range_optimizer_max_mem_size", 8388608),
    _v("eq_range_index_dive_limit", 200),
    _v("optimizer_switch", "index_merge=on,index_merge_union=on",
       scope=SCOPE_BOTH),
    _v("optimizer_search_depth", 62),
    _v("table_open_cache", 2000, scope=SCOPE_GLOBAL, read_only=True),
    _v("table_definition_cache", 2000, scope=SCOPE_GLOBAL,
       read_only=True),
    _v("open_files_limit", 65535, scope=SCOPE_GLOBAL, read_only=True),
    _v("thread_cache_size", 0, scope=SCOPE_GLOBAL, read_only=True),
    _v("max_prepared_stmt_count", 16382, scope=SCOPE_GLOBAL),
    _v("max_user_connections", 0, scope=SCOPE_GLOBAL),
    _v("max_connect_errors", 100, scope=SCOPE_GLOBAL),
    _v("connect_timeout", 10, scope=SCOPE_GLOBAL),
    _v("skip_name_resolve", 1, scope=SCOPE_GLOBAL, read_only=True),
    # ---- replication-shaped surface (inert; single-plane engine) ------
    _v("log_bin", 0, scope=SCOPE_GLOBAL, read_only=True),
    _v("server_id", 0, scope=SCOPE_GLOBAL),
    _v("server_uuid", "00000000-0000-0000-0000-000000000000",
       scope=SCOPE_GLOBAL, read_only=True),
    _v("binlog_format", "ROW", scope=SCOPE_GLOBAL),
    _v("binlog_row_image", "FULL", scope=SCOPE_GLOBAL),
    _v("gtid_mode", "OFF", scope=SCOPE_GLOBAL, read_only=True),
    _v("enforce_gtid_consistency", "OFF", scope=SCOPE_GLOBAL,
       read_only=True),
    _v("read_only", 0, scope=SCOPE_GLOBAL),
    _v("super_read_only", 0, scope=SCOPE_GLOBAL),
    _v("offline_mode", 0, scope=SCOPE_GLOBAL),
    # ---- logging surface ----------------------------------------------
    _v("event_scheduler", "OFF", scope=SCOPE_GLOBAL, read_only=True),
    _v("log_output", "FILE", scope=SCOPE_GLOBAL),
    _v("general_log", 0, scope=SCOPE_GLOBAL),
    _v("slow_query_log", 1, scope=SCOPE_GLOBAL),
    _v("slow_query_log_file", "", scope=SCOPE_GLOBAL),
    _v("long_query_time", 10.0, scope=SCOPE_GLOBAL),
    _v("log_queries_not_using_indexes", 0, scope=SCOPE_GLOBAL),
    _v("profiling", 0, scope=SCOPE_SESSION),
    _v("profiling_history_size", 15, scope=SCOPE_SESSION),
    # host sampling-profiler tick rate (@@profiling, /debug/profile)
    _v("tidb_profiler_sample_hz", 97),
    # TRACE drops spans past this cap (bounded span trees)
    _v("tidb_trace_span_cap", 4096),
    # ---- innodb-shaped surface (inert; columnar-epoch engine) ---------
    _v("innodb_buffer_pool_size", 134217728, scope=SCOPE_GLOBAL,
       read_only=True),
    _v("innodb_flush_log_at_trx_commit", 1, scope=SCOPE_GLOBAL),
    _v("innodb_io_capacity", 200, scope=SCOPE_GLOBAL),
    _v("innodb_file_per_table", 1, scope=SCOPE_GLOBAL, read_only=True),
    _v("innodb_large_prefix", "ON", scope=SCOPE_GLOBAL, read_only=True),
    _v("innodb_strict_mode", 1, scope=SCOPE_GLOBAL),
    _v("innodb_print_all_deadlocks", 0, scope=SCOPE_GLOBAL),
    _v("innodb_read_io_threads", 4, scope=SCOPE_GLOBAL, read_only=True),
    _v("innodb_write_io_threads", 4, scope=SCOPE_GLOBAL, read_only=True),
    _v("innodb_page_size", 16384, scope=SCOPE_GLOBAL, read_only=True),
    _v("innodb_version", "5.7.25", scope=SCOPE_GLOBAL, read_only=True),
    _v("ft_min_word_len", 4, scope=SCOPE_GLOBAL, read_only=True),
    _v("ngram_token_size", 2, scope=SCOPE_GLOBAL, read_only=True),
    _v("default_tmp_storage_engine", "InnoDB"),
    _v("internal_tmp_disk_storage_engine", "InnoDB", scope=SCOPE_GLOBAL,
       read_only=True),
    # ---- engine knobs (reference: sessionctx/variable/tidb_vars.go) ---
    _v("tidb_current_ts", 0, scope=SCOPE_SESSION, read_only=True),
    _v("tidb_config", "", scope=SCOPE_SESSION, read_only=True),
    _v("tidb_general_log", 0, scope=SCOPE_GLOBAL),
    _v("tidb_enable_window_function", 1),
    _v("tidb_enable_vectorized_expression", 1),
    _v("tidb_enable_cascades_planner", 0),
    _v("tidb_enable_index_merge", 1),
    _v("tidb_enable_table_partition", "on"),
    _v("tidb_enable_list_partition", 0),
    _v("tidb_hash_join_concurrency", 5),
    _v("tidb_projection_concurrency", 4),
    _v("tidb_hashagg_partial_concurrency", 4),
    _v("tidb_hashagg_final_concurrency", 4),
    _v("tidb_window_concurrency", 4),
    _v("tidb_executor_concurrency", 5),
    _v("tidb_index_serial_scan_concurrency", 1),
    _v("tidb_index_join_batch_size", 25000),
    _v("tidb_index_lookup_size", 20000),
    _v("tidb_index_lookup_join_concurrency", 4),
    _v("tidb_init_chunk_size", 32),
    _v("tidb_max_chunk_size", 1024),
    _v("tidb_skip_utf8_check", 0),
    _v("tidb_skip_ascii_check", 0),
    _v("tidb_opt_agg_push_down", 1),
    _v("tidb_opt_distinct_agg_push_down", 0),
    _v("tidb_opt_join_reorder_threshold", 0),
    _v("tidb_opt_correlation_threshold", 0.9),
    _v("tidb_opt_correlation_exp_factor", 1),
    _v("tidb_opt_insubq_to_join_and_agg", 1),
    _v("tidb_opt_prefer_range_scan", 0),
    _v("tidb_ddl_reorg_worker_cnt", 4, scope=SCOPE_GLOBAL),
    _v("tidb_ddl_reorg_batch_size", 256, scope=SCOPE_GLOBAL),
    _v("tidb_ddl_error_count_limit", 512, scope=SCOPE_GLOBAL),
    _v("tidb_max_delta_schema_count", 1024, scope=SCOPE_GLOBAL),
    _v("tidb_scatter_region", 0, scope=SCOPE_GLOBAL),
    _v("tidb_wait_split_region_finish", 1),
    _v("tidb_wait_split_region_timeout", 300),
    _v("tidb_backoff_lock_fast", 100),
    _v("tidb_backoff_weight", 2),
    _v("tidb_dml_batch_size", 0),
    _v("tidb_batch_insert", 0),
    _v("tidb_batch_delete", 0),
    _v("tidb_batch_commit", 0),
    _v("tidb_constraint_check_in_place", 0),
    _v("tidb_checksum_table_concurrency", 4),
    _v("tidb_isolation_read_engines", "tpu,host", scope=SCOPE_SESSION),
    _v("tidb_store_limit", 0, scope=SCOPE_GLOBAL),
    _v("tidb_low_resolution_tso", 0, scope=SCOPE_SESSION),
    _v("tidb_replica_read", "leader", scope=SCOPE_SESSION),
    _v("tidb_allow_batch_cop", 1),
    _v("tidb_enable_stmt_summary", 1, scope=SCOPE_GLOBAL),
    _v("tidb_stmt_summary_refresh_interval", 1800, scope=SCOPE_GLOBAL),
    _v("tidb_stmt_summary_history_size", 24, scope=SCOPE_GLOBAL),
    _v("tidb_stmt_summary_max_stmt_count", 3000, scope=SCOPE_GLOBAL),
    _v("tidb_stmt_summary_internal_query", 0, scope=SCOPE_GLOBAL),
    _v("tidb_enable_collect_execution_info", 1),
    _v("tidb_enable_async_commit", 1),
    _v("tidb_enable_1pc", 1),
    _v("tidb_enable_clustered_index", "INT_ONLY"),
    _v("tidb_analyze_version", 1),
    _v("tidb_build_stats_concurrency", 4),
    _v("tidb_enable_fast_analyze", 0),
    _v("tidb_expensive_query_time_threshold", 60, scope=SCOPE_GLOBAL),
    _v("tidb_force_priority", "NO_PRIORITY"),
    _v("tidb_enable_noop_functions", 0),
    _v("tidb_row_format_version", 2, scope=SCOPE_GLOBAL),
    _v("tidb_enable_chunk_rpc", 1, scope=SCOPE_SESSION),
    _v("tidb_query_log_max_len", 4096, scope=SCOPE_GLOBAL),
    _v("last_plan_from_binding", 0, scope=SCOPE_SESSION, read_only=True),
    _v("tidb_use_plan_baselines", 1),
]

SYSVARS: dict[str, SysVar] = {v.name: v for v in _VARS}

_META_PREFIX = b"sysvar:"


class SysVarManager:
    """Process-wide GLOBAL values; owned by the Storage (one per 'cluster').

    put/get ride the meta keyspace, so on a durable store SET GLOBAL
    survives restart (mysql.global_variables analog)."""

    def __init__(self, storage) -> None:
        self._storage = storage
        self._globals: dict[str, Any] = {}
        # config-derived defaults: consulted after user SET GLOBALs but
        # before the registry defaults; never persisted (the config file
        # is their durable form)
        self._config_defaults: dict[str, Any] = {}
        self._loaded = False

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        for name, sv in SYSVARS.items():
            raw = self._storage.get_meta(_META_PREFIX + name.encode())
            if raw is not None:
                val: Any = raw.decode("utf-8")
                if isinstance(sv.default, int):
                    try:
                        val = int(val)
                    except ValueError:
                        pass
                self._globals[name] = val

    def get_global(self, name: str) -> Optional[Any]:
        self._load()
        if name in self._globals:  # includes tolerated unknown knobs
            return self._globals[name]
        if name in self._config_defaults:
            return self._config_defaults[name]
        v = SYSVARS.get(name)
        return v.default if v is not None else None

    def set_global(self, name: str, value: Any) -> None:
        self._load()
        self._globals[name] = value
        self._storage.put_meta(_META_PREFIX + name.encode(),
                               str(value).encode("utf-8"))

    def set_config_default(self, name: str, value: Any) -> None:
        """Config-file seeding: wins over registry defaults, loses to
        any persisted/user SET GLOBAL (reference: config feeds sysvar
        bootstrap values without overriding mysql.global_variables)."""
        self._config_defaults[name] = value

    def all_globals(self) -> dict[str, Any]:
        self._load()
        return {name: self._globals.get(
                    name, self._config_defaults.get(name, v.default))
                for name, v in SYSVARS.items()}
