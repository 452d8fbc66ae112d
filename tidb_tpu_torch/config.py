"""Server configuration: TOML file + CLI flags + hot-reloadable subset.

Port of `tidb_tpu/config.py`, field for field: the same sections, keys,
defaults, validation messages, reloadable subset and `EXAMPLE` text, so a
config file loads into the same values on both packages and fails with
the same `ConfigError`. Counterpart of the reference's config system
(reference: config/config.go:94 — the Config struct with ~20 TOML
sections, strict-decode validation; tidb-server/main.go:168 file load,
:408 flag overrides, :369 hot reload of the reloadable subset;
config.toml.example documents every knob).

Precedence matches the reference: defaults < config file < CLI flags.
Unknown keys in the file are an error (strict decode) so typos fail
loudly at startup instead of silently running with defaults.

Some knobs belong to planes the port does not have yet. They load and
validate as in the reference, and at their defaults they do nothing; set
to anything else, the seed that would apply them raises `NotInSlice`
naming the queue item that ports the plane: `[mesh]` and
`diagnostics.skew-min-dispatches` (item 8). The entry point arms
`[analysis] lock-check` (the lock-order checker) before it opens the
store.
`[heatmap]`, `[ranges]` (through `Storage.arm_ranges`), `[replica-read]`
and the range plane's diagnostics thresholds are seeded whole.
`rpc_options` hands the `[transport]` knobs to the RPC tier.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .errors import NotInSlice


class ConfigError(Exception):
    pass


def _not_in_slice(what: str, item) -> NotInSlice:
    return NotInSlice(f"{what} (ROADMAP queue 1 item {item})")


@dataclass
class LogFileConfig:
    """The `[log.file]` TOML section (reference: config.go Log.File —
    lumberjack rotation knobs). Applies to the slow-query file sink:
    the file rotates by atomic rename at max-size, keeping max-backups
    rotated files, so a history-era long-running server cannot grow an
    unbounded slow log."""

    max_size: int = 300              # MB per file; 0 = never rotate
    max_backups: int = 2             # rotated files kept


@dataclass
class LogConfig:
    level: str = "info"
    slow_threshold: int = 300        # ms (reference: log.slow-threshold)
    slow_query_file: str = ""
    format: str = "text"
    file: LogFileConfig = field(default_factory=LogFileConfig)


@dataclass
class StatusConfig:
    report_status: bool = True
    status_host: str = "0.0.0.0"
    status_port: int = 10080
    metrics_interval: int = 15


@dataclass
class PerformanceConfig:
    max_procs: int = 0
    server_memory_quota: int = 0          # bytes; 0 = unlimited
    # server-wide memory limit feeding the governor's kill policy
    # (util/governor.py): bytes ("8589934592"), a fraction of physical
    # RAM ("0.8"), or a percentage ("80%"); "0" disables. When crossed,
    # the heaviest cancellable statement is killed with errno 8175.
    server_memory_limit: str = "0"
    # governor kill cooldown: one pressure spike kills at most one
    # statement per window instead of massacring the processlist
    governor_cooldown_ms: int = 1000
    # execution admission gate: concurrently EXECUTING statements
    # (0 = unlimited); waiters shed with a typed "server busy" error
    # after admission-timeout-ms (reference: token-limit, config.go)
    token_limit: int = 0
    admission_timeout_ms: int = 10000
    mem_quota_query: int = 1 << 30        # per-query default
    txn_total_size_limit: int = 100 * 1024 * 1024
    stats_lease: str = "3s"
    tile_rows: int = 1 << 22              # device tile granularity
    profiler_sample_hz: int = 97          # @@profiling / /debug/profile
    trace_span_cap: int = 4096            # TRACE drops spans past this
    # metrics time-series ring (information_schema.metrics_summary +
    # /debug/metrics/history): sampling cadence and retained points
    metrics_history_interval: int = 15    # seconds between samples
    metrics_history_cap: int = 240        # retained samples (ring size)
    # Top SQL: continuous per-digest/per-operator resource attribution
    # (information_schema.tidb_top_sql, cluster_top_sql, /debug/topsql).
    # Disabled by default — off it costs ZERO work on the statement
    # path; enabled it aggregates into a ring of time buckets, each a
    # digest map capped at topsql-digest-cap with an "(other)" overflow
    topsql_enabled: bool = False
    topsql_window_seconds: int = 60       # one attribution bucket's span
    topsql_digest_cap: int = 50           # digests kept per bucket
    # typed wait-state attribution (information_schema.tidb_wait_profile,
    # /debug/waitprofile, the wait_profile EXPLAIN ANALYZE / slow-log
    # column and the dominant-wait inspection rule). Disabled by
    # default — off, no WaitLedger is installed and the statement path
    # does ZERO ledger work; the tidb_wait_seconds histograms stay on
    # either way.
    wait_profile_enabled: bool = False
    # structured server event ring (information_schema.tidb_events +
    # /debug/events): retained events
    events_history_cap: int = 512
    # session plan-cache LRU capacity (physical plans + point
    # FastPlans; seeds tidb_plan_cache_size). The legacy [plan-cache]
    # capacity knob is honored when this one is left at its default.
    plan_cache_size: int = 128
    # thread-light conn plane: idle workers the pool keeps warm
    # (0 = auto: min(8, cpu/2)). Execution concurrency is bounded by
    # token-limit, not by this — the pool grows on demand so a parked
    # txn holder's COMMIT can never deadlock behind a busy pool.
    conn_worker_threads: int = 0


@dataclass
class StorageConfig:
    """Durability policy of the KV WAL (reference: TiKV's
    raftstore.sync-log — the knob that decides whether an acknowledged
    commit can die with the machine)."""

    # off      — flush to the OS only; process death loses nothing,
    #            power loss may lose acked commits
    # commit   — fsync at every commit boundary (no acked-commit loss);
    #            concurrent committers share one fsync via the
    #            cross-commit group rendezvous (kv/mvcc.py commit_sync)
    # interval — group commit by TIME: at most one fsync per
    #            sync-interval-ms, with a bounded loss window
    sync_log: str = "commit"
    sync_interval_ms: int = 100
    # cross-commit group fsync tuning (sync-log=commit only): the
    # elected leader may linger up to max-wait-µs gathering more
    # committers before its fsync (0 = fsync immediately — the natural
    # rendezvous during a ~17ms fsync already batches), skipped once
    # max-batch committers are aboard
    group_commit_max_batch: int = 64
    group_commit_max_wait_us: int = 0


@dataclass
class MeshSection:
    """The `[mesh]` TOML section: field names and defaults mirror the
    reference's copr/mesh.MeshConfig (the placement policy's runtime
    owner there). The port has no mesh plane: `seed_mesh` accepts only
    these defaults."""

    enabled: bool = True
    axis_size: int = 0                    # devices in the mesh; 0 = all
    shard_threshold_rows: int = 1 << 20
    replicate_threshold_bytes: int = 64 << 20
    # flight recorder: skew warning threshold (0 disables), HBM
    # watermark fraction + capacity override, dispatch-ring cap
    skew_warn_ratio: float = 4.0
    hbm_watermark_fraction: float = 0.85
    hbm_bytes: int = 0
    shard_ring_cap: int = 256


@dataclass
class DiagnosticsConfig:
    """The `[diagnostics]` TOML section: the automated inspection
    engine's knobs (obs_inspect.py is the runtime owner —
    field names/defaults MIRROR obs_inspect.DiagnosticsState, mirrored
    rather than imported so config parsing never pulls the obs import
    chain; tests/test_inspection.py pins the two definitions equal)."""

    # master switch: false = information_schema.inspection_result /
    # inspection_summary answer empty with ZERO rule work
    enabled: bool = True
    # how many MetricsHistory samples a windowed rule considers (the
    # window in seconds is this x metrics-history-interval)
    history_windows: int = 8
    # mesh skew must persist this many dispatches before it's a finding
    skew_min_dispatches: int = 2
    fsync_stall_threshold: int = 3       # stalls/window before a finding
    heartbeat_stale_ms: int = 10000      # member hb age past this
    host_fallback_fraction: float = 0.5  # of a digest's stage split
    governor_kill_threshold: int = 1     # kills/window before a finding
    admission_shed_threshold: int = 1    # sheds/window before a finding
    row_eval_threshold: int = 1          # per-row registry rows/window
    # a serving replica's apply lag past this is follower-apply-lag
    # (warning; critical at 3x — the replica stopped advancing); 0
    # disables the rule
    apply_lag_warn_ms: int = 2000
    # one range changing write leadership this many times in the
    # window fires range-leader-flap (a clean failover is ONE transfer)
    range_flap_threshold: int = 3
    # one range SPLITTING this many times inside split-flap-window-s
    # fires range-split-flap (the salted/monotonic hot-key symptom
    # splitting cannot fix); 0 disables the rule
    split_flap_threshold: int = 3
    # seconds of range_split history the split-flap rule considers
    # (its own window: splits are cooldown-paced, so the shared
    # history window is usually too short); 0 = the shared window
    split_flap_window_s: int = 300
    # dominant-wait: a digest spending at least this fraction of its
    # wall time blocked in backoff.* or lease_wait is a finding
    # (needs performance.wait-profile-enabled for data to exist)
    dominant_wait_threshold: float = 0.5
    # a range whose published closed_ts has not advanced for this long
    # WHILE its write counters moved fires range-closed-ts-stall
    # (warning; critical at 3x — every ranged replica read over it is
    # falling back); 0 disables the rule
    closed_ts_stall_ms: int = 10000


@dataclass
class HistoryConfig:
    """The `[history]` TOML section: the workload-history plane
    (obs_history.py WorkloadHistory is the runtime owner —
    field names/defaults MIRROR it, mirrored rather than imported so
    config parsing never pulls the obs chain; tests/test_history.py
    pins the two definitions equal)."""

    # master switch: off = ZERO statement-path work (the Top SQL
    # contract); on = every completed statement feeds the per-digest
    # (sql_digest, plan_digest) history, rotated windows persist under
    # <path>/history/ and survive restarts
    enabled: bool = False
    # one live aggregation window's span; a closed window rotates into
    # the durable record list (and to disk) at the next observation
    window_seconds: int = 60
    # durable records retained (oldest rotated out first)
    history_cap: int = 512
    # plan-regression / stmt-perf-regression threshold: a new plan (or
    # a drifted same-plan window) at least this many times slower than
    # the historical p50 is a finding
    regression_ratio: float = 1.5


@dataclass
class HeatmapConfig:
    """The `[heatmap]` TOML section: the keyspace heat plane
    (the reference's obs_heat.py RangeHeatRecorder is the runtime owner —
    field names/defaults MIRROR it, mirrored rather than imported so
    config parsing never pulls the obs chain; tests/test_heatmap.py
    pins the two definitions equal)."""

    # master switch: off = ZERO statement-path work (the Top SQL
    # contract); on = point reads, scans, 2PC commits and range-leader
    # applies feed the per-range time x traffic matrix
    enabled: bool = False
    # one heat bucket's span; hot detection runs at bucket rotation
    bucket_seconds: int = 10
    # buckets retained in the ring (the keyviz window =
    # ring-buckets x bucket-seconds)
    ring_buckets: int = 36
    # a range at >= this multiple of the fleet-median activity in a
    # bucket is hot-candidate
    hot_ratio: float = 8.0
    # consecutive hot buckets before the hot_range event / finding
    sustained_buckets: int = 2
    # per-range bounded write-key sample feeding the split advisory
    key_sample_cap: int = 64


@dataclass
class ReplicaReadConfig:
    """The `[replica-read]` TOML section: the follower read tier's
    knobs (rpc/replica.py ReplicaReadState is the runtime owner —
    field names/defaults MIRROR it, mirrored rather than imported so
    config parsing never pulls the rpc import chain;
    tests/test_replica_read.py pins the two definitions equal)."""

    # master switch: follower apply engine + serving endpoint + router
    enabled: bool = True
    # bounded-staleness cap (tidb_read_staleness is clamped to it) and
    # the lag bound past which a replica stops being a routing candidate
    max_staleness_ms: int = 5000
    # follower apply-engine cadence (closed-ts fetch + columnar fold)
    apply_interval_ms: int = 200
    # route eligible snapshot SELECTs to followers by default (seeds
    # the tidb_replica_read sysvar's global default)
    prefer_follower: bool = False
    # range-aware covering: a routed SELECT requires every range its
    # table spans touch to have published closed_ts >= read_ts (the
    # per-range ledger floors). False = today's routing byte-for-byte
    range_aware: bool = False


@dataclass
class RangesConfig:
    """The `[ranges]` TOML section: range-sharded write leadership
    (rpc/ranged.py RangePlane is the runtime owner). Disabled by
    default — and disabled means the plane is never constructed, so
    the statement path does ZERO new work (single-range deployments
    are byte-identical to the pre-range engine)."""

    # master switch: arm a RangeServer over <path>/ranges — per-range
    # leases, fencing terms, WALs and the range_* percolator RPC
    # surface. Needs a durable local path; restart to change.
    enabled: bool = False
    # even single-byte-prefix split count when split-points is empty
    # (the table is written once, first writer wins; restart-only)
    count: int = 4
    # explicit split keys, comma-separated (utf-8-encoded; overrides
    # count when non-empty; restart-only)
    split_points: str = ""
    # leadership lease horizon; a leader that cannot renew within it
    # fences itself, and a successor acquires right after expiry
    # (hot-reloadable)
    lease_ms: int = 1000
    # lock TTL the plane's committers stamp on prewrites: how long a
    # crashed coordinator's orphan locks block peers before
    # primary-status resolution may roll them forward/back
    # (hot-reloadable)
    resolve_ttl_ms: int = 3000
    # the range RPC listener bind (restart-only)
    listen: str = "127.0.0.1:0"
    # heat-driven auto-split actuator: act on range-split-advisory
    # findings by splitting at the advised weighted-median key. Off
    # (the default) the lease tick does ZERO actuator work — splits
    # never occur spontaneously (hot-reloadable)
    auto_split: bool = False
    # minimum quiet time between auto-splits — paces a hot workload
    # instead of shattering the keyspace (hot-reloadable)
    split_cooldown_ms: int = 10000
    # lifetime cap on actuator-triggered splits per server process, a
    # runaway-advisory backstop; manual range_split RPCs are never
    # counted or capped (hot-reloadable)
    max_auto_splits: int = 4


@dataclass
class AnalysisConfig:
    """The `[analysis]` TOML section: the concurrency-analysis plane
    (tidb_tpu_torch/analysis/). Its static half runs offline
    (`python -m tidb_tpu_torch.analysis`) and needs no config; this
    section arms the DYNAMIC half."""

    # instrument long-lived subsystem locks at creation and feed the
    # process-wide lock-order graph (cycles -> the lock-order-inversion
    # inspection rule + /debug/lockgraph). Off by default: disabled,
    # every lock is a plain threading primitive — zero overhead, the
    # Top SQL contract. The TIDB_TPU_LOCK_CHECK env var is the
    # no-config equivalent.
    lock_check: bool = False


@dataclass
class PlanCacheConfig:
    enabled: bool = True
    capacity: int = 128


@dataclass
class GCConfig:
    life_time: str = "10m0s"
    run_interval: str = "10m0s"


@dataclass
class SecurityConfig:
    skip_grant_table: bool = False
    ssl_ca: str = ""
    ssl_cert: str = ""
    ssl_key: str = ""
    # generate an ephemeral self-signed pair when no cert is configured
    # (reference: config auto-tls)
    auto_tls: bool = False
    require_secure_transport: bool = False
    # PROXY protocol: allowed LB networks, comma CIDRs or "*"
    # (reference: config.ProxyProtocol.Networks)
    proxy_protocol_networks: str = ""
    # LOAD DATA LOCAL INFILE opt-in (seeds the local_infile sysvar):
    # off = typed 1235 rejection; on = accept LOCAL with MySQL
    # semantics (the server reads the named path — acceptable only
    # when clients share the server's filesystem or the operator
    # accepts that exposure)
    local_infile: bool = False


@dataclass
class TransportConfig:
    """Multi-process plane transport (reference: the tikv-client section
    of config.go — timeouts/retries for the store RPC tier).

    mode selection: `listen` makes this server the store LEADER, also
    serving coordination RPC (TSO, WAL append/tail, KILL mailbox) on
    that address; `remote` makes it a FOLLOWER joining a leader's
    cluster over the socket with `path` as its private working dir.
    Both empty: local/shared-dir modes, exactly as before."""

    listen: str = ""             # leader RPC address (host:port|unix:/p)
    remote: str = ""             # follower: the leader's RPC address
    connect_timeout_ms: int = 1000
    request_timeout_ms: int = 5000
    backoff_budget_ms: int = 4000   # per-call typed-retry budget
    lock_budget_ms: int = 30000     # mutation-lease acquisition budget
    lease_ms: int = 3000            # leader-granted lease horizon
    stale_reads: bool = True        # degraded followers serve stale reads
    # follower diagnostics listener (cluster_* tables query it); the
    # default binds loopback with an ephemeral port — followers on
    # other hosts must set a SPECIFIC routable address (the bound host
    # is what peers dial, so wildcards like 0.0.0.0 are rejected)
    diag_listen: str = "127.0.0.1:0"
    # automatic failover: a follower whose leader heartbeat has failed
    # continuously for this long runs the deterministic election
    # (longest replicated WAL wins, ties to the lowest node id) and
    # either promotes in place or repoints to the winner. 0 disables —
    # followers then stay degraded read-only until the leader returns.
    election_timeout_ms: int = 10000
    # the address this follower serves coordination RPC on IF it wins
    # an election (peers repoint to the bound host:port, so multi-host
    # clusters need a routable host here)
    promote_listen: str = "127.0.0.1:0"
    # circuit breaker: after breaker-threshold CONSECUTIVE calls
    # exhausted their retry budget, fail fast for breaker-cooldown-ms
    # with one half-open probe after, instead of burning a full
    # backoff-budget-ms per call against a dead leader (0 disables)
    breaker_threshold: int = 3
    breaker_cooldown_ms: int = 2000


@dataclass
class Config:
    host: str = "0.0.0.0"
    port: int = 4000
    path: str = ""                   # durable storage dir; '' = in-memory
    socket: str = ""
    max_connections: int = 512
    # hard cap rejected with errno 1040 BEFORE any handshake work
    # (reference: max-server-connections / ER_CON_COUNT_ERROR);
    # 0 = use max-connections as the cap
    max_server_connections: int = 0
    default_db: str = "test"
    lease: str = "45s"               # schema lease (reference: --lease)
    log: LogConfig = field(default_factory=LogConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    status: StatusConfig = field(default_factory=StatusConfig)
    performance: PerformanceConfig = field(default_factory=PerformanceConfig)
    plan_cache: PlanCacheConfig = field(default_factory=PlanCacheConfig)
    analysis: AnalysisConfig = field(default_factory=AnalysisConfig)
    mesh: MeshSection = field(default_factory=MeshSection)
    diagnostics: DiagnosticsConfig = field(
        default_factory=DiagnosticsConfig)
    history: HistoryConfig = field(default_factory=HistoryConfig)
    heatmap: HeatmapConfig = field(default_factory=HeatmapConfig)
    replica_read: ReplicaReadConfig = field(
        default_factory=ReplicaReadConfig)
    ranges: RangesConfig = field(default_factory=RangesConfig)
    gc: GCConfig = field(default_factory=GCConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    # dotted names pinned by CLI flags: hot reload must not revert them
    # (defaults < file < flags precedence; reference: main.go:408)
    cli_overrides: set = field(default_factory=set, compare=False,
                               repr=False)

    # ---- loading -------------------------------------------------------
    @staticmethod
    def load(path: str) -> "Config":
        """Strict TOML decode (reference: config.go strict check — an
        undecoded key is an error)."""
        try:
            import tomllib
        except ImportError:  # Python < 3.11: the minimal subset parser
            tomllib = None
        if tomllib is not None:
            try:
                with open(path, "rb") as f:
                    raw = tomllib.load(f)
            except tomllib.TOMLDecodeError as e:
                raise ConfigError(
                    f"malformed TOML in {path}: {e}") from None
        else:
            try:
                with open(path, encoding="utf-8") as f:
                    raw = _parse_toml_subset(f.read())
            except _TomlError as e:
                raise ConfigError(
                    f"malformed TOML in {path}: {e}") from None
        cfg = Config()
        cfg.apply(raw)
        return cfg

    def apply(self, raw: dict) -> None:
        _apply_section(self, raw, "")

    # ---- validation ----------------------------------------------------
    def validate(self) -> None:
        if not 0 <= self.port <= 65535:
            raise ConfigError(f"port {self.port} out of range")
        if not 0 <= self.status.status_port <= 65535:
            raise ConfigError(
                f"status-port {self.status.status_port} out of range")
        if self.max_connections < 1:
            raise ConfigError("max-connections must be >= 1")
        if self.max_server_connections < 0:
            raise ConfigError(
                "max-server-connections must be >= 0 (0 = use "
                "max-connections)")
        if self.log.level not in ("debug", "info", "warn", "error"):
            raise ConfigError(f"unknown log level {self.log.level!r}")
        if self.performance.mem_quota_query < 0:
            raise ConfigError("mem-quota-query must be >= 0")
        from .util.governor import parse_mem_limit
        try:
            parse_mem_limit(self.performance.server_memory_limit)
        except ValueError as e:
            raise ConfigError(
                f"performance.server-memory-limit: {e}") from None
        if self.performance.token_limit < 0:
            raise ConfigError(
                "token-limit must be >= 0 (0 = unlimited)")
        if self.performance.admission_timeout_ms < 1:
            raise ConfigError("admission-timeout-ms must be >= 1")
        if self.performance.governor_cooldown_ms < 0:
            raise ConfigError("governor-cooldown-ms must be >= 0")
        if self.performance.profiler_sample_hz < 1:
            raise ConfigError("profiler-sample-hz must be >= 1")
        if self.performance.trace_span_cap < 16:
            raise ConfigError("trace-span-cap must be >= 16")
        if self.performance.metrics_history_interval < 1:
            raise ConfigError("metrics-history-interval must be >= 1")
        if self.performance.metrics_history_cap < 1:
            raise ConfigError("metrics-history-cap must be >= 1")
        if self.performance.topsql_window_seconds < 1:
            raise ConfigError("topsql-window-seconds must be >= 1")
        if self.performance.topsql_digest_cap < 1:
            raise ConfigError("topsql-digest-cap must be >= 1")
        if self.performance.events_history_cap < 1:
            raise ConfigError("events-history-cap must be >= 1")
        t = self.transport
        if t.listen and t.remote:
            raise ConfigError(
                "transport.listen (leader) and transport.remote "
                "(follower) are mutually exclusive")
        if t.listen and not self.path:
            raise ConfigError(
                "transport.listen requires path (the leader owns the "
                "durable store directory)")
        for knob in ("connect_timeout_ms", "request_timeout_ms",
                     "backoff_budget_ms", "lock_budget_ms", "lease_ms"):
            if getattr(t, knob) <= 0:
                raise ConfigError(f"transport.{knob} must be > 0")
        if t.election_timeout_ms < 0:
            raise ConfigError(
                "transport.election-timeout-ms must be >= 0 "
                "(0 disables automatic failover)")
        if t.breaker_threshold < 0:
            raise ConfigError(
                "transport.breaker-threshold must be >= 0 "
                "(0 disables the circuit breaker)")
        if t.breaker_cooldown_ms <= 0:
            raise ConfigError(
                "transport.breaker-cooldown-ms must be > 0")
        if self.mesh.axis_size < 0:
            raise ConfigError("mesh.axis-size must be >= 0 (0 = all "
                              "visible devices)")
        if self.mesh.shard_threshold_rows < 0:
            raise ConfigError("mesh.shard-threshold-rows must be >= 0")
        if self.mesh.replicate_threshold_bytes < 0:
            raise ConfigError(
                "mesh.replicate-threshold-bytes must be >= 0")
        if self.mesh.skew_warn_ratio < 0:
            raise ConfigError(
                "mesh.skew-warn-ratio must be >= 0 (0 disables the "
                "skew warning)")
        if not 0 < self.mesh.hbm_watermark_fraction <= 1:
            raise ConfigError(
                "mesh.hbm-watermark-fraction must be in (0, 1]")
        if self.mesh.hbm_bytes < 0:
            raise ConfigError(
                "mesh.hbm-bytes must be >= 0 (0 = ask the backend)")
        if self.mesh.shard_ring_cap < 1:
            raise ConfigError("mesh.shard-ring-cap must be >= 1")
        d = self.diagnostics
        if d.history_windows < 1:
            raise ConfigError("diagnostics.history-windows must be >= 1")
        if d.skew_min_dispatches < 1:
            raise ConfigError(
                "diagnostics.skew-min-dispatches must be >= 1")
        for knob in ("fsync_stall_threshold", "governor_kill_threshold",
                     "admission_shed_threshold", "row_eval_threshold"):
            if getattr(d, knob) < 1:
                raise ConfigError(
                    f"diagnostics.{knob.replace('_', '-')} "
                    "must be >= 1")
        if d.heartbeat_stale_ms < 0:
            raise ConfigError(
                "diagnostics.heartbeat-stale-ms must be >= 0 "
                "(0 disables the staleness check)")
        if d.apply_lag_warn_ms < 0:
            raise ConfigError(
                "diagnostics.apply-lag-warn-ms must be >= 0 "
                "(0 disables the follower-apply-lag rule)")
        if not 0 < d.dominant_wait_threshold <= 1:
            raise ConfigError(
                "diagnostics.dominant-wait-threshold must be in (0, 1]")
        h = self.history
        if h.window_seconds < 1:
            raise ConfigError("history.window-seconds must be >= 1")
        if h.history_cap < 1:
            raise ConfigError("history.history-cap must be >= 1")
        if h.regression_ratio < 1.0:
            raise ConfigError(
                "history.regression-ratio must be >= 1.0 (a plan this "
                "many times slower than its history is a regression)")
        hm = self.heatmap
        if hm.bucket_seconds < 1:
            raise ConfigError("heatmap.bucket-seconds must be >= 1")
        if hm.ring_buckets < 2:
            raise ConfigError(
                "heatmap.ring-buckets must be >= 2 (detection compares "
                "a closed bucket against the ring)")
        if hm.hot_ratio < 1.0:
            raise ConfigError(
                "heatmap.hot-ratio must be >= 1.0 (a range this many "
                "times over the fleet median is hot)")
        if hm.sustained_buckets < 1:
            raise ConfigError("heatmap.sustained-buckets must be >= 1")
        if hm.key_sample_cap < 2:
            raise ConfigError(
                "heatmap.key-sample-cap must be >= 2 (a split advisory "
                "needs at least two distinct sampled keys)")
        if self.log.file.max_size < 0:
            raise ConfigError(
                "log.file.max-size must be >= 0 (0 = never rotate)")
        if self.log.file.max_size > 0 and self.log.file.max_backups < 1:
            # RotatingFileHandler with backupCount=0 never rolls over:
            # the file would grow unbounded while paying a close+reopen
            # per record past the threshold — reject the combination
            raise ConfigError(
                "log.file.max-backups must be >= 1 when max-size > 0 "
                "(rotation keeps at least one backup; set max-size = 0 "
                "to disable rotation)")
        if self.log.file.max_backups < 0:
            raise ConfigError("log.file.max-backups must be >= 0")
        rr = self.replica_read
        if rr.max_staleness_ms < 0:
            raise ConfigError(
                "replica-read.max-staleness-ms must be >= 0")
        if rr.apply_interval_ms < 10:
            raise ConfigError(
                "replica-read.apply-interval-ms must be >= 10")
        if not 0 < d.host_fallback_fraction <= 1:
            raise ConfigError(
                "diagnostics.host-fallback-fraction must be in (0, 1]")
        rg = self.ranges
        if rg.enabled and not self.path:
            raise ConfigError(
                "ranges.enabled requires path (range leaders own "
                "durable per-range WAL directories)")
        if not 1 <= rg.count <= 256:
            raise ConfigError(
                "ranges.count must be in [1, 256] (single-byte prefix "
                "splits; use split-points for a finer table)")
        if rg.lease_ms < 50:
            raise ConfigError("ranges.lease-ms must be >= 50")
        if rg.resolve_ttl_ms < 1:
            raise ConfigError("ranges.resolve-ttl-ms must be >= 1")
        if rg.split_cooldown_ms < 0:
            raise ConfigError("ranges.split-cooldown-ms must be >= 0")
        if rg.max_auto_splits < 0:
            raise ConfigError("ranges.max-auto-splits must be >= 0")
        if self.diagnostics.split_flap_threshold < 0:
            raise ConfigError(
                "diagnostics.split-flap-threshold must be >= 0 "
                "(0 disables the rule)")
        if self.diagnostics.split_flap_window_s < 0:
            raise ConfigError(
                "diagnostics.split-flap-window-s must be >= 0 "
                "(0 = the shared history window)")
        if self.diagnostics.closed_ts_stall_ms < 0:
            raise ConfigError(
                "diagnostics.closed-ts-stall-ms must be >= 0 "
                "(0 disables the rule)")
        if self.storage.sync_log not in ("off", "commit", "interval"):
            raise ConfigError(
                f"storage.sync-log must be off|commit|interval, got "
                f"{self.storage.sync_log!r}")
        if self.storage.sync_interval_ms <= 0:
            raise ConfigError("storage.sync-interval-ms must be > 0")
        if self.storage.group_commit_max_batch < 1:
            raise ConfigError(
                "storage.group-commit-max-batch must be >= 1")
        if self.storage.group_commit_max_wait_us < 0:
            raise ConfigError(
                "storage.group-commit-max-wait-us must be >= 0")
        if self.performance.plan_cache_size < 1:
            raise ConfigError("performance.plan-cache-size must be >= 1")
        if self.performance.conn_worker_threads < 0:
            raise ConfigError(
                "performance.conn-worker-threads must be >= 0 "
                "(0 = auto)")

    # ---- hot reload ----------------------------------------------------
    # keys that may change at runtime (reference: the hot-reloadable
    # subset, tidb-server/main.go:369 ReloadGlobalConfig)
    RELOADABLE = frozenset({
        "log.slow_threshold", "log.level",
        "gc.life_time", "gc.run_interval",
        "performance.mem_quota_query",
        # overload-protection knobs apply live (the reload handler
        # re-runs seed_overload_protection): an operator fighting an
        # actual overload must not need a restart to tighten them
        "performance.server_memory_limit",
        "performance.governor_cooldown_ms",
        "performance.token_limit",
        "performance.admission_timeout_ms",
        # the attribution plane toggles live: turning Top SQL on to
        # chase a production regression must not need a restart
        "performance.topsql_enabled",
        "performance.topsql_window_seconds",
        "performance.topsql_digest_cap",
        # the wait-state attribution plane toggles live: typing WHERE
        # a production statement blocks must not need a restart
        "performance.wait_profile_enabled",
        "plan_cache.enabled",
        # OLTP fast-path knobs apply live: plan-cache sizing and
        # group-commit batching are exactly the dials an operator turns
        # while watching a production QPS cliff
        "performance.plan_cache_size",
        "performance.conn_worker_threads",
        "storage.group_commit_max_batch",
        "storage.group_commit_max_wait_us",
        # the diagnosis plane toggles/tunes live: arming inspection to
        # chase a production incident must not need a restart
        "diagnostics.enabled",
        "diagnostics.history_windows",
        "diagnostics.skew_min_dispatches",
        "diagnostics.fsync_stall_threshold",
        "diagnostics.heartbeat_stale_ms",
        "diagnostics.host_fallback_fraction",
        "diagnostics.governor_kill_threshold",
        "diagnostics.admission_shed_threshold",
        "diagnostics.row_eval_threshold",
        "diagnostics.apply_lag_warn_ms",
        "diagnostics.dominant_wait_threshold",
        "diagnostics.closed_ts_stall_ms",
        # the workload-history plane toggles/tunes live: arming the
        # plan/perf history to chase a production plan flip must not
        # need a restart (the Top SQL precedent)
        "history.enabled",
        "history.window_seconds",
        "history.history_cap",
        "history.regression_ratio",
        # the keyspace heat plane toggles/tunes live: arming the
        # heatmap to chase a hot range mid-incident must not need a
        # restart (same contract as [history]; every knob is a plain
        # recorder field re-read per note/rotation)
        "heatmap.enabled",
        "heatmap.bucket_seconds",
        "heatmap.ring_buckets",
        "heatmap.hot_ratio",
        "heatmap.sustained_buckets",
        "heatmap.key_sample_cap",
        # the follower read tier toggles/tunes live: routing policy and
        # staleness bounds must not need a restart (the apply cadence
        # does — it is a thread's wait interval, fixed at arm time)
        "replica_read.enabled",
        "replica_read.max_staleness_ms",
        "replica_read.prefer_follower",
        # range-aware covering is a pure router-side gate (one state
        # bit read per routed statement), so it toggles live too
        "replica_read.range_aware",
        # range-plane timing knobs apply live (lease horizon + orphan
        # TTL are operator dials during an incident); enabling the
        # plane or reshaping the table stays restart-only
        "ranges.lease_ms",
        "ranges.resolve_ttl_ms",
        # the auto-split actuator toggles/tunes live: arming it to
        # chase a hot range mid-incident (or disarming a runaway one)
        # must not need a restart
        "ranges.auto_split",
        "ranges.split_cooldown_ms",
        "ranges.max_auto_splits",
    })

    def hot_reload(self, path: str) -> list[str]:
        """Re-read the file, apply ONLY reloadable keys not pinned by a
        CLI flag; returns the dotted names applied. Non-reloadable
        changes are ignored (the reference logs and skips them the same
        way, main.go:369)."""
        fresh = Config.load(path)
        fresh.validate()
        applied = []
        for dotted in sorted(self.RELOADABLE - self.cli_overrides):
            section, _, leaf = dotted.partition(".")
            src = getattr(fresh, section)
            dst = getattr(self, section)
            if getattr(dst, leaf) != getattr(src, leaf):
                setattr(dst, leaf, getattr(src, leaf))
                applied.append(dotted)
        return applied

    def apply_log_level(self) -> None:
        """Point the package loggers at the configured level and wire
        the [log] sinks (startup + hot reload both call this;
        reference: logutil.InitLogger). Idempotent: a SIGHUP reload
        must not stack a second file handler."""
        import logging

        level = {"debug": logging.DEBUG, "info": logging.INFO,
                 "warn": logging.WARNING, "error": logging.ERROR}[
                     self.log.level]
        logging.getLogger("tidb_tpu_torch").setLevel(level)
        fmt: logging.Formatter
        if self.log.format == "json":
            fmt = _JsonLogFormatter()
        else:
            fmt = logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s %(message)s")
        # log.slow-query-file: mirror the slow log to its own file
        # (reference: the dedicated slow query log file LogSlowQuery
        # writes; the in-memory ring behind SHOW SLOW QUERIES stays)
        slow = logging.getLogger("tidb_tpu_torch.slowlog")
        for h in list(slow.handlers):
            if getattr(h, "_titpu_slow_sink", False):
                slow.removeHandler(h)
                h.close()
        if self.log.slow_query_file:
            # rotate by atomic rename at log.file.max-size, keeping
            # log.file.max-backups rotated files (reference: the
            # lumberjack rotation behind config.go Log.File) — a
            # long-running server's slow log stays bounded. max-size 0
            # keeps the legacy never-rotating sink.
            from logging.handlers import RotatingFileHandler
            fh = RotatingFileHandler(
                self.log.slow_query_file, encoding="utf-8", delay=True,
                maxBytes=self.log.file.max_size * (1 << 20),
                backupCount=self.log.file.max_backups)
            fh.setFormatter(fmt)
            fh._titpu_slow_sink = True  # type: ignore[attr-defined]
            slow.addHandler(fh)

    def rpc_options(self):
        """The transport knobs as the RPC tier's options object."""
        from .rpc.client import RpcOptions
        t = self.transport
        return RpcOptions(
            connect_timeout_ms=t.connect_timeout_ms,
            request_timeout_ms=t.request_timeout_ms,
            backoff_budget_ms=t.backoff_budget_ms,
            lock_budget_ms=t.lock_budget_ms,
            lease_ms=t.lease_ms,
            stale_reads=t.stale_reads,
            diag_listen=t.diag_listen,
            election_timeout_ms=t.election_timeout_ms,
            promote_listen=t.promote_listen,
            breaker_threshold=t.breaker_threshold,
            breaker_cooldown_ms=t.breaker_cooldown_ms,
        )

    def effective_max_connections(self) -> int:
        """The connection-gate cap: max-server-connections when set,
        else the legacy max-connections knob."""
        return self.max_server_connections or self.max_connections

    def seed_overload_protection(self, storage) -> None:
        """Arm the storage's memory governor and execution admission
        gate from the [performance] knobs (the server entry point and
        hot reload both call this)."""
        from .util.governor import parse_mem_limit
        p = self.performance
        limit = parse_mem_limit(p.server_memory_limit)
        if limit == 0 and p.server_memory_quota > 0:
            limit = p.server_memory_quota  # legacy alias of the limit
        storage.governor.configure(limit_bytes=limit,
                                   cooldown_ms=p.governor_cooldown_ms)
        storage.admission.configure(tokens=p.token_limit,
                                    timeout_ms=p.admission_timeout_ms)
        # commit-time txn size cap (enforced in Storage.commit with
        # ER_TXN_TOO_LARGE over the encoded mutation bytes)
        storage.txn_total_size_limit = int(p.txn_total_size_limit)
        # auto-analyze cadence floor: the maintenance worker skips
        # analyze passes closer together than the stats lease
        # (reference: the statistics handle's lease-driven update loop)
        from .store.daemon import parse_duration
        storage.maintenance.stats_lease_s = parse_duration(
            p.stats_lease, 3.0)

    def seed_mesh(self) -> None:
        """Configure the PROCESS-wide device-mesh plane from the [mesh]
        knobs (server startup). The port has one device and no mesh
        plane: the defaults configure nothing, any other value raises."""
        if self.mesh != MeshSection():
            raise _not_in_slice("[mesh]: the multi-device plane", 8)

    def seed_diagnostics(self, storage) -> None:
        """Arm the storage's inspection engine from the [diagnostics]
        knobs (startup and SIGHUP hot reload both call this). The
        edge-trigger memory survives a reseed — a reload must not
        re-fire every known critical finding."""
        d = self.diagnostics
        # the thresholds of rules over planes the port does not have:
        # the defaults are what those rules would read, any other value
        # raises
        unported = {"skew_min_dispatches": "8"}
        for knob, item in unported.items():
            if getattr(d, knob) != getattr(DiagnosticsConfig, knob):
                raise _not_in_slice(
                    f"diagnostics.{knob.replace('_', '-')}", item)
        st = storage.diagnostics
        st.enabled = d.enabled
        st.history_windows = d.history_windows
        st.fsync_stall_threshold = d.fsync_stall_threshold
        st.host_fallback_fraction = d.host_fallback_fraction
        st.governor_kill_threshold = d.governor_kill_threshold
        st.admission_shed_threshold = d.admission_shed_threshold
        st.row_eval_threshold = d.row_eval_threshold
        st.dominant_wait_threshold = d.dominant_wait_threshold
        st.heartbeat_stale_ms = d.heartbeat_stale_ms
        st.apply_lag_warn_ms = d.apply_lag_warn_ms
        st.range_flap_threshold = d.range_flap_threshold
        st.split_flap_threshold = d.split_flap_threshold
        st.split_flap_window_s = d.split_flap_window_s
        st.closed_ts_stall_ms = d.closed_ts_stall_ms
        # the /status counts must reflect the new thresholds now, not
        # after the cache TTL
        st._status_cache = None

    def seed_history(self, storage) -> None:
        """Arm the workload-history plane from the [history] knobs
        (startup and SIGHUP hot reload both call this)."""
        h = self.history
        storage.history.configure(
            enabled=h.enabled,
            window_seconds=h.window_seconds,
            history_cap=h.history_cap,
            regression_ratio=h.regression_ratio)

    def seed_heatmap(self, storage) -> None:
        """Arm the keyspace heat plane from the [heatmap] knobs
        (startup and SIGHUP hot reload both call this)."""
        hm = self.heatmap
        storage.heat.configure(
            enabled=hm.enabled,
            bucket_seconds=hm.bucket_seconds,
            ring_buckets=hm.ring_buckets,
            hot_ratio=hm.hot_ratio,
            sustained_buckets=hm.sustained_buckets,
            key_sample_cap=hm.key_sample_cap)

    def seed_replica_read(self, storage) -> None:
        """Arm the follower read tier from the [replica-read] knobs
        (startup and SIGHUP hot reload both call this): copy the
        routing/staleness settings onto the storage's state and
        start/stop the follower apply engine to match."""
        r = self.replica_read
        st = storage.replica_read
        st.enabled = r.enabled
        st.max_staleness_ms = r.max_staleness_ms
        st.apply_interval_ms = r.apply_interval_ms
        st.prefer_follower = r.prefer_follower
        st.range_aware = r.range_aware
        storage.arm_replica_read()

    def seed_ranges(self, storage) -> None:
        """Arm the range plane from the [ranges] knobs (startup and
        SIGHUP hot reload both call this; arm_ranges only applies the
        reloadable subset to an already-armed plane)."""
        rg = self.ranges
        points = [p.strip() for p in rg.split_points.split(",")
                  if p.strip()]
        storage.arm_ranges(
            enabled=rg.enabled, count=rg.count, split_points=points,
            lease_ms=rg.lease_ms, resolve_ttl_ms=rg.resolve_ttl_ms,
            listen=rg.listen, auto_split=rg.auto_split,
            split_cooldown_ms=rg.split_cooldown_ms,
            max_auto_splits=rg.max_auto_splits)

    def seed_group_commit(self, storage) -> None:
        """Apply the [storage] group-commit batching knobs to the
        engine's SyncPolicy (startup and SIGHUP hot reload)."""
        storage.configure_group_commit(
            max_batch=self.storage.group_commit_max_batch,
            max_wait_us=self.storage.group_commit_max_wait_us)

    def seed_observability(self, storage) -> None:
        """Arm the attribution/event plane from the [performance] knobs
        (startup and SIGHUP hot reload both call this)."""
        p = self.performance
        storage.obs.topsql.configure(
            enabled=p.topsql_enabled,
            window_s=p.topsql_window_seconds,
            digest_cap=p.topsql_digest_cap)
        storage.obs.waitprofile.configure(
            enabled=p.wait_profile_enabled)
        storage.obs.events.configure(cap=p.events_history_cap)
        # performance.metrics-history-interval is the preferred knob;
        # the legacy [status] metrics-interval wins only when the new
        # one is left at its default (same precedence as plan-cache
        # capacity — the dataclass defaults are the single source, so
        # changing a default cannot desynchronize this test)
        interval = p.metrics_history_interval
        if interval == PerformanceConfig.metrics_history_interval \
                and self.status.metrics_interval \
                != StatusConfig.metrics_interval:
            interval = self.status.metrics_interval
        storage.metrics_history.configure(
            interval_s=interval,
            cap=p.metrics_history_cap)

    # ---- sysvar seeding ------------------------------------------------
    def seed_sysvars(self, storage) -> None:
        """Push config-derived values into the sysvar plane as DEFAULTS:
        they beat the registry defaults but never override values a user
        persisted via SET GLOBAL (reference: config feeds sysvar
        bootstrap values without rewriting mysql.global_variables)."""
        sv = storage.sysvars
        sv.set_config_default("tidb_slow_log_threshold",
                              self.log.slow_threshold)
        sv.set_config_default("tidb_mem_quota_query",
                              self.performance.mem_quota_query)
        sv.set_config_default("tidb_enable_plan_cache",
                              1 if self.plan_cache.enabled else 0)
        # performance.plan-cache-size is the preferred knob; the legacy
        # [plan-cache] capacity wins only when the new one is untouched
        size = self.performance.plan_cache_size
        if size == 128 and self.plan_cache.capacity != 128:
            size = self.plan_cache.capacity
        sv.set_config_default("tidb_plan_cache_size", size)
        sv.set_config_default("tidb_gc_life_time", self.gc.life_time)
        sv.set_config_default("tidb_gc_run_interval",
                              self.gc.run_interval)
        sv.set_config_default("tidb_tile_rows", self.performance.tile_rows)
        sv.set_config_default("max_connections", self.max_connections)
        sv.set_config_default("tidb_profiler_sample_hz",
                              self.performance.profiler_sample_hz)
        sv.set_config_default("tidb_trace_span_cap",
                              self.performance.trace_span_cap)
        sv.set_config_default("local_infile",
                              1 if self.security.local_infile else 0)
        sv.set_config_default(
            "tidb_replica_read",
            "follower" if self.replica_read.prefer_follower
            else "leader")


class _JsonLogFormatter:
    """log.format = "json": one JSON object per record (reference:
    logutil's zap JSON encoder). Duck-typed Formatter: format() is the
    only method handlers call on it, and defining it without importing
    logging keeps config import-light."""

    def format(self, record) -> str:
        import json
        import time as _t
        out = {
            "ts": _t.strftime("%Y-%m-%d %H:%M:%S",
                              _t.localtime(record.created)),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        # the slow-log producer (obs.record_slow) attaches its full
        # structured entry — digest, per-stage/per-operator splits,
        # mem/spill, mesh skew — so the file sink explains the query,
        # not just names it
        slow = getattr(record, "slow_entry", None)
        if slow is not None:
            out["slow"] = slow
        return json.dumps(out, default=str)


class _TomlError(Exception):
    pass


def _parse_toml_subset(text: str) -> dict:
    """Fallback decoder for interpreters without tomllib: the subset the
    config format actually uses — [section] tables, key = value with
    quoted strings, integers, floats and booleans, # comments. Malformed
    input raises (strictness preserved: the caller maps to ConfigError)."""
    root: dict = {}
    cur = root
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise _TomlError(f"line {ln}: unterminated table header")
            cur = root
            for part in line[1:-1].strip().split("."):
                if not part:
                    raise _TomlError(f"line {ln}: empty table name")
                cur = cur.setdefault(part, {})
            continue
        key, eq, value = line.partition("=")
        if not eq:
            raise _TomlError(f"line {ln}: expected key = value")
        cur[key.strip()] = _toml_value(value.strip(), ln)
    return root


def _toml_value(v: str, ln: int):
    if v and v[0] in "\"'":
        q = v[0]
        end = v.find(q, 1)
        if end < 0:
            raise _TomlError(f"line {ln}: unterminated string")
        rest = v[end + 1:].strip()
        if rest and not rest.startswith("#"):
            raise _TomlError(f"line {ln}: trailing characters {rest!r}")
        return v[1:end]
    v = v.split("#", 1)[0].strip()
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v, 0)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        raise _TomlError(f"line {ln}: unsupported value {v!r}") from None


def _apply_section(obj, raw: dict, prefix: str) -> None:
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in raw.items():
        norm = key.replace("-", "_")
        f = fields.get(norm)
        if f is None:
            raise ConfigError(
                f"unknown config key {prefix + key!r}")
        current = getattr(obj, norm)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise ConfigError(
                    f"config section {prefix + key!r} must be a table")
            _apply_section(current, value, prefix + key + ".")
        else:
            if isinstance(current, bool) and not isinstance(value, bool):
                raise ConfigError(
                    f"config key {prefix + key!r} expects a boolean")
            if isinstance(current, int) and not isinstance(current, bool) \
                    and (not isinstance(value, int)
                         or isinstance(value, bool)):
                # bool is an int subclass: `port = true` must still fail
                raise ConfigError(
                    f"config key {prefix + key!r} expects an integer")
            if isinstance(current, str) and not isinstance(value, str):
                raise ConfigError(
                    f"config key {prefix + key!r} expects a string")
            setattr(obj, norm, value)


EXAMPLE = """\
# tidb-tpu-server configuration (reference: config.toml.example)
# Every key is optional; values below are the defaults.

host = "0.0.0.0"
port = 4000
# durable storage directory; empty = in-memory store
path = ""
max-connections = 512
# hard connection cap rejected with errno 1040 ("Too many connections")
# before any handshake work; 0 = use max-connections as the cap
max-server-connections = 0
default-db = "test"
# schema lease (informational; single-process DDL applies instantly)
lease = "45s"

[log]
level = "info"                 # debug | info | warn | error
slow-threshold = 300           # ms; statements slower than this are logged
slow-query-file = ""
format = "text"

[log.file]
# Rotation of the slow-query file sink: at max-size (MB) the file
# rotates by atomic rename (slow.log -> slow.log.1, shifting), keeping
# max-backups rotated files — a long-running server's slow log stays
# bounded. max-size = 0 disables rotation; with rotation on,
# max-backups must be >= 1 (at least one backup is kept).
max-size = 300
max-backups = 2

[storage]
# When the KV write-ahead log reaches disk (the acked-commit loss
# window under POWER loss; process crashes lose nothing either way):
#   off      — flush to the OS only
#   commit   — fsync at every commit boundary (no acked-commit loss)
#   interval — group commit: at most one fsync per sync-interval-ms,
#              amortized over every commit inside the window
sync-log = "commit"
sync-interval-ms = 100
# Cross-commit group fsync (sync-log = "commit" only): concurrent
# committers rendezvous on ONE in-flight WAL fsync — same durability
# guarantee (nothing acks before an fsync covering its bytes), but N
# waiters amortize one ~17ms disk barrier, so durable DML QPS scales
# with concurrency instead of capping near 1/fsync-latency. The
# elected leader may linger group-commit-max-wait-us gathering more
# committers (0 = fsync immediately; the natural rendezvous during a
# slow fsync already batches), skipped once group-commit-max-batch
# are aboard. Amortization is observable in the
# tidb_group_commit_batch_size histogram and `group_commit` events.
# Hot-reloadable via SIGHUP.
group-commit-max-batch = 64
group-commit-max-wait-us = 0

[status]
report-status = true           # expose /status /metrics /slow-query
status-host = "0.0.0.0"
status-port = 10080
metrics-interval = 15

[performance]
server-memory-quota = 0        # bytes; 0 = unlimited
# Server-wide memory limit (the governor's kill policy): bytes, a
# fraction of physical RAM ("0.8"), or a percentage ("80%"). "0"
# disables. When the server crosses the limit, the heaviest
# cancellable running statement is killed with errno 8175 and the
# kill is visible in tidb_governor_kills_total / the slow log's
# mem_max column. At most one kill per governor-cooldown-ms.
server-memory-limit = "0"
governor-cooldown-ms = 1000
# Execution admission gate: at most token-limit statements EXECUTE
# concurrently (0 = unlimited). Point gets and DML outrank large
# scans; waiters shed with a typed "server busy" error (errno 9003)
# after admission-timeout-ms instead of piling up.
token-limit = 0
admission-timeout-ms = 10000
mem-quota-query = 1073741824   # per-query working-set budget (bytes)
txn-total-size-limit = 104857600
stats-lease = "3s"
tile-rows = 4194304            # device tile granularity (rows)
profiler-sample-hz = 97        # @@profiling / /debug/profile tick rate
trace-span-cap = 4096          # TRACE drops spans past this cap
metrics-history-interval = 15  # seconds between metrics-history samples
metrics-history-cap = 240      # samples retained (feeds metrics_summary
                               # and /debug/metrics/history)
# Top SQL — continuous per-digest + per-operator resource attribution
# (information_schema.tidb_top_sql / cluster_top_sql, /debug/topsql,
# top-by-device-time in /status). Off by default: disabled it costs
# zero work and zero allocations on the statement path. Enabled, every
# completed statement feeds a ring of topsql-window-seconds buckets;
# each bucket keeps topsql-digest-cap digests and folds the rest into
# an "(other)" overflow entry. Hot-reloadable via SIGHUP.
topsql-enabled = false
topsql-window-seconds = 60
topsql-digest-cap = 50
# Typed wait-state attribution — per-statement exclusive wait ledger
# (tso_wait, lease_wait, backoff.{kind}, rpc_net, prewrite,
# commit_primary, commit_secondary, resolve_lock, fsync_wait) feeding
# the wait_profile column of EXPLAIN ANALYZE / the slow log,
# information_schema.tidb_wait_profile (+ cluster_ variant),
# /debug/waitprofile and the dominant-wait inspection rule. Off by
# default: disabled, no ledger is installed and the statement path does
# zero ledger work (the tidb_wait_seconds histograms stay on either
# way). Hot-reloadable via SIGHUP.
wait-profile-enabled = false
# Structured server event ring (information_schema.tidb_events,
# /debug/events): governor kills, admission sheds, rpc breaker trips,
# elections/promotions, checkpoint/fsync stalls, with conn/digest
# attribution. events-history-cap bounds the ring.
events-history-cap = 512
# Session plan-cache LRU capacity: physical plans AND point FastPlans
# (the OLTP bypass) share one per-session LRU under the same SQL-text /
# prepared-statement keys; hits/misses/evictions export as
# tidb_plan_cache_{hits,misses,evictions}_total. Hot-reloadable.
plan-cache-size = 128
# Thread-light conn plane: idle connections park on one reactor
# thread and only hold a worker while a statement executes. This is
# the pool's warm-idle reserve (0 = auto: min(8, cpu/2)); the pool
# grows on demand — execution concurrency is bounded by token-limit,
# never by the pool, so lock-holders can always get a worker for
# their COMMIT. Hot-reloadable via SIGHUP.
conn-worker-threads = 0

[plan-cache]
enabled = true
capacity = 128                 # legacy alias of plan-cache-size

[analysis]
# Concurrency analysis plane (tidb_tpu/analysis/). The STATIC half —
# the AST rule engine (blocking-call-under-hot-lock, lock-order,
# tls-frame-hygiene, thread-discipline, failpoint-registry,
# bare-except, engine-tag, metric-families, config-knob-drift) with
# its committed baseline (tidb_tpu/analysis/baseline.txt) — runs
# offline and inside tier-1:
#     python -m tidb_tpu.analysis --check
# and needs no configuration. This section arms the DYNAMIC half:
# lock-check = true wraps long-lived subsystem locks (storage commit
# lock, MVCC/native store mutexes, the group-fsync rendezvous, RPC
# registries) in instrumented twins feeding a process-wide lock-order
# graph; observed cycles (potential deadlocks) and blocking syscalls
# under a hot lock surface as the lock-order-inversion inspection
# rule and /debug/lockgraph. Off by default: disabled, every lock is
# a plain threading primitive — zero overhead, the Top SQL contract.
# TIDB_TPU_LOCK_CHECK=1 is the no-config equivalent, and
# TIDB_TPU_NATIVE_SANITIZE=1 rebuilds the native KV engine under
# ASan/UBSan (native/Makefile `sanitize` target).
lock-check = false

[mesh]
# Multi-chip data plane: shard large columnar epochs across the
# process's device mesh and execute scan/filter/agg fragments
# partition-wise (XLA partitions the kernels; exact limb partials
# merge with native-int32 collectives, so results are bit-identical
# to the single-device path). Placement policy:
#   * epochs with >= shard-threshold-rows rows shard on the row axis
#     and stay device-resident across queries;
#   * smaller tables keep the unchanged single-device path;
#   * join build sides replicate (broadcast join) unless larger than
#     replicate-threshold-bytes — then they shard by key range and
#     probe rows route over the mesh exchange (hash-partition join).
# With enabled = false or a single visible device everything takes
# the exact single-device path. axis-size = 0 uses every device.
enabled = true
axis-size = 0
shard-threshold-rows = 1048576
replicate-threshold-bytes = 67108864
# Mesh flight recorder (observability; zero-work when the plane is
# inactive). A sharded dispatch whose max/mean shard-row ratio reaches
# skew-warn-ratio raises a session warning + a mesh_skew event
# (0 disables). A device whose live buffer bytes cross
# hbm-watermark-fraction of capacity emits a mesh_hbm_watermark event
# (capacity from the backend, or hbm-bytes when the backend cannot
# report it). shard-ring-cap bounds the per-digest dispatch ring
# behind information_schema.tidb_mesh_shards / /debug/mesh.
skew-warn-ratio = 4.0
hbm-watermark-fraction = 0.85
hbm-bytes = 0
shard-ring-cap = 256

[diagnostics]
# Automated cluster inspection (information_schema.inspection_result /
# inspection_summary / cluster_inspection_result, /debug/inspection,
# the /status inspection section): a registry of named diagnosis rules
# evaluated over the live telemetry — metrics history, the server
# event ring, Top SQL windows, the mesh flight recorder, governor/
# admission/breaker state, transport membership, and config sanity.
# Rules are pure functions over one snapshot: thread-free, bounded,
# and with enabled = false the statement path does ZERO inspection
# work. Hot-reloadable via SIGHUP. A rule's FIRST crossing into
# severity=critical records an edge-triggered inspection_finding
# event (tidb_events).
enabled = true
# windowed rules consider this many metrics-history samples (window
# seconds = history-windows x performance.metrics-history-interval)
history-windows = 8
# mesh shard skew must persist this many dispatches to be a finding
skew-min-dispatches = 2
# WAL fsync stalls (>=100ms) per window before wal-fsync-stall fires
fsync-stall-threshold = 3
# member heartbeat age past this is follower-heartbeat-stale (ms;
# 0 disables)
heartbeat-stale-ms = 10000
# a Top SQL digest whose stage split is at least this fraction
# host_fallback is a de-deviced query (top-sql-host-fallback)
host-fallback-fraction = 0.5
# governor kills / admission sheds per window before a finding
governor-kill-threshold = 1
admission-shed-threshold = 1
# per-row scalar-registry rows per window before registry-row-eval
row-eval-threshold = 1
# a serving replica's apply lag past this fires follower-apply-lag
# (warning; critical at 3x — the replica stopped advancing); 0 disables
apply-lag-warn-ms = 2000
# one range changing write leadership this many times in the window
# fires range-leader-flap (a clean failover is ONE transfer)
range-flap-threshold = 3
# one range SPLITTING this many times inside split-flap-window-s fires
# range-split-flap (the salted/monotonic hot-key symptom splitting
# cannot fix); 0 disables the rule
split-flap-threshold = 3
# seconds of range_split history the split-flap rule considers (its
# own window: splits are cooldown-paced, so the shared history window
# is usually too short); 0 = the shared window
split-flap-window-s = 300
# a digest spending at least this fraction of its wall time blocked in
# backoff.* or lease_wait fires dominant-wait (needs
# performance.wait-profile-enabled for the data to exist)
dominant-wait-threshold = 0.5
# a range whose published closed timestamp has not advanced for this
# long WHILE its write counters moved fires range-closed-ts-stall
# (warning; critical at 3x — every range-aware replica read over it is
# falling back to the leader); 0 disables the rule
closed-ts-stall-ms = 10000

[history]
# Workload history plane (information_schema.statements_summary_history
# / tidb_plan_history + cluster_ variants, /debug/history): every
# completed statement feeds a per-(sql_digest, plan_digest) history —
# wall/stage split, engine tags with the fragment strategy, rows, mesh
# skew — aggregated in window-seconds windows; closed windows rotate
# into a durable record list persisted crash-atomically under
# <path>/history/ (tmp+fsync+rename), surviving restarts. A digest
# executing with a NEW plan digest (or a degraded engine class:
# device -> host fallback, point fast path -> full dispatch) fires a
# throttled `plan_change` event, and two inspection rules read the
# history: plan-regression (new plan >= regression-ratio slower than
# the replaced plan's p50) and stmt-perf-regression (same plan,
# sustained drift vs its own baseline). Off by default: disabled it
# costs ZERO work on the statement path (the Top SQL contract).
# Hot-reloadable via SIGHUP.
enabled = false
window-seconds = 60
history-cap = 512
regression-ratio = 1.5

[replica-read]
# Follower read tier: followers fold their mirrored (snapshot, WAL)
# stream into a live local engine continuously (the apply engine) and
# advertise a CLOSED timestamp on every heartbeat; eligible snapshot
# SELECTs (plain autocommit reads over base tables — DML, locking
# reads, system schemas and nondeterministic functions stay on the
# leader) then route to the least-loaded live replica that can cover
# the statement's read timestamp, with typed fallback to the leader on
# staleness, term fencing, or unreachability. Routed reads are
# bit-identical to the leader's answer: same fold, same timestamp.
# Surfaces: information_schema.cluster_info (applied_ts/apply_lag_ms/
# serving), /debug/replicas, tidb_replica_reads_total,
# tidb_follower_apply_lag_seconds, engine tag replica@host:port in
# EXPLAIN ANALYZE / slow log.
enabled = true
# staleness cap: bounds tidb_read_staleness AND how far behind a
# replica may run while remaining a routing candidate
max-staleness-ms = 5000
# follower apply cadence (closed-ts fetch + columnar fold)
apply-interval-ms = 200
# route eligible SELECTs to followers by default (seeds the
# tidb_replica_read sysvar; sessions override with
# SET tidb_replica_read = 'leader' | 'follower')
prefer-follower = false
# range-aware covering: a routed SELECT additionally requires every
# range its table spans touch to have published closed_ts >= read_ts
# (the per-range pending-commit ledger floors; needs [ranges] armed to
# see any ranges — without a range plane the gate is a no-op). Fault
# schedules for the partition drills this tier is tested under arm via
# the failpoint registry (TIDB_TPU_FAILPOINTS=net/delay=5 etc., see
# rpc/netfault.py), not TOML. false = single-closed-ts routing,
# byte-for-byte today's behavior.
range-aware = false

[ranges]
# Range-sharded write leadership: split the keyspace into ranges whose
# write leadership is held by independently-leased leaders (possibly
# different processes per range), each with its own fencing term, its
# own WAL and its own closed timestamp; cross-range transactions run
# percolator 2PC against each range's current leader with the primary
# key as the atomicity anchor. Disabled (the default) constructs
# nothing: single-range deployments run the exact pre-range commit
# path. Surfaces: information_schema.cluster_info type='range' rows,
# /status "ranges", tidb_range_{leaders,transfers_total,
# orphan_resolutions_total,splits_total}, the range-leader-flap and
# range-split-flap inspection rules.
enabled = false
# initial range table (written once, first writer wins; restart-only):
# `count` even single-byte-prefix splits, or explicit comma-separated
# split keys which override count
count = 4
split-points = ""
# leadership lease horizon: a leader that cannot renew within it
# fences itself and a successor takes over right after expiry
# (hot-reloadable)
lease-ms = 1000
# prewrite lock TTL: how long a crashed coordinator's orphan locks
# block peers before primary-status checks may roll them
# forward/backward (hot-reloadable)
resolve-ttl-ms = 3000
# the range RPC listener bind (restart-only)
listen = "127.0.0.1:0"
# heat-driven auto-split actuator: act on range-split-advisory findings
# (needs heatmap.enabled) by splitting the hot range online at the
# advised weighted-median key. Off (the default) the lease tick does
# ZERO actuator work — splits never occur spontaneously
# (hot-reloadable)
auto-split = false
# minimum quiet time between auto-splits — paces a hot workload instead
# of shattering the keyspace (hot-reloadable)
split-cooldown-ms = 10000
# lifetime cap on actuator-triggered splits per server process, a
# runaway-advisory backstop; manual range_split RPCs are never counted
# or capped (hot-reloadable)
max-auto-splits = 4

[heatmap]
# Keyspace heat plane (information_schema.tidb_hot_ranges /
# cluster_hot_ranges, /debug/keyviz): a rolling ring of ring-buckets
# time buckets x range cells, each accumulating read rows/bytes, write
# rows/bytes and statement counts, fed from the four traffic sites —
# fast-path point reads, coprocessor scans, 2PC commits, and
# range-leader applies (a routed write counts exactly once, on its
# leader). At each bucket rotation every range's activity is compared
# against the FLEET MEDIAN across all known ranges: a range at
# >= hot-ratio x median for sustained-buckets consecutive buckets
# fires one edge-triggered `hot_range` event, the hot-range inspection
# rule, and a range-split-advisory naming the within-range key (the
# weighted median of a bounded key-sample sketch) that best halves the
# observed write traffic — advisory only, add it to
# ranges.split-points to act on it. Surfaces also include
# tidb_range_{read,write}_{rows,bytes}_total{range},
# tidb_hot_range_ratio, and heat columns on /status ranges +
# cluster_info type='range' rows. Off by default: disabled it costs
# ZERO work on the statement path (the Top SQL contract).
# Hot-reloadable via SIGHUP.
enabled = false
# one heat bucket's span; hot detection runs at bucket rotation
bucket-seconds = 10
# buckets retained (the keyviz window = ring-buckets x bucket-seconds)
ring-buckets = 36
# a range at >= this multiple of the fleet-median bucket activity is a
# hot candidate
hot-ratio = 8.0
# consecutive hot buckets before the event / finding fires
sustained-buckets = 2
# per-range bounded write-key sample feeding the split advisory
key-sample-cap = 64

[gc]
life-time = "10m0s"            # versions younger than this survive GC
run-interval = "10m0s"         # background maintenance cadence

[transport]
# Multi-process plane transport. Default (both addresses empty): local
# single-process store, or flock-coordinated shared directory when the
# server starts with --shared. Socket mode needs no shared disk:
#   leader:   set `listen` on the server that owns `path`; it serves
#             TSO allocation, WAL append/tail and the KILL mailbox.
#   follower: set `remote` to the leader's address; `path` (or a
#             throwaway dir) is then this server's PRIVATE working dir.
# On leader loss a follower keeps serving READS at the last replicated
# state (bounded staleness) and rejects writes with errno 9001 until
# the lease renews; set stale-reads = false to fail reads instead.
listen = ""                    # leader RPC address (host:port | unix:/p)
remote = ""                    # follower: leader's RPC address
connect-timeout-ms = 1000
request-timeout-ms = 5000
backoff-budget-ms = 4000       # per-call typed-retry budget
lock-budget-ms = 30000         # mutation-lease acquisition budget
lease-ms = 3000                # leader-granted lease horizon
stale-reads = true             # degraded followers serve stale reads
diag-listen = "127.0.0.1:0"    # follower diagnostics endpoint
                               # (cluster_* tables pull rows from it;
                               # peers dial the bound host, so use a
                               # specific routable address — wildcards
                               # like 0.0.0.0 are rejected)
# Automatic leader failover: after the leader heartbeat has failed for
# election-timeout-ms, followers elect deterministically (longest
# replicated WAL wins, ties to the lowest node id); the winner
# promotes in place on promote-listen with a bumped fencing term, and
# survivors repoint. 0 disables failover (followers stay degraded
# read-only until the leader returns).
election-timeout-ms = 10000
promote-listen = "127.0.0.1:0" # coordination address if promoted
                               # (use a routable host across machines)
# Circuit breaker: after breaker-threshold CONSECUTIVE calls exhausted
# their retry budget, fail fast for breaker-cooldown-ms (one half-open
# probe after) instead of burning a full backoff-budget-ms per call
# against a dead leader. 0 disables. State rides /status transport
# health and tidb_rpc_breaker_*_total metrics.
breaker-threshold = 3
breaker-cooldown-ms = 2000

[security]
skip-grant-table = false
ssl-ca = ""
ssl-cert = ""                  # PEM chain; with ssl-key enables TLS
ssl-key = ""
auto-tls = false               # ephemeral self-signed cert at startup
require-secure-transport = false
proxy-protocol-networks = ""   # LB CIDRs (or "*") sending PROXY headers
# LOAD DATA LOCAL INFILE opt-in (seeds the local_infile sysvar).
# Off: LOCAL is rejected with errno 1235. On: LOCAL is accepted, but
# since this server reads the named path from ITS OWN filesystem (the
# client-side transfer sub-protocol is not implemented), authenticated
# users need either the FILE privilege or a configured
# secure-file-priv — which, when set, always confines the path.
# Duplicate-key errors degrade to IGNORE unless REPLACE was given.
local-infile = false
"""


__all__ = ["Config", "ConfigError", "EXAMPLE"]
