"""Process entry point: `python -m tidb_tpu_torch.server [flags]`.

Port of `tidb_tpu/server/__main__.py`: the same flags, precedence
(defaults < config file < flags, with the reloadable knobs a flag pins
kept across SIGHUP), seeds, stdout lines and signals. One flag more,
`--device` (default `cuda`): where every connection's coprocessor runs,
as `Server(device=)` takes it. The process does not move to the CPU on
its own: without a card it fails unless `--device cpu` is given, a
follower and a sibling as much as a leader. The mode follows the
reference: `[transport] remote` (or `--transport-remote`) makes a socket
follower with `--path` as its private working dir, `[transport] listen`
(or `--transport-listen`) a leader that also serves the coordination
RPC tier, `--shared` a sibling over a shared `--path`. A follower with
`election-timeout-ms` above 0 (the default, 10000) runs the failover
watcher and, when it wins an election, serves coordination RPC on
`promote-listen`; `--device` also places the sessions a follower serves
routed replica reads on. Startup and SIGHUP seed `[heatmap]` and
`[ranges]` as the reference does. `[analysis] lock-check` arms the
lock-order checker before the store opens. The knobs of the mesh plane,
which the port does not have, raise `NotInSlice` at startup (`[mesh]`,
ROADMAP item 8).

Counterpart of the reference's tidb-server binary (reference:
tidb-server/main.go:160 — flag parsing :76-151, config load + flag
override :168,408, store+domain creation :263, signal handling +
graceful shutdown :652,703; SIGHUP-style hot reload of the reloadable
config subset :369).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

import torch

from ..config import Config, ConfigError
from ..errors import NotInSlice
from ..store.storage import Storage
from .server import Server


def _parse_bool(v: str) -> bool:
    """strconv.ParseBool spellings (reference: flagBoolean)."""
    lv = v.strip().lower()
    if lv in ("1", "t", "true", "on", "yes"):
        return True
    if lv in ("0", "f", "false", "off", "no"):
        return False
    raise argparse.ArgumentTypeError(f"invalid boolean value {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tidb-tpu-server",
        description="MySQL-compatible SQL server on one CUDA device")
    p.add_argument("--config", default=None, help="TOML config file")
    p.add_argument("--print-example-config", action="store_true",
                   help="print the example config and exit")
    p.add_argument("-host", "--host", default=None, help="listen address")
    p.add_argument("-P", "--port", type=int, default=None,
                   help="MySQL protocol port")
    p.add_argument("--shared", action="store_true",
                   help="multi-process mode: coordinate with sibling "
                        "servers sharing --path (flock'd WAL, schema "
                        "reload, cross-server KILL)")
    p.add_argument("--transport-listen", default=None,
                   help="store leader: serve the coordination RPC tier "
                        "(TSO/WAL/KILL) on host:port or unix:/path so "
                        "followers can join without sharing --path")
    p.add_argument("--transport-remote", default=None,
                   help="follower: join the leader at host:port over "
                        "the socket transport; --path becomes this "
                        "server's private working dir")
    p.add_argument("--path", default=None,
                   help="durable storage directory (default: in-memory)")
    p.add_argument("--sync-log", default=None,
                   choices=["off", "commit", "interval"],
                   help="KV WAL fsync policy: commit = fsync every "
                        "commit boundary; interval = group commit")
    p.add_argument("--sync-interval-ms", type=int, default=None,
                   help="group-commit window for --sync-log interval")
    p.add_argument("--election-timeout-ms", type=int, default=None,
                   help="leader-loss window before a follower runs the "
                        "failover election (0 disables)")
    p.add_argument("--promote-listen", default=None,
                   help="coordination address this follower serves on "
                        "if it wins an election")
    p.add_argument("--socket", default=None, help="unix socket (unused)")
    p.add_argument("--default-db", default=None)
    p.add_argument("--max-connections", type=int, default=None)
    p.add_argument("--max-server-connections", type=int, default=None,
                   help="hard connection cap rejected with errno 1040 "
                        "before handshake work (0 = max-connections)")
    p.add_argument("--server-memory-limit", default=None,
                   help="server-wide memory limit (bytes, fraction "
                        "like 0.8, or 80%%); the governor kills the "
                        "heaviest statement past it")
    p.add_argument("--token-limit", type=int, default=None,
                   help="max concurrently executing statements "
                        "(0 = unlimited)")
    p.add_argument("--admission-timeout-ms", type=int, default=None,
                   help="queue wait before shedding with 'server busy'")
    p.add_argument("--lease", default=None, help="schema lease")
    p.add_argument("-L", "--log-level", default=None,
                   choices=["debug", "info", "warn", "error"])
    p.add_argument("--log-slow-threshold", type=int, default=None,
                   help="slow-log threshold (ms)")
    p.add_argument("--report-status", type=_parse_bool,
                   default=None, help="expose the HTTP status port")
    p.add_argument("--status-host", default=None)
    p.add_argument("--status", "--status-port", dest="status_port",
                   type=int, default=None, help="HTTP status port")
    p.add_argument("--mem-quota-query", type=int, default=None,
                   help="per-query memory budget (bytes)")
    p.add_argument("--gc-life-time", default=None)
    p.add_argument("--gc-run-interval", default=None)
    p.add_argument("--plan-cache", type=_parse_bool, default=None)
    p.add_argument("--tile-rows", type=int, default=None,
                   help="device tile granularity (rows)")
    p.add_argument("--skip-grant-table", action="store_true",
                   default=None)
    p.add_argument("--ssl-cert", default=None)
    p.add_argument("--ssl-key", default=None)
    p.add_argument("--auto-tls", type=_parse_bool, default=None)
    p.add_argument("--require-secure-transport", type=_parse_bool,
                   default=None)
    p.add_argument("--proxy-protocol-networks", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the coprocessor runs: cuda (default) or "
                        "cpu")
    return p


def resolve_config(args) -> Config:
    """defaults < config file < CLI flags (reference: main.go:408)."""
    cfg = Config.load(args.config) if args.config else Config()
    flag_map = [
        ("host", cfg, "host"), ("port", cfg, "port"),
        ("path", cfg, "path"), ("socket", cfg, "socket"),
        ("default_db", cfg, "default_db"),
        ("max_connections", cfg, "max_connections"),
        ("max_server_connections", cfg, "max_server_connections"),
        ("server_memory_limit", cfg.performance, "server_memory_limit"),
        ("token_limit", cfg.performance, "token_limit"),
        ("admission_timeout_ms", cfg.performance, "admission_timeout_ms"),
        ("lease", cfg, "lease"),
        ("log_level", cfg.log, "level"),
        ("log_slow_threshold", cfg.log, "slow_threshold"),
        ("report_status", cfg.status, "report_status"),
        ("status_host", cfg.status, "status_host"),
        ("status_port", cfg.status, "status_port"),
        ("mem_quota_query", cfg.performance, "mem_quota_query"),
        ("tile_rows", cfg.performance, "tile_rows"),
        ("gc_life_time", cfg.gc, "life_time"),
        ("gc_run_interval", cfg.gc, "run_interval"),
        ("plan_cache", cfg.plan_cache, "enabled"),
        ("skip_grant_table", cfg.security, "skip_grant_table"),
        ("ssl_cert", cfg.security, "ssl_cert"),
        ("ssl_key", cfg.security, "ssl_key"),
        ("auto_tls", cfg.security, "auto_tls"),
        ("require_secure_transport", cfg.security,
         "require_secure_transport"),
        ("proxy_protocol_networks", cfg.security,
         "proxy_protocol_networks"),
        ("transport_listen", cfg.transport, "listen"),
        ("transport_remote", cfg.transport, "remote"),
        ("sync_log", cfg.storage, "sync_log"),
        ("sync_interval_ms", cfg.storage, "sync_interval_ms"),
        ("election_timeout_ms", cfg.transport, "election_timeout_ms"),
        ("promote_listen", cfg.transport, "promote_listen"),
    ]
    dotted = {
        "log_slow_threshold": "log.slow_threshold",
        "log_level": "log.level",
        "gc_life_time": "gc.life_time",
        "gc_run_interval": "gc.run_interval",
        "mem_quota_query": "performance.mem_quota_query",
        # reloadable overload knobs: a CLI-pinned value must survive
        # SIGHUP (hot_reload skips cli_overrides), or the governor/gate
        # would silently disarm mid-incident
        "server_memory_limit": "performance.server_memory_limit",
        "token_limit": "performance.token_limit",
        "admission_timeout_ms": "performance.admission_timeout_ms",
        "plan_cache": "plan_cache.enabled",
    }
    for flag, obj, attr in flag_map:
        v = getattr(args, flag, None)
        if v is not None:
            setattr(obj, attr, v)
            if flag in dotted:
                cfg.cli_overrides.add(dotted[flag])
    cfg.validate()
    return cfg


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.print_example_config:
        from ..config import EXAMPLE
        print(EXAMPLE, end="")
        return 0
    try:
        cfg = resolve_config(args)
    except (ConfigError, OSError) as e:
        print(f"invalid configuration: {e}", file=sys.stderr)
        return 1

    cfg.apply_log_level()
    # [analysis] lock-check arms the dynamic lock-order checker BEFORE
    # any storage/lock creation — only locks created after enable()
    # are instrumented (env TIDB_TPU_LOCK_CHECK is the no-config path)
    if cfg.analysis.lock_check:
        from ..analysis import lockcheck
        lockcheck.enable()
    # the mesh plane's knobs fail before the store opens (not ported)
    cfg.seed_mesh()
    from ..device import resolve_device
    device = resolve_device(args.device)
    # a card that cannot take a tensor fails the start, not the first
    # query
    torch.empty(0, device=device)
    # transport selection: a follower joins a leader over the socket; a
    # leader also serves the coordination RPC tier; otherwise the local
    # and shared-directory modes (reference: main.go:263 creates the
    # store from the store-type flag the same way)
    sync_kw = {"sync_log": cfg.storage.sync_log,
               "sync_interval_ms": cfg.storage.sync_interval_ms,
               "device": device}
    if cfg.transport.remote:
        storage = Storage(cfg.path or None, remote=cfg.transport.remote,
                          rpc_options=cfg.rpc_options(), **sync_kw)
    elif cfg.transport.listen:
        storage = Storage(cfg.path or None, shared=True,
                          rpc_listen=cfg.transport.listen,
                          rpc_options=cfg.rpc_options(), **sync_kw)
    else:
        storage = Storage(cfg.path or None, shared=args.shared, **sync_kw)
    try:
        cfg.seed_sysvars(storage)
        # arm the attribution/event plane (Top SQL, event ring, metrics
        # history) and the overload-protection plane (memory governor,
        # execution admission gate) from the [performance] knobs
        cfg.seed_observability(storage)
        cfg.seed_overload_protection(storage)
        cfg.seed_diagnostics(storage)
        cfg.seed_history(storage)
        cfg.seed_heatmap(storage)
        cfg.seed_replica_read(storage)
        cfg.seed_ranges(storage)
        cfg.seed_group_commit(storage)
    except BaseException:
        storage.close()
        raise
    srv = Server(storage, host=cfg.host, port=cfg.port,
                 default_db=cfg.default_db,
                 max_connections=cfg.effective_max_connections(),
                 status_port=(cfg.status.status_port
                              if cfg.status.report_status else None),
                 status_host=cfg.status.status_host,
                 skip_grant_table=cfg.security.skip_grant_table,
                 ssl_cert=cfg.security.ssl_cert or None,
                 ssl_key=cfg.security.ssl_key or None,
                 ssl_ca=cfg.security.ssl_ca or None,
                 auto_tls=cfg.security.auto_tls,
                 require_secure_transport=(
                     cfg.security.require_secure_transport),
                 proxy_protocol_networks=(
                     cfg.security.proxy_protocol_networks),
                 conn_workers=cfg.performance.conn_worker_threads,
                 device=device)
    srv.start()
    # background GC / lock-TTL / auto-analyze / checkpoint loop; the
    # interval re-reads tidb_gc_run_interval every cycle (reference:
    # gcworker started with the store, gc_worker.go:95)
    storage.maintenance.start()
    print(f"tidb-tpu-server listening on {cfg.host}:{srv.port}",
          flush=True)
    if storage.rpc_server is not None:
        print(f"coordination rpc on {storage.rpc_server.address}",
              flush=True)

    done = threading.Event()

    def _stop(signum, frame):  # noqa: ARG001
        print("shutting down...", flush=True)
        done.set()

    def _reload(signum, frame):  # noqa: ARG001
        if not args.config:
            return
        try:
            applied = cfg.hot_reload(args.config)
            cfg.seed_sysvars(storage)
            cfg.seed_observability(storage)
            cfg.seed_overload_protection(storage)
            cfg.seed_diagnostics(storage)
            cfg.seed_history(storage)
            cfg.seed_heatmap(storage)
            cfg.seed_replica_read(storage)
            cfg.seed_ranges(storage)
            cfg.seed_group_commit(storage)
            if srv._pool is not None:
                # 0 = recompute the auto sizing (min(8, cpu/2)), so a
                # reload can RESTORE auto after an explicit override
                srv._pool.configure(
                    cfg.performance.conn_worker_threads
                    or Server.auto_conn_workers())
            cfg.apply_log_level()
            print(f"config reloaded: {applied or 'no reloadable changes'}",
                  flush=True)
        except (ConfigError, OSError, NotInSlice) as e:
            print(f"config reload failed: {e}", flush=True)

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _reload)
    done.wait()
    srv.close()
    storage.close()  # stops maintenance; checkpoints durable stores
    return 0


if __name__ == "__main__":
    sys.exit(main())
