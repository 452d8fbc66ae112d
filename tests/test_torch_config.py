"""The port's config system against the reference's, field by field.

tests/test_config.py's cases run on both packages: the same TOML text
loads into the same values (every dotted field compared), fails with the
same `ConfigError` text, validates alike, resolves the same flags with the
same precedence and CLI pins, hot-reloads the same subset and seeds the
same sysvars. `EXAMPLE` and `--print-example-config` are byte-equal to
`config.toml.example`. Then the port's own rule: a knob of a plane the
port does not have loads as in the reference, does nothing at its
default and raises `NotInSlice` naming its queue item otherwise; the
knobs of planes ported since (every plane now) act as the reference's
do.
Tolerance: none.
"""

from __future__ import annotations

import dataclasses
import os

import pytest

from tidb_tpu import config as RC
from tidb_tpu.server import __main__ as RM
from tidb_tpu.store.storage import Storage as RefStorage
from tidb_tpu_torch import config as PC
from tidb_tpu_torch.errors import NotInSlice
from tidb_tpu_torch.server import __main__ as PM
from tidb_tpu_torch.store.storage import Storage

SIDES = ((RC, RM), (PC, PM))


def _write(tmp_path, text):
    p = tmp_path / "cfg.toml"
    p.write_text(text)
    return str(p)


def _fields(obj, prefix: str = "") -> dict:
    """Every dotted field of a config and its sections."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def _same_fields(ref_cfg, port_cfg) -> None:
    a, b = _fields(ref_cfg), _fields(port_cfg)
    assert sorted(a) == sorted(b)
    for k in a:
        assert (k, a[k]) == (k, b[k])


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


def test_section_dataclasses_equal():
    for name in ("Config", "LogConfig", "LogFileConfig", "StatusConfig",
                 "PerformanceConfig", "StorageConfig", "MeshSection",
                 "DiagnosticsConfig", "HistoryConfig", "HeatmapConfig",
                 "ReplicaReadConfig", "RangesConfig", "AnalysisConfig",
                 "PlanCacheConfig", "GCConfig", "SecurityConfig",
                 "TransportConfig"):
        _same_fields(getattr(RC, name)(), getattr(PC, name)())
    assert PC.Config.RELOADABLE == RC.Config.RELOADABLE


def test_defaults_and_example_roundtrip(tmp_path):
    for C, _ in SIDES:
        cfg = C.Config()
        cfg.validate()
        loaded = C.Config.load(_write(tmp_path, C.EXAMPLE))
        loaded.validate()
        assert loaded == cfg
    assert PC.EXAMPLE == RC.EXAMPLE


def test_load_sections(tmp_path):
    path = _write(tmp_path, """
port = 4444
path = "/tmp/x"
[log]
slow-threshold = 50
level = "warn"
[gc]
life-time = "1h"
[plan-cache]
enabled = false
[performance]
topsql-enabled = true
token-limit = 3
[history]
enabled = true
[heatmap]
hot-ratio = 9.5
""")
    ref, port = RC.Config.load(path), PC.Config.load(path)
    _same_fields(ref, port)
    assert port.port == 4444 and port.path == "/tmp/x"
    assert port.log.slow_threshold == 50 and port.log.level == "warn"
    assert port.gc.life_time == "1h"
    assert port.plan_cache.enabled is False


@pytest.mark.parametrize("text", [
    "prot = 4000\n",
    "[log]\nlvl = 'info'\n",
    "port = 'x'\n",
    "[plan-cache]\nenabled = 'yes'\n",
    "port = true\n",
    "log = 3\n",
    'port = "unclosed\n',
    "[security]\nssl-cert = 5\n",
])
def test_load_errors_equal(tmp_path, text):
    """Strict decode, type mismatches (a bool for an int key too) and
    malformed TOML: the same ConfigError text on both packages."""
    path = _write(tmp_path, text)
    got = [_outcome(lambda C=C: C.Config.load(path)) for C, _ in SIDES]
    assert got[0][0] == "ConfigError"
    assert got[0] == got[1]


def test_strict_unknown_key(tmp_path):
    for C, _ in SIDES:
        with pytest.raises(C.ConfigError, match="unknown config key"):
            C.Config.load(_write(tmp_path, "prot = 4000\n"))
        with pytest.raises(C.ConfigError,
                           match="unknown config key 'log.lvl'"):
            C.Config.load(_write(tmp_path, "[log]\nlvl = 'info'\n"))


def test_type_mismatch(tmp_path):
    for C, _ in SIDES:
        with pytest.raises(C.ConfigError, match="expects an integer"):
            C.Config.load(_write(tmp_path, "port = 'x'\n"))
        with pytest.raises(C.ConfigError, match="expects a boolean"):
            C.Config.load(_write(tmp_path,
                                 "[plan-cache]\nenabled = 'yes'\n"))


# (dotted field, value) pairs that each fail one validation rule
INVALID = [
    ("port", 99999), ("log.level", "loud"), ("max_connections", 0),
    ("status.status_port", -1), ("performance.server_memory_limit", "x"),
    ("performance.token_limit", -1), ("performance.trace_span_cap", 4),
    ("performance.metrics_history_interval", 0),
    ("diagnostics.dominant_wait_threshold", 2.0),
    ("history.regression_ratio", 0.5), ("heatmap.ring_buckets", 1),
    ("log.file.max_backups", 0), ("storage.sync_log", "always"),
    ("transport.lease_ms", 0), ("mesh.hbm_watermark_fraction", 0.0),
    ("ranges.count", 0), ("performance.conn_worker_threads", -1),
]


@pytest.mark.parametrize("dotted,value", INVALID,
                         ids=[d for d, _ in INVALID])
def test_validation(dotted, value):
    got = []
    for C, _ in SIDES:
        cfg = C.Config()
        *path, leaf = dotted.split(".")
        obj = cfg
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, leaf, value)
        got.append(_outcome(cfg.validate))
    assert got[0][0] == "ConfigError"
    assert got[0] == got[1]


def test_flag_precedence(tmp_path):
    path = _write(tmp_path, "port = 4444\n[log]\nslow-threshold = 50\n")
    argv = ["--config", path, "-P", "5555", "--gc-life-time", "30m",
            "--token-limit", "2", "--report-status", "off"]
    ref = RM.resolve_config(RM.build_parser().parse_args(argv))
    port = PM.resolve_config(PM.build_parser().parse_args(argv))
    _same_fields(ref, port)
    assert port.cli_overrides == ref.cli_overrides
    assert port.port == 5555           # flag beats file
    assert port.log.slow_threshold == 50  # file beats default
    assert port.gc.life_time == "30m"


def test_parsers_have_the_same_flags():
    """Every flag of the reference, with its default; the port adds only
    --device."""
    def flags(p):
        return {a.dest: (sorted(a.option_strings), a.default)
                for a in p._actions if a.dest != "help"}
    ref, port = flags(RM.build_parser()), flags(PM.build_parser())
    assert port.pop("device") == (["--device"], "cuda")
    assert port == ref


def test_hot_reload_subset(tmp_path):
    for C, _ in SIDES:
        p = tmp_path / "cfg.toml"
        p.write_text("port = 4444\n[log]\nslow-threshold = 100\n")
        cfg = C.Config.load(str(p))
        p.write_text("port = 9999\n[log]\nslow-threshold = 250\n"
                     "[gc]\nlife-time = '20m'\n"
                     "[performance]\ntopsql-enabled = true\n")
        applied = cfg.hot_reload(str(p))
        assert applied == ["gc.life_time", "log.slow_threshold",
                           "performance.topsql_enabled"]
        assert cfg.log.slow_threshold == 250
        assert cfg.gc.life_time == "20m"
        assert cfg.port == 4444  # port is NOT reloadable


def test_seed_sysvars():
    got = []
    for C, S in ((RC, RefStorage), (PC, Storage)):
        cfg = C.Config()
        cfg.log.slow_threshold = 123
        cfg.performance.mem_quota_query = 777
        cfg.plan_cache.enabled = False
        cfg.plan_cache.capacity = 64
        cfg.gc.life_time = "1m"
        storage = S()
        cfg.seed_sysvars(storage)
        first = storage.sysvars.all_globals()
        # a user SET GLOBAL survives re-seeding (config provides
        # defaults, not overrides)
        storage.sysvars.set_global("tidb_slow_log_threshold", 999)
        cfg.seed_sysvars(storage)
        got.append((first, storage.sysvars.get_global(
            "tidb_slow_log_threshold")))
    names = set(got[0][0]) & set(got[1][0])
    assert {n: got[0][0][n] for n in names} == \
        {n: got[1][0][n] for n in names}
    assert got[1][0]["tidb_slow_log_threshold"] == 123
    assert got[1][0]["tidb_plan_cache_size"] == 64
    assert got[0][1] == got[1][1] == 999


def test_seeds_arm_the_same_planes(tmp_path):
    """seed_observability, seed_overload_protection, seed_diagnostics,
    seed_history and seed_group_commit leave both stores' planes in the
    same state."""
    path = _write(tmp_path, """
[performance]
topsql-enabled = true
topsql-window-seconds = 7
wait-profile-enabled = true
events-history-cap = 99
metrics-history-interval = 3
token-limit = 4
admission-timeout-ms = 250
server-memory-limit = "123456789"
txn-total-size-limit = 5000
stats-lease = "2s"
[diagnostics]
history-windows = 5
dominant-wait-threshold = 0.25
[history]
enabled = true
window-seconds = 9
[storage]
group-commit-max-batch = 7
[replica-read]
max-staleness-ms = 700
apply-interval-ms = 50
prefer-follower = true
range-aware = true
""")
    states = []
    for C, S in ((RC, RefStorage), (PC, Storage)):
        cfg = C.Config.load(path)
        st = S(str(tmp_path / C.__name__))
        try:
            for seed in ("seed_observability", "seed_overload_protection",
                         "seed_diagnostics", "seed_history",
                         "seed_group_commit", "seed_replica_read"):
                getattr(cfg, seed)(st)
            o = st.obs
            states.append({
                "topsql": (o.topsql.enabled, o.topsql.window_s,
                           o.topsql.digest_cap),
                "waits": o.waitprofile.enabled,
                "events": o.events._ring.maxlen,
                "mh": (st.metrics_history.interval_s,
                       st.metrics_history._ring.maxlen),
                "gov": st.governor.stats(),
                "gate": st.admission.stats(),
                "txn": st.txn_total_size_limit,
                "lease": st.maintenance.stats_lease_s,
                "diag": (st.diagnostics.history_windows,
                         st.diagnostics.dominant_wait_threshold,
                         st.diagnostics._status_cache),
                "hist": (st.history.enabled, st.history.window_seconds),
                "group": st.kv.kv._syncer.group_max_batch,
                "replica": dataclasses.asdict(st.replica_read),
            })
        finally:
            st.metrics_history.stop()
            st.close()
    assert states[0] == states[1]
    assert states[1]["lease"] == 2.0 and states[1]["topsql"][0]


@pytest.mark.parametrize("text,seed,item", [
    ("[heatmap]\nenabled = true\n", "seed_heatmap", "5c"),
    ("[heatmap]\nhot-ratio = 4.0\n", "seed_heatmap", "5c"),
    ("[ranges]\ncount = 8\n", "seed_ranges", "5c"),
    ("[diagnostics]\nclosed-ts-stall-ms = 5\n", "seed_diagnostics", "5c"),
    ("[diagnostics]\nskew-min-dispatches = 5\n", "seed_diagnostics", 8),
    ("[mesh]\naxis-size = 2\n", "seed_mesh", 8),
    ("[mesh]\nshard-threshold-rows = 16\n", "seed_mesh", 8),
    ("[ranges]\nenabled = true\n", "seed_ranges", "5c"),
    ("[diagnostics]\nsplit-flap-threshold = 2\n", "seed_diagnostics",
     "5c"),
    ("[diagnostics]\nrange-flap-threshold = 2\n", "seed_diagnostics",
     "5c"),
    ("[diagnostics]\nsplit-flap-window-s = 5\n", "seed_diagnostics", "5c"),
    ("[analysis]\nlock-check = true\n", "main", 6),
])
def test_unported_knobs_raise_not_in_slice(tmp_path, text, seed, item):
    """The knob loads as in the reference. For a plane the port does not
    have, its seed does nothing at the defaults and raises NotInSlice,
    naming the queue item, otherwise. The knobs of the range and heat
    planes (item 5c, ported since) seed both packages' durable stores
    alike: the heat plane's knobs, the range thresholds and the armed
    range plane (its table, knobs and hosted ranges) compared. The lock
    checker's knob (item 6, ported since) arms each package's checker
    in its entry point before the store opens."""
    path = _write(tmp_path, text)
    _same_fields(RC.Config.load(path), PC.Config.load(path))
    if item == "5c":
        states = []
        for C, S in ((RC, RefStorage),
                     (PC, lambda p: Storage(p, device="cpu"))):
            st = S(str(tmp_path / C.__name__))
            try:
                getattr(C.Config.load(path), seed)(st)
                states.append(_plane_state(st))
            finally:
                st.close()
        assert states[1] == states[0]
        return
    if seed == "main":
        assert _armed_before_the_store_opens(RM, path) is True
        assert _armed_before_the_store_opens(
            PM, path, "--device", "cpu") is True
        return
    if item == 8:
        # the mesh plane (item 8, ported since): [mesh] configures each
        # package's process plane alike, skew-min-dispatches arms each
        # storage's mesh-shard-skew rule alike
        assert _mesh_seed_state(RC, path, seed) == \
            _mesh_seed_state(PC, path, seed)
        return
    args = () if seed == "seed_mesh" else (Storage(),)
    getattr(PC.Config(), seed)(*args)
    with pytest.raises(NotInSlice) as e:
        getattr(PC.Config.load(path), seed)(*args)
    assert f"item {item})" in e.value.reason


def _mesh_seed_state(C, path, seed) -> dict:
    """What one package's seed of `path` sets: the process mesh plane's
    config (restored afterwards), or a fresh storage's diagnostics."""
    pkg = C.__name__.rsplit(".", 1)[0]
    M = __import__(pkg + ".copr.mesh", fromlist=["mesh"])
    if seed == "seed_mesh":
        old = M.get_plane().cfg
        try:
            C.Config.load(path).seed_mesh()
            return dataclasses.asdict(M.get_plane().cfg)
        finally:
            M.configure(**dataclasses.asdict(old))
    S = __import__(pkg + ".store.storage", fromlist=["Storage"]).Storage
    st = S() if C is RC else S(device="cpu")
    try:
        C.Config.load(path).seed_diagnostics(st)
        return {"skew_min_dispatches":
                st.diagnostics.skew_min_dispatches}
    finally:
        st.close()


class _StoreOpened(Exception):
    pass


def _armed_before_the_store_opens(main_mod, path, *flags):
    """Whether the entry point had armed its package's lock checker when
    it constructed the store (the stand-in store stops the start)."""
    lockcheck = __import__(
        main_mod.__name__.rsplit(".", 2)[0] + ".analysis.lockcheck",
        fromlist=["lockcheck"])
    was = lockcheck.enabled()
    seen = []

    def store(*a, **kw):
        seen.append(lockcheck.enabled())
        raise _StoreOpened()

    mp = pytest.MonkeyPatch()
    mp.setattr(main_mod, "Storage", store)
    try:
        with pytest.raises(_StoreOpened):
            main_mod.main(["--config", path, "-P", "0", *flags])
    finally:
        mp.undo()
        if not was:
            lockcheck.disable()
            lockcheck.reset()
    return seen[0]


def _plane_state(st) -> dict:
    """What the [heatmap], [ranges] and range-threshold seeds set."""
    h, d = st.heat, st.diagnostics
    plane = None
    if st.ranges is not None:
        plane = {k: v for k, v in st.ranges.status().items()
                 if k not in ("listen", "hosted")}
        plane["hosted"] = [(r["range_id"], r["term"], r["epoch"])
                           for r in st.ranges.status()["hosted"]]
    return {"heat": (h.enabled, h.bucket_seconds, h.ring_buckets,
                     h.hot_ratio, h.sustained_buckets, h.key_sample_cap),
            "diag": (d.range_flap_threshold, d.split_flap_threshold,
                     d.split_flap_window_s, d.closed_ts_stall_ms),
            "ranges": plane}


def test_malformed_toml(tmp_path):
    for C, _ in SIDES:
        with pytest.raises(C.ConfigError, match="malformed TOML"):
            C.Config.load(_write(tmp_path, 'port = "unclosed\n'))


def test_toml_subset_parser_equal():
    """The fallback decoder for interpreters without tomllib."""
    text = RC.EXAMPLE + "\n[log.file]\nmax-size = 0x10 # hex\n"
    assert PC._parse_toml_subset(text) == RC._parse_toml_subset(text)
    for bad in ("[log\n", "[]\n", "x\n", "a = 'b\n", "a = 'b' c\n",
                "a = nope\n"):
        got = [_outcome(lambda C=C: C._parse_toml_subset(bad))
               for C, _ in SIDES]
        assert got[0][0] == "_TomlError" and got[0] == got[1]


def test_bool_flag_spellings():
    for _, M in SIDES:
        p = M.build_parser()
        assert p.parse_args(["--plan-cache", "0"]).plan_cache is False
        assert p.parse_args(["--plan-cache", "False"]).plan_cache is False
        assert p.parse_args(["--report-status", "on"]).report_status \
            is True
        with pytest.raises(SystemExit):
            p.parse_args(["--plan-cache", "maybe"])


def test_hot_reload_respects_cli_pins(tmp_path):
    for _, M in SIDES:
        p = tmp_path / "cfg.toml"
        p.write_text("[log]\nslow-threshold = 300\n")
        args = M.build_parser().parse_args(
            ["--config", str(p), "--log-slow-threshold", "100"])
        cfg = M.resolve_config(args)
        assert cfg.log.slow_threshold == 100
        # SIGHUP with an unchanged file must not revert the CLI override
        applied = cfg.hot_reload(str(p))
        assert applied == []
        assert cfg.log.slow_threshold == 100


def test_example_file_in_sync():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "config.toml.example")
    with open(path) as f:
        text = f.read()
    assert text == PC.EXAMPLE == RC.EXAMPLE


def test_bool_literal_rejected_for_int_key(tmp_path):
    for C, _ in SIDES:
        with pytest.raises(C.ConfigError, match="expects an integer"):
            C.Config.load(_write(tmp_path, "port = true\n"))


def test_print_example_config(capsys):
    outs = []
    for _, M in SIDES:
        assert M.main(["--print-example-config"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == PC.EXAMPLE


def test_log_sinks_equal(tmp_path):
    """apply_log_level: the level on the package logger, and the slow
    log's rotating file sink (text and JSON formats) replaced, not
    stacked, on a second call."""
    import logging

    got = []
    for C, logger in ((RC, "tidb_tpu"), (PC, "tidb_tpu_torch")):
        cfg = C.Config()
        cfg.log.level = "warn"
        cfg.log.format = "json"
        cfg.log.slow_query_file = str(tmp_path / f"{logger}.log")
        cfg.apply_log_level()
        cfg.apply_log_level()
        slow = logging.getLogger(logger + ".slowlog")
        sinks = [h for h in slow.handlers
                 if getattr(h, "_titpu_slow_sink", False)]
        rec = logging.LogRecord("slowlog", logging.WARNING, "", 0,
                                "msg %s", ("x",), None)
        rec.slow_entry = {"digest": "d"}
        got.append((logging.getLogger(logger).level, len(sinks),
                    sinks[0].maxBytes, sinks[0].backupCount,
                    sinks[0].formatter.format(rec).split('"level"')[1]))
        cfg.log.slow_query_file = ""
        cfg.apply_log_level()
        logging.getLogger(logger).setLevel(logging.NOTSET)
    assert got[0] == got[1]
    assert got[1][:2] == (logging.WARNING, 1)


def test_effective_max_connections():
    for C, _ in SIDES:
        cfg = C.Config()
        assert cfg.effective_max_connections() == 512
        cfg.max_server_connections = 7
        assert cfg.effective_max_connections() == 7
