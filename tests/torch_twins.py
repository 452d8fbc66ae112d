"""Run a reference test module's cases on both packages side by side.

`load(name)` executes `tests/<name>` twice: once as written (the
reference, `tidb_tpu`), once with every `tidb_tpu` import rewritten to
`tidb_tpu_torch` (the port), where `Storage` and `Session` default to
`device="cpu"` (`PortStorage`, `PortSession`). `twin(ref, port, name)`
builds one pytest function that runs the case on the reference, then on
the port, each in its own directory, and holds the port to the
reference twice over:

* every assertion of the reference's case holds on the port (the same
  body runs against it);
* the outcomes of the two runs are equal: the class and message of every
  error a `pytest.raises` caught, the range tables on disk (ids, bounds,
  epochs) and the fencing terms, the hosted ranges each `describe()`
  reported (ids, terms, epochs, bounds, heat columns), the rows of every
  `tidb_hot_ranges` read (`RangeHeatRecorder.table_rows`), the rules,
  items and severities of the range and heat findings, the kinds of the
  events recorded, and the change of the process-wide range counters.

Messages are compared with addresses, the run's directory, timestamps
(integers of ten digits or more) and a backoff's spent time and retry
counts masked; owners (addresses
with a random port) and wall-clock columns are left out. The twin keeps
the reference case's marks (parametrize, slow) and fixtures: `tmp_path`
is a directory per run, `monkeypatch` a fresh one per run, and a fixture
defined in the reference module is called on each side's own module.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import os
import re
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))

_PORT_PKG = "tidb_tpu_torch"


@functools.lru_cache(maxsize=None)
def _port_storage_cls():
    from tidb_tpu_torch.store.storage import Storage

    class PortStorage(Storage):
        def __init__(self, *args, device="cpu", **kw):
            super().__init__(*args, device=device, **kw)

    return PortStorage


@functools.lru_cache(maxsize=None)
def _port_session_cls():
    from tidb_tpu_torch.session import Session

    class PortSession(Session):
        def __init__(self, *args, device="cpu", **kw):
            super().__init__(*args, device=device, **kw)

    return PortSession


def __getattr__(name):
    # lazy: importing this helper must not import either package
    if name == "PortStorage":
        return _port_storage_cls()
    if name == "PortSession":
        return _port_session_cls()
    raise AttributeError(name)


def port_source(src: str) -> str:
    """The reference test's source with its imports moved to the port."""
    src = re.sub(r"from tidb_tpu\.store\.storage import Storage\b",
                 "from torch_twins import PortStorage as Storage", src)
    src = re.sub(r"from tidb_tpu\.session import Session\b",
                 "from torch_twins import PortSession as Session", src)
    return re.sub(r"\btidb_tpu\b(?!_torch)", _PORT_PKG, src)


def _exec(src: str, path: str, modname: str) -> types.ModuleType:
    mod = types.ModuleType(modname)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102
    return mod


def load(name: str) -> tuple[types.ModuleType, types.ModuleType]:
    path = os.path.join(TESTS, name)
    with open(path) as f:
        src = f.read()
    stem = name[:-3]
    return (_exec(src, path, f"_twin_ref_{stem}"),
            _exec(port_source(src), path, f"_twin_port_{stem}"))


# ---- outcome capture ---------------------------------------------------------

_MASKS = (
    (re.compile(r"\d{1,3}(?:\.\d{1,3}){3}:\d+"), "<addr>"),
    (re.compile(r"\b\d{10,}\b"), "<ts>"),
    # a backoff's spent time and retry counts are the host's timing
    (re.compile(r"after \d+ms"), "after <n>ms"),
    (re.compile(r"([A-Za-z])x\d+\b"), r"\1x<n>"),
)

_RANGE_RULES = frozenset({"hot-range", "range-split-advisory",
                          "range-leader-flap", "range-split-flap",
                          "range-closed-ts-stall"})

_PROCESS_FAMILIES = ("RANGE_LEADERS", "RANGE_TRANSFERS",
                     "RANGE_ORPHAN_RESOLUTIONS", "RANGE_SPLITS")


class _Run:
    """What one side's run of a case produced."""

    def __init__(self, side: str, root: str) -> None:
        self.side = side
        self.root = root
        self.raised: list = []
        self.events: set = set()
        self.describe: list = []
        self.hot_rows: list = []
        self.findings: list = []

    def mask(self, text: str) -> str:
        text = str(text).replace(self.root, "<dir>")
        for rx, sub in _MASKS:
            text = rx.sub(sub, text)
        return text


def _metric_state(pkg) -> dict:
    obs = pkg.obs
    out = {}
    for fam in _PROCESS_FAMILIES:
        m = getattr(obs, fam)
        for key, v in m.samples():
            out[(fam, key)] = v
    return out


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for k in set(before) | set(after):
        d = after.get(k, 0.0) - before.get(k, 0.0)
        if d:
            out[k] = d
    return out


def _disk_state(root: str) -> dict:
    """Range tables and fencing terms under a run's directory."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if os.path.basename(dirpath) == "ranges" and "meta.json" in files:
            try:
                with open(os.path.join(dirpath, "meta.json")) as f:
                    out[rel + "/meta.json"] = json.load(f)
            except (OSError, ValueError):
                out[rel + "/meta.json"] = "unreadable"
        if re.fullmatch(r"r\d+", os.path.basename(dirpath)) \
                and "term" in files:
            with open(os.path.join(dirpath, "term"), "rb") as f:
                out[rel + "/term"] = f.read().strip()
    return out


class _RaisesShim:
    """`pytest` for a case's body: `raises` records what it caught."""

    def __init__(self, run: _Run) -> None:
        self._run = run

    def __getattr__(self, name):
        return getattr(pytest, name)

    def raises(self, *args, **kw):
        if len(args) > 1:  # the call form
            with self.raises(args[0], **kw) as info:
                args[1](*args[2:])
            return info
        return _RecordingRaises(self._run, pytest.raises(*args, **kw))


class _RecordingRaises:
    def __init__(self, run: _Run, cm) -> None:
        self._run = run
        self._cm = cm

    def __enter__(self):
        self._info = self._cm.__enter__()
        return self._info

    def __exit__(self, *exc):
        out = self._cm.__exit__(*exc)
        if self._info is not None and getattr(self._info, "_excinfo",
                                              None) is not None:
            e = self._info.value
            self._run.raised.append((type(e).__name__,
                                     self._run.mask(str(e))))
        return out


@contextlib.contextmanager
def _capture(pkg, run: _Run):
    """Record the outcomes of one run on one package."""
    import importlib
    obs = pkg.obs
    ranged = importlib.import_module(pkg.__name__ + ".rpc.ranged")
    heat = importlib.import_module(pkg.__name__ + ".obs_heat")
    insp = importlib.import_module(pkg.__name__ + ".obs_inspect")
    saved = []

    def wrap(owner, attr, after):
        orig = getattr(owner, attr)
        saved.append((owner, attr, orig))

        @functools.wraps(orig)
        def wrapper(*a, **kw):
            out = orig(*a, **kw)
            after(a, kw, out)
            return out
        setattr(owner, attr, wrapper)

    def on_event(a, kw, _out):
        kind = kw.get("kind", a[1] if len(a) > 1 else None)
        run.events.add(str(kind))

    def on_describe(_a, _kw, out):
        run.describe.append([
            (d["range_id"], d["term"], d["epoch"], d["start"], d["end"],
             d["read_rows"], d["read_bytes"], d["write_rows"],
             d["write_bytes"]) for d in out])

    def on_table_rows(_a, _kw, out):
        run.hot_rows.append([list(r) for r in out])

    def on_inspect(_a, _kw, out):
        run.findings.append(sorted(
            (f.rule, f.item, f.severity) for f in out
            if f.rule in _RANGE_RULES))

    wrap(obs.EventLog, "record", on_event)
    wrap(ranged.RangeServer, "describe", on_describe)
    wrap(heat.RangeHeatRecorder, "table_rows", on_table_rows)
    wrap(insp, "inspect", on_inspect)
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


# ---- fixtures of the reference module ----------------------------------------

def _fixture_fn(mod, name: str):
    fx = getattr(mod, name, None)
    get = getattr(fx, "_get_wrapped_function", None)
    return get() if get is not None else None


def _autouse(mod) -> list:
    out = []
    for name, fx in vars(mod).items():
        marker = getattr(fx, "_fixture_function_marker", None)
        if marker is not None and marker.autouse:
            out.append(name)
    return out


class _Fixtures:
    """Resolve a case's fixtures for one side: builtins per run, the
    module's own fixtures called on that module."""

    def __init__(self, mod, root: str, passed: dict) -> None:
        self.mod = mod
        self.root = root
        self.passed = passed
        self.values: dict = {}
        self.teardowns: list = []
        self.mp = pytest.MonkeyPatch()

    def get(self, name: str):
        if name in self.values:
            return self.values[name]
        if name in self.passed:
            v = self.passed[name]
        elif name in ("tmp_path", "tmpdir"):
            import pathlib
            os.makedirs(self.root, exist_ok=True)
            v = pathlib.Path(self.root)
        elif name == "monkeypatch":
            v = self.mp
        else:
            fn = _fixture_fn(self.mod, name)
            if fn is None:
                raise LookupError(f"fixture {name!r} not available")
            kw = {p: self.get(p) for p in inspect.signature(fn).parameters}
            v = fn(**kw)
            if inspect.isgenerator(v):
                gen = v
                v = next(gen)
                self.teardowns.append(gen)
        self.values[name] = v
        return v

    def close(self) -> None:
        errors = []
        for gen in reversed(self.teardowns):
            try:
                next(gen)
            except StopIteration:
                pass
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
        self.mp.undo()
        if errors:
            raise errors[0]


def run_side(mod, pkg, name: str, root: str, passed: dict) -> _Run:
    """One side's run of a case: its autouse fixtures around it, the
    outcomes captured."""
    fn = getattr(mod, name)
    run = _Run(mod.__name__, root)
    fx = _Fixtures(mod, root, passed)
    before = _metric_state(pkg)
    saved_pytest = mod.__dict__.get("pytest")
    mod.pytest = _RaisesShim(run)
    try:
        with _capture(pkg, run):
            for auto in _autouse(mod):
                fx.get(auto)
            kw = {p: fx.get(p) for p in inspect.signature(fn).parameters}
            try:
                fn(**kw)
            finally:
                fx.close()
    finally:
        mod.pytest = saved_pytest
    run.metrics = _delta(before, _metric_state(pkg))
    run.disk = _disk_state(root)
    return run


def _without_bounds(disk: dict) -> dict:
    """The range tables with their bounds left out (ids and epochs
    kept): where the reference's own case splits at a key that depends
    on how many writes landed before a lease tick."""
    out = {}
    for k, v in disk.items():
        if isinstance(v, dict) and "ranges" in v:
            v = sorted((r["id"], r["epoch"]) for r in v["ranges"])
        out[k] = v
    return out


def outcome(run: _Run, bounds: bool = True) -> dict:
    disk = run.disk if bounds else _without_bounds(run.disk)
    return {"raised": run.raised, "events": sorted(run.events),
            "describe": run.describe, "hot_rows": run.hot_rows,
            "findings": run.findings,
            "metrics": sorted((f, repr(k), v)
                              for (f, k), v in run.metrics.items()),
            "disk": disk}


def _param_names(fn) -> list:
    names = []
    for m in getattr(fn, "pytestmark", []):
        if m.name == "parametrize":
            arg = m.args[0]
            names += [a.strip() for a in arg.split(",")] \
                if isinstance(arg, str) else list(arg)
    return names


def twin(ref_mod, port_mod, name: str, exclude: tuple = (),
         bounds: bool = True, timed_events: tuple = ()):
    """A pytest case running `name` on both packages; `exclude` names
    outcome keys left out of the comparison ("disk.terms": the fencing
    terms on disk), `bounds=False` leaves the
    range tables' bounds out and `timed_events` event kinds whose firing
    depends on the host's timing (each with the reason at the call
    site)."""
    import tidb_tpu
    import tidb_tpu_torch
    ref_fn = getattr(ref_mod, name)
    params = _param_names(ref_fn)

    def case(tmp_path, **passed):
        ref = run_side(ref_mod, tidb_tpu, name, str(tmp_path / "ref"),
                       passed)
        port = run_side(port_mod, tidb_tpu_torch, name,
                        str(tmp_path / "port"), passed)
        want, got = outcome(ref, bounds), outcome(port, bounds)
        for o in (want, got):
            o["events"] = [k for k in o["events"] if k not in timed_events]
        for k in exclude:
            for o in (want, got):
                if k == "disk.terms":
                    o["disk"] = {p: v for p, v in o["disk"].items()
                                 if not p.endswith("/term")}
                else:
                    o.pop(k, None)
        for k in want:
            assert got[k] == want[k], k

    sig = [inspect.Parameter("tmp_path",
                             inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    sig += [inspect.Parameter(p, inspect.Parameter.KEYWORD_ONLY)
            for p in params]
    case.__signature__ = inspect.Signature(sig)
    case.__name__ = name
    case.__qualname__ = name
    case.__doc__ = ref_fn.__doc__
    marks = list(getattr(ref_fn, "pytestmark", []))
    if marks:
        case.pytestmark = marks
    return case


def cases(ref_mod) -> list:
    """The reference module's test functions, in definition order."""
    return [n for n, v in vars(ref_mod).items()
            if n.startswith("test_") and callable(v)]


__all__ = ["load", "twin", "cases", "port_source", "run_side", "outcome"]
