"""Fault-injection registry: named points compiled into the runtime.

Port of `tidb_tpu/util/failpoint.py`. Call sites invoke `inject(name)`
unconditionally; a disabled point is one dict probe. An enabled point's
value drives behaviour at the site:

  * an Exception instance or class — raised (simulated failure),
  * a callable — invoked (custom behaviour: sleep, crash flag, counter),
  * anything else — returned to the call site for it to interpret.

Tests use the context manager so points never leak:

    with failpoint("ddl/before-step", CrashError()):
        ...

Cross-process arming: `TIDB_TPU_FAILPOINTS=name=value;name2=value2` is
parsed at import, so points arm inside child server processes. Values:

    exit(N)      os._exit(N) at the hit — the SIGKILL-grade crash
    sleep(S)     block S seconds at the hit
    raise        raise RuntimeError at the hit
    <number>     returned to the call site
    true/false   boolean toggle
    anything@K   fire only on the K-th hit (1-based), inert otherwise

The port wires the reference's sites in the planes it has:

    daemon/before-gc             store/daemon.py, the GC safepoint taken,
                                 no version dropped yet
    ddl/before-step              ddl/ddl.py, between two persisted job steps
    governor/mem-pressure        util/governor.py, a number there is the
                                 server's memory usage (the synthetic
                                 pressure that makes a governor kill
                                 deterministic)
    kv/group-fsync               kv/mvcc.py, a group's bytes written, not
                                 yet fsynced (the leader of the batch)
    kv/wal-torn-append           kv/mvcc.py, half a WAL record written
                                 (the pure-Python engine only)
    storage/mid-checkpoint       store/storage.py, after each epoch file
                                 a checkpoint persists
    storage/before-fold          store/storage.py, KV committed, the
                                 columnar fold not yet run
    twopc/before-prewrite        kv/twopc.py, the percolator phases
    twopc/after-prewrite
    twopc/before-commit-primary
    twopc/after-primary-commit

The sites of planes not yet ported (rpc, net, diag, range, replica,
mesh) wait with them, and so does the reference's declared-site registry
(read by its static analysis). Armed points and their hit counts are
listed on the status port at /debug/failpoints (`snapshot()`).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Iterator, Optional

_lock = threading.Lock()
_active: dict[str, Any] = {}
_hits: dict[str, int] = {}


def enable(name: str, value: Any = True) -> None:
    with _lock:
        _active[name] = value


def disable(name: str) -> None:
    with _lock:
        _active.pop(name, None)


def disable_all() -> None:
    with _lock:
        _active.clear()
        _hits.clear()


def is_enabled(name: str) -> bool:
    with _lock:
        return name in _active


def hits(name: str) -> int:
    with _lock:
        return _hits.get(name, 0)


def snapshot() -> dict[str, dict]:
    """Armed points + lifetime hit counts (for /debug/failpoints).
    Points hit after being disarmed keep their counts until
    disable_all(), so a chaos run can still read what fired."""
    with _lock:
        out: dict[str, dict] = {}
        for name in set(_active) | set(_hits):
            out[name] = {
                "armed": name in _active,
                "value": repr(_active.get(name)),
                "hits": _hits.get(name, 0),
            }
        return out


def inject(name: str) -> Optional[Any]:
    """The call-site hook. Returns None when the point is disabled;
    otherwise raises/calls/returns per the enabled value."""
    with _lock:
        if name not in _active:
            return None
        value = _active[name]
        _hits[name] = _hits.get(name, 0) + 1
    if isinstance(value, BaseException):
        raise value
    if isinstance(value, type) and issubclass(value, BaseException):
        raise value(f"failpoint {name}")
    if callable(value):
        return value()
    return value


@contextmanager
def failpoint(name: str, value: Any = True) -> Iterator[None]:
    enable(name, value)
    try:
        yield
    finally:
        disable(name)


# ---- env-var arming (child processes) --------------------------------------
def _parse_action(spec: str) -> Any:
    spec = spec.strip()
    if spec.startswith("exit(") and spec.endswith(")"):
        code = int(spec[5:-1] or 1)
        return lambda: os._exit(code)
    if spec.startswith("sleep(") and spec.endswith(")"):
        secs = float(spec[6:-1] or 0)
        import time as _time
        return lambda: _time.sleep(secs)
    if spec == "raise":
        def _raise():
            raise RuntimeError("failpoint (env-armed)")
        return _raise
    if spec in ("true", "false"):
        return spec == "true"
    try:
        return int(spec)
    except ValueError:
        pass
    try:
        return float(spec)
    except ValueError:
        return spec


def _nth_hit(action: Any, k: int) -> Any:
    """Fire `action` only on the k-th evaluation (1-based): earlier traffic
    through the same site must not eat a crash aimed at the workload.
    Inert evaluations return None (call sites treat that as disabled)."""
    state = {"n": 0}

    def fire():
        state["n"] += 1
        if state["n"] != k:
            return None
        if isinstance(action, BaseException) or (
                isinstance(action, type)
                and issubclass(action, BaseException)):
            raise action
        return action() if callable(action) else action

    return fire


def arm_from_env(spec: Optional[str] = None) -> list[str]:
    """Parse `name=value;...` (TIDB_TPU_FAILPOINTS by default) and
    enable each point; returns the armed names."""
    if spec is None:
        spec = os.environ.get("TIDB_TPU_FAILPOINTS", "")
    armed = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, raw = part.partition("=")
        raw = raw.strip()
        if "@" in raw:
            raw, _, nth = raw.rpartition("@")
            value: Any = _nth_hit(_parse_action(raw), int(nth))
        else:
            value = _parse_action(raw)
        enable(name.strip(), value)
        armed.append(name.strip())
    return armed


arm_from_env()


__all__ = ["enable", "disable", "disable_all", "is_enabled", "inject",
           "hits", "snapshot", "failpoint", "arm_from_env"]
