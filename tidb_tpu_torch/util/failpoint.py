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
    net/delay, net/drop,         rpc/netfault.py, the per-peer schedules
    net/dup, net/partition       of the network fault plane, read by
                                 the frame hooks of rpc/frame.py
    range/before-prewrite-ack    rpc/ranged.py, a prewrite applied, its
                                 ack not sent (a leader-kill site)
    range/before-commit-ack      rpc/ranged.py, a commit applied, its ack
                                 not sent
    range/lease-drop             rpc/ranged.py, a forced lease release
                                 (value: a range id, or true for all)
    range/auto-split             rpc/ranged.py, the actuator about to run
                                 an advised split
    range/split-before-meta-commit   the split journal written, the
                                     range table not yet
    range/split-after-meta-commit    the table committed, the child empty
    range/split-mid-wal-partition    the child's WAL half written
    range/split-before-parent-retire the child ready, the parent whole
    storage/mid-checkpoint       store/storage.py, after each epoch file
                                 a checkpoint persists
    storage/before-fold          store/storage.py, KV committed, the
                                 columnar fold not yet run
    twopc/before-prewrite        kv/twopc.py, the percolator phases
    twopc/after-prewrite
    twopc/before-commit-primary
    twopc/after-primary-commit

and the rpc, diag and replica sites of the socket tier (`rpc/client.py`,
`rpc/diag.py`, `rpc/apply.py`). The site of the plane not yet ported
(mesh) waits with it; `DECLARED` lists every site the port has.
Arming-change listeners (`on_change`) run after every enable or disable: the network fault plane
keeps its one hot-path flag with them. Armed points and their hit counts are
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

# Arming-change listeners (rpc/netfault.py): called OUTSIDE _lock after
# any enable/disable so hot paths can cache "is anything armed" in a
# plain module flag instead of taking _lock per operation.
_listeners: list = []


def on_change(cb) -> None:
    with _lock:
        if cb not in _listeners:
            _listeners.append(cb)


def _notify() -> None:
    for cb in list(_listeners):
        cb()


# The declared registry: every inject() site in tidb_tpu_torch/ names one
# of these, and every name a test arms (context manager, enable(), or a
# TIDB_TPU_FAILPOINTS env spec) must exist here — an armed point whose
# inject() site was renamed away silently never fires. The reference's
# mesh site (mesh/skew) waits with its plane (ROADMAP queue 1 item 8).
# The failpoint-registry rule (analysis/rules.py) checks both
# directions.
DECLARED = frozenset({
    "daemon/before-gc",            # store/daemon.py GC tick
    "ddl/before-step",             # ddl/ddl.py job-step boundary
    "diag/peer-down",              # rpc/diag.py fan-out peer failure
    "diag/slow-peer",              # rpc/diag.py fan-out latency
    "governor/mem-pressure",       # util/governor.py synthetic RSS
    "kv/group-fsync",              # kv/mvcc.py pre-fsync crash site
    "kv/wal-torn-append",          # kv/mvcc.py torn WAL record
    "net/delay",                   # rpc/netfault.py per-peer frame
                                   # delay schedule
    "net/drop",                    # rpc/netfault.py silent frame loss
    "net/dup",                     # rpc/netfault.py frame duplication
    "net/partition",               # rpc/netfault.py sym/asym partition
    "range/before-commit-ack",     # rpc/ranged.py commit applied,
                                   # ack not sent (leader-kill site)
    "range/before-prewrite-ack",   # rpc/ranged.py prewrite applied,
                                   # ack not sent (leader-kill site)
    "range/lease-drop",            # rpc/ranged.py forced lease release
                                   # (value: range id, or true = all)
    "range/auto-split",            # rpc/ranged.py actuator about to
                                   # execute an advised split
    "range/split-before-meta-commit",   # journal written, table not
    "range/split-after-meta-commit",    # table committed, child empty
    "range/split-mid-wal-partition",    # child WAL half-written
    "range/split-before-parent-retire", # child ready, parent whole
    "replica/apply-stall",         # rpc/apply.py frozen apply loop
    "rpc/conn-drop",               # rpc/client.py transport chaos
    "rpc/delay",
    "rpc/partial-write",
    "rpc/stale-response",
    "storage/before-fold",         # store/storage.py commit fold
    "storage/mid-checkpoint",      # store/storage.py checkpoint crash
    "twopc/after-prewrite",        # kv/twopc.py percolator phases
    "twopc/after-primary-commit",
    "twopc/before-commit-primary",
    "twopc/before-prewrite",
})


def enable(name: str, value: Any = True) -> None:
    with _lock:
        _active[name] = value
    _notify()


def disable(name: str) -> None:
    with _lock:
        _active.pop(name, None)
    _notify()


def disable_all() -> None:
    with _lock:
        _active.clear()
        _hits.clear()
    _notify()


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


__all__ = ["DECLARED", "enable", "disable", "disable_all", "is_enabled",
           "inject", "hits", "snapshot", "failpoint", "arm_from_env",
           "on_change"]
