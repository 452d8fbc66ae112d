"""Dynamic lock-order checker: instrumented locks + a global lock graph.

The runtime half of the concurrency analysis plane (the static half
lives in analysis/rules.py). Counterpart of the discipline the
reference gets from `go test -race` and TiKV's deadlock detector: every
concurrent subsystem creates its long-lived locks through `lock()` /
`rlock()` below, and an OPT-IN wrapper records, per thread, the set of
held locks and folds every (held -> acquired) pair into one
process-wide lock-order graph. A cycle in that graph is a potential
deadlock (two code paths acquire the same locks in opposite orders —
the bug class a deadlock post-mortem finds too late); a blocking
syscall reported by `note_blocking()` while a HOT lock is held is the
fsync-under-store-mutex class that once serialized every writer of the
native engine (csrc/kvstore.cpp) behind the disk barrier.

Zero overhead when off — the same contract as Top SQL: with
TIDB_TPU_LOCK_CHECK unset, `lock()`/`rlock()` return PLAIN
threading.Lock/RLock objects (not wrappers), so the production hot
path pays nothing, not even an attribute hop. `note_blocking()` is one
module-global bool probe. Enabled (env var at process start, or
`enable()` in tests, or the [analysis] lock-check knob), every acquire
costs a thread-local list walk + one dict update under the graph lock.

Findings surface three ways: `findings()` (typed dicts, consumed by
tests and the inspection plane), the `lock-order-inversion` inspection
rule (information_schema.inspection_result), and /debug/lockgraph.
The port's test guard (tests/test_torch_analysis.py) calls
`held_snapshot()` after each of its tests and fails one that ends with
an instrumented lock still held.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Optional, Union

ENV_VAR = "TIDB_TPU_LOCK_CHECK"

# module-global fast path: note_blocking() and the lock factories probe
# this one bool; flipping it affects locks created AFTERWARDS only
# (already-created plain locks stay plain — tests enable() first, then
# build the storage under test)
_enabled = os.environ.get(ENV_VAR, "") not in ("", "0", "false", "off")

_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


class _Graph:
    """The process-wide lock-order graph. Nodes are lock names; a
    directed edge a->b means some thread acquired b while holding a.
    Bounded: one sample stack per edge, edges capped so a pathological
    run cannot grow without bound."""

    EDGE_CAP = 4096
    BLOCKING_CAP = 256

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # (held, acquired) -> {"count": n, "stack": str}
        self.edges: dict[tuple, dict] = {}
        # blocking syscalls observed under a hot lock
        self.blocking: list[dict] = []
        # name -> hot flag (every instrumented lock registers here)
        self.locks: dict[str, bool] = {}

    def register(self, name: str, hot: bool) -> None:
        with self._mu:
            self.locks[name] = bool(hot) or self.locks.get(name, False)

    def add_edge(self, held: str, acquired: str) -> None:
        key = (held, acquired)
        with self._mu:
            e = self.edges.get(key)
            if e is not None:
                e["count"] += 1
                return
            if len(self.edges) >= self.EDGE_CAP:
                return
            stack = "".join(traceback.format_stack(limit=8)[:-2])
            self.edges[key] = {"count": 1, "stack": stack[-2000:]}

    def add_blocking(self, kind: str, lock_name: str,
                     detail: str) -> None:
        with self._mu:
            # dedup by (kind, lock, detail): a hot loop hitting the
            # same bad site must not flood the ring
            for b in self.blocking:
                if b["kind"] == kind and b["lock"] == lock_name \
                        and b["detail"] == detail:
                    b["count"] += 1
                    return
            if len(self.blocking) >= self.BLOCKING_CAP:
                return
            stack = "".join(traceback.format_stack(limit=8)[:-2])
            self.blocking.append({
                "kind": kind, "lock": lock_name, "detail": detail,
                "count": 1, "stack": stack[-2000:]})

    def snapshot(self) -> tuple[dict, list, dict]:
        with self._mu:
            return ({k: dict(v) for k, v in self.edges.items()},
                    [dict(b) for b in self.blocking],
                    dict(self.locks))

    def clear(self) -> None:
        with self._mu:
            self.edges.clear()
            self.blocking.clear()


GRAPH = _Graph()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Arm the checker (tests; the [analysis] lock-check knob at server
    start). Only locks created AFTER this call are instrumented."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop recorded edges/blocking events AND the held mirror (test
    isolation). The mirror must clear here too: a thread that died
    holding a lock can never self-clear its entry, and a stale entry
    would fail every later test's leak guard. Live holders re-sync
    their entry on their next acquire/release."""
    GRAPH.clear()
    with _holders_mu:
        _holders.clear()


class _CheckedLock:
    """Instrumented Lock/RLock. Records (held -> this) edges on every
    non-reentrant acquire and keeps the thread's held list current.
    Reentrant RLock acquires neither re-record nor re-push."""

    __slots__ = ("name", "hot", "_inner", "_reentrant")

    def __init__(self, name: str, hot: bool, reentrant: bool) -> None:
        self.name = name
        self.hot = hot
        self._reentrant = reentrant
        self._inner = (threading.RLock() if reentrant
                       else threading.Lock())
        GRAPH.register(name, hot)

    def _entry(self) -> Optional[dict]:
        for e in _held():
            if e["lock"] is self:
                return e
        return None

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        held = _held()
        ent = self._entry() if self._reentrant else None
        if ent is None:
            # record intent-order edges BEFORE blocking: the edge
            # exists even if this acquire never succeeds (that is the
            # deadlocked interleaving the graph is for)
            for e in held:
                if e["lock"] is not self:
                    GRAPH.add_edge(e["lock"].name, self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if ent is not None:
                ent["depth"] += 1
            else:
                held.append({"lock": self, "depth": 1})
                _mirror_sync()
        return ok

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i]["lock"] is self:
                held[i]["depth"] -= 1
                if held[i]["depth"] <= 0:
                    del held[i]
                    _mirror_sync()
                break
        self._inner.release()

    def locked(self) -> bool:
        if self._reentrant:
            raise AttributeError("RLock has no locked()")
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "rlock" if self._reentrant else "lock"
        return f"<checked-{kind} {self.name} hot={self.hot}>"


LockLike = Union[threading.Lock, threading.RLock, _CheckedLock]


def lock(name: str, hot: bool = False):
    """A mutex for long-lived subsystem state. Disabled (the default):
    a PLAIN threading.Lock — zero added cost. Enabled: a _CheckedLock
    feeding the lock-order graph. `hot` marks locks on the declared
    hot list (analysis/registry.py HOT_LOCKS): blocking syscalls while
    one is held become findings."""
    if not _enabled:
        return threading.Lock()
    return _CheckedLock(name, hot, reentrant=False)


def rlock(name: str, hot: bool = False):
    if not _enabled:
        return threading.RLock()
    return _CheckedLock(name, hot, reentrant=True)


def note_blocking(kind: str, detail: str = "") -> None:
    """Report a blocking syscall (fsync, sleep, socket send, RPC) from
    the call site about to perform it. One bool probe when disabled.
    A finding is recorded only when the calling thread holds a HOT
    instrumented lock at that moment."""
    if not _enabled:
        return
    for e in _held():
        lk = e["lock"]
        if lk.hot:
            GRAPH.add_blocking(kind, lk.name, detail)


# held-lock mirror (held_snapshot cannot reach other threads' TLS, so
# acquire/release keep this registry current). Keyed by thread IDENT —
# two servers in one process spawn same-NAMED workers (titpu-conn-
# worker-1 each), and a name key would let one thread's release erase
# the other's live record; the name rides along for display only.
_holders_mu = threading.Lock()
_holders: dict[int, tuple[str, list[str]]] = {}


def held_snapshot() -> dict[str, list[str]]:
    """Instrumented locks currently held, keyed 'name#ident' — the
    test leak guard fails any test that ends with a non-empty
    snapshot (an instrumented lock still held after teardown is a
    leak, exactly like an orphaned child process)."""
    with _holders_mu:
        return {f"{name}#{tid}": list(names)
                for tid, (name, names) in _holders.items() if names}


def _mirror_sync() -> None:
    names = [e["lock"].name for e in _held()]
    t = threading.current_thread()
    with _holders_mu:
        if names:
            _holders[t.ident] = (t.name, names)
        else:
            _holders.pop(t.ident, None)


def elementary_cycles(edge_pairs) -> list[list[str]]:
    """Elementary cycles over directed (a, b) edge pairs (bounded
    DFS, deduped by canonical rotation). Each cycle is a name list
    [a, b, ..., a]. THE one cycle finder — the dynamic graph below
    and the static lock-order rule (analysis/rules.py) both use it,
    so their dedup/bounds semantics can never drift apart."""
    adj: dict[str, set] = {}
    for (a, b) in edge_pairs:
        adj.setdefault(a, set()).add(b)
    cycles: list[list[str]] = []
    seen_keys: set = set()

    def dfs(start: str, node: str, path: list[str],
            on_path: set) -> None:
        if len(cycles) >= 32 or len(path) > 8:
            return
        for nxt in sorted(adj.get(node, ())):
            if nxt == start:
                cyc = path + [start]
                # canonical rotation so each cycle reports once
                k = min(range(len(cyc) - 1),
                        key=lambda i: cyc[i])
                key = tuple(cyc[k:-1] + cyc[:k])
                if key not in seen_keys:
                    seen_keys.add(key)
                    rot = list(key) + [key[0]]
                    cycles.append(rot)
            elif nxt not in on_path and nxt > start:
                # only expand nodes > start: each cycle found from its
                # smallest node exactly once
                on_path.add(nxt)
                dfs(start, nxt, path + [nxt], on_path)
                on_path.discard(nxt)

    for n in sorted(adj):
        dfs(n, n, [n], {n})
    return cycles


def find_cycles() -> list[list[str]]:
    """Elementary cycles in the LIVE lock-order graph: some thread
    took b under a while another path takes a under b — a potential
    deadlock."""
    edges, _, _ = GRAPH.snapshot()
    return elementary_cycles(edges)


def findings() -> list[dict]:
    """Typed findings: lock-order cycles (potential deadlock) and
    blocking syscalls observed under a hot lock."""
    out: list[dict] = []
    edges, blocking, _ = GRAPH.snapshot()
    for cyc in find_cycles():
        sample = ""
        for i in range(len(cyc) - 1):
            e = edges.get((cyc[i], cyc[i + 1]))
            if e is not None:
                sample = e["stack"]
                break
        out.append({"kind": "lock-order-inversion",
                    "cycle": cyc,
                    "item": " -> ".join(cyc),
                    "stack": sample})
    for b in blocking:
        out.append({"kind": "blocking-under-hot-lock",
                    "item": f"{b['kind']} under {b['lock']}",
                    "count": b["count"],
                    "detail": b["detail"],
                    "stack": b["stack"]})
    return out


def debug_payload() -> dict:
    """/debug/lockgraph: enabled flag, registered locks, edges with
    counts, cycles, blocking events, currently-held mirror."""
    edges, blocking, locks = GRAPH.snapshot()
    return {
        "enabled": _enabled,
        "locks": [{"name": n, "hot": h}
                  for n, h in sorted(locks.items())],
        "edges": [{"held": a, "acquired": b, "count": e["count"]}
                  for (a, b), e in sorted(edges.items())],
        "cycles": [" -> ".join(c) for c in find_cycles()],
        "blocking": [{k: v for k, v in b.items() if k != "stack"}
                     for b in blocking],
        "held": held_snapshot(),
    }


__all__ = ["ENV_VAR", "enabled", "enable", "disable", "reset", "lock",
           "rlock", "note_blocking", "held_snapshot",
           "find_cycles", "findings", "debug_payload", "GRAPH"]
