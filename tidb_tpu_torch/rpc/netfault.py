"""Network fault injection at the framed-RPC seam.

Port of `tidb_tpu/rpc/netfault.py`. Every coordination RPC byte in the
system crosses `rpc/frame.py`'s send_frame/recv_frame. This module gives
those two
functions a deterministic per-peer fault plane — delay, silent loss,
duplication, and partition — armed through the ordinary failpoint
registry so the kill-9 harnesses' env/process plumbing works unchanged
(reference: the message-filter layer TiKV's raftstore tests use —
`test_raftstore`'s `PartitionFilterFactory`/`DelayFilter` — collapsed
onto one socket seam).

Fault kinds (failpoint names) and their schedule values:

    net/delay       {"peer": "...", "dir": "...", "ms": 5}
                    sleep `ms` before the frame op (a slow link)
    net/drop        {"peer": "...", "dir": "...", "nth": 3}
                    every nth matching frame silently vanishes; a
                    dropped request surfaces as the client's request
                    timeout, a dropped response the same — retry
                    machinery must absorb both
    net/dup         {"peer": "...", "nth": 3}
                    every nth matching frame is sent twice (send-side
                    only) — drives request idempotency and the
                    client's stale-response request-id fencing
    net/partition   {"peer": "...", "side": "...", "dir": "..."}
                    matching frames raise ConnectionResetError — the
                    wire is cut; disable the failpoint to heal

A schedule is one rule dict or a list of rule dicts. Common fields:

    peer   substring matched against either endpoint address of the
           socket ("host:port" or a unix path); missing = all peers
    side   which endpoint must match `peer`: "peer" (the remote end —
           traffic other nodes aim at that address), "local" (sockets
           the named server owns), "any" (default). `side` + `dir`
           express ASYMMETRIC partitions: {"peer": A, "side": "peer",
           "dir": "send"} cuts frames other processes send TOWARD A
           while A's own sends still flow.
    dir    "send" | "recv" | "both" — which frame ops the rule
           applies to. Default "both" for delay/partition, "send" for
           drop/dup (both endpoints of a link often live in one
           process, and a "both" loss rule would drop the same frame
           twice, once per side)

Scalar schedule values (env arming, `TIDB_TPU_FAILPOINTS=net/delay=5`)
coerce: a number means {"ms": N} for delay and {"nth": N} for
drop/dup; `true` means one match-everything rule.

Determinism: no randomness anywhere — `nth` counts frames per
(kind, rule) under a lock, delays are fixed, partitions are
level-triggered until healed.

Zero-work contract: when no net/* failpoint is armed, the frame path
pays ONE module-attribute read (`ACTIVE`) per operation and nothing
else. `WORK` counts armed-path entries and is the poison pin the
hygiene test asserts stays flat during unarmed traffic. ACTIVE is
recomputed by a failpoint arming-change listener, never polled.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ..util import failpoint

KINDS = ("net/delay", "net/drop", "net/dup", "net/partition")

# the one flag the unarmed hot path reads; flipped only by _refresh()
ACTIVE = False
# armed-path entry counter — the zero-work poison pin
WORK = 0

_mu = threading.Lock()
_counts: dict[tuple, int] = {}


def _refresh() -> None:
    global ACTIVE
    armed = any(failpoint.is_enabled(k) for k in KINDS)
    if armed != ACTIVE:
        ACTIVE = armed
        if not armed:
            with _mu:
                _counts.clear()


failpoint.on_change(_refresh)
_refresh()  # env-armed net/* points predate this import


def reset() -> None:
    """Clear nth-counters and the WORK pin (test isolation)."""
    global WORK
    with _mu:
        _counts.clear()
        WORK = 0


# ---- arming helpers --------------------------------------------------------
def arm(kind: str, **rule: Any) -> None:
    """failpoint.enable('net/<kind>', rule) with appending semantics:
    arming the same kind again extends the schedule instead of
    replacing it, so a harness can partition two peers independently."""
    name = kind if kind.startswith("net/") else f"net/{kind}"
    if name not in KINDS:
        raise ValueError(f"unknown net fault kind {kind!r}")
    rules = _schedule(name) if failpoint.is_enabled(name) else []
    failpoint.enable(name, rules + [dict(rule)])


def heal(kind: Optional[str] = None) -> None:
    """Disable one net fault kind, or all of them."""
    if kind is None:
        for k in KINDS:
            failpoint.disable(k)
        return
    name = kind if kind.startswith("net/") else f"net/{kind}"
    failpoint.disable(name)


# ---- schedule evaluation ---------------------------------------------------
def _rules_of(value: Any) -> list[dict]:
    if value is None:
        return []
    if isinstance(value, dict):
        return [value]
    if isinstance(value, (list, tuple)):
        return [r for r in value if isinstance(r, dict)]
    if value is True:
        return [{}]
    if isinstance(value, (int, float)):
        return [{"ms": float(value), "nth": int(value) or 1}]
    return []


def _addr_label(addr: Any) -> str:
    if isinstance(addr, (tuple, list)) and len(addr) >= 2:
        return f"{addr[0]}:{addr[1]}"
    return str(addr or "")


def _labels(sock) -> tuple[str, str]:
    """(peer endpoint, local endpoint) of the socket, best-effort —
    a half-dead socket matches by whichever endpoint still resolves."""
    try:
        peer = _addr_label(sock.getpeername())
    except OSError:
        peer = ""
    try:
        local = _addr_label(sock.getsockname())
    except OSError:
        local = ""
    return peer, local


def _matches(rule: dict, peer: str, local: str, direction: str,
             default_dir: str = "both") -> bool:
    d = str(rule.get("dir", default_dir))
    if d != "both" and d != direction:
        return False
    pat = str(rule.get("peer", ""))
    if not pat:
        return True
    side = str(rule.get("side", "any"))
    if side == "peer":
        return pat in peer
    if side == "local":
        return pat in local
    return pat in peer or pat in local


def _nth_fires(kind: str, idx: int, nth: int) -> bool:
    if nth <= 1:
        return True
    with _mu:
        k = (kind, idx)
        n = _counts.get(k, 0) + 1
        _counts[k] = n
        return n % nth == 0


# one literal inject site per kind: the failpoint-registry rule maps
# DECLARED <-> inject sites textually, and these are the read points the
# frame hooks below evaluate on every armed operation
_INJECT = {
    "net/partition": lambda: failpoint.inject("net/partition"),
    "net/delay": lambda: failpoint.inject("net/delay"),
    "net/drop": lambda: failpoint.inject("net/drop"),
    "net/dup": lambda: failpoint.inject("net/dup"),
}


def _schedule(kind: str) -> list[dict]:
    try:
        return _rules_of(_INJECT[kind]())
    except Exception:
        # a non-schedule value (exception-armed by mistake) must not
        # corrupt the transport with an unexpected error type
        return []


def on_send(sock, nbytes: int) -> int:
    """Armed-path send hook. Returns how many copies of the frame to
    put on the wire: 1 = pass, 0 = net/drop, 2 = net/dup. Raises
    ConnectionResetError for a matching net/partition; sleeps for a
    matching net/delay."""
    global WORK
    WORK += 1
    peer, local = _labels(sock)
    for i, r in enumerate(_schedule("net/partition")):
        if _matches(r, peer, local, "send"):
            raise ConnectionResetError(
                f"net/partition: send to {peer or local} cut")
    for i, r in enumerate(_schedule("net/delay")):
        if _matches(r, peer, local, "send"):
            time.sleep(float(r.get("ms", 1.0)) / 1000.0)
    # drop/dup default to the send direction only: both endpoints of a
    # link often live in one process (the in-process chaos harness),
    # and a dir="both" loss rule would otherwise count — and drop —
    # the same frame twice, once per side of the wire
    for i, r in enumerate(_schedule("net/drop")):
        if _matches(r, peer, local, "send", "send") and \
                _nth_fires("net/drop", i, int(r.get("nth", 1))):
            return 0
    for i, r in enumerate(_schedule("net/dup")):
        if _matches(r, peer, local, "send", "send") and \
                _nth_fires("net/dup", i, int(r.get("nth", 1))):
            return 2
    return 1


def on_recv(sock, nbytes: int) -> bool:
    """Armed-path receive hook, called with one fully-read frame.
    Returns True to discard it (net/drop on the inbound path — the
    reader loops for the next frame). Raises for net/partition,
    sleeps for net/delay."""
    global WORK
    WORK += 1
    peer, local = _labels(sock)
    for i, r in enumerate(_schedule("net/partition")):
        if _matches(r, peer, local, "recv"):
            raise ConnectionResetError(
                f"net/partition: recv from {peer or local} cut")
    for i, r in enumerate(_schedule("net/delay")):
        if _matches(r, peer, local, "recv"):
            time.sleep(float(r.get("ms", 1.0)) / 1000.0)
    for i, r in enumerate(_schedule("net/drop")):
        if _matches(r, peer, local, "recv", "send") and \
                _nth_fires("net/drop", i, int(r.get("nth", 1))):
            return True
    return False


__all__ = ["KINDS", "ACTIVE", "WORK", "arm", "heal", "reset",
           "on_send", "on_recv"]
