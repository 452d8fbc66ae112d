"""Typed retry backoff (reference: store/tikv/backoff.go).

The reference classifies every retryable condition (BoTxnLock,
BoRegionMiss, boTiKVRPC, ...) with its own base/cap growth and a total
budget per request, and surfaces exhaustion with the accumulated retry
types. The engine's retry sites (pessimistic lock waits, write-conflict
rescans, meta-key retries) use the same structure: a Backoffer carries a
millisecond budget, each sleep is typed, grows exponentially with
equal-jitter, and exhaustion raises with the full retry history so an
operator sees WHY a statement burned its budget instead of a bare
"retries exhausted".

Port of `tidb_tpu/kv/backoff.py`: each sleep reports to the backoff
families (`tidb_backoff_seconds`, `tidb_backoff_events_total`) and, as
`wait_state` or `backoff.<kind>`, to the statement's wait ledger.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from .. import obs
from ..errno import ER_TIKV_SERVER_TIMEOUT, CodedError


@dataclass(frozen=True)
class BackoffKind:
    name: str
    base_ms: int
    cap_ms: int


# the taxonomy (reference: backoff.go NewBackoffFn call sites)
BO_TXN_LOCK = BackoffKind("txnLock", 2, 200)          # foreign lock wait
BO_TXN_CONFLICT = BackoffKind("txnConflict", 2, 100)  # write conflict rescan
BO_REGION_MISS = BackoffKind("regionMiss", 2, 40)     # region map stale
BO_META = BackoffKind("metaConflict", 2, 100)         # meta-key CAS retry
BO_MAX_TS = BackoffKind("tsoWait", 1, 20)             # TSO window refill
BO_RPC = BackoffKind("tikvRPC", 10, 400)              # transport retry



class BackoffExhausted(CodedError):
    errno = ER_TIKV_SERVER_TIMEOUT
    sqlstate = "HY000"


@dataclass
class Backoffer:
    """Per-request retry budget (reference: backoff.go Backoffer).

    sleep(kind) blocks for the kind's current backoff (exponential with
    equal-jitter, capped) and charges the shared budget; once spent,
    BackoffExhausted carries the typed history."""

    budget_ms: int
    total_ms: float = 0.0
    attempts: dict = field(default_factory=dict)

    def sleep(self, kind: BackoffKind, wait_state: str = "") -> None:
        n = self.attempts.get(kind.name, 0)
        self.attempts[kind.name] = n + 1
        raw = min(kind.base_ms * (2 ** n), kind.cap_ms)
        ms = raw / 2 + random.uniform(0, raw / 2)  # equal jitter
        if self.total_ms + ms > self.budget_ms:
            hist = ", ".join(f"{k}x{v}"
                             for k, v in sorted(self.attempts.items()))
            raise BackoffExhausted(
                f"backoff budget exhausted after {self.total_ms:.0f}ms "
                f"(budget {self.budget_ms}ms): {hist}")
        self.total_ms += ms
        time.sleep(ms / 1000.0)
        sec = ms / 1000.0
        obs.BACKOFF_SECONDS.observe(sec, kind=kind.name)
        obs.BACKOFF_EVENTS.inc(kind=kind.name)
        obs.note_wait(wait_state or f"backoff.{kind.name}", sec)

    def charge(self, kind: BackoffKind, waited_s: float) -> None:
        """Account an externally-performed wait (e.g. a condition-var
        lock wait) against the budget without sleeping again."""
        self.attempts[kind.name] = self.attempts.get(kind.name, 0) + 1
        self.total_ms += waited_s * 1000.0
        if self.total_ms > self.budget_ms:
            hist = ", ".join(f"{k}x{v}"
                             for k, v in sorted(self.attempts.items()))
            raise BackoffExhausted(
                f"backoff budget exhausted after {self.total_ms:.0f}ms "
                f"(budget {self.budget_ms}ms): {hist}")
