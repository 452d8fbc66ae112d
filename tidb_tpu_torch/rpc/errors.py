"""Typed transport errors (reference: store/tikv/region_request.go's
error taxonomy — every failure class retries differently, and what
cannot be retried surfaces to the session with a real error code).

Port of `tidb_tpu/rpc/errors.py`: the same classes, errnos and
messages. All of these are CodedError subclasses: a follower whose
leader is gone answers MySQL clients with errno 9001
(ER_TIKV_SERVER_TIMEOUT), not a hang and not a bare 1105.

One difference, kept on purpose: `traced_response` turns into a wire
error only what `survivable()` names — the port's RPC, KV, transaction,
coded and `NotInSlice` errors and socket errors. Anything else (a
torch or CUDA error, a bug) propagates to the listener's connection
thread, which keeps it for `close()` to re-raise and drops the
connection, so the peer sees a transport error.
"""

from __future__ import annotations

from ..errno import ER_TIKV_SERVER_TIMEOUT, ER_WRITE_CONFLICT, CodedError


class RPCError(CodedError):
    """Base of the transport error surface."""

    errno = ER_TIKV_SERVER_TIMEOUT
    sqlstate = "HY000"


class LeaderUnavailable(RPCError):
    """The store leader could not be reached within the backoff budget.

    Carries the Backoffer's typed retry history in the message so an
    operator sees WHY the budget burned. Followers raise this from every
    write path while degraded — reads keep serving the last replicated
    state."""


class StaleLeaseError(RPCError):
    """A fenced operation arrived with a superseded lease token.

    The holder lost its lease (partition/pause) and another mutator may
    have run; the local buffered mutations were reverted, so retrying
    the whole statement at a fresh view is safe — hence the
    write-conflict errno clients already retry on."""

    errno = ER_WRITE_CONFLICT
    sqlstate = "40001"


class StaleTermError(RPCError):
    """A fenced operation carried a superseded fencing TERM: a zombie of
    a deposed epoch has every mutation rejected before it can
    split-brain the WAL. Clients react by re-resolving the leader, not
    by retrying the same request."""

    errno = ER_WRITE_CONFLICT
    sqlstate = "40001"


class NotLeaderError(RPCError):
    """The addressed server does not (or no longer) lead the range the
    request named (the range plane, `rpc/ranged.py`)."""

    errno = ER_WRITE_CONFLICT
    sqlstate = "40001"


class EpochNotMatchError(RPCError):
    """The request's range epoch is older than the server's routing
    table (the range plane, `rpc/ranged.py`)."""

    errno = ER_WRITE_CONFLICT
    sqlstate = "40001"


class ResultUndetermined(RPCError):
    """A WAL publish may or may not have landed (the leader became
    unreachable after the request was sent and before a response
    arrived, and retries exhausted the budget). Locally the buffered
    records are reverted to the last replicated state; if the append
    DID land, the next successful tail re-applies it."""


class ReplicaStaleError(RPCError):
    """A routed replica read could not be served at the requested
    timestamp (rpc/replica.py: the router falls back to the leader)."""


class WalOffsetMismatch(RPCError):
    """An append's expected WAL position no longer matches the file.

    Only reachable when fencing was bypassed (or the leader lost state);
    kept distinct from StaleLeaseError so chaos tests can tell the two
    protections apart."""

    errno = ER_WRITE_CONFLICT
    sqlstate = "40001"


_SURVIVABLE: tuple = ()


def survivable() -> tuple:
    """The exception classes a serving loop turns into a wire error or
    an error row: the port's own RPC, KV, transaction and coded errors,
    `NotInSlice`, and socket errors."""
    global _SURVIVABLE
    if not _SURVIVABLE:
        from ..errors import NotInSlice
        from ..kv.mvcc import KVError
        from ..kv.twopc import CommitError
        _SURVIVABLE = (CodedError, KVError, CommitError, NotInSlice,
                       OSError)
    return _SURVIVABLE


def traced_response(rid, method: str, fn, trace_ctx) -> dict:
    """The one traced-dispatch envelope both RPC servers answer with:
    run `fn` (under a SpanCollector when the request carried trace
    context), return {'id','r'[,'sp']} or the wire_error shape. Only a
    survivable error becomes a wire error; any other propagates."""
    from .. import obs
    try:
        result, spans = obs.run_remote_traced(
            trace_ctx, f"remote.{method}", fn)
        out = {"id": rid, "r": result}
        if spans is not None:
            out["sp"] = spans
        return out
    except survivable() as e:
        return wire_error(rid, e)


def wire_error(rid, e: BaseException) -> dict:
    """One server-side error as a response envelope — the single place
    the err-dict wire shape is produced (CoordRPCServer and the diag
    listeners both answer with it; WIRE_ERRORS re-raises it typed)."""
    if isinstance(e, CodedError):
        return {"id": rid, "err": {"type": type(e).__name__,
                                   "msg": str(e), "errno": e.errno}}
    return {"id": rid, "err": {"type": "RPCError",
                               "msg": f"{type(e).__name__}: {e}"}}


# wire name -> class, for re-raising a server-side error client-side
WIRE_ERRORS = {
    "LeaderUnavailable": LeaderUnavailable,
    "StaleLeaseError": StaleLeaseError,
    "StaleTermError": StaleTermError,
    "NotLeaderError": NotLeaderError,
    "EpochNotMatchError": EpochNotMatchError,
    "ResultUndetermined": ResultUndetermined,
    "ReplicaStaleError": ReplicaStaleError,
    "WalOffsetMismatch": WalOffsetMismatch,
    "RPCError": RPCError,
}


__all__ = ["RPCError", "LeaderUnavailable", "StaleLeaseError",
           "StaleTermError", "NotLeaderError", "EpochNotMatchError",
           "ResultUndetermined", "ReplicaStaleError",
           "WalOffsetMismatch", "WIRE_ERRORS", "wire_error",
           "traced_response", "survivable"]
