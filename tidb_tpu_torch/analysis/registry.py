"""Declared concurrency/hygiene registries the static rules check
against.

One place, in product code, that SAYS what the conventions are — the
rules in analysis/rules.py enforce them. Adding a hot lock, an engine
tag family or a TLS frame helper means adding it HERE first; an
undeclared one is a finding. (Failpoint names live with their runtime
in util/failpoint.py DECLARED — same idea, different owner.)
"""

from __future__ import annotations

# ---- hot locks --------------------------------------------------------------
# Locks on the commit/serving hot path: holding one while performing a
# blocking syscall serializes every writer (or reader) behind disk or
# network. Key = the RESOLVED lock node ("Class.attr", the same naming
# the static rule derives and lockcheck registers); value = why it is
# hot, for the finding text. Qualified on purpose: `_mu` is a hot
# store mutex on MVCCStore but a cold registry mutex on
# CoordRPCServer, and an attr-level match would conflate them.
HOT_LOCKS: dict[str, str] = {
    "Storage._commit_lock":
        "the storage commit lock — every commit, fold and closed-ts "
        "computation serializes under it (store/storage.py)",
    "Storage.infoschema_lock":
        "schema/DDL mutations + every statement's schema validation "
        "pass through it",
    "MVCCStore._mu":
        "the MVCC store mutex — prewrite/commit/read sections "
        "serialize under it (kv/mvcc.py)",
    "NativeOrderedKV._mu":
        "the native store mutex — an fsync under exactly this lock "
        "once serialized every writer behind the disk barrier "
        "(kv/native.py)",
    "RangeServer._mu":
        "the hosted-leader map lock — every cross-process 2PC request "
        "passes its fencing gate under it, so a lease renewal doing "
        "disk I/O inside would stall every range's writers at once "
        "(rpc/ranged.py)",
    "RangeHeatRecorder._mu":
        "the keyspace heat recorder's cell ring — every point read, "
        "scan, and 2PC commit notes its traffic under it while the "
        "heatmap is enabled, so any blocking call inside would "
        "serialize the whole statement path behind it (obs_heat.py)",
}

# ---- blocking calls ---------------------------------------------------------
# Call shapes the blocking-call-under-hot-lock rule flags inside a
# `with <hot lock>:` body. Matched against the dotted tail of the call
# (`os.fsync` matches `os.fsync(...)`; a bare name matches any
# attribute call ending in it, e.g. `.sendall`).
BLOCKING_CALLS: tuple[str, ...] = (
    "os.fsync", "fsync", "time.sleep", "sleep",
    "sendall", "send", "recv", "recv_into", "connect", "accept",
    "subprocess.run", "subprocess.check_output", "urlopen",
    # disk metadata syscalls: a stat against a contended volume blocks
    # like a read does
    "os.path.getsize", "os.stat", "fcntl.flock",
    # the RPC tier's budgeted call entry points
    "call", "call_with_retry",
)
# receivers whose .send/.recv/.call are NOT sockets/RPC (queue-ish and
# generator-ish false-positive names)
BLOCKING_RECEIVER_ALLOW: tuple[str, ...] = ("gen", "coro", "chan")

# ---- TLS frames -------------------------------------------------------------
# Thread-local push/pop helpers that MUST be finally-paired: the
# restore call has to sit in a `finally:` of a try statement that
# begins immediately after the install (any statement in between can
# raise and leak the frame onto the thread — the bug class the
# tls-frame-hygiene rule exists for). Names are matched on the called
# function's tail identifier.
TLS_FRAME_FNS: tuple[str, ...] = (
    "install_session_time_zone",   # copr/funcs.py — session time zone
    "install_stage_recorder",      # obs.py — per-statement recorder
)
# context-manager-only frames: calling one OUTSIDE a `with` item (or a
# return feeding one) leaves the frame management to the caller and is
# almost always a leak
TLS_FRAME_CTX_ONLY: tuple[str, ...] = (
    "placement_scope",             # copr/client.py, copr/mesh.py
)

# ---- thread discipline ------------------------------------------------------
# Every threading.Thread() started inside tidb_tpu_torch/ must carry a
# name with this prefix (the test leak guards and /debug surfaces key on
# it) and either be a daemon or have a join site in its module.
THREAD_NAME_PREFIX = "titpu-"

# ---- engine tags ------------------------------------------------------------
# The EXPLAIN ANALYZE / slow-log / Top SQL `engine` column families —
# the one enum the engine-tag rule checks literal producers against
# (obs.note_engine() / `<result>.engine = ...` sites). A produced tag
# must START with one of these.
ENGINE_TAG_FAMILIES: tuple[str, ...] = (
    "device",      # device, device@mesh8, device[fat]@mesh8
    "ranged",      # host index-range path
    "host(",       # host fallback with the gate reason embedded
    "point",       # the OLTP point fast path (plan/fastpath.py)
    "replica@",    # follower read tier (rpc/replica.py)
    "range#",      # per-range gate verdicts: range#<id>@gated
    "ranges@",     # range-aware covering summary: ranges@covered(...)
)

# bracketed device fragment modes — the exact vocabulary inside
# device[<mode>] / device[<mode>]@meshN tags (copr/fragment.py emode).
# Tooling that switches on the bracket contents (the golden engines
# corpus, the README coverage matrix) recognizes exactly these; a new
# spelling must be declared here first.
#   agg    dense-segment fused join+aggregation
#   rows   fused joins returning a probe-row bitmask
#   topn   fused join+topn (packed multi-key composite)
#   hc     high-cardinality candidate path (plain, host re-ranks)
#   fat    fused hc final cut (exact device ordering, k+1 rows out)
#   group  all-groups sorted-run aggregation (dense gate rejected)
#   +semi  suffix: semi/anti membership bitmap gates fused in
DEVICE_FRAGMENT_MODES: tuple[str, ...] = (
    "agg", "rows", "topn", "hc", "fat", "group",
    "agg+semi", "rows+semi", "topn+semi", "hc+semi", "fat+semi",
    "group+semi",
)

__all__ = ["HOT_LOCKS", "BLOCKING_CALLS", "BLOCKING_RECEIVER_ALLOW",
           "TLS_FRAME_FNS", "TLS_FRAME_CTX_ONLY", "THREAD_NAME_PREFIX",
           "ENGINE_TAG_FAMILIES", "DEVICE_FRAGMENT_MODES"]
