"""SQL plan management: statement bindings.

Port of `tidb_tpu/session/bindinfo.py` (the reference's own sources:
bindinfo/handle.go, bindinfo/session_handle.go, mysql.bind_info).

A binding pairs a literal-normalized statement with a hinted variant of
the same statement. At planning time a SELECT whose normalized form (and
current database) matches a binding gets the binding's optimizer hints
injected: the user's literals are kept, only the hint set transfers.

GLOBAL bindings persist through the storage's meta keyspace (`put_meta`,
`get_meta`; the mysql.bind_info analog) and are seen by every session of
the storage; SESSION bindings live on the Session and win over GLOBAL
ones. The digest of a binding is the reference's, so a store's records
read alike in both packages.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Optional

_META_PREFIX = b"binding:"
_META_INDEX = b"binding:__digests__"


def normalize_binding_sql(sql: str) -> str:
    """Literal-normalized, hint-stripped statement text: the binding
    match key (reference: parser.NormalizeDigest; hints are excluded so
    `FOR` and `USING` statements compare equal modulo hints)."""
    from ..sql.lexer import Lexer, TokenKind

    out: list[str] = []
    for t in Lexer(sql).tokens():
        if t.kind == TokenKind.EOF:
            break
        if t.kind == TokenKind.HINT:
            continue
        if t.kind in (TokenKind.INT, TokenKind.DECIMAL,
                      TokenKind.FLOAT, TokenKind.STRING):
            out.append("?")
        else:
            out.append(t.text.lower())
    joined = " ".join(out)
    return joined[:-2].strip() if joined.endswith(" ;") else joined


def binding_digest(norm_sql: str, db: str) -> str:
    return hashlib.sha256(
        f"{db.lower()}\x00{norm_sql}".encode()).hexdigest()[:32]


def make_record(norm_sql: str, bind_sql: str, db: str,
                hints: list) -> dict:
    """One binding record — the SHOW BINDINGS row source for both
    scopes, so the shape is defined exactly once."""
    now = time.strftime("%Y-%m-%d %H:%M:%S")
    return {
        "original_sql": norm_sql, "bind_sql": bind_sql,
        "default_db": db, "status": "enabled",
        "create_time": now, "update_time": now,
        "hints": [list(h) if not isinstance(h, list) else h
                  for h in hints],
    }


class BindingManager:
    """GLOBAL binding registry over the meta plane; one per Storage.
    Safe under the server's thread-per-connection model: every public
    method loads/copies/iterates only while holding the lock."""

    def __init__(self, storage) -> None:
        self._storage = storage
        self._lock = threading.Lock()
        self._cache: Optional[dict[str, dict]] = None
        self._fp: Optional[int] = None  # memoized fingerprint()

    def _load_locked(self) -> dict[str, dict]:
        if self._cache is not None:
            return self._cache
        out: dict[str, dict] = {}
        raw = self._storage.get_meta(_META_INDEX)
        for digest in json.loads(raw) if raw else []:
            rec = self._storage.get_meta(_META_PREFIX + digest.encode())
            if rec:
                out[digest] = json.loads(rec)
        self._cache = out
        return out

    def create(self, norm_sql: str, bind_sql: str, db: str,
               hints: list) -> None:
        digest = binding_digest(norm_sql, db)
        rec = make_record(norm_sql, bind_sql, db, hints)
        with self._lock:
            recs = self._load_locked()
            recs[digest] = rec
            self._storage.put_meta(_META_PREFIX + digest.encode(),
                                   json.dumps(rec).encode())
            self._storage.put_meta(
                _META_INDEX, json.dumps(sorted(recs)).encode())
            self._fp = None

    def drop(self, norm_sql: str, db: str) -> bool:
        digest = binding_digest(norm_sql, db)
        with self._lock:
            recs = self._load_locked()
            if digest not in recs:
                return False
            del recs[digest]
            self._storage.put_meta(_META_PREFIX + digest.encode(), b"")
            self._storage.put_meta(
                _META_INDEX, json.dumps(sorted(recs)).encode())
            self._fp = None
            return True

    def match(self, norm_sql: str, db: str) -> Optional[dict]:
        with self._lock:
            return self._load_locked().get(binding_digest(norm_sql, db))

    def has_any(self) -> bool:
        """O(1) emptiness probe for the per-SELECT fast path."""
        with self._lock:
            return bool(self._load_locked())

    def invalidate(self) -> None:
        """Sibling servers reload on catalog refresh (the bind-info
        load loop analog, bindinfo/handle.go:139 Update)."""
        with self._lock:
            self._cache = None
            self._fp = None

    def fingerprint(self) -> int:
        """Content hash of the binding set (digests AND hint sets) —
        part of the plan-cache key, so cached plans can't outlive a
        binding change (including a same-second re-create with different
        hints) while an unchanged set keeps the cache warm. Memoized
        until the set mutates or a refresh invalidates."""
        with self._lock:
            if self._fp is None:
                recs = self._load_locked()
                self._fp = hash(tuple(sorted(
                    (d, json.dumps(r.get("hints", [])))
                    for d, r in recs.items())))
            return self._fp

    def all(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._load_locked().values()]
