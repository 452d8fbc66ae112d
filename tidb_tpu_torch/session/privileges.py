"""User accounts + privilege checks, persisted in the meta keyspace.

Port of `tidb_tpu/session/privileges.py`, whole. The wire server's
`_check_auth` calls `exists`, `verify_native` and `default_roles`; the
statements that manage accounts (CREATE USER, GRANT, ...) and the
per-statement checks wait for the users-and-grants slice of the port.

Counterpart of the reference's privilege subsystem (reference:
privilege/privileges/cache.go — the mysql.user/db/tables_priv grant
tables cached in memory; checks hooked at plan build,
planner/optimize.go:246). Scaled to the statement surface this engine
executes: account management (CREATE/DROP USER, GRANT/REVOKE), the
mysql_native_password verification the wire server needs, and
table/db/global-scope privilege checks enforced by the session before
statements run.

Passwords store as SHA1(SHA1(password)) — MySQL's authentication_string
— so the server can verify the native-password scramble without ever
holding the cleartext: given client response R and salt s,
X := R xor SHA1(s + stored) recovers SHA1(password), and SHA1(X) must
equal stored (reference: server/auth semantics, conn.go:665)."""

from __future__ import annotations

import hashlib
import pickle
import threading
from typing import Optional

PRIVS = frozenset({
    "SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP", "ALTER",
    "INDEX", "ALL", "USAGE", "FILE", "SUPER", "PROCESS", "RELOAD",
    "REFERENCES", "CREATE VIEW", "SHOW VIEW", "TRIGGER", "EXECUTE",
})

_META_KEY = b"priv:users"


def _hash2(password: str) -> bytes:
    return hashlib.sha1(
        hashlib.sha1(password.encode("utf-8")).digest()).digest()


from ..errno import ER_SPECIFIC_ACCESS_DENIED, CodedError


class PrivilegeError(CodedError):
    errno = ER_SPECIFIC_ACCESS_DENIED
    sqlstate = "42000"


class PrivilegeManager:
    """name -> {"auth": SHA1(SHA1(pwd)) bytes | b"" (empty password),
    "grants": set[(priv, db, tbl)]}; '*' wildcards both scopes.
    root@empty-password with ALL on *.* bootstraps (reference:
    session/bootstrap.go:461 creates the root row the same way)."""

    def __init__(self, storage) -> None:
        self._storage = storage
        self._lock = threading.Lock()
        self._users: Optional[dict] = None

    def _load(self) -> dict:
        with self._lock:
            if self._users is None:
                raw = self._storage.get_meta(_META_KEY)
                if raw is not None:
                    self._users = pickle.loads(raw)
                else:
                    self._users = {
                        "root": {"auth": b"",
                                 "grants": {("ALL", "*", "*")}},
                    }
            return self._users

    def _persist(self) -> None:
        self._storage.put_meta(_META_KEY, pickle.dumps(self._users))

    # ---- account management -------------------------------------------
    def create_user(self, name: str, password: str,
                    if_not_exists: bool = False) -> None:
        users = self._load()
        with self._lock:
            if name in users:
                if if_not_exists:
                    return
                raise PrivilegeError(
                    f"Operation CREATE USER failed for '{name}'")
            users[name] = {
                "auth": _hash2(password) if password else b"",
                "grants": set(),
            }
            self._persist()

    def drop_user(self, name: str, if_exists: bool = False) -> None:
        users = self._load()
        with self._lock:
            if name not in users:
                if if_exists:
                    return
                raise PrivilegeError(
                    f"Operation DROP USER failed for '{name}'")
            del users[name]
            # the account may have been a role (DROP USER drops roles in
            # MySQL too): clear edges so a future same-named role isn't
            # silently re-granted to old grantees
            for other in users.values():
                other.get("roles", set()).discard(name)
                other.get("default_roles", set()).discard(name)
            self._persist()

    # ---- roles (reference: privilege/privileges role graph; MySQL 8
    # roles are locked accounts linked by role edges) -------------------
    def create_role(self, names: list[str],
                    if_not_exists: bool = False) -> None:
        users = self._load()
        with self._lock:
            # validate FIRST: a mid-loop failure must not leave partial
            # mutations for a later unrelated _persist to commit
            todo = []
            for name in names:
                if name in users:
                    if if_not_exists:
                        continue
                    raise PrivilegeError(
                        f"Operation CREATE ROLE failed for '{name}'")
                todo.append(name)
            for name in todo:
                users[name] = {"auth": None, "grants": set(),
                               "is_role": True}
            self._persist()

    def drop_role(self, names: list[str], if_exists: bool = False) -> None:
        users = self._load()
        with self._lock:
            todo = []
            for name in names:
                u = users.get(name)
                if u is None or not u.get("is_role"):
                    if if_exists:
                        continue
                    raise PrivilegeError(
                        f"Operation DROP ROLE failed for '{name}'")
                todo.append(name)
            for name in todo:
                del users[name]
                for other in users.values():
                    other.get("roles", set()).discard(name)
                    other.get("default_roles", set()).discard(name)
            self._persist()

    def is_role(self, name: str) -> bool:
        users = self._load()
        with self._lock:
            u = users.get(name)
            return bool(u and u.get("is_role"))

    def grant_roles(self, roles: list[str], targets: list[str],
                    revoke: bool = False) -> None:
        users = self._load()
        with self._lock:
            for r in roles:
                ru = users.get(r)
                if ru is None or not ru.get("is_role"):
                    raise PrivilegeError(f"Unknown role '{r}'")
            for t in targets:  # validate all targets before any mutation
                if t not in users:
                    raise PrivilegeError(f"unknown user '{t}'")
            for t in targets:
                u = users[t]
                edges = u.setdefault("roles", set())
                for r in roles:
                    if revoke:
                        edges.discard(r)
                        u.get("default_roles", set()).discard(r)
                    else:
                        edges.add(r)
            self._persist()

    def roles_of(self, name: str) -> set[str]:
        users = self._load()
        with self._lock:
            u = users.get(name)
            return set(u.get("roles", ())) if u else set()

    def set_default_roles(self, user: str, mode: str,
                          roles: list[str]) -> None:
        users = self._load()
        with self._lock:
            u = users.get(user)
            if u is None:
                raise PrivilegeError(f"unknown user '{user}'")
            granted = u.get("roles", set())
            if mode == "ALL":
                u["default_roles"] = set(granted)
            elif mode == "NONE":
                u["default_roles"] = set()
            else:
                missing = [r for r in roles if r not in granted]
                if missing:
                    raise PrivilegeError(
                        f"role '{missing[0]}' is not granted to "
                        f"'{user}'")
                u["default_roles"] = set(roles)
            self._persist()

    def default_roles(self, name: str) -> set[str]:
        users = self._load()
        with self._lock:
            u = users.get(name)
            return set(u.get("default_roles", ())) if u else set()

    def _expand_roles(self, users: dict, roles) -> set[str]:
        """Transitive closure over role->role edges (roles can be
        granted to roles, MySQL 8 semantics)."""
        out: set[str] = set()
        stack = list(roles)
        while stack:
            r = stack.pop()
            if r in out:
                continue
            ru = users.get(r)
            if ru is None or not ru.get("is_role"):
                continue
            out.add(r)
            stack.extend(ru.get("roles", ()))
        return out

    def set_password(self, name: str, password: str) -> None:
        users = self._load()
        with self._lock:
            if name not in users:
                raise PrivilegeError(f"unknown user '{name}'")
            users[name]["auth"] = _hash2(password) if password else b""
            self._persist()

    @staticmethod
    def _validate(privs: list[str]) -> list[str]:
        out = []
        for p in privs:
            p = p.upper()
            if p not in PRIVS:
                raise PrivilegeError(f"unknown privilege '{p}'")
            if p != "USAGE":  # USAGE = "no privileges" (MySQL): a no-op
                out.append(p)
        return out

    @staticmethod
    def _paired(privs: list[str], cols: Optional[list]):
        """(PRIV, cols|None) pairs validated WITHOUT dropping entries,
        keeping priv<->column alignment (USAGE filtered pairwise); all
        validation happens before any mutation."""
        out = []
        for i, p in enumerate(privs):
            p = p.upper()
            if p not in PRIVS:
                raise PrivilegeError(f"unknown privilege '{p}'")
            if p == "USAGE":  # "no privileges" (MySQL): a no-op
                continue
            pc = cols[i] if cols is not None and i < len(cols) else None
            out.append((p, pc))
        return out

    def grant(self, privs: list[str], db: str, tbl: str,
              name: str, cols: Optional[list] = None) -> None:
        """cols[i] is an optional column list for privs[i] — the
        mysql.columns_priv analog (reference: executor/grant.go column
        scope; privilege/privileges/cache.go columnsPriv)."""
        pairs = self._paired(privs, cols)
        if any(pc for _, pc in pairs) and tbl in ("*", ""):
            raise PrivilegeError(
                "column privileges need a specific table")
        users = self._load()
        with self._lock:
            u = users.get(name)
            if u is None:
                raise PrivilegeError(f"unknown user '{name}'")
            for p, pc in pairs:
                if pc:
                    cg = u.setdefault("col_grants", set())
                    for c in pc:
                        cg.add((p, db.lower(), tbl.lower(), c.lower()))
                else:
                    u["grants"].add((p, db.lower(), tbl.lower()))
            self._persist()

    def revoke(self, privs: list[str], db: str, tbl: str,
               name: str, cols: Optional[list] = None) -> None:
        pairs = self._paired(privs, cols)
        users = self._load()
        with self._lock:
            u = users.get(name)
            if u is None:
                raise PrivilegeError(f"unknown user '{name}'")
            for p, pc in pairs:
                if pc:
                    cg = u.get("col_grants", set())
                    for c in pc:
                        cg.discard((p, db.lower(), tbl.lower(), c.lower()))
                else:
                    u["grants"].discard((p, db.lower(), tbl.lower()))
            self._persist()

    def grants_for(self, name: str) -> list[tuple[str, str, str]]:
        users = self._load()
        with self._lock:
            u = users.get(name)
            return sorted(u["grants"]) if u else []

    def col_grants_for(self, name: str) -> list[tuple[str, str, str, str]]:
        users = self._load()
        with self._lock:
            u = users.get(name)
            return sorted(u.get("col_grants", ())) if u else []

    def rename_users(self, pairs: list) -> None:
        """RENAME USER a TO b (reference: executor/simple.go
        executeRenameUser): validate every pair before mutating any."""
        users = self._load()
        with self._lock:
            taken = set(users)
            for old, new in pairs:
                if old not in taken:
                    raise PrivilegeError(f"unknown user '{old}'")
                if new in taken:  # includes earlier pairs' targets
                    raise PrivilegeError(
                        f"Operation RENAME USER failed for '{new}'")
                taken.discard(old)
                taken.add(new)
            for old, new in pairs:
                users[new] = users.pop(old)
                for other in users.values():
                    edges = other.get("roles")
                    if edges and old in edges:
                        edges.discard(old)
                        edges.add(new)
                    dflt = other.get("default_roles")
                    if dflt and old in dflt:
                        dflt.discard(old)
                        dflt.add(new)
            self._persist()

    def account_names(self) -> list[str]:
        """Sorted non-role account names (a locked snapshot — callers
        must never iterate the live users dict)."""
        users = self._load()
        with self._lock:
            return sorted(n for n, u in users.items()
                          if not u.get("is_role"))

    def exists(self, name: str) -> bool:
        users = self._load()
        with self._lock:
            return name in users

    # ---- checks --------------------------------------------------------
    def check(self, name: Optional[str], priv: str, db: str,
              tbl: str = "*", roles=()) -> bool:
        """None user = internal session (unchecked); information_schema is
        world-readable (reference: infoschema needs no grants). `roles`
        are the session's ACTIVE roles — their grants (transitively, for
        roles granted to roles) union with the user's own."""
        if name is None:
            return True
        if priv == "SELECT" and db.lower() == "information_schema":
            return True
        users = self._load()
        with self._lock:
            u = users.get(name)
            # snapshot under the lock: grant/revoke mutate the set from
            # other connection threads (reference caches are swapped
            # atomically, privileges/cache.go)
            grants = list(u["grants"]) if u is not None else None
            col_grants = list(u.get("col_grants", ())) if u is not None \
                else []
            if grants is not None and roles:
                for r in self._expand_roles(users, roles):
                    grants.extend(users[r]["grants"])
                    col_grants.extend(users[r].get("col_grants", ()))
        if grants is None:
            return False
        db = db.lower()
        tbl = tbl.lower()
        if self._match(grants, priv, db, tbl):
            return True
        # MySQL: holding the privilege on ANY column of the table passes
        # the table-level gate; exact columns check at resolution
        # (check_columns)
        return any(gp in (priv, "ALL") and gdb == db and gtbl == tbl
                   for gp, gdb, gtbl, _ in col_grants)

    @staticmethod
    def _match(grants, priv: str, db: str, tbl: str) -> bool:
        for gp, gdb, gtbl in grants:
            if gp not in (priv, "ALL"):
                continue
            if gdb not in (db, "*"):
                continue
            if gtbl in (tbl, "*"):
                return True
        return False

    def has_col_grants(self, name: Optional[str], roles=()) -> bool:
        """O(1)-ish probe: does this principal hold ANY column-scoped
        grant? The hot read path skips all column enforcement when not
        (full-table access is already gated statement-level)."""
        if name is None:
            return False
        users = self._load()
        with self._lock:
            u = users.get(name)
            if u is None:
                return False
            if u.get("col_grants"):
                return True
            if roles:
                return any(users[r].get("col_grants")
                           for r in self._expand_roles(users, roles))
        return False

    def check_columns(self, name: Optional[str], priv: str, db: str,
                      tbl: str, cols, roles=()) -> Optional[str]:
        """First column of `cols` the user may NOT touch, or None when
        all are allowed. Enforcement applies only to principals whose
        access to THIS table comes through column grants; users with a
        full table/db/global grant — or with no grants on the base table
        at all (e.g. access mediated by a view they hold SELECT on,
        already gated statement-level) — pass."""
        if name is None:
            return None
        db = db.lower()
        tbl = tbl.lower()
        if priv == "SELECT" and db == "information_schema":
            return None
        users = self._load()
        with self._lock:
            u = users.get(name)
            if u is None:
                return None
            grants = list(u["grants"])
            col_grants = set(u.get("col_grants", ()))
            if roles:
                for r in self._expand_roles(users, roles):
                    grants.extend(users[r]["grants"])
                    col_grants.update(users[r].get("col_grants", ()))
        if self._match(grants, priv, db, tbl):
            return None
        if not any(gdb == db and gtbl == tbl
                   for _, gdb, gtbl, _c in col_grants):
            return None  # no column route to this table: defer to gates
        for c in cols:
            c = c.lower()
            if (priv, db, tbl, c) not in col_grants and \
                    ("ALL", db, tbl, c) not in col_grants:
                return c
        return None

    # ---- wire auth -----------------------------------------------------
    def verify_native(self, name: str, salt: bytes,
                      response: bytes) -> bool:
        """mysql_native_password check against the stored double-SHA1."""
        users = self._load()
        with self._lock:
            u = users.get(name)
            stored = u["auth"] if u is not None else None
            if u is not None and u.get("is_role"):
                stored = None  # roles are locked accounts: no login
        if stored is None:
            return False
        if stored == b"":
            # empty-password account: MySQL accepts only an EMPTY auth
            # response (a client that sent a scramble used a password)
            return response == b""
        if len(response) != 20:
            return False
        mask = hashlib.sha1(salt + stored).digest()
        candidate = bytes(a ^ b for a, b in zip(response, mask))
        import secrets
        return secrets.compare_digest(hashlib.sha1(candidate).digest(),
                                      stored)
