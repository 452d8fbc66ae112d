"""The shipped static rules: project-specific concurrency + hygiene
checks over the parsed source tree.

Each rule is a pure function SourceTree -> [AnalysisFinding] with the
same registration contract as the inspection rules (name, severity,
reference). Items are chosen to be stable under unrelated edits (no
line numbers in keys) so the committed baseline only churns when the
finding itself appears or disappears.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from .engine import (CONFIG_PATH, PKG, TOML_CONTRACT, AnalysisFinding,
                     SourceTree, call_name, enclosing_function_name, rule,
                     str_prefix, walk_with_stack)
from . import registry as reg

_LOCKISH = re.compile(r"(lock|mutex|_mu|_cv)$")


def _resolve_lock_node(tree: SourceTree, expr: ast.AST,
                       stack: list) -> Optional[str]:
    """A with-item context expression -> a stable lock node name
    ('Class.attr'), or None when it isn't a lock or cannot be resolved
    unambiguously (ambiguity must not fabricate graph edges)."""
    if not isinstance(expr, ast.Attribute):
        return None
    attr = expr.attr
    if not _LOCKISH.search(attr):
        return None
    if isinstance(expr.value, ast.Name) and expr.value.id == "self":
        for n in reversed(stack):
            if isinstance(n, ast.ClassDef):
                return f"{n.name}.{attr}"
        return None
    owners = tree.class_attr_index().get(attr, set())
    if len(owners) == 1:
        return f"{next(iter(owners))}.{attr}"
    return None


def _iter_with_lock_items(tree: SourceTree, f):
    """Yield (With-node, [(lock_node_name, attr)], stack) for every
    with-statement in the file that acquires at least one lock-like
    attribute."""
    for node, stack in walk_with_stack(f.tree):
        if not isinstance(node, ast.With):
            continue
        locks = []
        for item in node.items:
            name = _resolve_lock_node(tree, item.context_expr, stack)
            if name is not None:
                locks.append((name, item.context_expr.attr))
        if locks:
            yield node, locks, list(stack)


def _body_calls(node: ast.With):
    """Call nodes inside a with-body, skipping deferred execution
    (nested function/lambda bodies run later, not under the lock)."""
    def rec(n):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from rec(child)
    for stmt in node.body:
        yield from rec(stmt)
        if isinstance(stmt, ast.Call):
            yield stmt


def _is_blocking_call(call: ast.Call) -> Optional[str]:
    name = call_name(call.func)
    if not name:
        return None
    parts = name.split(".")
    tail = parts[-1]
    for pat in reg.BLOCKING_CALLS:
        if "." in pat:
            if name == pat or name.endswith("." + pat):
                return pat
        elif tail == pat:
            recv = parts[-2] if len(parts) > 1 else ""
            if recv in reg.BLOCKING_RECEIVER_ALLOW:
                continue
            return pat
    return None


def _class_method_map(f) -> dict[tuple, ast.FunctionDef]:
    """(ClassName, method) -> FunctionDef for one file."""
    out = {}
    for node in ast.walk(f.tree):
        if isinstance(node, ast.ClassDef):
            for ch in node.body:
                if isinstance(ch, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                    out[(node.name, ch.name)] = ch
    return out


def _scan_blocking(calls, methods, cls_name, depth=1):
    """(call, pattern, via) triples: direct blocking calls plus one
    level of same-class helper expansion — `self._wal_size()` under
    the commit lock is the bug even though getsize lives one frame
    down."""
    for call in calls:
        pat = _is_blocking_call(call)
        if pat is not None:
            yield call, pat, ""
            continue
        if depth <= 0:
            continue
        name = call_name(call.func)
        parts = name.split(".")
        if len(parts) == 2 and parts[0] == "self":
            helper = methods.get((cls_name, parts[1]))
            if helper is None:
                continue
            inner = [n for s in helper.body for n in ast.walk(s)
                     if isinstance(n, ast.Call)]
            for _, ipat, _ in _scan_blocking(inner, methods,
                                             cls_name, depth=0):
                yield call, ipat, parts[1]
                break


@rule("blocking-call-under-hot-lock", "critical",
      "analysis/registry.py HOT_LOCKS — no fsync/sleep/socket/RPC "
      "while holding a declared hot lock (the "
      "fsync-under-store-mutex class: every writer serializes behind "
      "the syscall); checks the lock body plus one level of "
      "same-class helpers")
def _r_blocking_under_hot_lock(tree: SourceTree):
    out = []
    for f in tree.product_files():
        methods = None
        for node, locks, stack in _iter_with_lock_items(tree, f):
            hot = [(n, a) for (n, a) in locks if n in reg.HOT_LOCKS]
            if not hot:
                continue
            if methods is None:
                methods = _class_method_map(f)
            cls = next((n.name for n in reversed(stack)
                        if isinstance(n, ast.ClassDef)), "")
            fn = enclosing_function_name(stack)
            for call, pat, via in _scan_blocking(
                    _body_calls(node), methods, cls):
                lock_name = hot[0][0]
                via_txt = f" (via self.{via}())" if via else ""
                out.append(AnalysisFinding(
                    "blocking-call-under-hot-lock", f.path,
                    call.lineno,
                    f"{fn}:{hot[0][1]}:{pat}", "critical",
                    f"{call_name(call.func)}(){via_txt} under hot "
                    f"lock {lock_name} "
                    f"({reg.HOT_LOCKS[lock_name][:80]})"))
    return out


@rule("lock-order", "critical",
      "static lock-acquisition graph over nested `with <lock>:` "
      "blocks — a cycle means two code paths take the same locks in "
      "opposite orders (potential deadlock); fix the order or break "
      "the nesting (TIDB_TPU_LOCK_CHECK catches the dynamic cases)")
def _r_lock_order(tree: SourceTree):
    # edges: (outer, inner) -> sample (path, line)
    edges: dict[tuple, tuple] = {}

    def walk_stmts(f, stmts, held: list, stack: list) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def is a new execution context: locks held
                # at its DEFINITION are not held when it runs
                stack.append(stmt)
                walk_stmts(f, stmt.body, [], stack)
                stack.pop()
                continue
            if isinstance(stmt, ast.ClassDef):
                stack.append(stmt)
                walk_stmts(f, stmt.body, held, stack)
                stack.pop()
                continue
            acquired: list[str] = []
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    name = _resolve_lock_node(tree, item.context_expr,
                                              stack)
                    if name is None:
                        continue
                    for h in held + acquired:
                        if h != name:
                            edges.setdefault(
                                (h, name), (f.path, stmt.lineno))
                    acquired.append(name)
            for _, body in ast.iter_fields(stmt):
                if not isinstance(body, list) or not body:
                    continue
                if isinstance(body[0], ast.stmt):
                    walk_stmts(f, body, held + acquired, stack)
                elif isinstance(body[0], ast.excepthandler):
                    # Try.handlers holds ExceptHandler wrappers, not
                    # stmts — error-path acquisitions are exactly
                    # where order inversions hide
                    for h in body:
                        walk_stmts(f, h.body, held + acquired, stack)

    for f in tree.product_files():
        walk_stmts(f, f.tree.body, [], [])

    # THE shared elementary-cycle finder (lockcheck.elementary_cycles)
    # so the static and dynamic halves can never drift in dedup or
    # bound semantics
    from .lockcheck import elementary_cycles
    out = []
    for cyc in elementary_cycles(edges):
        sp, sl = edges[(cyc[-2], cyc[-1])] \
            if (cyc[-2], cyc[-1]) in edges else edges[(cyc[0], cyc[1])]
        out.append(AnalysisFinding(
            "lock-order", sp, sl, " -> ".join(cyc), "critical",
            "lock acquisition order inversion: "
            + "; ".join(
                f"{a}->{b} at {edges[(a, b)][0]}:{edges[(a, b)][1]}"
                for a, b in zip(cyc, cyc[1:]) if (a, b) in edges)))
    return out


def _stmt_calls_fn(stmt: ast.stmt, fn_tail: str) -> bool:
    for n in ast.walk(stmt):
        if isinstance(n, ast.Call) and \
                call_name(n.func).split(".")[-1] == fn_tail:
            return True
    return False


@rule("tls-frame-hygiene", "warning",
      "analysis/registry.py TLS_FRAME_FNS — a thread-local frame "
      "install must be IMMEDIATELY followed by the try whose finally "
      "restores it (any statement in between can raise and leak the "
      "frame onto the worker thread)")
def _r_tls_frames(tree: SourceTree):
    out = []
    frame_fns = set(reg.TLS_FRAME_FNS)
    ctx_only = set(reg.TLS_FRAME_CTX_ONLY)
    for f in tree.product_files():
        # finally-paired installs
        for node, stack in walk_with_stack(f.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            fname = node.name
            if fname in frame_fns:
                continue  # the frame helper's own definition

            def scan_block(stmts, in_finally, in_protected):
                for i, stmt in enumerate(stmts):
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        continue
                    hit = next((fn for fn in frame_fns
                                if _stmt_calls_fn(stmt, fn)), None)
                    if hit and not isinstance(stmt, ast.Try):
                        ok = in_finally or in_protected
                        if not ok:
                            nxt = stmts[i + 1] if i + 1 < len(stmts) \
                                else None
                            ok = isinstance(nxt, ast.Try) and any(
                                _stmt_calls_fn(s, hit)
                                for s in nxt.finalbody)
                        if not ok:
                            out.append(AnalysisFinding(
                                "tls-frame-hygiene", f.path,
                                stmt.lineno,
                                f"{fname}:{hit}", "warning",
                                f"{hit}() install is not finally-"
                                f"paired: the restoring try/finally "
                                f"must begin on the very next "
                                f"statement"))
                    if isinstance(stmt, ast.Try):
                        protected = any(
                            _stmt_calls_fn(s, fn)
                            for s in stmt.finalbody
                            for fn in frame_fns)
                        scan_block(stmt.body,
                                   in_finally,
                                   in_protected or protected)
                        for h in stmt.handlers:
                            scan_block(h.body, in_finally,
                                       in_protected)
                        scan_block(stmt.orelse, in_finally,
                                   in_protected or protected)
                        scan_block(stmt.finalbody, True,
                                   in_protected)
                    elif isinstance(stmt, (ast.If, ast.For,
                                           ast.While, ast.With)):
                        for field in ("body", "orelse", "finalbody"):
                            sub = getattr(stmt, field, None)
                            if sub:
                                scan_block(sub, in_finally,
                                           in_protected)

            scan_block(node.body, False, False)
        # context-manager-only frames: a call outside a with-item
        with_items = set()
        for node, _ in walk_with_stack(f.tree):
            if isinstance(node, ast.With):
                for item in node.items:
                    with_items.add(id(item.context_expr))
        for node, stack in walk_with_stack(f.tree):
            if isinstance(node, ast.Call) and \
                    call_name(node.func).split(".")[-1] in ctx_only \
                    and id(node) not in with_items:
                fname = enclosing_function_name(stack)
                if fname.split(".")[-1] in ctx_only:
                    continue  # the helper's own definition/recursion
                out.append(AnalysisFinding(
                    "tls-frame-hygiene", f.path, node.lineno,
                    f"{fname}:{call_name(node.func).split('.')[-1]}",
                    "warning",
                    f"{call_name(node.func)}() is declared "
                    f"context-manager-only; use it as a `with` item"))
    return out


# an IDENTIFIER.join( call — `", ".join(...)` (string) fails the
# identifier requirement and `os.path.join(`/`posixpath.join(` is
# excluded by name, so only thread-ish joins satisfy the join-path
# heuristic
_THREAD_JOIN = re.compile(r"[^\"'\w]([A-Za-z_]\w*)\.join\(")


def _has_thread_join(text: str) -> bool:
    return any(m.group(1) not in ("path", "posixpath", "ntpath")
               for m in _THREAD_JOIN.finditer(text))


@rule("thread-discipline", "warning",
      "the test leak guards + /debug surfaces key on thread "
      "names — every threading.Thread started in tidb_tpu_torch/ must be "
      "named 'titpu-*' and be a daemon or have a join path in its "
      "module")
def _r_thread_discipline(tree: SourceTree):
    out = []
    for f in tree.product_files():
        has_join = _has_thread_join(f.text)
        prefix_ok_consts = set(re.findall(
            r'_thread_prefix\s*=\s*["\'](titpu-[^"\']*)["\']', f.text))
        for node, stack in walk_with_stack(f.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node.func)
            if cname not in ("threading.Thread", "Thread"):
                continue
            fn = enclosing_function_name(stack)
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            name_node = kw.get("name")
            named_ok = False
            if name_node is not None:
                prefix = str_prefix(name_node)
                if prefix is not None and \
                        prefix.startswith(reg.THREAD_NAME_PREFIX):
                    named_ok = True
                elif isinstance(name_node, ast.JoinedStr) and \
                        name_node.values and \
                        isinstance(name_node.values[0],
                                   ast.FormattedValue):
                    head = name_node.values[0].value
                    if isinstance(head, ast.Attribute) and \
                            head.attr == "_thread_prefix" and \
                            prefix_ok_consts:
                        named_ok = True
            if not named_ok:
                out.append(AnalysisFinding(
                    "thread-discipline", f.path, node.lineno,
                    f"{fn}:name", "warning",
                    "threading.Thread without a static 'titpu-*' name"))
            daemon = kw.get("daemon")
            is_daemon = isinstance(daemon, ast.Constant) and \
                daemon.value is True
            if not is_daemon and not has_join:
                out.append(AnalysisFinding(
                    "thread-discipline", f.path, node.lineno,
                    f"{fn}:join", "warning",
                    "non-daemon thread with no join() path in its "
                    "module"))
    return out


_FP_NAME = re.compile(r"\A[a-z0-9_]+(?:/[a-z0-9_.-]+)+\Z")


def _env_spec_names(value: str) -> list[str]:
    """Failpoint names out of a TIDB_TPU_FAILPOINTS-shaped string,
    parsed exactly like failpoint.arm_from_env (';'-separated
    name=value pairs whose name is a slash path) — prose that happens
    to contain '=' never matches."""
    names = []
    for part in value.split(";"):
        name, eq, _ = part.strip().partition("=")
        if eq and _FP_NAME.match(name.strip()):
            names.append(name.strip())
    return names


_FAILPOINT_PATH = f"{PKG}/util/failpoint.py"


def _declared_failpoints(tree: SourceTree) -> Optional[set]:
    """The DECLARED frozenset parsed out of util/failpoint.py's AST —
    read statically so synthetic test trees can carry their own."""
    f = tree.files.get(_FAILPOINT_PATH)
    if f is None:
        return None
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "DECLARED"
                for t in node.targets):
            names = set()
            for n in ast.walk(node.value):
                if isinstance(n, ast.Constant) and \
                        isinstance(n.value, str):
                    names.add(n.value)
            return names
    return None


@rule("failpoint-registry", "warning",
      "util/failpoint.py DECLARED — every failpoint.inject() site "
      "uses a declared name and every name a test arms exists in the "
      "runtime (an undeclared armed point silently never fires)")
def _r_failpoints(tree: SourceTree):
    declared = _declared_failpoints(tree)
    if declared is None:
        return []
    out = []
    inject_sites: dict[str, tuple] = {}
    for f in tree.product_files():
        for node, stack in walk_with_stack(f.tree):
            if isinstance(node, ast.Call) and \
                    call_name(node.func).endswith("failpoint.inject") \
                    and node.args:
                lit = str_prefix(node.args[0])
                if lit:
                    inject_sites.setdefault(lit,
                                            (f.path, node.lineno))
    for name, (path, line) in sorted(inject_sites.items()):
        if name not in declared:
            out.append(AnalysisFinding(
                "failpoint-registry", path, line, name, "warning",
                f"failpoint.inject({name!r}) is not in "
                f"util/failpoint.py DECLARED"))
    for name in sorted(declared - set(inject_sites)):
        out.append(AnalysisFinding(
            "failpoint-registry", _FAILPOINT_PATH, 0,
            name, "warning",
            f"DECLARED failpoint {name!r} has no inject() site"))
    # names armed by tests (context manager / enable / env var specs);
    # the env-spec scan only runs in files that actually mention the
    # env var — random prose containing '=' must not be parsed as an
    # arming spec
    for f in tree.test_files():
        scan_env = "TIDB_TPU_FAILPOINTS" in f.text
        for node, _ in walk_with_stack(f.tree):
            if isinstance(node, ast.Call):
                tail = call_name(node.func).split(".")[-1]
                if tail in ("failpoint", "enable") and node.args:
                    lit = str_prefix(node.args[0])
                    if lit and "/" in lit and lit not in declared:
                        out.append(AnalysisFinding(
                            "failpoint-registry", f.path,
                            node.lineno, lit, "warning",
                            f"test arms undeclared failpoint "
                            f"{lit!r}"))
            elif scan_env and isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    "=" in node.value and "/" in node.value:
                for name in _env_spec_names(node.value):
                    if name not in declared:
                        out.append(AnalysisFinding(
                            "failpoint-registry", f.path,
                            node.lineno, name, "warning",
                            f"env spec arms undeclared failpoint "
                            f"{name!r}"))
    return out


@rule("bare-except", "warning",
      "a bare `except:`/`except BaseException:` on the statement path "
      "swallows QueryInterrupted/KeyboardInterrupt and breaks the "
      "kill/governor plane; catch Exception (or narrower), or "
      "re-raise")
def _r_bare_except(tree: SourceTree):
    out = []
    for f in tree.product_files():
        counts: dict[str, int] = {}
        for node, stack in walk_with_stack(f.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            bare = node.type is None
            base = isinstance(node.type, ast.Name) and \
                node.type.id == "BaseException"
            if not (bare or base):
                continue
            reraises = any(isinstance(n, ast.Raise) and n.exc is None
                           for s in node.body for n in ast.walk(s))
            if base and reraises:
                continue  # catch-log-reraise is the legitimate shape
            fn = enclosing_function_name(stack)
            idx = counts.get(fn, 0)
            counts[fn] = idx + 1
            out.append(AnalysisFinding(
                "bare-except", f.path, node.lineno,
                f"{fn}:{idx}", "warning",
                ("bare `except:`" if bare else
                 "`except BaseException:` without re-raise")
                + " swallows interrupts"))
    return out


@rule("engine-tag", "warning",
      "analysis/registry.py ENGINE_TAG_FAMILIES — every produced "
      "EXPLAIN/slow-log/Top SQL engine tag starts with a declared "
      "family, so tooling that switches on the tag never meets an "
      "unknown spelling")
def _r_engine_tags(tree: SourceTree):
    out = []

    def check(f, node, value, fn):
        prefix = str_prefix(value)
        if prefix is None or prefix == "":
            return  # dynamic tag — the producer owns it
        if any(prefix.startswith(fam) or fam.startswith(prefix)
               for fam in reg.ENGINE_TAG_FAMILIES):
            return
        out.append(AnalysisFinding(
            "engine-tag", f.path, node.lineno,
            f"{fn}:{prefix[:32]}", "warning",
            f"engine tag {prefix!r} matches no declared family "
            f"{list(reg.ENGINE_TAG_FAMILIES)}"))

    for f in tree.product_files():
        for node, stack in walk_with_stack(f.tree):
            fn = enclosing_function_name(stack)
            if isinstance(node, ast.Call) and \
                    call_name(node.func).split(".")[-1] == \
                    "note_engine" and node.args:
                check(f, node, node.args[0], fn)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            t.attr == "engine":
                        check(f, node, node.value, fn)
    return out


_METRIC_REG_FNS = ("counter", "gauge", "histogram")
_METRIC_REF_FNS = ("metric_family", "metric_delta", "metric")


@rule("metric-families", "warning",
      "obs.py registries — every metric family the inspection/"
      "metrics_schema tier references by name must have a literal "
      "registration site (a renamed family silently zeroes every "
      "rule that read it)")
def _r_metric_families(tree: SourceTree):
    registered: set[str] = set()
    for f in tree.product_files():
        for node, _ in walk_with_stack(f.tree):
            if isinstance(node, ast.Call) and \
                    call_name(node.func).split(".")[-1] in \
                    _METRIC_REG_FNS and node.args:
                lit = str_prefix(node.args[0])
                if lit and lit.startswith("tidb_"):
                    registered.add(lit)
    if not registered:
        return []
    out = []
    for f in tree.product_files():
        for node, stack in walk_with_stack(f.tree):
            if not (isinstance(node, ast.Call) and
                    call_name(node.func).split(".")[-1] in
                    _METRIC_REF_FNS and node.args):
                continue
            lit = str_prefix(node.args[0])
            if not lit or not lit.startswith("tidb_"):
                continue
            family = lit.split("{", 1)[0]
            if family not in registered:
                out.append(AnalysisFinding(
                    "metric-families", f.path, node.lineno, family,
                    "warning",
                    f"references metric family {family!r} with no "
                    f"literal registration site"))
    return out


def _flatten_toml(raw: dict) -> list[tuple[str, str]]:
    """[('', 'port'), ('storage', 'sync-log'), ...]"""
    out = []
    for k, v in raw.items():
        if isinstance(v, dict):
            for kk in v:
                out.append((k, kk))
        else:
            out.append(("", k))
    return out


class _SysvarSink:
    """Captures Config.seed_sysvars writes (duck-typed storage)."""

    def __init__(self) -> None:
        self.values: dict[str, object] = {}
        self.sysvars = self

    def set_config_default(self, name, value):
        self.values[name] = value


@rule("config-knob-drift", "warning",
      "config.py EXAMPLE is the contract: every documented knob "
      "must parse into a Config field AND have a read site, and every "
      "config-seeded sysvar's registry default must equal the config "
      "default (SHOW VARIABLES on an embedded store must not lie)")
def _r_config_drift(tree: SourceTree):
    toml_text = tree.aux.get(TOML_CONTRACT)
    if toml_text is None:
        return []
    try:
        import tomllib
        raw = tomllib.loads(toml_text)
    except ImportError:
        from ..config import _parse_toml_subset
        raw = _parse_toml_subset(toml_text)
    from ..config import Config
    cfg = Config()
    out = []
    # a read site is an ATTRIBUTE read `.field` anywhere in product
    # code — config.py's own seed_*/validate functions count (they
    # are how knobs reach the runtime) but the dataclass declaration
    # itself does not (no leading dot); CLI flags count (kebab form)
    read_corpus = "\n".join(f.text for f in tree.product_files())
    for section, key in _flatten_toml(raw):
        snake = key.replace("-", "_")
        dotted = f"{section}.{key}" if section else key
        owner = cfg
        if section:
            owner = getattr(cfg, section.replace("-", "_"), None)
            if owner is None:
                out.append(AnalysisFinding(
                    "config-knob-drift", CONFIG_PATH, 0,
                    dotted, "warning",
                    f"section [{section}] has no Config field"))
                continue
        if not hasattr(owner, snake):
            out.append(AnalysisFinding(
                "config-knob-drift", CONFIG_PATH, 0,
                dotted, "warning",
                f"knob {dotted} has no parsed Config field"))
            continue
        if not re.search(rf"\.{re.escape(snake)}\b", read_corpus) \
                and f"--{key}" not in read_corpus:
            out.append(AnalysisFinding(
                "config-knob-drift", CONFIG_PATH, 0,
                dotted, "warning",
                f"knob {dotted} parses into Config.{snake} but "
                f"nothing outside config.py reads it"))
    # sysvar half: simulate seeding from a DEFAULT config and compare
    # against the registry defaults (loaded standalone so this never
    # imports the session/executor chain)
    sink = _SysvarSink()
    cfg.seed_sysvars(sink)
    defaults = _sysvar_defaults()
    if defaults is not None:
        for name, seeded in sorted(sink.values.items()):
            if name not in defaults:
                out.append(AnalysisFinding(
                    "config-knob-drift", CONFIG_PATH, 0,
                    f"sysvar:{name}", "warning",
                    f"seed_sysvars seeds unknown sysvar {name!r}"))
            elif str(defaults[name]) != str(seeded):
                out.append(AnalysisFinding(
                    "config-knob-drift", CONFIG_PATH, 0,
                    f"sysvar:{name}", "warning",
                    f"sysvar {name} registry default "
                    f"{defaults[name]!r} != config-seeded default "
                    f"{seeded!r}"))
    return out


def _sysvar_defaults() -> Optional[dict]:
    """session/sysvars.py's registry defaults via a standalone module
    load (the session package import chain would pull the executor)."""
    import importlib.util
    import sys
    from .engine import REPO_ROOT
    path = REPO_ROOT / PKG / "session" / "sysvars.py"
    if not path.is_file():
        return None
    name = "_titpu_torch_analysis_sysvars"
    cached = sys.modules.get(name)
    if cached is not None:
        return {v.name: v.default for v in cached._VARS}
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves cls.__module__ through sys.modules at class
    # creation, so the module must be registered before exec
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return {v.name: v.default for v in mod._VARS}
