"""The project static-analysis engine: rule registry + source tree +
baseline ratchet.

Deliberately the same shape as the inspection engine (obs_inspect.py):
rules are registered with a name, a severity and reference text, and
are PURE FUNCTIONS over one bounded snapshot — there an
InspectionContext of live telemetry, here a SourceTree of parsed ASTs.
`lint_rules()` applies the identical registry-hygiene contract.

The baseline file (analysis/baseline.txt) is the ratchet: findings
keyed (rule, path, item) that predate the engine are committed there
with a one-line reason and burn down over time; a NEW finding — one
not in the baseline — fails `--check` (and the tier-1 test that wraps
it). Keys deliberately exclude line numbers so unrelated edits don't
churn the file.

Import-light by design: this module and everything it pulls must never
import torch, jax or the package's executor/planner chain — `python -m
tidb_tpu_torch.analysis --check` runs inside tier-1 and in shells with no
CUDA, where loading a device backend to lint source text would be absurd.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

SEVERITIES = ("info", "warning", "critical")

# repo root: tidb_tpu_torch/analysis/engine.py -> tidb_tpu_torch -> repo
REPO_ROOT = Path(__file__).resolve().parent.parent.parent
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.txt"
# the package the product rules hold, and the aux key of its TOML
# contract: the example configuration `config.EXAMPLE` (the text
# `--print-example-config` prints), read out of config.py's source
PKG = "tidb_tpu_torch"
CONFIG_PATH = f"{PKG}/config.py"
TOML_CONTRACT = "config.EXAMPLE"
# test-side files beside tests/: the card smoke script
TEST_SIDE_EXTRAS = ("chip_smoke.py",)


@dataclass(frozen=True)
class AnalysisFinding:
    rule: str
    path: str        # repo-relative posix path
    line: int        # 1-based; 0 = whole-file/projectwide
    item: str        # stable identity within (rule, path) — no lines
    severity: str
    message: str

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.item)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"[{self.severity}] {self.rule} {loc} ({self.item}): " \
               f"{self.message}"


class AnalysisRule:
    __slots__ = ("name", "severity", "reference", "fn")

    def __init__(self, name: str, severity: str, reference: str,
                 fn: Callable) -> None:
        self.name = name
        self.severity = severity
        self.reference = reference
        self.fn = fn


RULES: dict[str, AnalysisRule] = {}


def rule(name: str, severity: str, reference: str):
    """Register one static rule (same metadata contract as
    obs_inspect.rule; lint_rules re-checks it in tier-1)."""
    def deco(fn: Callable) -> Callable:
        if not name or not reference:
            raise ValueError(
                f"analysis rule needs name+reference, got {name!r}")
        if severity not in SEVERITIES:
            raise ValueError(
                f"analysis rule {name}: severity {severity!r} not in "
                f"{SEVERITIES}")
        if name in RULES:
            raise ValueError(f"analysis rule {name} already registered")
        RULES[name] = AnalysisRule(name, severity, reference, fn)
        return fn
    return deco


def lint_rules(rules: Optional[dict] = None) -> list[str]:
    """Registry hygiene: kebab-case names, valid severity, reference
    text present, callable fn — identical to obs_inspect.lint_rules."""
    findings: list[str] = []
    for name, r in (RULES if rules is None else rules).items():
        if not name or name != name.lower() or " " in name \
                or "_" in name:
            findings.append(f"rule {name!r}: name must be kebab-case")
        if getattr(r, "severity", None) not in SEVERITIES:
            findings.append(
                f"rule {name}: severity {getattr(r, 'severity', None)!r}"
                f" not in {SEVERITIES}")
        if not getattr(r, "reference", ""):
            findings.append(f"rule {name}: missing reference text")
        if not callable(getattr(r, "fn", None)):
            findings.append(f"rule {name}: fn is not callable")
    return findings


# ---- the source snapshot rules run over -------------------------------------

class SourceFile:
    __slots__ = ("path", "text", "tree", "parse_error")

    def __init__(self, path: str, text: str) -> None:
        self.path = path
        self.text = text
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.tree = ast.Module(body=[], type_ignores=[])
            self.parse_error = str(e)


class SourceTree:
    """One parsed snapshot of the project's Python sources. Product
    code (tidb_tpu_torch/) and tests are kept distinct — several rules
    hold them to different contracts. Tests build tiny synthetic trees
    via `from_files` to pin each rule's fire/silent behavior."""

    def __init__(self, files: dict[str, str],
                 aux: Optional[dict[str, str]] = None) -> None:
        self.files = {p: SourceFile(p, t)
                      for p, t in sorted(files.items())}
        # non-Python inputs some rules read (the TOML contract);
        # absent in synthetic test trees, whose rules then no-op
        self.aux: dict[str, str] = dict(aux or {})
        self._class_attr_index: Optional[dict] = None

    @classmethod
    def load(cls, root: Optional[Path] = None) -> "SourceTree":
        """The port's own tree: the package, its tests
        (`tests/test_torch_*.py` and their twin harness) and the card
        smoke script. The JAX package and its tests are not read."""
        root = Path(root) if root else REPO_ROOT
        paths: list[Path] = []
        pkg = root / PKG
        if pkg.is_dir():
            paths += sorted(p for p in pkg.rglob("*.py")
                            if "__pycache__" not in p.parts)
        tests = root / "tests"
        if tests.is_dir():
            paths += sorted(tests.glob("test_torch_*.py"))
            paths += [p for p in (tests / "torch_twins.py",)
                      if p.is_file()]
        paths += [root / x for x in TEST_SIDE_EXTRAS
                  if (root / x).is_file()]
        files = {p.relative_to(root).as_posix():
                 p.read_text(encoding="utf-8", errors="replace")
                 for p in paths}
        aux = {}
        example = _config_example(files.get(CONFIG_PATH))
        if example is not None:
            aux[TOML_CONTRACT] = example
        return cls(files, aux)

    @classmethod
    def from_files(cls, files: dict[str, str],
                   aux: Optional[dict[str, str]] = None) -> "SourceTree":
        return cls(dict(files), aux)

    # ---- helpers rules share -------------------------------------------
    def product_files(self):
        for p, f in self.files.items():
            if p.startswith(f"{PKG}/") and \
                    not p.startswith(f"{PKG}/analysis/"):
                yield f

    def test_files(self):
        for p, f in self.files.items():
            if p.startswith("tests/") or p in TEST_SIDE_EXTRAS:
                yield f

    def all_files(self):
        yield from self.files.values()

    def class_attr_index(self) -> dict[str, set]:
        """attr name -> {ClassName} for every `self.X = ...` assignment
        inside a class body, project-wide — the receiver-resolution
        index the lock rules use (`st._commit_lock` resolves to the
        unique class that creates `_commit_lock`)."""
        if self._class_attr_index is not None:
            return self._class_attr_index
        idx: dict[str, set] = {}
        for f in self.product_files():
            for cls_node in ast.walk(f.tree):
                if not isinstance(cls_node, ast.ClassDef):
                    continue
                for node in ast.walk(cls_node):
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, ast.AnnAssign):
                        targets = [node.target]
                    else:
                        continue
                    for t in targets:
                        if isinstance(t, ast.Attribute) and \
                                isinstance(t.value, ast.Name) and \
                                t.value.id == "self":
                            idx.setdefault(t.attr, set()).add(
                                cls_node.name)
        self._class_attr_index = idx
        return idx


def _config_example(text: Optional[str]) -> Optional[str]:
    """The string bound to `EXAMPLE` at the top level of config.py's
    source (parsed, never imported)."""
    if text is None:
        return None
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "EXAMPLE"
                for t in node.targets) and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            return node.value.value
    return None


# ---- shared AST utilities ---------------------------------------------------

def call_name(node: ast.AST) -> str:
    """Dotted tail of a call's func: `os.fsync` -> 'os.fsync',
    `self._syncer.flush` -> 'self._syncer.flush', `foo` -> 'foo'."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


def str_prefix(node: ast.AST) -> Optional[str]:
    """The STATIC prefix of a string expression: a literal's full text,
    an f-string's leading literal text (possibly ''), None for
    anything unknowable."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str):
            return node.values[0].value
        return ""
    return None


def enclosing_function_name(stack: list) -> str:
    """Qualified-ish name from an ancestor stack: Class.method, or
    function, or '(module)'."""
    names = [n.name for n in stack
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    return ".".join(names) if names else "(module)"


def walk_with_stack(tree: ast.AST):
    """(node, ancestor_stack) depth-first — several rules need the
    enclosing function/class for stable item names."""
    stack: list = []

    def rec(node):
        yield node, stack
        push = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
        if push:
            stack.append(node)
        for child in ast.iter_child_nodes(node):
            yield from rec(child)
        if push:
            stack.pop()

    yield from rec(tree)


# ---- baseline ratchet -------------------------------------------------------

def load_baseline(path: Optional[Path] = None) -> dict[tuple, str]:
    """baseline.txt -> {(rule, path, item): reason}. Line format:
    `rule | path | item | reason` with '#' comments; malformed lines
    are ignored loudly by check() (they can never mask a finding)."""
    p = Path(path) if path else BASELINE_PATH
    out: dict[tuple, str] = {}
    if not p.is_file():
        return out
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [s.strip() for s in line.split("|")]
        if len(parts) >= 4:
            out[(parts[0], parts[1], parts[2])] = parts[3]
    return out


def format_baseline_line(f: AnalysisFinding, reason: str) -> str:
    return f"{f.rule} | {f.path} | {f.item} | {reason}"


def run(tree: Optional[SourceTree] = None,
        rules: Optional[dict] = None) -> list[AnalysisFinding]:
    """Evaluate every registered rule over one source snapshot. A rule
    that raises degrades to an info finding naming itself (same
    contract as the inspection engine) — analysis must never crash on
    the code it analyzes."""
    from . import rules as _rules  # noqa: F401 — registers on import
    if tree is None:
        tree = SourceTree.load()
    findings: list[AnalysisFinding] = []
    for r in (RULES if rules is None else rules).values():
        try:
            findings.extend(r.fn(tree) or ())
        except Exception as e:  # noqa: BLE001 — report, don't crash
            findings.append(AnalysisFinding(
                r.name, "(rule)", 0, "rule-error", "info",
                f"rule raised {type(e).__name__}: {str(e)[:200]}"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.item))
    return findings


def check(tree: Optional[SourceTree] = None,
          baseline: Optional[dict] = None
          ) -> tuple[list[AnalysisFinding], list[tuple]]:
    """The ratchet: (new_findings, stale_baseline_keys). New findings
    (not baselined) fail --check / the tier-1 test; stale entries —
    baselined findings that no longer fire — are reported for removal
    but do not fail (the burn-down is the point)."""
    if baseline is None:
        baseline = load_baseline()
    findings = run(tree)
    live_keys = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    stale = [k for k in baseline if k not in live_keys]
    return new, stale


__all__ = ["AnalysisFinding", "AnalysisRule", "RULES", "rule",
           "lint_rules", "SourceTree", "SourceFile", "run", "check",
           "load_baseline", "format_baseline_line", "call_name",
           "str_prefix", "walk_with_stack", "enclosing_function_name",
           "REPO_ROOT", "BASELINE_PATH", "SEVERITIES", "PKG",
           "CONFIG_PATH", "TOML_CONTRACT"]
