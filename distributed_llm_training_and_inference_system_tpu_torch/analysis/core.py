"""graftlint core: module index, findings, suppressions, baseline.

The port's copy of the JAX package's ``analysis/core.py``: the shared
plumbing of the five AST passes (``analysis/passes_*.py``) that check the
serving fleet's cross-file invariants over the port's own source tree.

- :class:`LintContext` parses every module of the package tree ONCE into
  a :class:`Module` (source, AST, per-line suppressions) and a global
  function index (:class:`FunctionInfo`, nested defs included), so each
  pass is a pure function over pre-parsed trees. By default the tree is
  this package (``..``) and the repository root its parent.
- :class:`Finding` carries a STABLE ``key`` (never a line number) so the
  checked-in baseline survives unrelated edits. Keys hold repo-relative
  paths: the same finding in the two packages differs only in the
  package directory's name.
- Suppressions are per-line comments: ``# graftlint: ignore[rule-id]``
  (or ``ignore[a,b]``, or bare ``ignore`` for all rules) on the
  offending line or on the enclosing ``def``/field line.
- The baseline file (``analysis/baseline.json``, the port's own)
  grandfathers DELIBERATE findings with a required ``note``; matching is
  by (rule, key). Baselined/suppressed findings are reported but do not
  fail the run.

Stdlib only: it imports neither torch nor the JAX package.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

RULE_IDS = (
    "thread-context",
    "lock-discipline",
    "counter-wiring",
    "config-wiring",
    "np-jnp-parity",
)

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore(?:\[(?P<rules>[\w\-, ]+)\])?")

# decorator names the thread-context pass understands (annotations.py)
THREAD_MARKS = ("engine_thread_only", "supervisor_thread",
                "aiohttp_handler", "thread_seam")


@dataclass
class Finding:
    rule: str
    file: str          # repo-root-relative posix path
    line: int          # 1-based anchor (suppression comment goes here)
    message: str
    key: str           # stable identity for the baseline (no line numbers)
    suppressed: bool = False
    baselined: bool = False

    def to_dict(self) -> dict:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "key": self.key,
                "suppressed": self.suppressed,
                "baselined": self.baselined}


@dataclass
class FunctionInfo:
    module: "Module"
    qualname: str                  # "Class.method", "func", "f.<locals>.g"
    name: str
    node: ast.AST                  # FunctionDef | AsyncFunctionDef
    cls: Optional[str]
    marks: frozenset               # thread-context decorator names

    @property
    def line(self) -> int:
        return self.node.lineno


class Module:
    """One parsed package source file."""

    def __init__(self, path: Path, relpath: str):
        self.path = path
        self.relpath = relpath
        self.source = path.read_text(encoding="utf-8")
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        # line (1-based) -> None (ignore all rules) | set of rule ids
        self.suppressions: dict[int, Optional[set]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = m.group("rules")
            if rules is None:
                self.suppressions[i] = None
            else:
                self.suppressions[i] = {
                    r.strip() for r in rules.split(",") if r.strip()}

    def suppressed_at(self, line: int, rule: str) -> bool:
        got = self.suppressions.get(line, False)
        if got is False:
            return False
        return got is None or rule in got


def _decorator_name(node: ast.expr) -> Optional[str]:
    """Terminal name of a decorator expression: ``@x``, ``@m.x``,
    ``@x(...)`` all resolve to ``x``."""
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def index_functions(mod: Module) -> list[FunctionInfo]:
    """Every function/method in the module, including nested defs,
    with its thread-context decorator marks."""
    out: list[FunctionInfo] = []

    def visit(node: ast.AST, stack: tuple, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, stack + (child.name,), child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                marks = frozenset(
                    n for n in (_decorator_name(d)
                                for d in child.decorator_list)
                    if n in THREAD_MARKS)
                qual = ".".join(stack + (child.name,))
                out.append(FunctionInfo(module=mod, qualname=qual,
                                        name=child.name, node=child,
                                        cls=cls, marks=marks))
                visit(child, stack + (child.name, "<locals>"), cls)
    visit(mod.tree, (), None)
    return out


class LintContext:
    """Parsed view of the package tree the passes run over."""

    def __init__(self, package_root: Optional[Path] = None,
                 repo_root: Optional[Path] = None):
        here = Path(__file__).resolve()
        self.package_root = (Path(package_root) if package_root
                             else here.parents[1])
        self.repo_root = (Path(repo_root) if repo_root
                          else self.package_root.parent)
        self.modules: dict[str, Module] = {}
        self.functions: list[FunctionInfo] = []
        # bare function name -> [FunctionInfo] (by-name call resolution)
        self.by_name: dict[str, list[FunctionInfo]] = {}
        for path in sorted(self.package_root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(self.repo_root).as_posix()
            try:
                mod = Module(path, rel)
            except (SyntaxError, UnicodeDecodeError) as e:
                raise RuntimeError(f"graftlint cannot parse {rel}: {e}")
            self.modules[rel] = mod
            for fn in index_functions(mod):
                self.functions.append(fn)
                self.by_name.setdefault(fn.name, []).append(fn)

    def module(self, suffix: str) -> Optional[Module]:
        """Look a module up by path suffix (posix), e.g.
        ``serve/engine.py``."""
        for rel, mod in self.modules.items():
            if rel.endswith(suffix):
                return mod
        return None

    def read_repo_text(self, relpath: str) -> Optional[str]:
        p = self.repo_root / relpath
        if not p.is_file():
            return None
        return p.read_text(encoding="utf-8")


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Optional[Path] = None) -> dict[tuple, str]:
    """{(rule, key): note} of grandfathered findings."""
    p = Path(path) if path else default_baseline_path()
    if not p.is_file():
        return {}
    data = json.loads(p.read_text(encoding="utf-8"))
    out = {}
    for entry in data.get("findings", ()):
        out[(entry["rule"], entry["key"])] = entry.get("note", "")
    return out


def write_baseline(findings: Iterable[Finding],
                   path: Optional[Path] = None,
                   note: str = "grandfathered by --write-baseline") -> Path:
    p = Path(path) if path else default_baseline_path()
    existing = load_baseline(p)
    entries = []
    seen = set()
    for (rule, key), n in existing.items():
        entries.append({"rule": rule, "key": key, "note": n})
        seen.add((rule, key))
    for f in findings:
        if not f.suppressed and (f.rule, f.key) not in seen:
            entries.append({"rule": f.rule, "key": f.key, "note": note})
            seen.add((f.rule, f.key))
    entries.sort(key=lambda e: (e["rule"], e["key"]))
    p.write_text(json.dumps({"findings": entries}, indent=2) + "\n",
                 encoding="utf-8")
    return p


@dataclass
class LintResult:
    findings: list[Finding] = field(default_factory=list)
    rules_run: tuple = ()

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings
                if not f.suppressed and not f.baselined]

    @property
    def ok(self) -> bool:
        return not self.unsuppressed

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "rules": list(self.rules_run),
            "total": len(self.findings),
            "suppressed": sum(f.suppressed for f in self.findings),
            "baselined": sum(f.baselined for f in self.findings),
            "unsuppressed": len(self.unsuppressed),
            "findings": [f.to_dict() for f in self.findings],
        }

    def render_text(self) -> str:
        lines = []
        for f in sorted(self.findings,
                        key=lambda x: (x.rule, x.file, x.line)):
            tag = ("suppressed" if f.suppressed
                   else "baselined" if f.baselined else "FAIL")
            lines.append(f"[{f.rule}] {f.file}:{f.line} {tag}: "
                         f"{f.message}")
        lines.append(
            f"graftlint: {len(self.findings)} finding(s), "
            f"{len(self.unsuppressed)} unsuppressed "
            f"({sum(f.suppressed for f in self.findings)} suppressed, "
            f"{sum(f.baselined for f in self.findings)} baselined) "
            f"across {len(self.rules_run)} pass(es)")
        return "\n".join(lines)


def apply_suppressions(ctx: LintContext, findings: list[Finding],
                       baseline: dict[tuple, str]) -> None:
    """Mark findings suppressed (inline comment on the anchor line or
    the enclosing def line) or baselined (rule+key in the baseline)."""
    for f in findings:
        mod = ctx.modules.get(f.file)
        if mod is not None:
            if mod.suppressed_at(f.line, f.rule):
                f.suppressed = True
                continue
            # the enclosing def's line (decorated defs: any decorator
            # line too) may carry the suppression for the whole body
            for fn in ctx.functions:
                if fn.module is mod and hasattr(fn.node, "body") \
                        and fn.node.lineno <= f.line \
                        and f.line <= (fn.node.end_lineno or f.line):
                    anchor = [fn.node.lineno]
                    anchor += [d.lineno for d
                               in getattr(fn.node, "decorator_list", ())]
                    if any(mod.suppressed_at(a, f.rule) for a in anchor):
                        f.suppressed = True
                        break
            if f.suppressed:
                continue
        if (f.rule, f.key) in baseline:
            f.baselined = True
