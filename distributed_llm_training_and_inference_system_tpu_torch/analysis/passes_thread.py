"""thread-context pass: no handler/poll path reaches engine-only code.

The port's copy of the JAX package's pass. Donated KV page buffers and
mid-dispatch engine state are only coherent ON the engine's stepping
thread at loop boundaries. Supervisor polls and HTTP request handlers
therefore may only reach ``@engine_thread_only`` functions through a
``@thread_seam``: a function that enqueues work for the engine thread
(``request_prefix_extract``, ``request_drain``), reads lock-free advisory
state (``outstanding_tokens``), or holds the engine lock for a bounded
host-only section (``submit``).

The port has no aiohttp. Its fleet front, workers and store members
answer on ``http.server.ThreadingHTTPServer`` through ``worker.py``'s JSON
router, one request thread per connection. Such a handler is a foreign
thread exactly as an aiohttp handler is to the JAX engine, so the port
keeps the marker name: ``@aiohttp_handler`` on a port function means
"runs on an HTTP request thread", and it is a root here as in JAX
(``ROOT_MARKS``). Keeping the name keeps the rule's messages and keys
equal in the two packages. Every route the JAX front marks is a marked
method of the port's ``serve/fleet/http.py``.

Mechanics: a best-effort lexical call graph. From every root
(``@supervisor_thread`` / ``@aiohttp_handler`` function) we walk calls:

- ``f(...)``            -> the same-module top-level function ``f``
- ``self.m(...)``       -> method ``m`` of the lexically enclosing class
- ``mod.f(...)``        -> function ``f`` of the imported module ``mod``
  (import aliases resolved per module)
- ``<expr>.m(...)``     -> resolved BY NAME, but only against ANNOTATED
  functions: if any indexed ``@engine_thread_only`` function is named
  ``m`` the path is a finding; a seam by that name stops traversal;
  unannotated names produce no edge (an under-approximation).

Traversal stops at seams and never descends into an engine-thread-only
body (the finding IS the arrival). Findings anchor at the offending
call site, with the root-to-target path in the message.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, FunctionInfo, LintContext

RULE = "thread-context"

ROOT_MARKS = ("supervisor_thread", "aiohttp_handler")


def _import_aliases(mod) -> dict[str, str]:
    """{local_name: module_basename} for ``import x``/``from . import x``
    statements, so ``migration.precopy_slot(...)`` resolves exactly."""
    out: dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = \
                    a.name.split(".")[-1]
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def _calls_of(fn: FunctionInfo) -> list[ast.Call]:
    return [n for n in ast.walk(fn.node) if isinstance(n, ast.Call)]


class _Graph:
    def __init__(self, ctx: LintContext):
        self.ctx = ctx
        self._aliases = {id(m): _import_aliases(m)
                         for m in ctx.modules.values()}
        # (module relpath, qualname) -> FunctionInfo
        self.by_qual = {(f.module.relpath, f.qualname): f
                        for f in ctx.functions}
        # per-module: top-level functions and class methods by name
        self.mod_funcs: dict[str, dict[str, FunctionInfo]] = {}
        self.cls_methods: dict[tuple, dict[str, FunctionInfo]] = {}
        for f in ctx.functions:
            if "." not in f.qualname:
                self.mod_funcs.setdefault(
                    f.module.relpath, {})[f.name] = f
            elif f.cls is not None \
                    and f.qualname == f"{f.cls}.{f.name}":
                self.cls_methods.setdefault(
                    (f.module.relpath, f.cls), {})[f.name] = f

    def resolve(self, caller: FunctionInfo, call: ast.Call
                ) -> tuple[Optional[FunctionInfo], Optional[str]]:
        """-> (exact target | None, by-name method | None)."""
        fn = call.func
        if isinstance(fn, ast.Name):
            target = self.mod_funcs.get(
                caller.module.relpath, {}).get(fn.id)
            return target, None
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls") \
                    and caller.cls is not None:
                target = self.cls_methods.get(
                    (caller.module.relpath, caller.cls), {}).get(fn.attr)
                if target is not None:
                    return target, None
                return None, fn.attr
            if isinstance(recv, ast.Name):
                alias = self._aliases[id(caller.module)].get(recv.id)
                if alias is not None:
                    for rel, funcs in self.mod_funcs.items():
                        if rel.endswith(f"/{alias}.py") and fn.attr in funcs:
                            return funcs[fn.attr], None
            return None, fn.attr
        return None, None


def run(ctx: LintContext) -> list[Finding]:
    graph = _Graph(ctx)
    findings: list[Finding] = []
    roots = [f for f in ctx.functions
             if any(m in f.marks for m in ROOT_MARKS)]

    def by_name_marked(name: str, mark: str) -> Optional[FunctionInfo]:
        for cand in ctx.by_name.get(name, ()):
            if mark in cand.marks:
                return cand
        return None

    for root in roots:
        # DFS with an explicit path; visited is per-root so every root
        # reports its own reach (paths stay explainable)
        stack = [(root, (root,))]
        visited = {(root.module.relpath, root.qualname)}
        while stack:
            fn, path = stack.pop()
            for call in _calls_of(fn):
                target, attr = graph.resolve(fn, call)
                if target is not None:
                    if "engine_thread_only" in target.marks:
                        findings.append(_finding(root, path, fn, call,
                                                 target))
                        continue
                    if "thread_seam" in target.marks:
                        continue
                    key = (target.module.relpath, target.qualname)
                    if key not in visited:
                        visited.add(key)
                        stack.append((target, path + (target,)))
                elif attr is not None:
                    hit = by_name_marked(attr, "engine_thread_only")
                    if hit is not None \
                            and by_name_marked(attr, "thread_seam") is None:
                        findings.append(_finding(root, path, fn, call,
                                                 hit))
    return findings


def _finding(root: FunctionInfo, path: tuple, caller: FunctionInfo,
             call: ast.Call, target: FunctionInfo) -> Finding:
    chain = " -> ".join(p.qualname for p in path)
    if caller is not path[-1]:
        chain += f" -> {caller.qualname}"
    return Finding(
        rule=RULE,
        file=caller.module.relpath,
        line=call.lineno,
        message=(f"{root.marks and sorted(root.marks)[0]} root "
                 f"'{root.qualname}' reaches @engine_thread_only "
                 f"'{target.qualname}' ({target.module.relpath}) "
                 f"outside any @thread_seam (path: {chain})"),
        key=f"{root.module.relpath}:{root.qualname}->"
            f"{target.module.relpath}:{target.qualname}",
    )
