"""lock-discipline pass: nothing slow or blocking inside a lock body.

The port's copy of the JAX package's pass. Every lock in the serve tree
guards HOST bookkeeping only (the engine lock is never held across device
work). Inside any ``with <...lock...>:`` body there must be no

- ``await`` (an event-loop coroutine parking while it holds a thread
  lock starves every engine/supervisor thread contending for it),
- ``time.sleep`` / bare ``sleep`` calls,
- socket / urllib / http.client / requests I/O calls (the port's fleet
  talks HTTP through ``urllib`` and ``http.client``; ``aiohttp.`` stays in
  the list so the rule reads the same in both packages, and matches
  nothing here),
- courier ``transfer()`` / ``ship()`` calls (a chunked, retrying,
  deadline-bounded network push: seconds under fault injection).

Lexical scope only: nested ``def``/``lambda`` bodies are excluded (a
callback DEFINED under a lock is not CALLED under it). Lock detection
is by name: any context-manager expression whose source mentions "lock"
(``self.lock``, ``eng.lock``, ``self._state_lock``...).
"""

from __future__ import annotations

import ast
import re

from .core import Finding, LintContext

RULE = "lock-discipline"

_LOCK_RE = re.compile(r"lock", re.I)

# dotted-source fragments that mean blocking I/O when CALLED
_IO_FRAGMENTS = ("urlopen", "urllib.", "requests.", "socket.",
                 "http.client", "aiohttp.")
_BLOCKING_ATTRS = {"sleep", "transfer", "ship"}


def _with_lock_items(node):
    for item in node.items:
        try:
            src = ast.unparse(item.context_expr)
        except Exception:       # pragma: no cover - unparse is total in 3.9+
            continue
        if _LOCK_RE.search(src):
            return src
    return None


def _body_nodes(with_node):
    """Every AST node lexically inside the with body, excluding nested
    function/lambda bodies and nested classes."""
    out = []
    stack = list(with_node.body)
    while stack:
        n = stack.pop()
        out.append(n)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return out


def _offense(node) -> str | None:
    if isinstance(node, ast.Await):
        return "await expression"
    if isinstance(node, ast.Call):
        try:
            src = ast.unparse(node.func)
        except Exception:       # pragma: no cover
            return None
        attr = src.rsplit(".", 1)[-1]
        if attr in _BLOCKING_ATTRS:
            return f"blocking call {src}()"
        if any(f in src for f in _IO_FRAGMENTS):
            return f"network I/O call {src}()"
    return None


def run(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for rel, mod in ctx.modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_src = _with_lock_items(node)
            if lock_src is None:
                continue
            for inner in _body_nodes(node):
                why = _offense(inner)
                if why is None:
                    continue
                try:
                    what = ast.unparse(inner)[:60]
                except Exception:       # pragma: no cover
                    what = why
                findings.append(Finding(
                    rule=RULE, file=rel, line=inner.lineno,
                    message=(f"{why} inside `with {lock_src}:` "
                             f"(code: {what!r}) — lock bodies must be "
                             f"bounded host-only sections"),
                    key=f"{rel}:{lock_src}:{why}:{what[:40]}",
                ))
    return findings
