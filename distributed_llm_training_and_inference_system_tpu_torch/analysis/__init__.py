"""graftlint over the port's own tree: AST checks of the serving fleet's
contracts (``llmctl-torch admin lint``; also a tier-1 test).

The port's copy of the JAX package's ``analysis/``, with its five passes
and rule ids:

- ``thread-context``  — no supervisor-poll / HTTP-request-thread call
  path reaches an ``@engine_thread_only`` function except through a
  ``@thread_seam`` (``passes_thread.py`` says why the port keeps the
  ``@aiohttp_handler`` name for its ThreadingHTTPServer handlers).
- ``lock-discipline`` — no ``await``, ``time.sleep``, socket/urllib/
  http.client I/O, or courier ``transfer()``/``ship()`` lexically inside
  a ``with <lock>:`` body.
- ``counter-wiring``  — every ``total_*`` counter flows through its
  snapshot function and maps to a registered Prometheus name (or a
  declared None), per the port's ``metrics/names.py``.
- ``config-wiring``   — every ``ServeConfig``/``FleetConfig`` field has
  a CLI flag in the port's commands and a USER_GUIDE mention.
- ``np-jnp-parity``   — every ``*_np`` twin in ``ops/quantization.py``
  signature-matches its torch counterpart.

Suppress one finding with ``# graftlint: ignore[rule-id]`` on the
offending (or enclosing ``def``) line; grandfather deliberate findings
in ``analysis/baseline.json`` with a note. ``run_lint()`` is the
programmatic entry; it is stdlib-only (no torch import) and reads the
tree as text, so it runs wherever the repository parses.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

from .annotations import (aiohttp_handler, engine_thread_only,
                          np_host_only, np_twin_of, supervisor_thread,
                          thread_seam)
from .core import (Finding, LintContext, LintResult, RULE_IDS,
                   apply_suppressions, default_baseline_path,
                   load_baseline, write_baseline)

__all__ = [
    "Finding",
    "LintContext",
    "LintResult",
    "RULE_IDS",
    "aiohttp_handler",
    "default_baseline_path",
    "engine_thread_only",
    "np_host_only",
    "np_twin_of",
    "run_lint",
    "supervisor_thread",
    "thread_seam",
    "write_baseline",
]


def _passes():
    from . import (passes_config, passes_counters, passes_lock,
                   passes_parity, passes_thread)
    return {
        "thread-context": passes_thread.run,
        "lock-discipline": passes_lock.run,
        "counter-wiring": passes_counters.run,
        "config-wiring": passes_config.run,
        "np-jnp-parity": passes_parity.run,
    }


def run_lint(package_root: Optional[Path] = None,
             repo_root: Optional[Path] = None,
             rules: Optional[Sequence[str]] = None,
             baseline_path: Optional[Path] = None) -> LintResult:
    """Run the selected passes (default: all) over the package tree and
    return a :class:`LintResult` with suppressions/baseline applied."""
    passes = _passes()
    selected = tuple(rules) if rules else tuple(passes)
    unknown = [r for r in selected if r not in passes]
    if unknown:
        raise ValueError(
            f"unknown graftlint rule(s) {unknown}; known: {RULE_IDS}")
    ctx = LintContext(package_root=package_root, repo_root=repo_root)
    baseline = load_baseline(baseline_path)
    findings: list[Finding] = []
    for rule in selected:
        findings.extend(passes[rule](ctx))
    apply_suppressions(ctx, findings, baseline)
    return LintResult(findings=findings, rules_run=selected)
