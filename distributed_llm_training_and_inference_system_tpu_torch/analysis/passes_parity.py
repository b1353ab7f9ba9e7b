"""np-jnp-parity pass: the numpy twins track their torch counterparts.

The port's copy of the JAX package's pass, under JAX's rule id so a
finding names the same rule in both packages. The courier's wire codec
uses numpy twins of the nibble helpers of ``ops/quantization.py``: ONE
definition of the nibble/byte layout shared by the KV write path (torch
here, jnp in JAX) and the codec (numpy). The semantics pin is a runtime
test; this pass pins the SIGNATURES, so a drive-by parameter change on
one side fails at lint time instead of at the first cross-host transfer.

For every top-level ``*_np`` function in ``ops/quantization.py``:

- ``@np_host_only("reason")``     -> skipped (no torch counterpart by
  design: the delta filters only ever run host-side in the courier);
- ``@np_twin_of("torch_name")``   -> matched against that function;
- otherwise                        -> matched against the ``_np``-
  stripped name.

Signature match: same positional parameter names in order; the torch
side may take EXTRA trailing parameters only if they are defaulted;
shared defaulted parameters must have textually equal defaults.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, LintContext

RULE = "np-jnp-parity"

TARGET_MODULE = "ops/quantization.py"


def _top_level_functions(mod) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in mod.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _decorator_directive(node) -> tuple[Optional[str], Optional[str]]:
    """-> (twin_name, host_only_reason); at most one is set."""
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call):
            name = None
            if isinstance(dec.func, ast.Name):
                name = dec.func.id
            elif isinstance(dec.func, ast.Attribute):
                name = dec.func.attr
            arg = (dec.args[0].value
                   if dec.args and isinstance(dec.args[0], ast.Constant)
                   else None)
            if name == "np_twin_of" and isinstance(arg, str):
                return arg, None
            if name == "np_host_only":
                return None, str(arg) if arg is not None else ""
    return None, None


def _params(node) -> list[tuple[str, Optional[str]]]:
    """[(name, default_source|None)] for positional(-or-keyword) args."""
    args = node.args
    defaults = [None] * (len(args.args) - len(args.defaults)) \
        + [ast.unparse(d) for d in args.defaults]
    return [(a.arg, d) for a, d in zip(args.args, defaults)]


def run(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    mod = ctx.module(TARGET_MODULE)
    if mod is None:
        return [Finding(rule=RULE, file=TARGET_MODULE, line=1,
                        message=f"{TARGET_MODULE} not found",
                        key="missing-module")]
    funcs = _top_level_functions(mod)
    for name, node in sorted(funcs.items()):
        if not name.endswith("_np"):
            continue
        twin_name, host_reason = _decorator_directive(node)
        if host_reason is not None:
            continue        # no torch counterpart by design
        twin_name = twin_name or name[:-len("_np")]
        twin = funcs.get(twin_name)
        if twin is None:
            findings.append(Finding(
                rule=RULE, file=mod.relpath, line=node.lineno,
                message=(f"{name} has no torch counterpart {twin_name!r} "
                         f"in {TARGET_MODULE} — add it, point the twin "
                         f"elsewhere with @np_twin_of, or mark "
                         f"@np_host_only with a reason"),
                key=f"{name}:missing-twin:{twin_name}"))
            continue
        np_params = _params(node)
        j_params = _params(twin)
        for i, (pn, pd) in enumerate(np_params):
            if i >= len(j_params):
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=node.lineno,
                    message=(f"{name} takes parameter {pn!r} (pos {i}) "
                             f"but twin {twin_name} has only "
                             f"{len(j_params)} parameters"),
                    key=f"{name}:extra-param:{pn}"))
                continue
            jn, jd = j_params[i]
            if pn != jn:
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=node.lineno,
                    message=(f"{name} parameter {i} is {pn!r} but twin "
                             f"{twin_name} has {jn!r} — twins must "
                             f"signature-match"),
                    key=f"{name}:param-name:{i}:{pn}:{jn}"))
            elif pd != jd:
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=node.lineno,
                    message=(f"{name} parameter {pn!r} default {pd!r} "
                             f"!= twin {twin_name}'s {jd!r}"),
                    key=f"{name}:param-default:{pn}"))
        for jn, jd in j_params[len(np_params):]:
            if jd is None:
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=node.lineno,
                    message=(f"twin {twin_name} takes extra REQUIRED "
                             f"parameter {jn!r} absent from {name} — "
                             f"extra twin parameters must be "
                             f"defaulted"),
                    key=f"{name}:twin-extra-required:{jn}"))
    return findings
