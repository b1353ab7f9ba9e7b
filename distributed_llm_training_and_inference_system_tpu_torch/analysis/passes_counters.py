"""counter-wiring pass: every total_* counter flows to its snapshot.

The port's copy of the JAX package's pass, reading the port's registry
(``metrics/names.py``) and exporter (``metrics/observability.py``). A
``total_*`` running counter on the engine/supervisor must surface through
that class's snapshot function (``InferenceEngine.stats`` /
``ReplicaSupervisor.snapshot``) so probes, ``/fleet/status`` and the
Prometheus delta pump can all read it.

Checks, driven by the declared registry:

1. every ``self.total_* = <number>`` attribute AST-discovered in a
   registered owner class appears in :data:`~..metrics.names.COUNTER_FLOW`
   or, for a counter of the port's own engine features, in
   ``PORT_COUNTER_FLOW`` (unregistered counter: wire it or declare it);
2. each registered counter's ``snapshot_key`` appears as a string
   constant inside the owner's snapshot function;
3. each registered counter's declared Prometheus name (when not None)
   is a key of :data:`~..metrics.names.METRICS`;
4. every ``llmctl_*`` name literal anywhere in the package is a
   registered metric name (no off-registry metric strings);
5. every registered metric name appears as a literal in
   ``metrics/observability.py`` (a deleted exporter line fails here);
6. stale registry rows (attribute no longer defined) are flagged too.
"""

from __future__ import annotations

import ast

from ..metrics import names as reg
from .core import Finding, LintContext

RULE = "counter-wiring"


def _class_node(mod, cls_name):
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return node
    return None


def _self_total_assigns(cls_node) -> dict[str, int]:
    """{attr: first lineno} of ``self.total_* = <constant>`` stores
    anywhere in the class body (init or reset paths)."""
    out: dict[str, int] = {}
    for node in ast.walk(cls_node):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self" \
                    and t.attr.startswith("total_"):
                out.setdefault(t.attr, t.lineno)
    return out


def _function_node(cls_node, name):
    for node in cls_node.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _string_constants(node) -> set[str]:
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def run(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    flow_by_owner: dict[str, dict[str, reg.CounterFlow]] = {}
    for f in reg.COUNTER_FLOW + reg.PORT_COUNTER_FLOW:
        flow_by_owner.setdefault(f.owner, {})[f.attr] = f

    for owner, (mod_suffix, snap_name) in reg.COUNTER_SNAPSHOT_FN.items():
        mod = ctx.module(mod_suffix)
        if mod is None:
            findings.append(Finding(
                rule=RULE, file=mod_suffix, line=1,
                message=f"registry names module {mod_suffix} for "
                        f"{owner} but it does not exist",
                key=f"missing-module:{owner}:{mod_suffix}"))
            continue
        cls = _class_node(mod, owner)
        if cls is None:
            findings.append(Finding(
                rule=RULE, file=mod.relpath, line=1,
                message=f"registry names class {owner} in "
                        f"{mod.relpath} but it does not exist",
                key=f"missing-class:{owner}"))
            continue
        declared = flow_by_owner.get(owner, {})
        discovered = _self_total_assigns(cls)
        snap_fn = _function_node(cls, snap_name)
        snap_keys = (_string_constants(snap_fn)
                     if snap_fn is not None else set())
        if snap_fn is None:
            findings.append(Finding(
                rule=RULE, file=mod.relpath, line=cls.lineno,
                message=f"{owner} has no snapshot function "
                        f"{snap_name}() for its counters",
                key=f"missing-snapshot-fn:{owner}.{snap_name}"))
        for attr, lineno in sorted(discovered.items()):
            flow = declared.get(attr)
            if flow is None:
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=lineno,
                    message=(f"{owner}.{attr} is not declared in "
                             f"metrics/names.py COUNTER_FLOW — every "
                             f"total_* counter must declare its "
                             f"snapshot key (and Prometheus name or "
                             f"None)"),
                    key=f"unregistered-counter:{owner}.{attr}"))
                continue
            if snap_fn is not None and flow.snapshot_key not in snap_keys:
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=lineno,
                    message=(f"{owner}.{attr} declares snapshot key "
                             f"{flow.snapshot_key!r} but "
                             f"{owner}.{snap_name}() never emits it — "
                             f"the counter is invisible to probes/"
                             f"status/Prometheus"),
                    key=f"counter-not-in-snapshot:{owner}.{attr}"))
            if flow.metric is not None and flow.metric not in reg.METRICS:
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=lineno,
                    message=(f"{owner}.{attr} maps to Prometheus name "
                             f"{flow.metric!r} which is not in the "
                             f"METRICS registry"),
                    key=f"unknown-metric:{owner}.{attr}:{flow.metric}"))
        for attr, flow in sorted(declared.items()):
            if attr not in discovered:
                findings.append(Finding(
                    rule=RULE, file=mod.relpath, line=cls.lineno,
                    message=(f"COUNTER_FLOW declares {owner}.{attr} but "
                             f"no such attribute is assigned in the "
                             f"class — stale registry row"),
                    key=f"stale-registry-row:{owner}.{attr}"))

    # package-wide metric-name literal cross-check (both directions).
    # Only WELL-FORMED metric names count ("llmctl_" + word chars, the
    # whole constant) — docstrings merely mentioning the prefix, and
    # the linter's own sources, are not metric references.
    import re
    metric_re = re.compile(r"^llmctl_[a-z0-9_]+$")
    obs = ctx.module("metrics/observability.py")
    obs_literals: set[str] = set()
    registry_mod = ctx.module("metrics/names.py")
    for rel, mod in ctx.modules.items():
        if registry_mod is not None and mod is registry_mod:
            continue        # the registry defines the names
        if "/analysis/" in f"/{rel}":
            continue        # the linter talks ABOUT names, not to them
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and metric_re.match(node.value):
                name = node.value
                if mod is obs:
                    obs_literals.add(name)
                base = (name[:-len("_total")]
                        if name.endswith("_total") else name)
                if name not in reg.METRICS and base not in reg.METRICS:
                    findings.append(Finding(
                        rule=RULE, file=rel, line=node.lineno,
                        message=(f"metric name literal {name!r} is not "
                                 f"in the metrics/names.py registry"),
                        key=f"literal-off-registry:{rel}:{name}"))
    if obs is not None:
        for name in sorted(reg.METRICS):
            if name not in obs_literals:
                findings.append(Finding(
                    rule=RULE, file=obs.relpath, line=1,
                    message=(f"registered metric {name!r} is never "
                             f"referenced in metrics/observability.py "
                             f"— registry entries must be constructed "
                             f"by the exporter"),
                    key=f"registered-not-constructed:{name}"))
    return findings
