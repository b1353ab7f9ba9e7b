"""graftlint over the port (``analysis/`` and ``admin lint``), held to the
JAX package's.

- The JAX package's ``tests/test_graftlint.py`` on the port's passes:
  seeded violations in ``tmp_path`` trees for every pass, suppressions,
  the baseline's notes, and the port's real tree clean with its
  annotation coverage. Left out, by name: ``test_cli_lint_exits_zero``,
  which drives JAX's click command; its port counterpart below drives
  ``llmctl-torch admin lint``.
- Findings equal by (rule, key): ``run_lint()`` over each package's own
  tree, and the port's passes against JAX's over the JAX tree, where the
  code is the same.
- The markers of ``serve/engine.py``, ``serve/kv_cache.py``,
  ``ops/quantization.py`` and ``serve/fleet/http.py`` carried across.
"""

import contextlib
import io
import json
from pathlib import Path

import pytest

from torch_fleet_harness import on_the_port

from distributed_llm_training_and_inference_system_tpu import (
    analysis as jlint)
from distributed_llm_training_and_inference_system_tpu.analysis import (
    core as jcore)
from distributed_llm_training_and_inference_system_tpu_torch import (
    analysis as tlint)
from distributed_llm_training_and_inference_system_tpu_torch.analysis import (
    core as tcore)
from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)

_ref = on_the_port("test_graftlint.py",
                   leave_out=("test_cli_lint_exits_zero",))
for _name, _obj in list(_ref.items()):
    if _name.startswith("Test") and isinstance(_obj, type):
        globals()[_name] = _obj

JAX_PKG = "distributed_llm_training_and_inference_system_tpu"
PORT_PKG = JAX_PKG + "_torch"
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ctxs():
    """Each package's tree parsed once: JAX's by JAX's core, the port's by
    the port's, and JAX's tree by the port's core."""
    return {"jax": jcore.LintContext(), "port": tcore.LintContext(),
            "jax_by_port": tcore.LintContext(package_root=REPO / JAX_PKG,
                                             repo_root=REPO)}


def _run(passes, ctx):
    findings = []
    for run in passes.values():
        findings.extend(run(ctx))
    return findings


def _keys(findings, pkg):
    """{(rule, key)} with the package directory's name taken out."""
    return {(f.rule, f.key.replace(f"{pkg}/", "<pkg>/"))
            for f in findings}


def test_findings_equal_to_jax_on_each_tree(ctxs):
    """Every pass on each package's own tree: the same (rule, key)
    findings, the baselined ones included (``run_lint()`` on each is
    clean); the port's baseline carries JAX's notes."""
    j = _run(jlint._passes(), ctxs["jax"])
    t = _run(tlint._passes(), ctxs["port"])
    assert j and _keys(t, PORT_PKG) == _keys(j, JAX_PKG)
    jnotes = jcore.load_baseline()
    for key, note in tcore.load_baseline().items():
        assert jnotes[key] == note


@pytest.mark.parametrize("rule", ["thread-context", "lock-discipline",
                                  "config-wiring", "np-jnp-parity"])
def test_port_passes_equal_jax_passes_on_the_same_code(rule, ctxs):
    """The port's pass and JAX's over one tree (the JAX package's): the
    same findings, line for line (counter-wiring reads its own package's
    registry, so it is compared on each tree above)."""
    j = jlint._passes()[rule](ctxs["jax"])
    t = tlint._passes()[rule](ctxs["jax_by_port"])
    assert sorted((f.rule, f.key, f.line) for f in t) == \
        sorted((f.rule, f.key, f.line) for f in j)


def _marked(ctx, suffix):
    return {(fn.qualname, m) for fn in ctx.functions
            if fn.module.relpath.endswith(suffix) for m in fn.marks}


@pytest.mark.parametrize("suffix", ["serve/engine.py", "serve/kv_cache.py"])
def test_engine_markers_carried(suffix, ctxs):
    """The JAX engine's and KV cache's ``@engine_thread_only`` functions
    are marked alike on the port (21 and 6)."""
    j = _marked(ctxs["jax"], suffix)
    t = _marked(ctxs["port"], suffix)
    assert t == j and len(j) == {"serve/engine.py": 21,
                                 "serve/kv_cache.py": 6}[suffix]


def test_parity_markers_carried():
    """``np_twin_of`` / ``np_host_only`` on the same ``*_np`` twins, with
    the same arguments."""
    import ast

    def directives(pkg):
        src = (REPO / pkg / "ops" / "quantization.py").read_text()
        out = {}
        for node in ast.parse(src).body:
            if isinstance(node, ast.FunctionDef) and node.decorator_list:
                out[node.name] = [ast.unparse(d) for d in node.decorator_list]
        return out
    j, t = directives(JAX_PKG), directives(PORT_PKG)
    assert len(j) == 6 and t == j


def test_http_handlers_are_roots(ctxs):
    """Every route of the port's fleet front runs through a marked
    handler: a root of the thread pass, as JAX's 16 aiohttp handlers."""
    from distributed_llm_training_and_inference_system_tpu_torch.serve.\
        fleet import http as thttp
    j = _marked(ctxs["jax"], "serve/fleet/http.py")
    t = _marked(ctxs["port"], "serve/fleet/http.py")
    assert len(j) == 16 and len(t) >= 16
    srv = thttp.FleetServer.__new__(thttp.FleetServer)
    for route in srv.routes().values():
        assert "aiohttp_handler" in route.__graftlint__, route


def test_cli_lint_exits_zero(tmp_path):
    """``llmctl-torch admin lint`` end to end: the JSON report with the
    five passes, 0 unsuppressed; without the baseline the deliberate
    findings surface as JAX's text lines and it exits 1."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tmain.main(["admin", "lint", "--format", "json"]) == 0
    payload = json.loads(buf.getvalue())
    assert payload["ok"] is True and payload["unsuppressed"] == 0
    assert set(payload["rules"]) == {
        "thread-context", "lock-discipline", "counter-wiring",
        "config-wiring", "np-jnp-parity"}
    assert sorted(payload) == ["baselined", "findings", "ok", "rules",
                               "suppressed", "total", "unsuppressed"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tmain.main(["admin", "lint", "--baseline",
                           str(tmp_path / "none.json")]) == 1
    lines = buf.getvalue().splitlines()
    n = payload["total"]
    assert lines[-1] == (f"graftlint: {n} finding(s), {n} unsuppressed "
                         f"across 5 pass(es)")
    assert len(lines) == n + 1
    assert all(ln.startswith("[config-wiring] ") and " FAIL: " in ln
               for ln in lines[:-1])
