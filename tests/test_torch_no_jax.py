"""The port and chip_smoke.py never import JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = "distributed_llm_training_and_inference_system_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "distributed_llm_training_and_inference_system_tpu"}
SOURCES = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert path.is_file()
    bad = _imported_top_levels(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (ROOT / PORT).rglob("*.py"))
    code = (
        "import sys, importlib\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_walk_covers_the_quantized_serving_modules():
    names = {str(p.relative_to(ROOT / PORT)) for p in SOURCES[:-1]}
    for module in ("ops/quantization.py", "ops/int4_matmul.py",
                   "ops/int8_matmul.py", "ops/rmsnorm.py",
                   "ops/paged_attention_cuda.py", "profile_decode.py"):
        assert module in names


def test_quantization_keeps_its_own_numpy_helpers():
    """The JAX module takes its numpy-twin markers from the JAX package's
    ``analysis.annotations``; the port's copy defines the helpers plainly
    and imports nothing of that name, relative imports included."""
    path = ROOT / PORT / "ops" / "quantization.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert "annotations" not in (node.module or "")
            assert "analysis" not in (node.module or "")
            assert node.level == 0, "quantization.py imports from the package"
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"delta_encode_planes_np", "delta_decode_planes_np",
            "unpack_nibbles_np", "pack_nibbles_np", "nibble_delta_encode_np",
            "nibble_delta_decode_np"} <= defined
