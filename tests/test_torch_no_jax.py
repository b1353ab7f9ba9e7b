"""The port and chip_smoke.py never import JAX, the JAX package, optax,
ml_dtypes or safetensors, nor what the card machine lacks of the JAX
CLI's and metrics' packages: click, rich, psutil, prometheus_client,
aiohttp and opentelemetry. The one exception is ``OTLPExporter``'s lazy
``opentelemetry`` import (``metrics/observability.py``), made only when
an OTLP endpoint is asked for."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = "distributed_llm_training_and_inference_system_tpu_torch"
# JAX and its package, and what the card machine lacks: optax,
# ml_dtypes, safetensors, and the JAX CLI's and metrics' packages
FORBIDDEN = {"jax", "jaxlib", "distributed_llm_training_and_inference_system_tpu",
             "optax", "ml_dtypes", "safetensors", "click", "rich", "psutil",
             "prometheus_client", "aiohttp", "opentelemetry"}
# (port file, package) -> the one function allowed to import it lazily
LAZY_EXCEPTIONS = {("metrics/observability.py", "opentelemetry"):
                   "OTLPExporter.__init__"}
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


def _allowed(path: Path) -> set:
    rel = str(path.relative_to(ROOT / PORT)) if PORT in path.parts else ""
    return {pkg for (f, pkg) in LAZY_EXCEPTIONS if f == rel}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert path.is_file()
    bad = _imported_top_levels(path) & FORBIDDEN - _allowed(path)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_lazy_opentelemetry_import_is_the_one_exception():
    """opentelemetry is imported in OTLPExporter.__init__ and nowhere else
    in the file: not at module level, not in another function."""
    for (rel, pkg), where in LAZY_EXCEPTIONS.items():
        tree = ast.parse((ROOT / PORT / rel).read_text())
        cls_name, fn_name = where.split(".")
        found = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for fn in node.body:
                    if isinstance(fn, ast.FunctionDef):
                        for sub in ast.walk(fn):
                            if isinstance(sub, ast.ImportFrom) and (
                                    sub.module or "").split(".")[0] == pkg:
                                found.append((node.name, fn.name))
        assert found and set(found) == {(cls_name, fn_name)}, found
        top = {n.module.split(".")[0] for n in tree.body
               if isinstance(n, ast.ImportFrom) and n.module}
        top |= {a.name.split(".")[0] for n in tree.body
                if isinstance(n, ast.Import) for a in n.names}
        assert pkg not in top


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


OPERATOR_MODULES = ("io/remote.py", "io/native.py", "io/data.py",
                    "plugins/__init__.py", "plugins/autotuning.py",
                    "cli/commands/bench.py", "cli/commands/trace.py",
                    "cli/commands/replay.py", "cli/commands/tune.py",
                    "cli/commands/admin.py", "runtime/engine.py")


@pytest.mark.parametrize("module", OPERATOR_MODULES)
def test_walk_covers_the_operator_modules(module):
    """The walk above reaches the operator's tools, plugins/ included, and
    none of them imports from the JAX package by a relative path either."""
    names = {str(p.relative_to(ROOT / PORT)) for p in SOURCES[:-1]}
    assert module in names
    tree = ast.parse((ROOT / PORT / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert "distributed_llm_training_and_inference_system_tpu" \
                not in (node.module or "")


def test_native_source_is_the_ports_own_copy():
    """native/ holds the packer's C++ source (no Python, no JAX) and no
    built library: io/native.py builds it under build/native/."""
    native = ROOT / PORT / "native"
    assert sorted(p.name for p in native.iterdir()
                  if p.name != "__pycache__") == ["dataloader.cpp"]
    src = (native / "dataloader.cpp").read_text()
    includes = [line for line in src.splitlines()
                if line.startswith("#include")]
    assert includes == ["#include <cstdint>", "#include <cstring>"]
    assert "Python.h" not in src


FRONT_SCRIPT = """
import sys, torch
for m in ("jax", "jaxlib", "aiohttp", "click", "rich",
          "distributed_llm_training_and_inference_system_tpu"):
    sys.modules[m] = None
def _touched(*a, **k):
    raise AssertionError("the front touched CUDA")
torch.cuda._lazy_init = _touched
torch.cuda.init = _touched
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config)
from distributed_llm_training_and_inference_system_tpu_torch.config.schema \\
    import FleetConfig
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet.http \\
    import FleetServer
srv = FleetServer(
    get_model_config("gpt-test"),
    ServeConfig(model="gpt-test", host="127.0.0.1", port=0),
    FleetConfig(replicas=2, remote_replicas="0,1", fleet_endpoints={
        0: "http://127.0.0.1:9", 1: "http://127.0.0.1:10"},
        state_store="file", state_store_dir=sys.argv[1], fronts=2))
srv.start()
srv.fleet.status()
srv.stop()
assert not torch.cuda.is_initialized()
print("no cuda")
"""


def test_a_front_of_remote_replicas_never_initialises_cuda(tmp_path):
    """A ``FleetServer`` whose replicas are all remote holds no model: with
    JAX and aiohttp blocked and CUDA's initialisers made to fail, it
    starts, snapshots and stops, and CUDA stays uninitialised."""
    res = subprocess.run([sys.executable, "-c", FRONT_SCRIPT, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "no cuda"


STORE_MODULES = ("serve/fleet/kv_store.py", "serve/fleet/store_tier.py",
                 "serve/fleet/store_service.py", "serve/fleet/weights.py",
                 "serve/fleet/autoscaler.py")


@pytest.mark.parametrize("module", STORE_MODULES)
def test_walk_covers_the_store_tier_modules(module):
    """The walk above reaches the store tier and the autoscaler, and none
    of them imports aiohttp or the JAX package, relative imports
    included."""
    names = {str(p.relative_to(ROOT / PORT)) for p in SOURCES[:-1]}
    assert module in names
    tree = ast.parse((ROOT / PORT / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert "distributed_llm_training_and_inference_system_tpu" \
                not in (node.module or "")
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(m.split(".")[0] == "aiohttp" for m in mods)


STORE_SCRIPT = """
import sys, torch
import numpy as np
for m in ("jax", "jaxlib", "aiohttp", "click", "rich", "ml_dtypes",
          "distributed_llm_training_and_inference_system_tpu"):
    sys.modules[m] = None
def _touched(*a, **k):
    raise AssertionError("the store touched CUDA")
torch.cuda._lazy_init = _touched
torch.cuda.init = _touched
from distributed_llm_training_and_inference_system_tpu_torch.config.schema \\
    import FleetConfig
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet \\
    import store_service as svc_mod, weights as wmod
from distributed_llm_training_and_inference_system_tpu_torch.serve.fleet \\
    .transport import CourierReceiver
from distributed_llm_training_and_inference_system_tpu_torch.serve \\
    .kv_cache import BF16_HOST
cfg = FleetConfig(kv_store=True, courier_chunk_bytes=1024)
svc = svc_mod.StoreService(cfg, member_id="m0", membership_dir=sys.argv[1])
ep = "http://127.0.0.1:%d" % svc.serve_http("127.0.0.1", 0)
client = svc_mod.StoreClient(FleetConfig(kv_store_endpoint=ep))
bits = np.arange(2 * 1 * 2 * 8 * 16, dtype=np.uint16).reshape(2, 1, 2, 8, 16)
page = {"k": bits.view(BF16_HOST), "v": bits.view(BF16_HOST),
        "num_pages": 1}
assert client.demote([b"h" * 16], page) == 1
out = client.fetch([b"h" * 16], CourierReceiver())
assert out["pages"]["k"].dtype == BF16_HOST
assert (out["pages"]["k"].view(np.uint16) == bits).all()
tree = {"embed": {"embedding": bits.view(BF16_HOST).reshape(-1, 16)}}
wc = wmod.WeightCourier(cfg, endpoint=ep)
assert wc.ship("w", tree)["members"] == 1
back = wc.fetch("w")["embed"]["embedding"]
assert back.dtype == BF16_HOST and (back.view(np.uint16) == bits.reshape(
    -1, 16)).all()
svc.stop()
assert not torch.cuda.is_initialized()
print("no cuda")
"""


def test_the_store_service_never_initialises_cuda(tmp_path):
    """The store service holds no tensor: with JAX, aiohttp and ml_dtypes
    blocked and CUDA's initialisers made to fail, a member serves a bf16
    page and a bf16 checkpoint to the port's client and weight courier,
    and CUDA stays uninitialised."""
    res = subprocess.run([sys.executable, "-c", STORE_SCRIPT, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "no cuda"
