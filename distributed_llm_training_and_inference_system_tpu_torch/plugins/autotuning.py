"""Kernel autotuning by measurement (the JAX package's
``plugins/autotuning.py``).

The same classes, search and cache as the JAX module, over the port's own
knobs:

- ``MatMulTuner``: ``dtype`` x ``precision`` x ``accum_dtype``, the JAX
  space and ``validate``. ``precision`` sets
  ``torch.set_float32_matmul_precision`` ("default" is "medium" on a card,
  where fp32 products may run in bf16 passes, and "highest" on the CPU;
  "high" is TF32; "highest" is full fp32); ``accum_dtype="bfloat16"``
  allows cuBLAS's reduced-precision bf16 reductions
  (``allow_bf16_reduced_precision_reduction``) and "float32" forbids
  them. The product ``build`` returns sets both process-wide settings for
  itself and restores them after, also when it raises.
- ``AttentionTuner``: ``impl`` "xla" is the plain masked attention
  (``models/layers.dot_product_attention``), "flash" is
  ``ops/attention.flash_attention``, the hand-written CUDA kernels. The
  kernels' tiles are fixed (they ignore ``block_q``/``block_k``), so
  ``validate`` pins both implementations to one block pair, and flash is
  valid only on a card (as the JAX module allows its Pallas kernel only
  on a TPU) at the head dims its kernels are built for.
- ``AutoTuner``: grid search with timeout and patience (unlike the JAX
  module's, a trial that raises fails the search: a flash kernel that
  does not build or launch must not leave the plain attention as the
  cached best; what an op refuses by shape or dtype ``validate`` leaves
  out up front), a results cache
  keyed as the JAX module keys it (``matmul_{m}x{k}x{n}_{backend}``,
  backend "gpu" on a card and "cpu" on the CPU) and ``save_results`` /
  ``load_results`` in the JAX module's JSON, so each reads the other's
  cache.
- ``CollectiveTuner``: pattern x chunking x dtype over a live mesh axis,
  each trial ``comms/bench.bench_collective`` over the axis (every member
  of it runs the same search together). Its trials and its timeout are
  agreed over the axis (the slowest member's latency, any member's
  timeout), so every member takes the same path through the grid.

Every time comes from ``utils/timing.time_fn`` (CUDA events on a card).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import torch

from ..device import resolve_device

logger = logging.getLogger("llmctl.autotuning")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def backend_name(device: torch.device) -> str:
    """The cache keys' backend: "gpu" on a card (as ``jax.default_backend``
    names a GPU), else the device type."""
    return "gpu" if device.type == "cuda" else device.type


@dataclass
class TuningConfig:
    max_iterations: int = 64
    timeout_seconds: float = 120.0
    num_warmup: int = 2
    num_trials: int = 5
    convergence_patience: int = 16   # stop after N configs with no gain


@dataclass
class TuningResult:
    best_params: dict[str, Any]
    best_latency_ms: float
    improvement_pct: float           # vs the first valid config measured
    num_evaluated: int
    all_results: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "best_params": self.best_params,
            "best_latency_ms": self.best_latency_ms,
            "improvement_pct": self.improvement_pct,
            "num_evaluated": self.num_evaluated,
            "all_results": self.all_results,
        }


class Tunable(ABC):
    """A benchmarkable operation with a discrete parameter space."""

    name: str = "tunable"
    device: torch.device

    @abstractmethod
    def parameter_space(self) -> dict[str, list]:
        ...

    def validate(self, params: dict[str, Any]) -> bool:
        return True

    def agree(self, flag: bool) -> bool:
        """A search decision taken on one process (a timeout): what the
        processes that search together decide (this one's alone here)."""
        return flag

    @abstractmethod
    def build(self, params: dict[str, Any]):
        """Return (fn, args): a callable and its inputs."""
        ...

    def benchmark(self, params: dict[str, Any], warmup: int,
                  trials: int) -> float:
        """Best-window mean latency in ms (CUDA events on a card)."""
        from ..utils.timing import time_fn
        fn, args = self.build(params)
        return time_fn(fn, *args, warmup=warmup, iters=trials,
                       device=self.device) * 1e3


@contextlib.contextmanager
def matmul_settings(precision: str, accum_dtype: str, device: torch.device):
    """The process-wide matmul settings of one MatMulTuner trial, restored
    on exit (also when the trial raises)."""
    old_prec = torch.get_float32_matmul_precision()
    old_red = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    mode = {"default": "medium" if device.type == "cuda" else "highest",
            "high": "high", "highest": "highest"}[precision]
    try:
        torch.set_float32_matmul_precision(mode)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            accum_dtype == "bfloat16")
        yield
    finally:
        torch.set_float32_matmul_precision(old_prec)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            old_red)


class MatMulTuner(Tunable):
    """Tune an (M,K)x(K,N) matmul: dtype, fp32 matmul precision and the
    reduction's precision."""

    name = "matmul"

    def __init__(self, m: int, k: int, n: int, seed: int = 0, device=None):
        self.m, self.k, self.n = m, k, n
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._a32 = torch.randn((m, k), generator=gen, device=self.device)
        self._b32 = torch.randn((k, n), generator=gen, device=self.device)

    def parameter_space(self) -> dict[str, list]:
        return {
            "dtype": ["bfloat16", "float32"],
            "precision": ["default", "high", "highest"],
            "accum_dtype": ["float32", "bfloat16"],
        }

    def validate(self, params: dict[str, Any]) -> bool:
        # fp32 inputs with bf16 accumulation is a pointless downcast
        return not (params["dtype"] == "float32"
                    and params["accum_dtype"] == "bfloat16")

    def build(self, params: dict[str, Any]):
        dt = _DTYPES[params["dtype"]]
        accum = _DTYPES[params["accum_dtype"]]
        a, b = self._a32.to(dt), self._b32.to(dt)

        def fn(x, y):
            # the trial's settings hold for this product only (as the JAX
            # module bakes its precision into the jitted product)
            with matmul_settings(params["precision"], params["accum_dtype"],
                                 self.device):
                return (x @ y).to(accum)
        return fn, (a, b)

    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n


class AttentionTuner(Tunable):
    """Tune causal self-attention: the plain masked attention against the
    flash kernels, bf16 and fp32."""

    name = "attention"
    BLOCK = 128          # the one block pair each implementation is timed at

    def __init__(self, seq_len: int, head_dim: int, num_heads: int,
                 batch_size: int, seed: int = 0, device=None):
        self.seq_len, self.head_dim = seq_len, head_dim
        self.num_heads, self.batch_size = num_heads, batch_size
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        shape = (batch_size, seq_len, num_heads, head_dim)
        self._q, self._k, self._v = (
            torch.randn(shape, generator=gen, device=self.device)
            for _ in range(3))

    def parameter_space(self) -> dict[str, list]:
        return {
            "impl": ["xla", "flash"],
            "block_q": [128, 256, 512],
            "block_k": [128, 256, 512],
            "dtype": ["bfloat16", "float32"],
        }

    def validate(self, params: dict[str, Any]) -> bool:
        # neither implementation reads the block sizes (the kernels' tiles
        # are fixed): one pair each, so the same work is not timed 9 times
        if params["block_q"] != self.BLOCK or params["block_k"] != self.BLOCK:
            return False
        if params["impl"] == "xla":
            return True
        # the flash kernels are CUDA kernels (a card only) for the head
        # dims they are built for
        from ..ops.attention_cuda import HEAD_DIMS
        return self.device.type == "cuda" and self.head_dim in HEAD_DIMS

    def build(self, params: dict[str, Any]):
        dt = _DTYPES[params["dtype"]]
        q, k, v = (x.to(dt) for x in (self._q, self._k, self._v))
        if params["impl"] == "flash":
            from ..ops.attention import flash_attention
            return (lambda q, k, v: flash_attention(
                q, k, v, causal=True, block_q=params["block_q"],
                block_k=params["block_k"])), (q, k, v)
        from ..models.layers import attention_mask, dot_product_attention
        pos = torch.arange(self.seq_len, dtype=torch.int32,
                           device=self.device)[None, :].expand(
                               self.batch_size, -1)
        mask = attention_mask(pos, pos)
        return (lambda q, k, v: dot_product_attention(q, k, v, mask)), \
            (q, k, v)

    def flops(self) -> float:
        # 2 matmuls of [S,D]x[D,S] and [S,S]x[S,D] per head, causal ~ /2
        return (2.0 * 2 * self.batch_size * self.num_heads
                * self.seq_len * self.seq_len * self.head_dim / 2)


class CollectiveTuner(Tunable):
    """Tune collective dispatch over a live mesh axis, by measurement.

    Space: pattern x payload chunking x dtype. Chunking (one collective
    split into n_chunks sequential ones) is the knob of bucket size, and
    matters for comm/compute overlap."""

    name = "collective"

    def __init__(self, mesh, axis: str, size_mb: float = 8.0):
        self.mesh, self.axis, self.size_mb = mesh, axis, size_mb
        self.device = mesh.device

    def parameter_space(self) -> dict[str, list]:
        return {
            "pattern": ["allreduce", "all_gather", "reduce_scatter",
                        "ppermute", "all_to_all"],
            "n_chunks": [1, 2, 4],
            "dtype": ["float32", "bfloat16"],
        }

    def agree(self, flag: bool) -> bool:
        from ..comms.bench import slowest
        return slowest(float(flag), self.mesh, self.axis) > 0

    def build(self, params: dict[str, Any]):
        raise NotImplementedError   # benchmark() times itself

    def benchmark(self, params: dict[str, Any], warmup: int,
                  trials: int) -> float:
        """The slowest member's ms for the payload in ``n_chunks``
        sequential collectives."""
        from ..comms.bench import bench_collective
        chunk_mb = self.size_mb / params["n_chunks"]
        return sum(bench_collective(self.mesh, self.axis, params["pattern"],
                                    size_mb=chunk_mb, dtype=params["dtype"],
                                    iters=trials)["time_ms"]
                   for _ in range(params["n_chunks"]))


class AutoTuner:
    def __init__(self, config: Optional[TuningConfig] = None, device=None):
        self.config = config or TuningConfig()
        self.device = resolve_device(device)
        self.cache: dict[str, dict] = {}

    def grid_search(self, tunable: Tunable,
                    cache_key: Optional[str] = None) -> TuningResult:
        cfg = self.config
        if cache_key and cache_key in self.cache:
            logger.info("cache hit for %s", cache_key)
            return TuningResult(**self.cache[cache_key])

        space = tunable.parameter_space()
        names = list(space)
        combos = list(itertools.product(*(space[n] for n in names)))

        t_start = time.perf_counter()
        best: Optional[dict] = None
        best_ms = float("inf")
        first_ms: Optional[float] = None
        since_improvement = 0
        all_results: list[dict] = []

        for combo in combos[:cfg.max_iterations]:
            params = dict(zip(names, combo))
            if not tunable.validate(params):
                continue
            if tunable.agree(time.perf_counter() - t_start
                             > cfg.timeout_seconds):
                logger.warning("%s tuning timed out after %d configs",
                               tunable.name, len(all_results))
                break
            if since_improvement >= cfg.convergence_patience:
                logger.info("%s tuning converged after %d configs",
                            tunable.name, len(all_results))
                break
            # a trial that raises fails the search: what an op refuses by
            # shape or dtype, ``validate`` leaves out before it is run
            ms = tunable.benchmark(params, cfg.num_warmup, cfg.num_trials)
            all_results.append({"params": params, "latency_ms": ms})
            if first_ms is None:
                first_ms = ms
            if ms < best_ms:
                best, best_ms = params, ms
                since_improvement = 0
            else:
                since_improvement += 1

        if best is None:
            raise RuntimeError(
                f"no valid configuration for {tunable.name} "
                f"(space={len(combos)} combos)")
        improvement = (100.0 * (first_ms - best_ms) / first_ms
                       if first_ms else 0.0)
        result = TuningResult(
            best_params=best, best_latency_ms=best_ms,
            improvement_pct=improvement, num_evaluated=len(all_results),
            all_results=all_results)
        if cache_key:
            self.cache[cache_key] = result.to_dict()
        return result

    def tune_matmul(self, m: int, k: int, n: int) -> TuningResult:
        backend = backend_name(self.device)
        return self.grid_search(MatMulTuner(m, k, n, device=self.device),
                                cache_key=f"matmul_{m}x{k}x{n}_{backend}")

    def tune_attention(self, seq_len: int, head_dim: int, num_heads: int,
                       batch_size: int) -> TuningResult:
        backend = backend_name(self.device)
        return self.grid_search(
            AttentionTuner(seq_len, head_dim, num_heads, batch_size,
                           device=self.device),
            cache_key=f"attention_{seq_len}_{head_dim}_{num_heads}"
                      f"_{batch_size}_{backend}")

    def tune_collective(self, mesh, axis: str,
                        size_mb: float = 8.0) -> TuningResult:
        """Every member of ``axis`` calls it together."""
        return self.grid_search(
            CollectiveTuner(mesh, axis, size_mb),
            cache_key=f"collective_{axis}{mesh.axis_size(axis)}_{size_mb}mb")

    def save_results(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.cache, indent=2, sort_keys=True))

    def load_results(self, path: str | Path) -> None:
        p = Path(path)
        if p.exists():
            self.cache.update(json.loads(p.read_text()))


def create_auto_tuner(config: Optional[TuningConfig] = None,
                      device=None) -> AutoTuner:
    return AutoTuner(config, device=device)
