"""Collective microbenchmarks over a live mesh of ranks.

The port's counterpart of the JAX package's ``comms/bench.py``: the
measured wall of each collective pattern over a mesh axis, on the port's
``comms/collectives.py``. Every rank of the axis calls ``bench_collective``
(or ``bench_all``) together, each with its shard of a global [rows, 128]
payload cut over the axis (rows a multiple of n^2, so a shard splits n
ways again for reduce-scatter and all-to-all), and every rank returns the
same row: the slowest rank's time a call. On a card the calls are timed
with CUDA events (``utils/timing.time_fn``), on the CPU with the host
clock.

Under gloo a CUDA tensor passes through host memory (the collectives stage
it), so a figure read over gloo is host-staged: each row names its
``backend``, and ``host_staged`` says so.
"""

from __future__ import annotations

import torch

from ..utils.timing import time_fn
from . import collectives as cc

PATTERNS = ("allreduce", "all_gather", "reduce_scatter", "ppermute",
            "all_to_all")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _payload(mesh, axis, size_mb: float, dtype) -> torch.Tensor:
    """This rank's shard [rows / n, 128] of the global payload."""
    n = mesh.axis_size(axis)
    itemsize = torch.empty((), dtype=dtype).element_size()
    elems = int(size_mb * 1e6 / itemsize)
    cols = 128
    rows = max(elems // cols // (n * n), 1) * n * n
    return torch.ones((rows // n, cols), dtype=dtype, device=mesh.device)


def slowest(value: float, mesh, axis) -> float:
    """The largest of the members' ``value`` (every member calls it)."""
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    return float(cc.all_gather(t, axis, mesh=mesh).max())


def bench_collective(mesh, axis, pattern: str, size_mb: float = 16.0,
                     dtype: str = "float32", iters: int = 10) -> dict:
    """Measure one collective pattern over ``axis`` (every member calls
    it). Returns the time a call and the algorithmic (bus) bandwidth of
    ring algorithms, the JAX row's keys, plus the backend and whether the
    traffic was host-staged."""
    n = mesh.axis_size(axis)
    x = _payload(mesh, axis, size_mb, _DTYPES[dtype])
    if pattern == "allreduce":
        def body(v):
            return cc.allreduce_sum(v, axis, mesh)
        # ring allreduce moves 2*(n-1)/n of the buffer per device
        algo_factor = 2 * (n - 1) / n if n > 1 else 1.0
    elif pattern == "all_gather":
        def body(v):
            return cc.all_gather(v, axis, gather_dim=0, mesh=mesh)
        algo_factor = (n - 1) / n if n > 1 else 1.0
    elif pattern == "reduce_scatter":
        def body(v):
            return cc.reduce_scatter(v, axis, scatter_dim=0, mesh=mesh)
        algo_factor = (n - 1) / n if n > 1 else 1.0
    elif pattern == "ppermute":
        def body(v):
            return cc.ring_shift(v, axis, mesh=mesh)
        algo_factor = 1.0 / n
    elif pattern == "all_to_all":
        # split along rows (the payload keeps rows % n^2 == 0)
        def body(v):
            return cc.all_to_all(v, axis, split_dim=0, concat_dim=1,
                                 mesh=mesh)
        algo_factor = (n - 1) / n if n > 1 else 1.0
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    cc.barrier(axis, mesh)
    sec = slowest(time_fn(body, x, iters=iters, device=mesh.device), mesh,
                  axis)
    bytes_total = x.numel() * x.element_size() * n
    return {
        "pattern": pattern, "axis": axis, "devices": n,
        "size_mb": size_mb, "dtype": dtype,
        "time_ms": sec * 1e3,
        "bus_bandwidth_gbps": bytes_total * algo_factor / sec / 1e9,
        "backend": mesh.backend,
        "host_staged": mesh.backend == "gloo",
    }


def bench_all(mesh, axis, size_mb: float = 16.0,
              patterns=PATTERNS) -> list[dict]:
    return [bench_collective(mesh, axis, p, size_mb) for p in patterns]
