"""The RMSNorm kernel's launch plan on the CPU, and an emulation of its
fixed-order sum against the JAX package's Pallas kernel.

- ``launch_plan`` gives every row to exactly one warp (or block) for H from
  8 to 16384, in fp32 and bf16, and stays within the kernel's limits;
- an emulation of the kernel's sum of squares, each thread over its
  16-byte vectors in order, then a butterfly of shuffles (and, for a block
  a row, the warps' sums in order), followed by the kernel's scaling,
  matches JAX ``rms_norm_pallas`` (interpret mode) within the tolerance of
  tests/test_torch_quant_ops.py: 1e-6 in fp32 (the same fp32 statistics
  summed in another order), one bf16 step of the largest value in bf16
  (both round the fp32 result once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.ops import (
    rmsnorm as jrms)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    rmsnorm as rn)

BLOCK_THREADS = 256          # csrc/rmsnorm.cu: the block-per-row path

def _rows_of(plan: dict, rows: int) -> list[list[int]]:
    """The rows each warp of a warp plan takes, in the kernel's order:
    warp w of the grid rows w, w + warps, ..."""
    return [list(range(w, rows, plan["warps"])) if w < plan["warps"] else []
            for w in range(plan["grid"] * plan["warps_per_block"])]


H_VALUES = [8, 16, 24, 64, 256, 1000, 1024, 2048, 2056, 4096, 4104, 8192,
            16384]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("H", H_VALUES)
@pytest.mark.parametrize("rows", [1, 7, 1024, 8192, 100003])
def test_the_plan_gives_every_row_to_one_warp(rows, H, itemsize):
    plan = rn.launch_plan(rows, H, itemsize, sm_count=132)
    if plan["mode"] == "block":
        assert H * itemsize > 32 * rn.MAX_LANE_VECS * 16
        assert plan["grid"] == rows
        return
    vecs = H * itemsize // 16
    assert plan["vpl"] in (1, 2, 4, 8, 16)
    assert 32 * plan["vpl"] >= vecs > 32 * plan["vpl"] // 2 or vecs <= 32
    assert 1 <= plan["warps_per_block"] <= rn.MAX_WARPS_PER_BLOCK
    assert plan["grid"] * plan["warps_per_block"] >= plan["warps"]
    assert (plan["grid"] - 1) * plan["warps_per_block"] < plan["warps"]
    owned = _rows_of(plan, rows)
    flat = sorted(r for rs in owned for r in rs)
    assert flat == list(range(rows))
    assert max(len(rs) for rs in owned) == plan["rows_per_warp"]


@pytest.mark.parametrize("H,itemsize,mode,vpl", [
    (2048, 2, "warp", 8), (4096, 2, "warp", 16), (4104, 2, "block", 0),
    (2048, 4, "warp", 16), (2056, 4, "block", 0), (64, 2, "warp", 1),
    (16384, 2, "block", 0)])
def test_a_warp_owns_a_row_up_to_sixteen_vectors_a_lane(H, itemsize, mode,
                                                       vpl):
    plan = rn.launch_plan(1024, H, itemsize)
    assert (plan["mode"], plan["vpl"]) == (mode, vpl)


@pytest.mark.parametrize("sm_count,rows,warps,rows_per_warp", [
    (132, 1024, 1024, 1), (132, 8192, 1024, 8), (66, 1024, 512, 2),
    (66, 8192, 512, 16), (132, 8, 8, 1), (132, 1, 1, 1)])
def test_warps_are_spread_over_the_card(sm_count, rows, warps,
                                        rows_per_warp):
    """8 warps an SM: on 132 SMs the entry forward's [1024, 2048] takes a
    warp a row, and [8192, 4096] 1024 warps of 8 rows, each reading the
    scale once for them."""
    plan = rn.launch_plan(rows, 2048, 2, sm_count=sm_count)
    assert (plan["warps"], plan["rows_per_warp"]) == (warps, rows_per_warp)


@pytest.mark.parametrize("bad", [(4, 12, 2), (4, 0, 2), (-1, 64, 2)])
def test_the_plan_refuses_rows_it_cannot_cut(bad):
    with pytest.raises(ValueError):
        rn.launch_plan(*bad)


def _emulate(x: np.ndarray, scale: np.ndarray, eps: float, plan: dict,
             out_dtype) -> np.ndarray:
    """The kernel's arithmetic on fp32 values: thread partial sums over its
    vectors in order, a butterfly over each warp's 32 lanes, the warps'
    sums in order (a block a row), then (x * inv) * (1 + scale)."""
    rows, H = x.shape
    vec = 16 // torch.tensor([], dtype=out_dtype).element_size()
    threads = 32 if plan["mode"] == "warp" else BLOCK_THREADS
    v = x.reshape(rows, H // vec, vec).astype(np.float32)
    sums = np.zeros((rows, threads), dtype=np.float32)
    for t in range(threads):
        for i in range(t, H // vec, threads):
            s = np.zeros(rows, dtype=np.float32)
            for e in range(vec):
                s = s + v[:, i, e] * v[:, i, e]
            sums[:, t] = sums[:, t] + s
    w = sums.reshape(rows, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, :, np.arange(32) ^ o]
    total = np.zeros(rows, dtype=np.float32)
    for k in range(threads // 32):
        total = total + w[:, k, 0]
    inv = (1.0 / np.sqrt(total / np.float32(H) + np.float32(eps))).astype(
        np.float32)
    out = (x.astype(np.float32) * inv[:, None]) * (
        np.float32(1) + scale.astype(np.float32))
    return torch.from_numpy(out.astype(np.float32)).to(out_dtype).float() \
        .numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 64), (5, 2048), (3, 4096), (2, 8192),
                                   (4, 1000)])
def test_the_kernels_sum_order_matches_the_pallas_kernel(shape, dtype):
    rs = np.random.RandomState(shape[-1])
    x = (rs.randn(*shape) * 2).astype(np.float32)
    scale = (rs.randn(shape[-1]) * 0.1).astype(np.float32)
    tdt = getattr(torch, dtype)
    # the inputs as the kernel sees them: rounded to the dtype
    xr = torch.from_numpy(x).to(tdt).float().numpy()
    sr = torch.from_numpy(scale).to(tdt).float().numpy()
    xj = jnp.asarray(x).astype(dtype)
    sj = jnp.asarray(scale).astype(dtype)
    ref = np.asarray(jrms.rms_norm_pallas(xj, sj, 1e-5).astype(jnp.float32))
    plan = rn.launch_plan(shape[0], shape[1], 4 if dtype == "float32" else 2)
    got = _emulate(xr, sr, 1e-5, plan, tdt)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
