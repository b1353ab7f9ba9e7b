"""The split of the reduction over blocks in the W8A16 kernel, on the CPU.

``split_plan`` (``ops/int8_matmul.py``) fixes the split on the host from the
weight's shape and the card's SM count, and the kernel follows it;
``split_ranges`` gives each split's input rows as the kernel computes them.
These tests hold the plan to whole k-steps, at most 8 splits (one cluster)
and exact coverage, then emulate in torch what the kernel computes: each
split's fp32 partial over its rows and the combine that adds the partials
in split order. The emulation is held against the port's plain version
``matmul_w8_plain`` within the card tests' limits (fp32 1e-4, bf16 1e-2 of
the output's largest value) and against the JAX package's ``matmul_w8``
(the TPU kernel in interpret mode) on the same inputs from a numpy seed,
within 1e-5 of the largest value (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.ops import (
    int8_matmul_pallas as jw8)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    int8_matmul as tw8, quantization as tq)
from distributed_llm_training_and_inference_system_tpu_torch.ops.\
    int8_matmul import (BLOCK_COLS, K_STEP, MAX_SPLITS, split_plan,
                        split_ranges)

LLAMA = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [
    ((4096, 4096), (512, 8, 32)),      # q, o: 256 blocks
    ((4096, 1024), (512, 8, 8)),       # k, v: 64 blocks
    ((4096, 14336), (1024, 4, 112)),   # gate, up: 448 blocks
    ((14336, 4096), (1792, 8, 32)),    # down (the k-split route): 256
])
def test_plan_at_the_llama_projections(shape, want):
    """llama-8b-gqa's projections on an H100's 132 SMs: as many splits as
    bring the grid to about 4 blocks an SM, at most 8."""
    p = split_plan(*shape)
    assert (p["k_per_split"], p["splits"], p["col_tiles"]) == want
    assert p["grid"] == want[1] * want[2] <= 4 * 132


def _covers_once(n_in, n_out, sms):
    p = split_plan(n_in, n_out, sms)
    kps, n = p["k_per_split"], p["splits"]
    assert 1 <= n <= MAX_SPLITS
    assert kps > 0 and kps % K_STEP == 0          # whole k-steps
    assert p["col_tiles"] == -(-n_out // BLOCK_COLS)
    assert p["grid"] == p["col_tiles"] * n
    ranges = split_ranges(p, n_in)
    assert len(ranges) == n
    at = 0
    for s, (b, e) in enumerate(ranges):
        assert b == at == s * kps                  # in order, no gap
        assert b < e <= n_in                       # none empty
        assert e - b == kps or (s == n - 1 and e == n_in)
        at = e
    assert at == n_in                              # every row once
    return p


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("shape", LLAMA + [(1000, 192), (256, 128)])
def test_plan_covers_every_row_once_in_whole_k_steps(shape, sms):
    _covers_once(*shape, sms)


@pytest.mark.parametrize("n_in", [1, 8, 15, 16, 17, 63, 64, 65, 100, 1000,
                                  2047, 2048, 11008, 20000, 32768])
@pytest.mark.parametrize("n_out", [64, 192, 1024, 14336])
def test_plan_covers_any_reduction_length(n_in, n_out):
    _covers_once(n_in, n_out, 132)


def test_boundaries_the_card_tests_reach():
    """One k-step (a single split), one split ending in a short tail, and
    a reduction that is no multiple of 16 with its last split short."""
    assert split_plan(16, 128) == {"k_per_split": 16, "splits": 1,
                                   "col_tiles": 1, "grid": 1}
    assert split_plan(100, 128)["splits"] == 1          # 6.25 k-steps
    p = split_plan(1000, 192)
    assert (p["k_per_split"], p["splits"]) == (128, 8)
    assert split_ranges(p, 1000)[-1] == (896, 1000)     # 6.5 k-steps


def test_a_split_walks_at_least_four_k_steps_where_it_can():
    for n_in in (64, 128, 256, 1000):
        p = split_plan(n_in, 128)
        assert all(e - b >= min(n_in, 4 * K_STEP)
                   for b, e in split_ranges(p, n_in)[:-1])


# -- the emulation -------------------------------------------------------------

def emulate(x, values, scale, plan):
    """What the kernel computes: each split's fp32 partial over its input
    rows, the partials added in split order, cast to x's dtype."""
    xs = tw8.fold_scale(x, scale).float()
    y = None
    for b, e in split_ranges(plan, values.shape[0]):
        part = xs[:, b:e] @ values[b:e].float()
        y = part if y is None else y + part
    return y.to(x.dtype)


def _inputs(rows, n_in, n_out, seed):
    rs = np.random.RandomState(seed)
    w = (rs.randn(n_in, n_out) * 0.05).astype(np.float32)
    x = rs.randn(rows, n_in).astype(np.float32)
    values, scale = tq.quantize_int8(torch.from_numpy(w))
    return x, values, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 44])
@pytest.mark.parametrize("shape", [(256, 128), (1000, 192), (100, 128),
                                   (16, 64), (2048, 256)])
def test_emulation_equals_plain(shape, rows, dtype):
    x, values, scale = _inputs(rows, *shape, seed=rows)
    xt = torch.from_numpy(x).to(dtype)
    plan = split_plan(*shape)
    out = emulate(xt, values, scale, plan)
    ref = tw8.matmul_w8_plain(xt, values, scale)
    assert out.dtype == dtype and out.shape == (rows, shape[1])
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * \
        ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("rows", [1, 8, 20])
@pytest.mark.parametrize("shape", [(256, 512), (1000, 192), (8192, 512)])
def test_emulation_equals_jax_interpret(shape, rows, sms):
    """The JAX package's kernel (whole-K at (256, 512) and (1000, 192),
    k-split at (8192, 512)) and the emulated split of the port."""
    x, values, scale = _inputs(rows, *shape, seed=shape[0] + rows)
    ref = np.asarray(jw8.matmul_w8(jnp.asarray(x),
                                   jnp.asarray(values.numpy()),
                                   jnp.asarray(scale.numpy()),
                                   interpret=True))
    out = emulate(torch.from_numpy(x), values, scale, split_plan(*shape,
                                                                 sms))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
