"""The port's 256-candidate sampling tier and its threefry ``randint``
against the JAX package (CPU).

- The tier's filtered logits equal the single sort's bit for bit, and the
  JAX tier's, wherever the kept set lies inside the candidates (the tier
  itself runs: its "needs the exact path" flag is off) and wherever it
  does not (boundary ties, top_k > 256, a top-p mass reached past the
  candidates: the flag is on and the exact path runs).
- Tokens under the same Gumbel noise equal JAX's at a vocab that engages
  the JAX tier, from the port's sampler (the single sort) and from the
  port's tier; a seeded sampled request through the port's engine equals
  the JAX engine's tokens (gpt-test at vocab 1024, fp32).
- ``randint`` equals ``jax.random.randint`` bit for bit for several keys,
  shapes and ranges (the int4-awq calibration tokens).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling,
    sampling as js)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams, sampling as ts)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)


def _both(logits, tk, tp):
    """(port tier, port single sort, JAX tier, the port tier's flag)."""
    B = logits.shape[0]
    tk = np.full((B,), tk, np.int64) if np.isscalar(tk) else np.asarray(tk)
    tp = np.full((B,), tp, np.float32) if np.isscalar(tp) else np.asarray(
        tp, np.float32)
    t = torch.from_numpy(logits)
    k, p = torch.from_numpy(tk), torch.from_numpy(tp)
    tier = ts._filtered_fast_or_exact(t, k, p, tk).numpy()
    exact = ts._filtered_single_sort(t, k, p).numpy()
    _, flag = ts._filtered_fast(t, k, p)
    ref = np.asarray(jax.jit(js._filtered_fast_or_exact)(
        jnp.asarray(logits), jnp.asarray(tk, jnp.int32), jnp.asarray(tp)))
    return tier, exact, ref, bool(flag)


@pytest.mark.parametrize("tk,tp,exact_path", [
    (50, 1.0, False),          # top-k only
    (0, 0.9, False),           # top-p only
    (64, 0.8, False),          # both
    (0, 0.01, False),          # a razor top-p (about one token)
    (256, 1.0, False),         # top-k at the candidates' width
    (500, 0.9, True),          # top_k past the candidates
    (-1, 0.95, False),         # a negative k is off
    (0, 0.9999, True),         # top-p's mass is not reached in 256
])
def test_tier_equals_single_sort_and_jax(tk, tp, exact_path):
    rs = np.random.RandomState(5)
    scale = 0.1 if tp > 0.999 else 4.0      # a flat row spreads its mass
    logits = (rs.randn(4, 2048) * scale).astype(np.float32)
    tier, exact, ref, flag = _both(logits, tk, tp)
    assert flag == exact_path
    np.testing.assert_array_equal(tier, exact)
    np.testing.assert_array_equal(tier, ref)


@pytest.mark.parametrize("tk,tp", [(8, 0.8), (0, 0.5), (290, 0.99),
                                   (300, 1.0)])
def test_tier_with_ties_across_the_boundary(tk, tp):
    """300 tied top values: every cut touches the 257th candidate, so the
    exact path runs, and the result is still the single sort's."""
    logits = np.zeros((2, 1024), np.float32)
    logits[:, :300] = 1.0
    tier, exact, ref, flag = _both(logits, tk, tp)
    assert flag
    np.testing.assert_array_equal(tier, exact)
    np.testing.assert_array_equal(tier, ref)


def test_tier_rebuilds_the_argsort_tie_order():
    """Ties inside the candidates (a coarse grid), a kth value tied
    within them and rows of every kind in one batch: kept set and values
    equal the single sort's with the fast path taken."""
    rs = np.random.RandomState(7)
    logits = (np.round(rs.randn(6, 4096) * 2) / 2).astype(np.float32)
    logits[:, :40] += 20.0                 # 40 candidates far above the rest
    logits[:, 10:14] = logits[:, 10:11]    # a tie among them
    tk = np.array([3, 12, 0, 40, 11, 1])
    tp = np.array([1.0, 0.9, 0.6, 0.95, 1.0, 0.5], np.float32)
    tier, exact, ref, flag = _both(logits, tk, tp)
    assert not flag
    np.testing.assert_array_equal(tier, exact)
    np.testing.assert_array_equal(tier, ref)


def test_tokens_under_the_same_noise_match_jax():
    """sample_tokens (the single sort) and the port's tier at a vocab that
    engages JAX's tier, fed JAX's Gumbel draws for JAX's keys: JAX's
    tokens (greedy and top_k > 256 rows included)."""
    B, V = 4, 4096
    logits = (np.random.RandomState(9).randn(B, V) * 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(13), B)
    temp, tk, tp = [1.0, 0.8, 0.0, 1.2], [40, 0, 10, 300], [0.9, 0.7, 1, 1]
    ref = np.asarray(js.sample_tokens(
        jnp.asarray(logits), keys, jnp.asarray(temp, jnp.float32),
        jnp.asarray(tk, jnp.int32), jnp.asarray(tp, jnp.float32)))
    noise = np.stack([np.asarray(jax.random.gumbel(k, (V,), jnp.float32))
                      for k in keys])
    out = ts.sample_tokens(torch.from_numpy(logits), temp, tk, tp,
                           noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(out.numpy(), ref)
    t = np.asarray(temp, np.float32)
    scaled = torch.from_numpy(logits / np.maximum(t, 1e-6)[:, None])
    tier = ts._filtered_fast_or_exact(
        scaled, torch.tensor(tk), torch.tensor(tp, dtype=torch.float32),
        np.where(t > 0, tk, 0))
    toks = (tier + torch.from_numpy(noise)).argmax(-1).numpy()
    np.testing.assert_array_equal(np.where(t > 0, toks, ref), ref)


def test_seeded_requests_through_the_engine_match_jax():
    """gpt-test at vocab 1024 (JAX's tier engages past 257), fp32: seeded
    top-k/top-p requests, token for token with the JAX engine."""
    jc = dataclasses.replace(jax_cfg("gpt-test"), vocab_size=1024)
    tc = dataclasses.replace(torch_cfg("gpt-test"), vocab_size=1024)
    params = jax_init(jc, jax.random.PRNGKey(0))
    serve = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
                 prefill_chunk=32, kv_block_size=8, dtype="float32")
    je = JaxEngine(jc, jax_schema.ServeConfig(**serve), params=params,
                   seed=0)
    te = InferenceEngine(tc, ServeConfig(**serve), params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tc, device="cpu"),
        seed=0, device="cpu")
    rs = np.random.default_rng(4)
    prompts = [[int(t) for t in rs.integers(1, 1024, n)] for n in (7, 19)]
    for sp in (dict(temperature=0.9, top_k=40, seed=5, max_tokens=12),
               dict(temperature=1.1, top_p=0.8, seed=6, max_tokens=12)):
        want = [r.generated_tokens for r in je.generate(
            prompts, JaxSampling(**sp))]
        got = [r.generated_tokens for r in te.generate(
            prompts, SamplingParams(**sp))]
        assert got == want


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (2, 256), 1, 128256),      # the int4-awq calibration draw
    (0, (2, 128), 1, 256),
    (7, (3, 5), 0, 10),
    (123, (1000,), -50, 50),
    (2 ** 31 + 5, (4, 4), 1, 2 ** 31 - 1),
    (3, (8,), 5, 5),               # an empty range returns minval
])
def test_randint_equals_jax(seed, shape, lo, hi):
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo,
                                        hi))
    out = ts.randint(ts.prng_key(torch.tensor(seed)), shape, lo, hi)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_split_equals_jax():
    for seed in (0, 1, 99):
        ref = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.PRNGKey(seed))))
        out = ts.split(ts.prng_key(torch.tensor(seed)))
        np.testing.assert_array_equal(
            np.array([[int(a), int(b)] for a, b in out]), ref)
