"""Two faults of the port's serving path, repaired, held against JAX:

- the LM head keeps its fp32 accumulator: the port's ``unembed`` on bf16
  hidden states and weights is within 1e-5 of JAX's ``unembed``
  (``preferred_element_type=float32``); a product rounded to bf16 and
  widened after is off by the bf16 rounding of the logits;
- seeded sampling draws JAX's threefry bits: keys, ``fold_in``, raw bits
  and the uniforms of ``categorical``'s Gumbel noise are bit-equal to
  ``jax.random``, and the port's engine is token-identical to the JAX
  engine for seeded sampled requests (gpt-test, fp32).
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
    gpt as jgpt)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams, sampling as ts)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

TINY = float(np.finfo(np.float32).tiny)


# -- unembed -----------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
def test_bf16_unembed_keeps_the_fp32_accumulator(tied):
    jc = dataclasses.replace(jax_cfg("gpt-test"), tie_word_embeddings=tied)
    tc = dataclasses.replace(torch_cfg("gpt-test"), tie_word_embeddings=tied)
    params = jgpt.init(jc, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    rs = np.random.RandomState(1)
    params["final_norm"]["scale"] = jnp.asarray(
        0.1 * rs.randn(jc.hidden_size), jnp.bfloat16)
    x = jnp.asarray(rs.randn(2, 9, jc.hidden_size), jnp.bfloat16)
    ref = np.asarray(jgpt.unembed(params, x, jc))
    model = params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params), tc,
        device="cpu", dtype=torch.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        out = tgpt.unembed(model, xt, tc)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # the old computation (bf16 product, widened after) is measurably off
    with torch.no_grad():
        h = tgpt.rms_norm(xt, model.final_norm, tc.norm_eps)
        rounded = (h @ tgpt.head_weight(model, torch.bfloat16)).float()
    assert np.abs(rounded.numpy() - ref).max() > 1e-4


def test_unembed_gradient_flows_through_the_fp32_head():
    """The head product's backward returns gradients in the operands'
    dtypes (fp32 here, equal to plain autograd)."""
    cfg = torch_cfg("gpt-test")
    model = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 5, cfg.hidden_size, requires_grad=True)
    tgpt.unembed(model, x, cfg).square().sum().backward()
    h = tgpt.rms_norm(x.detach().requires_grad_(True), model.final_norm,
                      cfg.norm_eps)
    w = model.lm_head.detach().clone().requires_grad_(True)
    (h @ w).square().sum().backward()
    torch.testing.assert_close(model.lm_head.grad, w.grad, rtol=1e-5,
                               atol=1e-6)


# -- threefry ------------------------------------------------------------------

SEEDS = [0, 7, -3, 2 ** 31 + 5, 2 ** 40 + 3, 123456789]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    tk = ts.prng_key(torch.tensor([seed]))
    assert tuple(int(a) for a in np.asarray(jax.random.key_data(key))) == \
        (int(tk[0][0]), int(tk[1][0]))
    positions = [0, 1, 17, 4095, 2 ** 31 - 1]
    folded = ts.fold_in(ts.prng_key(torch.tensor([seed] * len(positions))),
                        torch.tensor(positions))
    for i, pos in enumerate(positions):
        ref = np.asarray(jax.random.key_data(jax.random.fold_in(key, pos)))
        assert (int(folded[0][i]), int(folded[1][i])) == tuple(map(int, ref))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 7, 256, 50304])
def test_random_bits_and_uniforms_equal_jax(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 33)
    tk = ts.fold_in(ts.prng_key(torch.tensor([seed])), torch.tensor([33]))
    bits = ts.random_bits(tk, n)[0].numpy().astype(np.uint32)
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(key, (n,))))
    u = ts.uniform(tk, n, minval=TINY)[0].numpy()
    ref = np.asarray(jax.random.uniform(key, (n,), minval=TINY))
    np.testing.assert_array_equal(u.view(np.uint32), ref.view(np.uint32))
    # -log(-log(u)): the two frameworks' log may differ in the last place
    g = ts.gumbel_noise(torch.tensor([seed]), torch.tensor([33]), n)[0]
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.random.gumbel(
        key, (n,))), rtol=1e-6, atol=1e-6)


def test_categorical_draws_equal_jax():
    """argmax(logits + the port's noise) is ``jax.random.categorical`` for
    the same keys."""
    rs = np.random.RandomState(4)
    logits = rs.randn(6, 300).astype(np.float32) * 3
    seeds, pos = np.arange(6) * 11 + 2, np.arange(6) * 5 + 1
    noise = ts.gumbel_noise(torch.tensor(seeds), torch.tensor(pos), 300)
    out = (torch.from_numpy(logits) + noise).argmax(-1).numpy()
    ref = [int(jax.random.categorical(
        jax.random.fold_in(jax.random.PRNGKey(int(s)), int(p)),
        jnp.asarray(row))) for s, p, row in zip(seeds, pos, logits)]
    assert out.tolist() == ref


# -- the engines -------------------------------------------------------------

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")
_rs = np.random.RandomState(5)
PROMPTS = [[int(t) for t in _rs.randint(0, 256, n)] for n in (9, 3, 21, 14,
                                                              30)]


@pytest.fixture(scope="module")
def engines():
    params = jgpt.init(jax_cfg("gpt-test"), jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              torch_cfg("gpt-test"), device="cpu")
    return params, tparams


@pytest.mark.parametrize("seed", [1, 42, 2 ** 33 + 7])
@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (20, 1.0), (0, 0.9),
                                         (40, 0.95)])
def test_seeded_sampling_token_identical_to_jax_engine(engines, seed, top_k,
                                                       top_p):
    params, tparams = engines
    kw = dict(temperature=0.8, top_k=top_k, top_p=top_p, max_tokens=10,
              seed=seed)
    ref = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(**SERVE),
                    params=params, seed=0).generate(PROMPTS,
                                                    JaxSampling(**kw))
    out = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**SERVE),
                          params=tparams, seed=0, device="cpu").generate(
        PROMPTS, SamplingParams(**kw))
    assert [r.generated_tokens for r in out] == \
        [r.generated_tokens for r in ref]
    assert all(len(r.generated_tokens) == 10 for r in out)
