"""MoE serving: the port's engine against the JAX engine on the same
params (gpt-test-moe, fp32, CPU).

Routing makes a row's output depend on the rest of its call: capacity is
counted over every row of a forward, idle slots and pad tokens included,
and a lower row keeps its place in a full expert. So the engines must
issue forwards of the same shapes with the same contents in their idle and
pad rows. Tolerance: none. Greedy and seeded output must be token-identical
to the JAX engine's, with the same engine counters and weight bytes, with
chunked prefill, n-gram speculation, a prefix-cache hit and swap
preemption, under int8 and int4 weights and int8 KV pages. The scratch
page that idle rows read is written as JAX writes it (the last of
several rows sent there wins).
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
from distributed_llm_training_and_inference_system_tpu.ops import (
    paged_attention as jpa)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    paged_attention as tpa)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

NAME = "gpt-test-moe"
SERVE = dict(model=NAME, max_batch_size=4, max_seq_len=128, prefill_chunk=32,
             kv_block_size=8, dtype="float32", decode_steps_per_dispatch=4)
_RNG = np.random.default_rng(12)
PROMPTS = [[int(t) for t in _RNG.integers(1, 250, n)] for n in (5, 40, 13)]
REPETITIVE = [7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9, 10, 7, 8]
GREEDY = dict(temperature=0.0, max_tokens=16)
SEEDED = dict(temperature=0.8, top_k=20, seed=123, max_tokens=16)
# counters both engines report
COUNTERS = ("prefill_tokens", "decode_steps", "prefix_cached_tokens",
            "spec_dispatches", "spec_drafts", "spec_accepted", "preemptions",
            "swap_ins", "weight_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny matrices: one intra-op thread runs them as fast as many and
    keeps parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wide():
    """gpt-test-moe with a router that quantizes (L * H * E = 4096): 8
    experts over H = 256, so int4 serving takes an int4 router."""
    over = dict(hidden_size=256, head_dim=64)
    cfgs = []
    for get in (jax_cfg, torch_cfg):
        c = get(NAME)
        cfgs.append(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, num_experts=8), **over))
    return cfgs


_PARAMS = {}


def _setup(wide=False):
    """(JAX config, port config, JAX params, the port's bridged model)."""
    if wide not in _PARAMS:
        jc, tc = _wide() if wide else (jax_cfg(NAME), torch_cfg(NAME))
        p = jax_init(jc, jax.random.PRNGKey(0))
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, p), tc,
                                device="cpu")
        _PARAMS[wide] = (jc, tc, p, model)
    return _PARAMS[wide]


def _engines(wide=False, **over):
    """Both engines from the same fp32 params; each quantizes them itself
    when asked (``quantization``)."""
    jc, tc, p, model = _setup(wide)
    kw = dict(SERVE, **over)
    je = JaxEngine(jc, jax_schema.ServeConfig(**kw), params=p, seed=0)
    te = InferenceEngine(tc, ServeConfig(**kw), params=model, seed=0,
                         device="cpu")
    return je, te


def _run(engine, prompts, **sampling):
    sp = (JaxSampling if isinstance(engine, JaxEngine)
          else SamplingParams)(**sampling)
    return [r.generated_tokens for r in engine.generate(prompts, sp)]


def _same(je, te, prompts, sampling, rounds=1):
    """Serve ``prompts`` ``rounds`` times on both engines (a later round
    can hit the prefix cache the first filled); the tokens and counters
    must be equal."""
    for _ in range(rounds):
        want = _run(je, prompts, **sampling)
        assert _run(te, prompts, **sampling) == want
    st, rst = te.stats(), je.stats()
    for key in COUNTERS:
        assert st[key] == rst[key], (key, st[key], rst[key])
    return st


@pytest.mark.parametrize("sampling", ["greedy", "seeded"])
def test_moe_engine_two_busy_slots_token_identical_to_jax(sampling):
    """Two requests in four slots: every decode step routes the two idle
    rows too (C = 2 an expert), and they read the scratch page."""
    je, te = _engines()
    st = _same(je, te, PROMPTS[:2], GREEDY if sampling == "greedy"
               else SEEDED)
    assert st["decode_slot_utilization"] < 1.0


FEATURES = {
    "chunked": dict(chunked_prefill_tokens=8),
    "speculation": dict(speculative="ngram", speculative_tokens=4),
    "prefix_hit": dict(prefix_caching=True),
    "swap": dict(admission="ondemand", preemption="swap", kv_num_blocks=11),
    "all": dict(chunked_prefill_tokens=16, speculative="ngram",
                speculative_tokens=4, prefix_caching=True,
                admission="ondemand", preemption="swap", kv_num_blocks=14),
}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_moe_engine_features_token_identical_to_jax(feature):
    je, te = _engines(**FEATURES[feature])
    prompts = {"speculation": [REPETITIVE, REPETITIVE[3:] * 2, PROMPTS[0]],
               "prefix_hit": [PROMPTS[1], PROMPTS[1][:24] + [5, 6, 7]],
               "swap": [PROMPTS[0] + PROMPTS[2][:11]] * 2,
               "all": [REPETITIVE + PROMPTS[1][:10], PROMPTS[1][:16],
                       REPETITIVE * 2]}.get(feature, PROMPTS)
    sampling = dict(GREEDY, max_tokens=40 if feature in ("swap", "all")
                    else 16)
    st = _same(je, te, prompts, sampling,
               rounds=2 if feature == "prefix_hit" else 1)
    check = {"chunked": st["chunked_prefills"] > 0,
             "speculation": st["spec_dispatches"] > 0
             and st["spec_accepted"] > 0,
             "prefix_hit": st["prefix_cached_tokens"] > 0,
             "swap": st["swap_ins"] > 0,
             "all": st["swap_ins"] > 0 and st["spec_dispatches"] > 0
             and st["chunked_prefills"] > 0}[feature]
    assert check, st


@pytest.mark.parametrize("quantization,kv", [("int8", "none"),
                                             ("int4", "none"),
                                             ("int8", "int8"),
                                             ("none", "int8")])
def test_moe_engine_quantized_token_identical_to_jax(quantization, kv):
    """The wide config: int8 quantizes router and experts; int4 puts the
    router in int4 groups and the experts in int8. Both engines quantize
    the same fp32 params themselves; the bytes agree (weight_bytes)."""
    je, te = _engines(wide=True, quantization=quantization,
                      kv_quantization=kv, speculative="ngram",
                      speculative_tokens=4)
    st = _same(je, te, [PROMPTS[1], REPETITIVE], GREEDY)
    assert st["quantization"] == quantization or quantization == "none"
    if quantization != "none":
        leaves = te.params.blocks[0].leaves()
        kinds = {n: type(leaves[n]).__name__ for n in
                 ("moe_router", "moe_gate", "moe_up", "moe_down")}
        router = "Quant4Tensor" if quantization == "int4" else "QuantTensor"
        assert kinds == {"moe_router": router, "moe_gate": "QuantTensor",
                         "moe_up": "QuantTensor", "moe_down": "QuantTensor"}


def test_scratch_page_keeps_the_last_row_as_jax():
    """Rows sent to the same (page, offset) — masked rows and rows past a
    slot's chain, all on scratch page 0 — leave the last such row's values,
    as the JAX scatter does; pages big enough, and threads enough, that an
    unordered ``index_put_`` keeps another row."""
    torch.set_num_threads(4)                  # the module's fixture resets
    rs = np.random.RandomState(0)
    NP, Nkv, PS, D, R = 50, 8, 16, 64, 96
    pages = rs.randn(NP, Nkv, PS, D).astype(np.float32)
    new = rs.randn(R, Nkv, D).astype(np.float32)
    tables = np.zeros((R, 4), np.int32)
    tables[::3, 0] = 7                          # a third write a real page
    positions = rs.randint(0, PS, R).astype(np.int32)
    active = rs.rand(R) < 0.7
    ref = jpa.write_token_to_pages(jnp.asarray(pages), jnp.asarray(new),
                                   jnp.asarray(tables), jnp.asarray(positions),
                                   jnp.asarray(active))
    got = tpa.write_token_to_pages(torch.from_numpy(pages.copy()),
                                   torch.from_numpy(new),
                                   torch.from_numpy(tables),
                                   torch.from_numpy(positions),
                                   torch.from_numpy(active))
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()


def test_dense_prefill_writes_the_scratch_page_as_jax():
    """A 5-token prompt in a 32-token bucket: the bucket's three pages past
    the prompt all map to scratch page 0, and both engines leave the last
    of them there."""
    je, te = _engines()
    _run(je, [PROMPTS[0]], **dict(GREEDY, max_tokens=1))
    _run(te, [PROMPTS[0]], **dict(GREEDY, max_tokens=1))
    for jp, tp in ((je.kv.k_pages, te.kv.k_pages),
                   (je.kv.v_pages, te.kv.v_pages)):
        np.testing.assert_allclose(tp[:, 0].numpy(), np.asarray(jp)[:, 0],
                                   rtol=0, atol=1e-5)
