"""Shared cases and checks of the tensor-parallel serving tests
(``test_torch_tp_serve.py``, ``test_torch_tp_serve_quant.py``): the
engines and requests of the JAX package's ``tests/test_tp_serve.py``, the
JAX side of each, and the comparisons. Imported by the test processes
only (the ranks run ``torch_dist_ranks.serve_rank``, which imports no
JAX)."""

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_ranks as R
from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling)

PROMPTS = [[5, 17, 99, 3, 42, 7, 23],
           [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
           [7, 8, 9, 10] * 4]
ONE = [[5, 17, 99, 3, 42, 7, 11, 23]]
GREEDY8 = dict(temperature=0.0, max_tokens=8)
LONG = [int(t) for t in np.random.default_rng(3).integers(1, 250, 64)]
REPETITIVE = [7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9, 10, 7, 8]
FEATURES = dict(chunked_prefill_tokens=16, speculative="ngram",
                speculative_tokens=4, admission="ondemand",
                preemption="swap", kv_num_blocks=14,
                decode_steps_per_dispatch=4)
FEATURE_PROMPTS = [REPETITIVE + LONG[:10], LONG[:16], REPETITIVE * 2]

# case -> (ServeConfig overrides, [(prompts, sampling, each|together)]):
# the engines and requests of tests/test_tp_serve.py
CASES = {
    "plain": ({}, [
        (PROMPTS, dict(temperature=0.0, max_tokens=10), "each"),
        (PROMPTS, GREEDY8, "together"),
        (PROMPTS[:1], dict(temperature=0.9, top_k=20, max_tokens=8,
                           seed=11), "each")]),
    "spec_prefix": (dict(speculative="ngram", speculative_tokens=4,
                         prefix_caching=True), [
        ([[7, 8, 9, 10] * 5], dict(temperature=0.0, max_tokens=10),
         "each"),
        ([[7, 8, 9, 10] * 5], dict(temperature=0.0, max_tokens=10),
         "each")]),
    "int8": (dict(quantization="int8"), [(ONE, GREEDY8, "each")]),
    "int8_kv": (dict(kv_quantization="int8"), [(ONE, GREEDY8, "each")]),
    "int4_kv": (dict(kv_quantization="int4"), [(ONE, GREEDY8, "each")]),
    # beyond the reference's cases: chunked prefill, swap preemption and
    # speculation together, held to the port at tp=1
    "features": (FEATURES, [(FEATURE_PROMPTS,
                             dict(temperature=0.0, max_tokens=36),
                             "together")]),
}


def jax_engine(params, tp, **over):
    kw = dict(R.SERVE, tensor_parallel=tp, **over)
    return JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(**kw),
                     params=params, seed=0)


def runs_of(engine, runs, sampling_cls=JaxSampling):
    out = []
    for prompts, sampling, how in runs:
        sp = sampling_cls(**sampling)
        groups = [[p] for p in prompts] if how == "each" else [prompts]
        out.append([r.generated_tokens for g in groups
                    for r in engine.generate(g, sp)])
    return out


def jax_side(params, cases) -> tuple:
    """({case: JAX's engine at tp 2}, {case: {tp: tokens a run}} at tp 2
    and 1)."""
    engines, runs = {}, {}
    for case in cases:
        over, requests = CASES[case]
        engines[case] = jax_engine(params, 2, **over)
        runs[case] = {2: runs_of(engines[case], requests),
                      1: runs_of(jax_engine(params, 1, **over), requests)}
    return engines, runs


def jax_parts(leaf) -> tuple:
    """A JAX leaf's arrays in the port's part order."""
    if hasattr(leaf, "packed"):
        return leaf.packed, leaf.scale, leaf.chan
    if hasattr(leaf, "values"):
        return leaf.values, leaf.scale
    return (leaf,)


def held(ranks, jax_runs, case):
    """The leader's tokens equal JAX's at tp 2 and tp 1; the ranks agree
    on what they sampled and ran. Returns the leader's result."""
    leader, follower = ranks[0][case], ranks[1][case]
    assert leader["tokens"] == jax_runs[case][2] == jax_runs[case][1], case
    a, b = leader["report"], follower["report"]
    assert a["token_digest"] == b["token_digest"]
    assert a["paged_passes"] == b["paged_passes"] > 0
    return leader


def shards_equal_jax(ranks, kind: str, eng) -> None:
    """Each rank holds JAX's shard of every leaf of ``eng`` (a JAX engine
    at tp 2 with weights of ``kind``), quantized leaves part by part, on
    its mesh position; some leaf is really cut."""
    cfg = jax_cfg("gpt-test")
    devs = list(eng.mesh.devices.reshape(-1))
    top = {"embed": eng.params["embed"]["embedding"],
           "final_norm": eng.params["final_norm"]["scale"]}
    blocks = eng.params["blocks"]
    leaves = {"q": blocks["q"]["kernel"], "k": blocks["k"]["kernel"],
              "v": blocks["v"]["kernel"], "o": blocks["o"]["kernel"],
              "gate": blocks["mlp"]["gate"]["kernel"],
              "up": blocks["mlp"]["up"]["kernel"],
              "down": blocks["mlp"]["down"]["kernel"],
              "attn_norm": blocks["attn_norm"]["scale"],
              "mlp_norm": blocks["mlp_norm"]["scale"]}
    cut = 0
    for rank, dev in enumerate(devs):
        got = ranks[rank]["shards"][kind]
        for name, leaf in {**top, **leaves}.items():
            for j, part in enumerate(jax_parts(leaf)):
                idx = part.sharding.devices_indices_map(part.shape)[dev]
                want = np.asarray(part)[idx]
                if name in top:
                    mine = got[name][j]
                else:
                    mine = np.stack([got[f"blocks.{i}.{name}"][j]
                                     for i in range(cfg.num_layers)])
                if want.dtype == jnp.bfloat16:
                    want = want.astype(np.float32)
                assert mine.shape == want.shape, (kind, name, j)
                np.testing.assert_array_equal(mine, want)
                cut += mine.size < np.asarray(part).size
    assert cut > 0, kind                       # really sharded


def tree_of(params):
    return jax.tree_util.tree_map(np.asarray, params)
