"""Tensor-parallel serving in the port against the JAX engine.

The cases of the JAX package's ``tests/test_tp_serve.py`` run on two gloo
ranks of the port (``tests/torch_dist_ranks.py`` ``serve_rank``: one
spawn a file), each rank built from the JAX params tree by
``weights.rank_params_from_jax`` (quantized whole, then cut). The bar is
the reference's: the port's tp=2 greedy and seeded output equals, token
for token, both the JAX engine at tp=2 (GSPMD on two fake CPU devices) and
at tp=1, on gpt-test in fp32. Tolerance: none. The quantized cases (int8
weights, int8 KV, int4 KV) are ``test_torch_tp_serve_quant.py``'s.

Also held here: each rank's shard of every leaf is the bytes JAX places
on that mesh position (``NamedSharding.devices_indices_map``); the pages
hold Nkv/tp heads; the ranks' sampled-token digests and paged passes
agree; chunked prefill with swap preemption and speculation at tp=2
equals the port at tp=1; tp=3 raises "must divide"; MoE under tp raises
naming its ROADMAP item; and a follower that leaves makes the leader's
next request raise within seconds, after which the engine does not
recover.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_ranks as R
import torch_tp_cases as C
from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt, init as jax_init)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

SPAWNED = ("plain", "spec_prefix", "features")
JAX_CASES = ("plain", "spec_prefix")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tree(params):
    return C.tree_of(params)


@pytest.fixture(scope="module")
def ranks(tree):
    """Both ranks' results of this file's cases (one spawn)."""
    return R.spawn(R.serve_rank, 2, tree,
                   {c: C.CASES[c] for c in SPAWNED}, ("none",))


@pytest.fixture(scope="module")
def jax_side(params):
    return C.jax_side(params, JAX_CASES)


class TestTensorParallelServe:
    def test_params_and_pages_actually_sharded(self, ranks, jax_side):
        """Each rank holds JAX's shard of every leaf on its mesh position,
        and its pages hold Nkv/2 heads."""
        jeng = jax_side[0]["plain"]
        C.shards_equal_jax(ranks, "none", jeng)
        shard = jeng.kv.k_pages.sharding.shard_shape(jeng.kv.k_pages.shape)
        for r in ranks:
            assert r["plain"]["pages"][2] == shard[2] == \
                jax_cfg("gpt-test").num_kv_heads // 2

    def test_tp2_greedy_matches_single_device(self, ranks, jax_side):
        C.held(ranks, jax_side[1], "plain")

    def test_tp2_concurrent_requests(self, params, ranks, jax_side):
        leader = C.held(ranks, jax_side[1], "plain")
        for prompt, toks in zip(C.PROMPTS, leader["tokens"][1]):
            logits_ref = jgpt.forward(params, jnp.asarray([prompt]),
                                      jax_cfg("gpt-test"))
            assert toks[0] == int(jnp.argmax(logits_ref[0, -1])), prompt

    def test_tp2_with_speculation_and_prefix_cache(self, ranks, jax_side):
        leader = C.held(ranks, jax_side[1], "spec_prefix")
        assert leader["tokens"][0] == leader["tokens"][1]   # cache hit run
        assert leader["stats"]["spec_dispatches"] > 0
        assert leader["stats"]["kv"]["prefix_hits"] > 0

    def test_tp2_sampled_matches_single_device(self, ranks, jax_side):
        leader = C.held(ranks, jax_side[1], "plain")
        assert leader["tokens"][2] == jax_side[1]["plain"][1][2]

    def test_tp_must_divide_heads(self, tree):
        with pytest.raises(ValueError, match="must divide"):
            InferenceEngine(torch_cfg("gpt-test"),
                            ServeConfig(**R.SERVE, tensor_parallel=3),
                            params=params_from_jax(tree,
                                                   torch_cfg("gpt-test"),
                                                   device="cpu"),
                            device="cpu")


def test_tp2_chunked_prefill_swap_and_speculation_match_tp1(tree, ranks):
    """Chunked prefill, swap preemption (each rank's payload of its heads
    written back) and speculation at tp=2 give the port's tp=1 tokens."""
    over, runs = C.CASES["features"]
    one = InferenceEngine(torch_cfg("gpt-test"),
                          ServeConfig(**R.SERVE, **over),
                          params=params_from_jax(tree, torch_cfg("gpt-test"),
                                                 device="cpu"),
                          seed=0, device="cpu")
    want = C.runs_of(one, runs, SamplingParams)
    leader, follower = ranks[0]["features"], ranks[1]["features"]
    assert leader["tokens"] == want
    st = leader["stats"]
    assert st["swap_ins"] > 0 and st["chunked_prefills"] > 0
    assert st["spec_dispatches"] > 0
    for key in ("swap_ins", "swap_outs", "swap_out_bytes", "preemptions",
                "prefill_tokens", "decode_steps"):
        assert st[key] == one.stats()[key], key
    assert (leader["report"]["token_digest"]
            == follower["report"]["token_digest"])


def test_moe_under_tp_is_refused():
    with pytest.raises(NotImplementedError, match="item 7b"):
        InferenceEngine(torch_cfg("gpt-test-moe"),
                        ServeConfig(**{**R.SERVE, "model": "gpt-test-moe"},
                                    tensor_parallel=2), device="cpu")


def test_a_follower_that_leaves_fails_the_leader(tree):
    """The follower leaves at the second request's prefill: the leader's
    collective raises within seconds (not the group's timeout), and the
    engine reports it cannot recover."""
    first, err, seconds, recovered = R.spawn(R.dead_follower_rank, 2,
                                             tree)[0]
    assert len(first) == 4
    assert err in ("RuntimeError", "DistBackendError"), err
    assert seconds < 30 and recovered is False


def test_tied_head_and_an_uncut_ffn_match_tp1():
    """A tied head (each rank's hidden slice of the embedding, the partial
    logits all-reduced) and an FFN width tp does not divide (whole on each
    rank, no all-reduce after down) give the one-rank engine's tokens."""
    got, want, shapes = R.spawn(R.odd_shapes_rank, 2)[0]
    assert got == want
    assert shapes == ((256, 32), (64, 99))
