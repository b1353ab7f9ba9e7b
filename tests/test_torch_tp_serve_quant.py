"""Tensor-parallel serving of quantized weights and pages in the port
against the JAX engine.

The quantized cases of the JAX package's ``tests/test_tp_serve.py`` (int8
weights, int8 KV pages, int4 KV pages) on two gloo ranks of the port (one
spawn), held token for token to the JAX engine at tp=2 and at tp=1 on
gpt-test in fp32 (tolerance: none); and each rank's shard of every leaf
of int8 and int4 weights, the parts of ``QuantTensor`` (values, scale)
and ``Quant4Tensor`` (packed, group scale, chan) included, equal to the
bytes JAX places on that mesh position. The pool reports the JAX
engine's global pages and bytes.
"""

import jax
import pytest
import torch

import torch_dist_ranks as R
import torch_tp_cases as C
from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)

CASES = ("int8", "int8_kv", "int4_kv")


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
def ranks(params):
    """Both ranks' results of the quantized cases and their int8 and int4
    shards (one spawn)."""
    return R.spawn(R.serve_rank, 2, C.tree_of(params),
                   {c: C.CASES[c] for c in CASES}, ("int8", "int4"))


@pytest.fixture(scope="module")
def jax_side(params):
    return C.jax_side(params, CASES)


def test_quantized_leaves_sharded_as_jax_shards_them(params, ranks,
                                                     jax_side):
    C.shards_equal_jax(ranks, "int8", jax_side[0]["int8"])
    C.shards_equal_jax(ranks, "int4",
                       C.jax_engine(params, 2, quantization="int4"))


def test_tp2_int8_matches_single_device_int8(ranks, jax_side):
    leader = C.held(ranks, jax_side[1], "int8")
    assert leader["stats"]["quantization"] == "int8"


def test_tp2_int8_kv_matches_single_device(ranks, jax_side):
    leader = C.held(ranks, jax_side[1], "int8_kv")
    assert leader["stats"]["kv"]["kv_quantization"] == "int8"


def test_tp2_int4_kv_matches_single_device(ranks, jax_side):
    leader = C.held(ranks, jax_side[1], "int4_kv")
    jeng = jax_side[0]["int4_kv"]
    assert leader["stats"]["kv"]["hbm_bytes"] == jeng.kv.hbm_bytes()
    assert leader["stats"]["kv"]["num_pages"] == jeng.kv.num_pages
