"""Quantized serving on the CPU: the port's engine against the JAX engine.

gpt-test in fp32, the ServeConfig of tests/test_torch_serve.py. Both engines
are fed the SAME quantized bytes (the JAX tree's quantized leaves go through
``weights.params_from_jax`` as numpy), so greedy and seeded output must be
token-identical for every ``quantization`` x ``kv_quantization`` pair; and
an engine that quantizes by itself must arrive at the bytes the JAX tree
quantizers give. Off the accelerator both engines take the dequant route
for the matmuls and the gather path for attention.

The shared prefix (two full pages) leaves suffixes of at most one page, so
the cached-prefix path writes through the window write; the longer suffix,
where the JAX int4 scatter loses a nibble, is held in
tests/test_torch_quant_ops.py.
"""

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
    quantization as jq)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling,
    kv_cache as jax_kv)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    paged_attention as tpa, quantization as tq)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, InferenceServer, SamplingParams, kv_cache as torch_kv)
from distributed_llm_training_and_inference_system_tpu_torch.serve.decode \
    import mm
from distributed_llm_training_and_inference_system_tpu_torch.serve.engine \
    import quantize_blocks
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")

_rs = np.random.RandomState(0)
_SHARED = [int(t) for t in _rs.randint(0, 256, 20)]     # 2 full pages + 4
PROMPTS = [
    _SHARED + [1, 2, 3],
    [int(t) for t in _rs.randint(0, 256, 7)],
    [5],
    [int(t) for t in _rs.randint(0, 256, 40)],
    [int(t) for t in _rs.randint(0, 256, 3)],
    _SHARED + [9, 9, 9],                # queued: hits the 2 cached pages
    [int(t) for t in _rs.randint(0, 256, 11)],
]
COMBOS = [("int8", "none"), ("int4", "none"), ("none", "int8"),
          ("none", "int4"), ("int8", "int8"), ("int4", "int4"),
          ("int8", "int4"), ("int4", "int8")]


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(3))


def _jax_quantized(params, kind):
    """The JAX engine's own quantization of a full-precision tree."""
    if kind == "int8":
        return dict(params, blocks=jq.to_runtime_quant(
            jq.quantize_tree_int8(params["blocks"], min_ndim=3)))
    if kind == "int4":
        return jq.to_runtime_quant(jq.quantize_tree_int4(dict(params)))
    return params


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           torch_cfg("gpt-test"), device="cpu")


def _engines(params, quantization, kv, tree=None, **over):
    tree = _jax_quantized(params, quantization) if tree is None else tree
    kw = dict(SERVE, quantization=quantization, kv_quantization=kv, **over)
    je = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(**kw),
                   params=tree, seed=0)
    te = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**kw),
                         params=_to_torch(tree), seed=0, device="cpu")
    return je, te


def _tokens(reqs):
    return [r.generated_tokens for r in reqs]


@pytest.mark.parametrize("quantization,kv", COMBOS)
def test_greedy_token_identical_to_jax(params, quantization, kv):
    je, te = _engines(params, quantization, kv)
    greedy = dict(temperature=0.0, max_tokens=12)
    ref = je.generate(PROMPTS, JaxSampling(**greedy))
    out = te.generate(PROMPTS, SamplingParams(**greedy))
    assert _tokens(out) == _tokens(ref)
    st, rst = te.stats(), je.stats()
    for key in ("prefill_tokens", "prefix_cached_tokens", "decode_steps",
                "weight_bytes"):
        assert st[key] == rst[key], key
    assert st["prefix_cached_tokens"] == 16          # the extend path ran
    assert st["quantization"] == quantization
    assert st["kv"]["kv_quantization"] == rst["kv"]["kv_quantization"] == kv
    assert st["kv"]["hbm_bytes"] == rst["kv"]["hbm_bytes"]
    assert st["nonfinite_logits"] == 0


@pytest.mark.parametrize("quantization,kv", [("int8", "int8"),
                                             ("int4", "int4"),
                                             ("int8", "int4")])
def test_seeded_sampling_token_identical_to_jax(params, quantization, kv):
    je, te = _engines(params, quantization, kv)
    kw = dict(temperature=0.9, top_k=20, top_p=0.9, max_tokens=10, seed=77)
    ref = je.generate(PROMPTS[:5], JaxSampling(**kw))
    out = te.generate(PROMPTS[:5], SamplingParams(**kw))
    assert _tokens(out) == _tokens(ref)


@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_engine_quantizes_to_the_bytes_of_the_jax_tree_quantizers(
        params, quantization):
    ref = _jax_quantized(params, quantization)["blocks"]
    plain = _to_torch(params)
    eng = InferenceEngine(
        torch_cfg("gpt-test"),
        ServeConfig(**SERVE, quantization=quantization), params=plain,
        seed=0, device="cpu")
    paths = {"q": ("q", "kernel"), "k": ("k", "kernel"), "v": ("v", "kernel"),
             "o": ("o", "kernel"), "gate": ("mlp", "gate", "kernel"),
             "up": ("mlp", "up", "kernel"), "down": ("mlp", "down", "kernel")}
    for i, blk in enumerate(eng.params.blocks):
        for name, path in paths.items():
            node = ref
            for p in path:
                node = node[p]
            leaf = getattr(blk, name)
            if quantization == "int8":
                assert isinstance(leaf, tq.QuantTensor)
                pairs = ((node.values, leaf.values), (node.scale, leaf.scale))
            else:
                assert isinstance(leaf, tq.Quant4Tensor)
                assert leaf.group == node.group
                pairs = ((node.packed, leaf.packed),
                         (node.scale, leaf.scale), (node.chan, leaf.chan))
            for a, b in pairs:
                np.testing.assert_array_equal(np.asarray(a)[i], b.numpy())
        assert isinstance(blk.attn_norm, torch.nn.Parameter)
    # the caller's model keeps its full-precision kernels
    assert isinstance(plain.blocks[0].q, torch.nn.Parameter)
    assert eng.params.embed is plain.embed
    assert eng.stats()["weight_bytes"] == jq.tree_weight_bytes(
        _jax_quantized(params, quantization))
    assert eng.stats()["weight_bytes"] < plain.weight_bytes()
    # a model the engine made itself gives up its full-precision kernels
    own = quantize_blocks(_to_torch(params), quantization, free_source=True)
    assert isinstance(own.blocks[1].down, (tq.QuantTensor, tq.Quant4Tensor))


def test_export_form_and_nontrivial_chan_cross_the_bridge(params):
    """Export-form marker dicts and a Quant4Tensor whose channel scales are
    not all ones: the same bytes on both sides, the same tokens."""
    marked = jq.quantize_tree_int4(dict(params))
    assert marked["blocks"]["q"]["kernel"]["__quant__"] == "int4"
    from_markers = _to_torch(marked)
    from_runtime = _to_torch(jq.to_runtime_quant(marked))
    for a, b in zip(from_markers.blocks, from_runtime.blocks):
        for name in ("q", "down"):
            for x, y in zip(getattr(a, name).tensors(),
                            getattr(b, name).tensors()):
                assert torch.equal(x, y)
    # channel scales 2 and 1/2 (exact in any arithmetic) on the q kernels
    H = jax_cfg("gpt-test").hidden_size
    act = jnp.tile(jnp.asarray([4.0, 0.25], jnp.float32), H // 2)[None]
    act = jnp.repeat(act, 2, axis=0)
    tree = jq.to_runtime_quant(marked)
    packed, scale, chan = jq.quantize_int4_groupwise(
        params["blocks"]["q"]["kernel"], group=64, act_scale=act)
    tree["blocks"] = dict(tree["blocks"], q={"kernel": jq.Quant4Tensor(
        packed, scale, chan, group=64)})
    je, te = _engines(params, "int4", "int4", tree=tree)
    assert bool((te.params.blocks[0].q.chan != 1).any())
    np.testing.assert_array_equal(te.params.blocks[1].q.chan.numpy(),
                                  np.asarray(chan)[1])
    greedy = dict(temperature=0.0, max_tokens=8)
    assert _tokens(te.generate(PROMPTS[:4], SamplingParams(**greedy))) == \
        _tokens(je.generate(PROMPTS[:4], JaxSampling(**greedy)))
    with pytest.raises(ValueError, match="no runtime form"):
        _to_torch(dict(params, blocks=dict(params["blocks"], q={"kernel": {
            "__quant__": "int8-awq", "values": 0, "scale": 0, "chan": 0}})))


@pytest.mark.parametrize("kind", ["none", "int8", "int4", True])
def test_pool_autosize_and_bytes_match_jax_per_kind(kind):
    """The uncapped autosize (D+4 and D/2+4 bytes per row) and the cap of
    every slot resident, both against the JAX cache; llama-8b-gqa geometry
    for the first."""
    for model, kw in (
            ("llama-8b-gqa", dict(num_slots=4096, max_seq_len=2048,
                                  page_size=64, hbm_budget_gb=0.05)),
            ("gpt-test", dict(num_slots=4, max_seq_len=128, page_size=8,
                              hbm_budget_gb=4.0))):
        j = jax_kv.PagedKVCache(jax_cfg(model), **kw, dtype=jnp.bfloat16,
                                quantized=kind)
        t = torch_kv.PagedKVCache(torch_cfg(model), **kw,
                                  dtype=torch.bfloat16, device="cpu",
                                  quantized=kind)
        assert t.num_pages == j.num_pages
        assert t.hbm_bytes() == j.hbm_bytes()
        assert t.stats()["kv_quantization"] == j.stats()["kv_quantization"]
        assert t.quantized == j.quantized
    if kind == "int4":
        assert isinstance(t.k_pages, tpa.Int4Pages)
        assert t.k_pages.shape == (2, 65, 2, 8, 16)
        assert t.k_pages[1].values.shape == (65, 2, 4, 16)


def test_pool_refuses_unknown_kinds_and_odd_int4_pages():
    cfg = torch_cfg("gpt-test")
    with pytest.raises(ValueError, match="none|int8|int4"):
        torch_kv.PagedKVCache(cfg, 2, 64, device="cpu", quantized="fp8")
    with pytest.raises(ValueError, match="even"):
        torch_kv.PagedKVCache(cfg, 2, 64, page_size=7, device="cpu",
                              quantized="int4")


@pytest.mark.parametrize("over,item", [
    ({"quantization": "int4-awq"}, "int4-awq"),
    ({"artifact": "/nonexistent/artifact"}, "none"),
])
def test_awq_and_artifacts_still_refuse_naming_their_item(params, over, item):
    """int4-awq and artifacts are ported: the engine no longer refuses
    them and reports the quantization the JAX engine reports (an artifact
    beside given params is not read, as in the JAX engine)."""
    eng = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**SERVE, **over),
                          params=_to_torch(params), device="cpu")
    assert eng.stats()["quantization"] == item


def test_mm_routes_by_shape_and_device():
    """On the CPU every quantized weight takes the dequant route, whatever
    the flags; the result is the plain product with the dequantized
    weight."""
    rs = np.random.RandomState(1)
    w = torch.from_numpy((rs.randn(256, 128) * 0.05).astype(np.float32))
    a = torch.from_numpy(rs.randn(2, 3, 256).astype(np.float32))
    q8 = tq.QuantTensor(*tq.quantize_int8(w))
    q4 = tq.Quant4Tensor(*tq.quantize_int4_groupwise(w, 128), group=128)
    for q in (q8, q4):
        out = mm(a, q, torch.float32, w4_kernel_ok=True, w8_kernel_ok=True)
        assert torch.equal(out, a @ q.dequant(torch.float32))
    assert torch.equal(mm(a, w, torch.float32), a @ w)


def test_dense_forward_dequantizes_quantized_blocks(params):
    """``forward`` over a model with quantized kernels equals ``forward``
    over the model built from the dequantized kernels."""
    tree = _jax_quantized(params, "int4")
    model = _to_torch(tree)
    blocks = [{n: (leaf.dequant(torch.float32)
                   if isinstance(leaf, tq.Quant4Tensor) else leaf)
               for n, leaf in blk.leaves().items()} for blk in model.blocks]
    dense = model.with_block_leaves(
        [{n: (torch.nn.Parameter(v) if not isinstance(v, torch.nn.Parameter)
              else v) for n, v in b.items()} for b in blocks])
    tokens = torch.tensor([PROMPTS[3]])
    with torch.inference_mode():
        a = tgpt.forward(model, tokens)
        b = tgpt.forward(dense, tokens)
    assert torch.equal(a, b)


@pytest.mark.socket
def test_server_health_reports_the_quantization(params):
    import json
    import urllib.request
    srv = InferenceServer(
        torch_cfg("gpt-test"),
        ServeConfig(**SERVE, host="127.0.0.1", port=0, quantization="int8",
                    kv_quantization="int4"),
        params=_to_torch(params), device="cpu")
    port = srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            health = json.loads(r.read())
    finally:
        srv.stop()
    assert health["engine"]["quantization"] == "int8"
    assert health["engine"]["kv"]["kv_quantization"] == "int4"
