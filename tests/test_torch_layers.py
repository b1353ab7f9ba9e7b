"""The port's layers and GPT forward against the JAX package's, on the same
numpy inputs and bridged params (fp32, CPU). Tolerances: 1e-5 for single
layers; 1e-4 (abs and rel) for whole-model logits, whose summation order
differs between the two frameworks."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt, layers as jl)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt, layers as tl)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_autograd():
    """The parameters are trainable; these comparisons need no graph."""
    with torch.no_grad():
        yield


def _np_params(cfg, seed=0):
    """JAX init params as numpy, with every leaf (norm scales and biases
    included, which init leaves at zero) perturbed so each one matters."""
    p = jgpt.init(cfg, jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rs.randn(*a.shape).astype(np.float32),
        p)


def _cfgs(tied=False, bias=False):
    j = dataclasses.replace(jax_cfg("gpt-test"), tie_word_embeddings=tied,
                            attention_bias=bias)
    t = dataclasses.replace(torch_cfg("gpt-test"), tie_word_embeddings=tied,
                            attention_bias=bias)
    return j, t


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 64).astype(np.float32)
    s = 0.1 * rs.randn(64).astype(np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    out = tl.rms_norm(_t(x), _t(s), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("scaling,factor", [("none", 1.0), ("linear", 4.0),
                                            ("ntk", 8.0)])
def test_rope_frequencies_match_jax(scaling, factor):
    for base in (10000.0, 500000.0):
        ref = np.asarray(jl.rope_frequencies(128, base, scaling, factor))
        out = tl.rope_frequencies(128, base, scaling, factor).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_apply_rope_rotates_split_halves_like_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(2, 7, 4, 16).astype(np.float32)
    pos = rs.randint(0, 100, (2, 7)).astype(np.int32)
    inv = jl.rope_frequencies(16, 10000.0)
    ref = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv))
    out = tl.apply_rope(_t(x), _t(pos), _t(inv)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_attention_mask_matches_jax():
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    seg = np.array([[1, 1, 1, 2, 2, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    ref = np.asarray(jl.attention_mask(jnp.asarray(pos), jnp.asarray(pos),
                                       jnp.asarray(seg), jnp.asarray(seg)))
    out = tl.attention_mask(_t(pos), _t(pos), _t(seg), _t(seg)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_dot_product_attention_gqa_mask_matches_jax():
    rs = np.random.RandomState(2)
    q = rs.randn(2, 5, 8, 16).astype(np.float32)
    k = rs.randn(2, 9, 2, 16).astype(np.float32)
    v = rs.randn(2, 9, 2, 16).astype(np.float32)
    mask = rs.rand(2, 5, 9) > 0.3
    mask[:, :, 0] = True
    assert tl.NEG_INF == jl.NEG_INF
    ref = np.asarray(jl.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    out = tl.dot_product_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_mlp_and_attention_blocks_match_jax():
    jcfg, tcfg = _cfgs(bias=True)
    p = _np_params(jcfg, seed=4)
    model = params_from_jax(p, tcfg, device="cpu")
    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 64).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    inv = jl.rope_frequencies(16, 10000.0)
    for i, blk in enumerate(model.blocks):
        layer = jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]),
                                       p["blocks"])
        ref = np.asarray(jl.mlp_block(jnp.asarray(x), layer["mlp"], jcfg))
        out = tl.mlp_block(_t(x), blk, tcfg).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
        ref_a, _ = jl.attention_block(jnp.asarray(x), layer, jcfg,
                                      jnp.asarray(pos), None, inv)
        out_a, _ = tl.attention_block(_t(x), blk, tcfg, _t(pos), None,
                                      _t(inv))
        np.testing.assert_allclose(out_a.numpy(), np.asarray(ref_a),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("tied,bias", [(False, False), (True, False),
                                       (False, True)])
def test_forward_logits_match_jax(tied, bias):
    jcfg, tcfg = _cfgs(tied, bias)
    p = _np_params(jcfg, seed=7)
    model = params_from_jax(p, tcfg, device="cpu")
    toks = np.random.RandomState(8).randint(0, 256, (2, 12)).astype(np.int32)
    ref = np.asarray(jgpt.forward(p, jnp.asarray(toks), jcfg))
    out = tgpt.forward(model, _t(toks).long(), tcfg).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_forward_with_dense_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    p = _np_params(jcfg, seed=9)
    model = params_from_jax(p, tcfg, device="cpu")
    toks = np.random.RandomState(10).randint(0, 256, (2, 8)).astype(np.int32)
    off = np.array([0, 5], np.int32)
    unembed = np.array([7, 2], np.int32)
    jc = jgpt.init_kv_cache(jcfg, 2, 16, dtype=jnp.float32)
    ref, (jk, jv) = jgpt.forward(p, jnp.asarray(toks), jcfg, kv_cache=jc,
                                 cache_offset=jnp.asarray(off),
                                 unembed_positions=jnp.asarray(unembed))
    tc = tgpt.init_kv_cache(tcfg, 2, 16, dtype=torch.float32, device="cpu")
    out, (tk, tv) = tgpt.forward(model, _t(toks).long(), tcfg, kv_cache=tc,
                                 cache_offset=_t(off).long(),
                                 unembed_positions=_t(unembed))
    assert out.shape == (2, 1, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    # the cache was written in place
    assert tk.data_ptr() == tc[0].data_ptr()


def test_return_hidden_is_final_normed():
    jcfg, tcfg = _cfgs()
    p = _np_params(jcfg, seed=11)
    model = params_from_jax(p, tcfg, device="cpu")
    toks = np.arange(10, dtype=np.int32)[None]
    ref = np.asarray(jgpt.forward(p, jnp.asarray(toks), jcfg,
                                  return_hidden=True))
    out = tgpt.forward(model, _t(toks).long(), tcfg, return_hidden=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_init_distributions():
    cfg = torch_cfg("gpt-test")
    gen = torch.Generator().manual_seed(0)
    m = tgpt.init(cfg, gen, device="cpu")
    q = torch.cat([b.q.flatten() for b in m.blocks])
    # a normal truncated at +-3 sigma has std 0.9866 sigma
    assert abs(q.std().item() - 0.02 * 0.9866) < 0.001
    assert q.abs().max().item() <= 3 * 0.02 + 1e-7
    o = torch.cat([b.o.flatten() for b in m.blocks])
    resid = 0.02 / math.sqrt(2 * cfg.num_layers)
    assert o.abs().max().item() <= 3 * resid + 1e-7
    assert all(float(b.attn_norm.abs().sum()) == 0 for b in m.blocks)
    assert m.lm_head is not None and m.lm_head.shape == (64, 256)
    tied = tgpt.init(dataclasses.replace(cfg, tie_word_embeddings=True),
                     device="cpu")
    assert tied.lm_head is None
    assert all(p.requires_grad for p in m.parameters())   # trainable
    # same seed, same weights
    again = tgpt.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.blocks[1].down, m.blocks[1].down)


def test_flops_per_token_and_param_count_match_jax():
    for name in ("gpt-test", "llama-8b-gqa", "gpt-7b"):
        assert tgpt.flops_per_token(torch_cfg(name), 2048) == \
            jgpt.flops_per_token(jax_cfg(name), 2048)
    cfg = torch_cfg("gpt-test")
    m = tgpt.init(cfg, device="cpu")
    assert sum(p.numel() for p in m.parameters()) == cfg.param_count


def test_params_from_jax_checks_shapes():
    jcfg, tcfg = _cfgs()
    p = _np_params(jcfg)
    with pytest.raises(ValueError):
        params_from_jax(p, dataclasses.replace(tcfg, num_layers=3),
                        device="cpu")
    with pytest.raises(ValueError):
        params_from_jax(p, dataclasses.replace(tcfg, ffn_size=96),
                        device="cpu")
