"""The port's quantizers, packers and tree helpers against the JAX package.

The same numpy inputs go through ``ops/quantization.py`` of both packages.
Quantized values, scales and packed bytes must be BITWISE equal: both round
half to even, divide in fp32 and floor the scale at 1e-12. Dequantized
values are compared bitwise too (the same products in the same dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.ops import (
    quantization as jq)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    quantization as tq)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(jax_out, torch_out):
    for a, b in zip(jax_out, torch_out):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _x(shape, seed=0, dtype=np.float32):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * rs.choice([1e-3, 1.0, 40.0])).astype(dtype)
    x.flat[::7] = 0.0
    return x


@pytest.mark.parametrize("shape", [(5, 16), (2, 3, 128), (4, 2, 8, 64)])
def test_quantize_int8_rows_bitwise(shape):
    x = _x(shape, seed=len(shape))
    _same(jq.quantize_int8_rows(jnp.asarray(x)),
          tq.quantize_int8_rows(_t(x)))
    q, s = tq.quantize_int8_rows(_t(x))
    _same([jq.dequantize_int8_rows(jnp.asarray(q.numpy()),
                                   jnp.asarray(s.numpy()))],
          [tq.dequantize_int8_rows(q, s)])


def test_quantize_int8_rows_of_zeros_keeps_the_scale_floor():
    q, s = tq.quantize_int8_rows(torch.zeros(3, 8))
    assert (q == 0).all() and (s == np.float32(1e-12)).all()


@pytest.mark.parametrize("axis", [-1, -2, 0, 2])
def test_quantize_int8_both_axes_bitwise(axis):
    x = _x((3, 32, 48), seed=axis + 5)
    _same(jq.quantize_int8(jnp.asarray(x), axis),
          tq.quantize_int8(_t(x), axis))
    q, s = tq.quantize_int8(_t(x), axis)
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        ref = jq.dequantize_int8(jnp.asarray(q.numpy()),
                                 jnp.asarray(s.numpy()), dt_j)
        out = tq.dequantize_int8(q, s, dt_t)
        np.testing.assert_array_equal(
            np.asarray(ref.astype(jnp.float32)), out.float().numpy())


def test_bf16_input_quantizes_like_jax():
    x = _x((6, 64), seed=9)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = _t(x).to(torch.bfloat16)
    _same(jq.quantize_int8_rows(xj), tq.quantize_int8_rows(xt))
    _same(jq.quantize_int4_rows(xj), tq.quantize_int4_rows(xt))


@pytest.mark.parametrize("shape", [(7, 16), (2, 5, 2, 64)])
def test_quantize_int4_rows_bitwise(shape):
    x = _x(shape, seed=3)
    _same(jq.quantize_int4_rows(jnp.asarray(x)),
          tq.quantize_int4_rows(_t(x)))


@pytest.mark.parametrize("axis", [-2, 0, -1])
@pytest.mark.parametrize("n", [8, 5, 1])
def test_pack_unpack_int4_rows_bitwise_including_odd_counts(n, axis):
    rs = np.random.RandomState(n)
    shape = [3, 4, 6]
    shape[axis] = n
    q = rs.randint(-8, 8, shape).astype(np.int8)
    ref = jq.pack_int4_rows(jnp.asarray(q), axis)
    out = tq.pack_int4_rows(_t(q), axis)
    _same([ref], [out])
    _same([jq.unpack_int4_rows(ref, axis), jq.unpack_int4_rows(ref, axis, n)],
          [tq.unpack_int4_rows(out, axis), tq.unpack_int4_rows(out, axis, n)])
    np.testing.assert_array_equal(
        tq.unpack_int4_rows(out, axis, n).numpy(), q)


def test_dequantize_int4_rows_bitwise():
    x = _x((3, 2, 8, 16), seed=4)
    qv, sc = tq.quantize_int4_rows(_t(x))
    packed = tq.pack_int4_rows(qv, axis=-2)
    _same([jq.dequantize_int4_rows(jnp.asarray(packed.numpy()),
                                   jnp.asarray(sc.numpy()))],
          [tq.dequantize_int4_rows(packed, sc)])


@pytest.mark.parametrize("block", [32, 16])
def test_int4_blockwise_bitwise(block):
    x = _x((4, 6, 64), seed=block)
    ref = jq.quantize_int4_blockwise(jnp.asarray(x), block)
    out = tq.quantize_int4_blockwise(_t(x), block)
    _same(ref, out)
    _same([jq.dequantize_int4_blockwise(*ref, block, jnp.float32)],
          [tq.dequantize_int4_blockwise(*out, block, torch.float32)])
    with pytest.raises(ValueError):
        tq.quantize_int4_blockwise(_t(x), 48)


def _exact_act(n_in, layers=2):
    """A channel statistic whose AWQ scale is exact in any arithmetic:
    alternating 4 and 1/4 (then 16 and 1/16) have geometric mean 1, so
    chan = sqrt(act) is 2, 1/2 (4, 1/4) whatever the order of the sum of
    logs."""
    act = np.tile(np.array([4.0, 0.25], np.float32), n_in // 2)
    act = np.stack([act * (1 if i % 2 == 0 else act) for i in range(layers)])
    return act.astype(np.float32)


@pytest.mark.parametrize("with_chan", [False, True])
@pytest.mark.parametrize("group,n_in", [(128, 256), (64, 128), (32, 64)])
def test_int4_groupwise_bitwise_with_and_without_chan(group, n_in, with_chan):
    x = _x((2, n_in, 48), seed=group)
    act = _exact_act(n_in) if with_chan else None
    ref = jq.quantize_int4_groupwise(
        jnp.asarray(x), group, None if act is None else jnp.asarray(act))
    out = tq.quantize_int4_groupwise(_t(x), group,
                                     None if act is None else _t(act))
    _same(ref, out)
    assert bool((out[2] != 1).any()) == with_chan
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        dref = jq.dequantize_int4_groupwise(*ref, group, dt_j)
        dout = tq.dequantize_int4_groupwise(*out, group, dt_t)
        np.testing.assert_array_equal(
            np.asarray(dref.astype(jnp.float32)), dout.float().numpy())


def test_quant_tensors_report_the_logical_shape_and_dequantize():
    x = _x((2, 128, 48), seed=1)
    act = _exact_act(128)
    packed, scale, chan = tq.quantize_int4_groupwise(_t(x), 64, _t(act))
    q4 = tq.Quant4Tensor(packed, scale, chan, group=64)
    j4 = jq.Quant4Tensor(jnp.asarray(packed.numpy()),
                         jnp.asarray(scale.numpy()),
                         jnp.asarray(chan.numpy()), group=64)
    assert q4.shape == tuple(j4.shape) == (2, 128, 48) and q4.ndim == 3
    np.testing.assert_array_equal(
        np.asarray(j4.dequant(jnp.float32)), q4.dequant(torch.float32).numpy())
    values, s8 = tq.quantize_int8(_t(x))
    q8 = tq.QuantTensor(values, s8)
    assert q8.shape == (2, 128, 48) and q8.ndim == 3
    np.testing.assert_array_equal(
        np.asarray(jq.QuantTensor(jnp.asarray(values.numpy()),
                                  jnp.asarray(s8.numpy())
                                  ).dequant(jnp.float32)),
        q8.dequant(torch.float32).numpy())


@pytest.mark.parametrize("name", [
    "delta_encode_planes_np", "delta_decode_planes_np", "unpack_nibbles_np",
    "pack_nibbles_np", "nibble_delta_encode_np", "nibble_delta_decode_np"])
def test_numpy_helpers_equal_the_jax_packages(name):
    rs = np.random.RandomState(2)
    a = rs.randint(0, 256, (3, 2, 8, 16)).astype(np.uint8)
    if name == "pack_nibbles_np":
        a = a & 0xF
    if name.startswith("delta"):
        a = a.view(np.int8)
    np.testing.assert_array_equal(getattr(tq, name)(a), getattr(jq, name)(a))


def test_numpy_nibble_helpers_equal_the_tensor_ones():
    rs = np.random.RandomState(3)
    packed = rs.randint(0, 256, (2, 4, 16)).astype(np.uint8)
    raw = tq.unpack_nibbles_np(packed, axis=-2)
    signed = tq.unpack_int4_rows(_t(packed), axis=-2).numpy()
    np.testing.assert_array_equal(raw.astype(np.int8) & 0xF, signed & 0xF)
    np.testing.assert_array_equal(tq.pack_nibbles_np(raw, axis=-2), packed)
    np.testing.assert_array_equal(
        tq.pack_int4_rows(_t(signed), axis=-2).numpy(), packed)
    for enc, dec in ((tq.delta_encode_planes_np, tq.delta_decode_planes_np),
                     (tq.nibble_delta_encode_np, tq.nibble_delta_decode_np)):
        np.testing.assert_array_equal(dec(enc(packed)), packed)


# -- tree quantizers on gpt-test ----------------------------------------------

@pytest.fixture(scope="module")
def trees():
    params = jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(1))
    as_np = jax.tree_util.tree_map(np.asarray, params)
    as_torch = jax.tree_util.tree_map(lambda a: _t(a), as_np)
    return params, as_torch


def _flat(tree, prefix=""):
    """{path: leaf} over nested dicts; marker dicts are descended too."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(jtree, ttree):
    jf, tf = _flat(jtree), _flat(ttree)
    assert sorted(jf) == sorted(tf)
    for key, a in jf.items():
        b = tf[key]
        if isinstance(a, (str, int)):
            assert a == b, key
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), key)


@pytest.mark.parametrize("min_ndim", [2, 3])
def test_quantize_tree_int8_bitwise(trees, min_ndim):
    params, tparams = trees
    # min_size 64 lets the [L, H] norm scales pass the size filter, so
    # that min_ndim alone decides whether they quantize
    kw = dict(min_size=64, min_ndim=min_ndim)
    ref = jq.quantize_tree_int8(params["blocks"], **kw)
    out = tq.quantize_tree_int8(tparams["blocks"], **kw)
    _assert_trees_equal(ref, out)
    quantized = [k for k in _flat(out) if k.endswith("__quant__")]
    assert len(quantized) == (9 if min_ndim == 2 else 7)


def test_quantize_tree_int4_bitwise_and_runtime_forms(trees):
    params, tparams = trees
    ref = jq.quantize_tree_int4(dict(params))
    out = tq.quantize_tree_int4(dict(tparams))
    _assert_trees_equal(ref, out)
    assert not isinstance(out["embed"]["embedding"], dict)
    assert out["blocks"]["q"]["kernel"]["group"] == 64       # H = 64
    rt = tq.to_runtime_quant(out)
    q = rt["blocks"]["mlp"]["down"]["kernel"]
    assert isinstance(q, tq.Quant4Tensor) and q.group == 128
    assert tq.tree_weight_bytes(rt) == jq.tree_weight_bytes(
        jq.to_runtime_quant(ref))
    deq = tq.dequantize_tree(out, torch.float32)
    dref = jq.dequantize_tree(ref, jnp.float32)
    _assert_trees_equal(dref, deq)
    with pytest.raises(ValueError, match="int8-awq"):
        tq.to_runtime_quant({"w": {"__quant__": "int8-awq", "values": 0,
                                   "scale": 0, "chan": 0}})


def test_cast_and_precast_params_semantics(trees):
    _, tparams = trees
    blocks = tq.to_runtime_quant(tq.quantize_tree_int8(tparams["blocks"],
                                                       min_ndim=3))
    pre = tq.precast_params(blocks, torch.bfloat16)
    assert isinstance(pre["q"]["kernel"], tq.QuantTensor)    # stays int8
    assert pre["attn_norm"]["scale"].dtype == torch.bfloat16
    layer = {"q": {"kernel": tq.QuantTensor(
        pre["q"]["kernel"].values[0], pre["q"]["kernel"].scale[0])},
        "n": pre["attn_norm"]["scale"][0]}
    cast = tq.cast_params(layer, torch.float32)
    assert cast["q"]["kernel"].dtype == torch.float32
    assert cast["n"].dtype == torch.float32
    kept = tq.cast_params(layer, torch.float32, keep_w8=True)
    assert isinstance(kept["q"]["kernel"], tq.QuantTensor)
    assert isinstance(tq.cast_params(layer, torch.float32, keep_w4=True)
                      ["q"]["kernel"], torch.Tensor)


def test_int4_group_falls_back_to_int8_where_no_group_divides():
    assert tq.int4_group_for(4096) == 128 and tq.int4_group_for(14336) == 128
    assert tq.int4_group_for(96) == 32 and tq.int4_group_for(7) == 0
    w = _t(_x((2, 7, 600), seed=8))
    out = tq.quantize_tree_int4({"k": w})
    ref = jq.quantize_tree_int4({"k": jnp.asarray(w.numpy())})
    assert out["k"]["__quant__"] == ref["k"]["__quant__"] == "int8"
    _assert_trees_equal(ref, out)
