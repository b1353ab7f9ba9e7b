"""The port's quantized ops on the CPU against the JAX package: page
writes into int8/int4 pages (bitwise), paged attention over them, the
W8A16 and W4A16 matmuls' plain versions against the Pallas kernels in
interpret mode, and RMSNorm through ``impl``.

Tolerances are stated where they are used: writes are bitwise; attention
1e-5 (fp32, summation order); matmuls 1e-5 of the output's largest value
(fp32 sums of the same products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.models import (
    layers as jlayers)
from distributed_llm_training_and_inference_system_tpu.ops import (
    int4_matmul_pallas as jw4, int8_matmul_pallas as jw8,
    paged_attention as jpa, paged_attention_pallas as jpp,
    quantization as jq, rmsnorm as jrms)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    layers as tlayers)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    int4_matmul as tw4, int8_matmul as tw8, paged_attention as tpa,
    paged_attention_cuda as pac, quantization as tq)
from distributed_llm_training_and_inference_system_tpu_torch.ops.rmsnorm \
    import rms_norm_fused, rmsnorm_kernel

NP, NKV, PS, D, B, MAXP = 12, 2, 8, 16, 4, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables():
    bt = np.zeros((B, MAXP), np.int32)
    bt[0, :2] = [3, 7]
    bt[1, :4] = [1, 2, 4, 5]
    bt[3, :3] = [6, 8, 10]
    return bt                               # slot 2 owns nothing (scratch)


def _pages(kind, seed):
    """The same random page content, quantized, for both packages."""
    rs = np.random.RandomState(seed)
    dense = rs.randn(NP, NKV, PS, D).astype(np.float32)
    if kind == "int8":
        q, s = tq.quantize_int8_rows(_t(dense))
        return (jpa.QuantPages(jnp.asarray(q.numpy()), jnp.asarray(s.numpy())),
                tpa.QuantPages(q, s))
    q, s = tq.quantize_int4_rows(_t(dense))
    packed = tq.pack_int4_rows(q, axis=-2)
    return (jpa.Int4Pages(jnp.asarray(packed.numpy()),
                          jnp.asarray(s.numpy())),
            tpa.Int4Pages(packed, s))


def _assert_pages_equal(jp, tp, before):
    """Bitwise on every page but scratch; scratch page 0 is as it was."""
    np.testing.assert_array_equal(np.asarray(jp.values)[1:],
                                  tp.values.numpy()[1:])
    np.testing.assert_array_equal(np.asarray(jp.scale)[1:],
                                  tp.scale.numpy()[1:])
    if before is not None:
        np.testing.assert_array_equal(tp.values.numpy()[0], before[0])
        np.testing.assert_array_equal(tp.scale.numpy()[0], before[1])


def test_page_classes_report_logical_shapes_and_layer_views():
    _, p8 = _pages("int8", 0)
    _, p4 = _pages("int4", 0)
    assert p8.shape == p4.shape == (NP, NKV, PS, D)
    assert p4.values.shape == (NP, NKV, PS // 2, D)
    assert isinstance(p4, tpa.QuantPages)          # Int4Pages tested first
    layer = p4[3]
    assert isinstance(layer, tpa.Int4Pages)
    layer.values.fill_(7)                           # a view: reaches the pool
    assert (p4.values[3] == 7).all()
    jp8, _ = _pages("int8", 0)
    np.testing.assert_array_equal(np.asarray(jp8.dequant()),
                                  p8.dequant().numpy())


WINDOWS = {
    # starts per slot; slot 2 has no pages, so its rows go nowhere
    "T1": (1, [5, 31, 0, 16]),
    "T4": (4, [2, 20, 0, 9]),
    "crossing": (4, [6, 28, 0, 14]),     # slot 0 crosses pages 3 -> 7,
                                         # slot 1 ends in its last page,
                                         # slot 3 crosses 8 -> 10
    "full_page": (8, [8, 0, 0, 12]),
    "past_the_table": (4, [14, 30, 0, 22]),   # slots 0, 1, 3 run past their
                                              # chains / the table's end
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(WINDOWS))
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_write_window_bitwise_equal_to_jax(kind, case, masked):
    T, starts = WINDOWS[case]
    rs = np.random.RandomState(T + len(case))
    new = rs.randn(B, T, NKV, D).astype(np.float32)
    ok = None
    if masked:
        ok = rs.rand(B, T) > 0.4
        ok[1] = False                         # a slot that writes nothing
    jp, tp = _pages(kind, 1)
    before = (tp.values.numpy()[0].copy(), tp.scale.numpy()[0].copy())
    starts = np.array(starts, np.int32)
    ref = jpa.write_window_to_pages(
        jp, jnp.asarray(new), jnp.asarray(_tables()), jnp.asarray(starts),
        None if ok is None else jnp.asarray(ok))
    out = tpa.write_window_to_pages(
        tp, _t(new), _t(_tables()), _t(starts),
        None if ok is None else _t(ok))
    assert out is tp and type(out) is type(tp)       # in place
    _assert_pages_equal(ref, tp, before)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_write_token_bitwise_equal_to_jax(kind):
    rs = np.random.RandomState(5)
    new = rs.randn(B, NKV, D).astype(np.float32)
    positions = np.array([9, 31, 4, 17], np.int32)
    active = np.array([True, True, True, False])
    jp, tp = _pages(kind, 2)
    ref = jpa.write_token_to_pages(jp, jnp.asarray(new),
                                   jnp.asarray(_tables()),
                                   jnp.asarray(positions),
                                   jnp.asarray(active))
    out = tpa.write_token_to_pages(tp, _t(new), _t(_tables()),
                                   _t(positions), _t(active))
    assert out is tp
    _assert_pages_equal(ref, tp, None)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_window_write_equals_token_writes(kind):
    """The two write paths of the port agree bit for bit (what the JAX
    package asserts of its own pair)."""
    rs = np.random.RandomState(6)
    T = 4
    new = rs.randn(B, T, NKV, D).astype(np.float32)
    starts = np.array([6, 28, 0, 14], np.int32)
    _, a = _pages(kind, 3)
    _, b = _pages(kind, 3)
    tpa.write_window_to_pages(a, _t(new), _t(_tables()), _t(starts))
    pos = (starts[:, None] + np.arange(T)).reshape(-1)
    tpa.write_token_to_pages(b, _t(new.reshape(B * T, NKV, D)),
                             _t(np.repeat(_tables(), T, 0)), _t(pos))
    np.testing.assert_array_equal(a.values.numpy()[1:], b.values.numpy()[1:])
    np.testing.assert_array_equal(a.scale.numpy()[1:], b.scale.numpy()[1:])


def test_int4_long_suffix_write_keeps_both_nibbles():
    """A suffix prefill longer than a page flattens B*T rows into one
    ``write_token_to_pages`` call, where tokens 2i and 2i+1 share a byte.
    The port's pages must hold what quantizing and packing whole pages
    gives (what its dense prefill writes). The JAX package's single scatter
    builds both nibbles from the old byte and keeps one, so its pages
    differ there: ROADMAP queue 3 records that, and this test keeps the
    record true."""
    rs = np.random.RandomState(7)
    T = 2 * PS
    new = rs.randn(T, NKV, D).astype(np.float32)
    bt = np.array([[2, 4, 5, 0]], np.int32)
    pos = np.arange(PS, PS + T).astype(np.int32)      # one cached page
    qv, sc = tq.quantize_int4_rows(_t(new))
    want_v = np.zeros((NP, NKV, PS // 2, D), np.uint8)
    want_s = np.zeros((NP, NKV, PS), np.float32)
    for page, lo in ((4, 0), (5, PS)):
        want_v[page] = tq.pack_int4_rows(
            qv[lo:lo + PS].permute(1, 0, 2), axis=-2).numpy()
        want_s[page] = sc[lo:lo + PS].T.numpy()
    tp = tpa.Int4Pages(torch.zeros(NP, NKV, PS // 2, D, dtype=torch.uint8),
                       torch.zeros(NP, NKV, PS))
    tpa.write_token_to_pages(tp, _t(new), _t(np.repeat(bt, T, 0)), _t(pos))
    np.testing.assert_array_equal(tp.values.numpy()[1:], want_v[1:])
    np.testing.assert_array_equal(tp.scale.numpy()[1:], want_s[1:])
    jp = jpa.Int4Pages(jnp.zeros((NP, NKV, PS // 2, D), jnp.uint8),
                       jnp.zeros((NP, NKV, PS), jnp.float32))
    ref = jpa.write_token_to_pages(jp, jnp.asarray(new),
                                   jnp.asarray(np.repeat(bt, T, 0)),
                                   jnp.asarray(pos))
    np.testing.assert_array_equal(np.asarray(ref.scale)[1:], want_s[1:])
    assert not np.array_equal(np.asarray(ref.values)[1:], want_v[1:])


# -- paged attention over quantized pages -------------------------------------

@pytest.mark.parametrize("jax_impl", ["pallas", "gather"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_paged_attention_over_quantized_pages_matches_jax(kind, T, jax_impl):
    """GQA (4 q heads over 2 kv heads), ragged lengths, fp32: the port's
    gather version against the JAX Pallas kernel in interpret mode and the
    JAX gather path, 1e-5 (2e-5 over the longest sums)."""
    rs = np.random.RandomState(T)
    q = rs.randn(B, T, 4, D).astype(np.float32)
    jk, tk = _pages(kind, 10)
    jv, tv = _pages(kind, 11)
    starts = np.array([14 - T, 32 - T, 0, 19 - T], np.int32)
    if jax_impl == "pallas":
        ref = jpp.paged_attention_pallas_multi(
            jnp.asarray(q), jk, jv, jnp.asarray(_tables()),
            jnp.asarray(starts), interpret=True)
    else:
        ref = jpa.paged_attention_multi(
            jnp.asarray(q), jk, jv, jnp.asarray(_tables()),
            jnp.asarray(starts), impl="gather")
    counters = (pac.paged_attention_int8_kernel, pac.paged_attention_int4_kernel)
    before = [c.launches for c in counters]
    out = tpa.paged_attention_multi(_t(q), tk, tv, _t(_tables()), _t(starts))
    assert [c.launches for c in counters] == before     # CPU: no launch
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)


def test_quantized_page_wrappers_refuse_cpu_tensors():
    _, tk = _pages("int8", 0)
    _, t4 = _pages("int4", 0)
    q = torch.zeros(B, 1, 4, D)
    args = (_t(_tables()), torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError):
        pac.paged_attention_int8_kernel(q, tk, tk, *args)
    with pytest.raises(ValueError):
        pac.paged_attention_int4_kernel(q, t4, t4, *args)
    with pytest.raises(ValueError):     # the fp wrapper takes no QuantPages
        pac.paged_attention_kernel(q, tk, tk, *args)


# -- W8A16 --------------------------------------------------------------------

def _w8_inputs(rows, n_in, n_out, seed=0):
    rs = np.random.RandomState(seed)
    w = (rs.randn(n_in, n_out) * 0.05).astype(np.float32)
    x = rs.randn(rows, n_in).astype(np.float32)
    values, scale = tq.quantize_int8(_t(w))
    return x, values, scale


@pytest.mark.parametrize("rows", [1, 8, 20])
@pytest.mark.parametrize("shape,route", [((256, 512), "whole_k"),
                                         ((8192, 512), "ksplit")])
def test_matmul_w8_plain_matches_jax_interpret(shape, route, rows):
    """1e-5 of the output's largest value: the same bf16-rounded
    activations times the same int8 values, fp32 sums in another order."""
    x, values, scale = _w8_inputs(rows, *shape, seed=rows)
    assert tw8.w8_route(*shape) == route
    ref = np.asarray(jw8.matmul_w8(jnp.asarray(x), jnp.asarray(values.numpy()),
                                   jnp.asarray(scale.numpy()),
                                   interpret=True))
    before = (tw8.int8_matmul_kernel.launches,
              tw8.int8_matmul_ksplit_kernel.launches)
    out = tw8.matmul_w8(_t(x), values, scale)        # CPU: the plain version
    assert before == (tw8.int8_matmul_kernel.launches,
                      tw8.int8_matmul_ksplit_kernel.launches)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    flat = tw8.matmul_w8_plain(_t(x), values, scale.reshape(-1))
    np.testing.assert_array_equal(flat.numpy(), out.numpy())   # [in] scale


ROUTE_SHAPES = [
    (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),   # llama-8b-gqa
    (2048, 2048), (2048, 5632), (5632, 2048),                   # gpt-1b
    (4096, 11008), (11008, 4096),                               # gpt-7b
    (64, 64), (128, 64), (256, 128), (8192, 512), (16384, 128),
    (20000, 128), (11000, 256)]


@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_w8_route_predicate_equals_jax(shape, monkeypatch):
    """Which of its two kernels the JAX wrapper builds for a shape (seen by
    tracing it, nothing is run) is what ``w8_route`` answers. Where JAX
    builds neither (a wide reduction that no k tile divides: it warns and
    dequantizes), the port answers "ksplit", whose kernel takes any
    reduction length."""
    n_in, n_out = shape
    built = []
    whole, ksplit = jw8._make_kernel, jw8._make_ksplit_kernel
    monkeypatch.setattr(jw8, "_make_kernel",
                        lambda d: built.append("whole_k") or whole(d))
    monkeypatch.setattr(jw8, "_make_ksplit_kernel",
                        lambda d: built.append("ksplit") or ksplit(d))
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jax.eval_shape(
            lambda x, v, s: jw8.matmul_w8.__wrapped__(x, v, s,
                                                      interpret=True),
            jax.ShapeDtypeStruct((8, n_in), jnp.float32),
            jax.ShapeDtypeStruct((n_in, n_out), jnp.int8),
            jax.ShapeDtypeStruct((n_in, 1), jnp.float32))
    assert len(built) <= 1
    assert tw8.w8_route(n_in, n_out) == (built[0] if built else "ksplit")


def test_w8_wrappers_refuse_cpu_tensors():
    x, values, scale = _w8_inputs(2, 256, 128)
    with pytest.raises(ValueError):
        tw8.int8_matmul_kernel(_t(x), values, scale)
    with pytest.raises(ValueError):
        tw8.int8_matmul_ksplit_kernel(_t(x), values, scale)


# -- W4A16 --------------------------------------------------------------------

def _w4_inputs(rows, n_in, n_out, group, seed=0):
    rs = np.random.RandomState(seed)
    w = (rs.randn(n_in, n_out) * 0.05).astype(np.float32)
    x = rs.randn(rows, n_in).astype(np.float32)
    act = (rs.rand(n_in) + 0.25).astype(np.float32)       # non-trivial chan
    packed, scale, chan = tq.quantize_int4_groupwise(_t(w), group, _t(act))
    assert (chan != 1).any()
    return x, packed, scale, chan


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("group,shape", [(128, (512, 256)), (64, (256, 128)),
                                         (64, (128, 192))])
def test_matmul_w4_plain_matches_jax_interpret(group, shape, rows):
    """With ``weight_dtype=float32`` the plain version computes what the
    JAX kernel computes in interpret mode (which skips the weight rounding
    there): 1e-5 of the output's largest value. With ``bfloat16``, the
    kernel's and the TPU's arithmetic, each weight is rounded once more
    (2^-9 relative), so the result stays within 1e-2 of the same output."""
    x, packed, scale, chan = _w4_inputs(rows, *shape, group, seed=rows)
    ref = np.asarray(jw4.matmul_w4(
        jnp.asarray(x), jnp.asarray(packed.numpy()),
        jnp.asarray(scale.numpy()), jnp.asarray(chan.numpy()), group=group,
        interpret=True))
    top = np.abs(ref).max()
    exact = tw4.matmul_w4_plain(_t(x), packed, scale, chan, group,
                                weight_dtype=torch.float32)
    np.testing.assert_allclose(exact.numpy(), ref, rtol=0, atol=1e-5 * top)
    before = tw4.int4_matmul_kernel.launches
    out = tw4.matmul_w4(_t(x), packed, scale, chan, group)   # CPU: plain
    assert tw4.int4_matmul_kernel.launches == before
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-2 * top)
    assert not np.array_equal(out.numpy(), exact.numpy())
    # against the dequantized weight: the same function, fp32 throughout
    dense = _t(x) @ tq.dequantize_int4_groupwise(packed, scale, chan, group,
                                                 torch.float32)
    np.testing.assert_allclose(exact.numpy(), dense.numpy(), rtol=0,
                               atol=1e-2 * top)


def test_w4_plain_checks_shapes_and_wrapper_refuses_cpu():
    x, packed, scale, chan = _w4_inputs(2, 256, 128, 64)
    with pytest.raises(ValueError):
        tw4.matmul_w4_plain(_t(x)[:, :250], packed, scale, chan, 64)
    with pytest.raises(ValueError):
        tw4.matmul_w4_plain(_t(x), packed, scale, chan, 96)
    with pytest.raises(ValueError):
        tw4.int4_matmul_kernel(_t(x), packed, scale, chan, 64)


# -- RMSNorm ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128), (300, 256)])
def test_rms_norm_impl_matches_the_pallas_kernel(shape, dtype):
    """fp32: 1e-6 (the same fp32 statistics). bf16: both round the fp32
    result to bf16 once, so they may differ by one bf16 step of the largest
    value."""
    rs = np.random.RandomState(shape[-1])
    x = (rs.randn(*shape) * 2).astype(np.float32)
    scale = (rs.randn(shape[-1]) * 0.1).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    sj = jnp.asarray(scale).astype(dtype)
    ref = np.asarray(jrms.rms_norm_pallas(xj, sj, 1e-5).astype(jnp.float32))
    via_impl = np.asarray(jlayers.rms_norm(xj, sj, 1e-5, impl="pallas")
                          .astype(jnp.float32))
    np.testing.assert_array_equal(ref, via_impl)
    tdt = getattr(torch, dtype)
    before = rmsnorm_kernel.launches
    out = tlayers.rms_norm(_t(x).to(tdt), _t(scale).to(tdt), 1e-5,
                           impl="cuda")
    assert rmsnorm_kernel.launches == before           # CPU: the plain version
    assert out.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)
    plain = tlayers.rms_norm(_t(x).to(tdt), _t(scale).to(tdt), 1e-5)
    np.testing.assert_array_equal(out.float().numpy(), plain.float().numpy())


def test_rms_norm_kernel_is_forward_only_and_refuses_cpu():
    x = torch.randn(4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rms_norm_fused(x, torch.zeros(64))
    with torch.no_grad():                       # nothing is recorded: fine
        rms_norm_fused(x, torch.zeros(64))
    with pytest.raises(ValueError):
        rmsnorm_kernel(x.detach(), torch.zeros(64))
    with pytest.raises(ValueError, match="unknown norm impl"):
        tlayers.rms_norm(x, torch.zeros(64), impl="pallas")
