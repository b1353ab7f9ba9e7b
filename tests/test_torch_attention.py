"""The port's flash attention (its plain PyTorch version, on the CPU)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as tests/test_ops.py runs them: ``flash_attention``, the raw ``_fwd`` and
``_bwd_impl``, and ``fold_gqa``, on the same numpy inputs (fp32).

Tolerances: out and lse 1e-5 (summation order); dq/dk/dv against
``jax.grad`` through the JAX kernels 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.ops import (
    attention as ja)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    layers as tl)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    attention as ta)

B, S = 2, 32


def _inputs(Nq, Nkv, D, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, Nq, D).astype(np.float32)
    k = rs.randn(B, S, Nkv, D).astype(np.float32)
    v = rs.randn(B, S, Nkv, D).astype(np.float32)
    w = rs.randn(B, S, Nq, D).astype(np.float32)
    return q, k, v, w


def _packed():
    """Three documents per row, positions restarting in each, a padded
    tail on the last row."""
    segs = np.ones((B, S), np.int32)
    segs[:, 10:19] = 2
    segs[:, 19:] = 3
    segs[1, 28:] = 0
    pos = np.concatenate([np.arange(10), np.arange(9),
                          np.arange(13)])[None].repeat(B, 0)
    return segs, pos.astype(np.int32)


CASES = {
    "causal": dict(Nq=4, Nkv=4, D=16, packed=False, positions=False),
    "gqa": dict(Nq=4, Nkv=2, D=16, packed=False, positions=False),
    "packed": dict(Nq=4, Nkv=2, D=16, packed=True, positions=False),
    "restart_positions": dict(Nq=2, Nkv=1, D=32, packed=True,
                              positions=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_and_grads_match_jax(case):
    c = CASES[case]
    q, k, v, w = _inputs(c["Nq"], c["Nkv"], c["D"], seed=len(case))
    segs, pos = _packed() if c["packed"] else (None, None)
    if not c["positions"]:
        pos = None
    jkw = dict(block_q=16, block_k=16)
    if segs is not None:
        jkw["segment_ids"] = jnp.asarray(segs)
    if pos is not None:
        jkw["positions"] = jnp.asarray(pos)

    def jloss(a, b_, c_):
        return jnp.sum(ja.flash_attention(a, b_, c_, **jkw) * w)

    jout = ja.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **jkw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = ta.flash_attention(
        tq, tk, tv, block_q=16, block_k=16,
        segment_ids=None if segs is None else torch.from_numpy(segs),
        positions=None if pos is None else torch.from_numpy(pos))
    (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    for name, jg, tg in zip("qkv", jgrads, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


def test_raw_fwd_and_bwd_impl_match_jax():
    """The raw entry points on the folded layout, with positions that
    restart per document and a row with no key at all (lse NEG_INF)."""
    q, k, v, w = _inputs(4, 2, 16, seed=9)
    segs, pos = _packed()
    segs[0, :] = 0
    scale = 1.0 / 4.0
    jf = ja.fold_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(segs), jnp.asarray(pos))
    tf = ta.fold_gqa(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), torch.from_numpy(segs),
                     torch.from_numpy(pos))
    for a, b in zip(jf[:7], tf[:7]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    qf, kf, vf, sq, pq, sk, pk = jf[:7]
    jout, jlse = ja._fwd(qf, kf, vf, sq, sk, pq, pk, True, 16, 16, scale)
    tout, tlse = ta._fwd(*tf[:3], tf[3], tf[5], tf[4], tf[6], True, 16, 16,
                         scale)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-6)
    assert (tlse.numpy()[:2] == np.float32(ta.NEG_INF)).all()  # empty row
    do = np.random.RandomState(3).randn(*qf.shape).astype(np.float32)
    delta = np.sum(do * np.asarray(jout), axis=-1, keepdims=True)
    jg = ja._bwd_impl(qf, kf, vf, sq, sk, pq, pk, jnp.asarray(do), jlse,
                      jnp.asarray(delta), True, 16, 16, scale)
    tg = ta._bwd_impl(*tf[:3], tf[3], tf[5], tf[4], tf[6],
                      torch.from_numpy(do), torch.from_numpy(np.array(jlse)),
                      torch.from_numpy(delta), True, 16, 16, scale)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)
    # the plain versions beside the two backward kernels are its halves
    args = (*tf[:3], tf[3], tf[5], tf[4], tf[6], torch.from_numpy(do),
            torch.from_numpy(np.array(jlse)), torch.from_numpy(delta), True,
            scale)
    assert torch.equal(ta._bwd_dq_plain(*args), tg[0])
    for a, b in zip(ta._bwd_dkv_plain(*args), tg[1:]):
        assert torch.equal(a, b)


def test_flash_matches_the_plain_masked_attention():
    """The flash plain version equals the layers' masked attention (the
    "xla" path) on packed rows."""
    q, k, v, _ = _inputs(4, 2, 16, seed=2)
    segs, _ = _packed()
    pos = np.tile(np.arange(S), (B, 1))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = ta.flash_attention(*t, segment_ids=torch.from_numpy(segs))
    mask = tl.attention_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                             torch.from_numpy(segs), torch.from_numpy(segs))
    ref = tl.dot_product_attention(*t, mask)
    live = torch.from_numpy(segs != 0)[..., None, None]
    torch.testing.assert_close(out * live, ref * live, atol=1e-5, rtol=0)


def test_cpu_tensor_never_reaches_the_kernel():
    q, k, v, _ = _inputs(2, 2, 16, seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError):
        ta.flash_attention(*t, impl="kernel")
    with pytest.raises(ValueError):
        ta.flash_attention(*t, impl="fast")
