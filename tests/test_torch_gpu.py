"""The port on a CUDA card: the hand-written kernel against its plain
version, and the engine on the card against the engine on the CPU.

Every test is marked ``gpu`` and skips, from inside its body, where there is
no card. On a card:

    python -m pytest -m gpu tests/test_torch_*.py

This file imports neither JAX nor the JAX package, so on a machine that has
only PyTorch (where tests/conftest.py, which imports JAX, cannot load):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: fp32 1e-5 (summation order); bf16 2e-2 (the kernel's output is
rounded to bf16).
"""

import pytest
import torch

from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config)
from distributed_llm_training_and_inference_system_tpu_torch.models import gpt
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    paged_attention as pa)
from distributed_llm_training_and_inference_system_tpu_torch.ops.\
    paged_attention_cuda import paged_attention_kernel
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _case(B, T, Nq, Nkv, D, PS, lengths, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    maxP = max(-(-n // PS) for n in lengths) + 1
    NP = B * maxP + 1
    perm = (torch.randperm(NP - 1, generator=g, device="cuda") + 1).tolist()
    tables = torch.zeros(B, maxP, dtype=torch.int32)
    for b, n in enumerate(lengths):
        used = -(-n // PS)
        tables[b, :used] = torch.tensor(perm[b * maxP:b * maxP + used])
    q = torch.randn(B, T, Nq, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(NP, Nkv, PS, D, generator=g, device="cuda").to(dtype)
    vp = torch.randn(NP, Nkv, PS, D, generator=g, device="cuda").to(dtype)
    starts = torch.tensor([n - T for n in lengths], dtype=torch.int32,
                          device="cuda")
    return q, kp, vp, tables.cuda(), starts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 3, 20])
@pytest.mark.parametrize("geom", [
    (8, 2, 128, 16),       # Nq, Nkv, D, PS
    (32, 8, 128, 64),      # llama-8b-gqa
    (4, 2, 16, 8),         # gpt-test
    (12, 12, 64, 16),      # MHA, D=64
    (8, 1, 256, 32),       # MQA, the largest head dim
])
def test_kernel_matches_plain(geom, T, dtype):
    _need_card()
    Nq, Nkv, D, PS = geom
    lengths = [max(n, T) for n in (1, PS, PS + 1, 5 * PS - 3)]
    args = _case(4, T, Nq, Nkv, D, PS, lengths, dtype, seed=T)
    before = paged_attention_kernel.launches
    out = pa.paged_attention_multi(*args)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    ref = pa.paged_attention_multi(*args, impl="gather")
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.gpu
def test_kernel_scratch_table_and_window_past_the_table():
    """A slot whose table is all scratch, and a window whose last rows run
    past the table's end (their keys are clamped to the table)."""
    _need_card()
    q, kp, vp, tables, starts = _case(2, 4, 8, 2, 128, 16, [16, 30],
                                      torch.float32)
    tables[0] = 0
    starts[1] = tables.shape[1] * 16 - 2
    out = pa.paged_attention_multi(q, kp, vp, tables, starts)
    ref = pa.paged_attention_multi(q, kp, vp, tables, starts, impl="gather")
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_run():
    _need_card()
    q, kp, vp, tables, starts = _case(2, 1, 8, 2, 128, 16, [5, 9],
                                      torch.float32)
    with pytest.raises(ValueError):
        paged_attention_kernel(q.half(), kp.half(), vp.half(), tables, starts)
    with pytest.raises(ValueError):
        paged_attention_kernel(q, kp, vp, tables.long(), starts)
    with pytest.raises(ValueError):
        paged_attention_kernel(q[..., :100].contiguous(),
                               kp[..., :100].contiguous(),
                               vp[..., :100].contiguous(), tables, starts)


@pytest.mark.gpu
def test_engine_on_card_matches_engine_on_cpu():
    """gpt-test in fp32: the engine on the card (paged attention through
    the kernel) produces the CPU engine's greedy tokens, prefix-cache hit
    and queued requests included."""
    _need_card()
    cfg = get_model_config("gpt-test")
    scfg = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
                prefill_chunk=32, kv_block_size=8, dtype="float32")
    cpu_model = gpt.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    card_model = gpt.GPT(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    shared = list(range(30, 50))
    prompts = [shared + [1, 2, 3], [7] * 9, [5], list(range(40)), [3, 1, 4],
               shared + [9] * 5, list(range(100, 111))]
    greedy = SamplingParams(temperature=0.0, max_tokens=12)
    ref = InferenceEngine(cfg, ServeConfig(**scfg), params=cpu_model,
                          device="cpu").generate(prompts, greedy)
    before = paged_attention_kernel.launches
    eng = InferenceEngine(cfg, ServeConfig(**scfg), params=card_model)
    out = eng.generate(prompts, greedy)
    assert [r.generated_tokens for r in out] == \
        [r.generated_tokens for r in ref]
    st = eng.stats()
    assert st["nonfinite_logits"] == 0
    assert st["prefix_cached_tokens"] > 0
    assert paged_attention_kernel.launches - before == cfg.num_layers * (
        st["dispatched_steps"] + st["extend_prefills"])


# -- training kernels ---------------------------------------------------------

from distributed_llm_training_and_inference_system_tpu_torch.exec import (  # noqa: E402
    fused_update as fu)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (  # noqa: E402
    attention as fa)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (  # noqa: E402
    attention_cuda as fac)
from distributed_llm_training_and_inference_system_tpu_torch.ops.adamw_cuda \
    import adamw_kernel  # noqa: E402


def _flash_case(B, S, Nq, Nkv, D, dtype, packed, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, Nq, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Nkv, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Nkv, D, generator=g, device="cuda").to(dtype)
    segs = pos = None
    if packed:      # three documents a row, positions restarting in each
        cut = [0, S // 3, S // 3 + S // 4, S]
        segs = torch.zeros(B, S, dtype=torch.int32, device="cuda")
        pos = torch.zeros(B, S, dtype=torch.int32, device="cuda")
        for i in range(3):
            segs[:, cut[i]:cut[i + 1]] = i + 1
            pos[:, cut[i]:cut[i + 1]] = torch.arange(cut[i + 1] - cut[i])
        segs[-1, -5:] = 0                        # a padded tail
    return q, k, v, segs, pos


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


def _assert_bf16_close(a, b):
    """bf16 kernel output ``a`` against plain ``b``: within 2e-2 of the max;
    each element within one bf16 rounding of itself (2^-7 of |b|) plus
    2.5e-2 of its row's rms over D, the row's rms taken as at least 0.1 of
    the tensor's (a row left by cancellation is near zero); the tensor's
    rms error within 5e-3 of its rms."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    rms = b.pow(2).mean().sqrt()
    row = b.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=0.1 * rms)
    excess = (diff - 2.0 ** -7 * b.abs()).clamp(min=0.0)
    assert _rel(a, b) <= 2e-2
    worst = (excess - 2.5e-2 * row).max().item()
    assert worst <= 0.0, f"{worst} past the row limit"
    rms_err = (diff.pow(2).mean().sqrt() / rms.clamp(min=1e-30)).item()
    assert rms_err <= 5e-3, f"rms error {rms_err}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("geom", [
    (2, 200, 4, 4, 64),      # B, S, Nq, Nkv, D: a ragged tail
    (1, 256, 8, 2, 128),     # GQA
    (2, 96, 2, 1, 64),
    (2, 300, 8, 2, 64),      # GQA fold G=4
    (2, 300, 8, 2, 128),
])
def test_flash_kernels_match_plain(geom, packed, dtype):
    """Forward (out, lse) and the gradients through both backward kernels
    against the plain version on the same inputs. fp32: out 1e-5 abs,
    grads 1e-4 of their max; bf16: ``_assert_bf16_close``."""
    _need_card()
    B, S, Nq, Nkv, D = geom
    q, k, v, segs, pos = _flash_case(B, S, Nq, Nkv, D, dtype, packed)
    w = torch.randn(B, S, Nq, D, device="cuda").to(dtype)
    before = (fac.flash_fwd.launches, fac.flash_bwd_dq.launches,
              fac.flash_bwd_dkv.launches)
    outs, grads = [], []
    for impl in ("kernel", "plain"):
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = fa.flash_attention(qs, ks, vs, segment_ids=segs, positions=pos,
                                 impl=impl)
        (out.float() * w.float()).sum().backward()
        outs.append(out)
        grads.append((qs.grad, ks.grad, vs.grad))
    torch.cuda.synchronize()
    assert (fac.flash_fwd.launches, fac.flash_bwd_dq.launches,
            fac.flash_bwd_dkv.launches) == tuple(b + 1 for b in before)
    if dtype == torch.float32:
        assert (outs[0] - outs[1]).abs().max().item() <= 1e-5
        for a, b in zip(*grads):
            assert _rel(a, b) <= 1e-4
    else:
        _assert_bf16_close(outs[0], outs[1])
        for a, b in zip(*grads):
            _assert_bf16_close(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_raw_entry_points_with_restarting_positions(dtype):
    """_fwd/_bwd_impl on the folded layout with positions that restart per
    document and an empty row (all padding): lse and every gradient."""
    _need_card()
    B, S, Nq, Nkv, D = 2, 192, 4, 2, 64
    q, k, v, segs, pos = _flash_case(B, S, Nq, Nkv, D, dtype, True, seed=5)
    segs[0, :] = 0                             # a row with no key at all
    qf, kf, vf, sq, pq, sk, pk, _ = fa.fold_gqa(q, k, v, segs, pos)
    scale = 1.0 / D ** 0.5
    res = [fa._fwd(qf, kf, vf, sq, sk, pq, pk, True, 512, 512, scale, impl=i)
           for i in ("kernel", "plain")]
    (ok, lk), (op, lp) = res
    assert bool(torch.isfinite(lk).all()) and bool(torch.isfinite(ok.float()).all())
    live = lp > fa.NEG_INF / 2                 # rows with at least one key
    assert torch.equal(lk[~live], lp[~live])   # NEG_INF on the empty ones
    lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
    assert (lk[live] - lp[live]).abs().max().item() <= lse_tol
    if dtype == torch.float32:
        assert (ok - op).abs().max().item() <= 1e-5
    else:
        _assert_bf16_close(ok, op)
    do = torch.randn_like(qf)
    delta = (do.float() * op.float()).sum(-1, keepdim=True)
    gk = fa._bwd_impl(qf, kf, vf, sq, sk, pq, pk, do, lp, delta, True, 512,
                      512, scale, impl="kernel")
    gp = fa._bwd_impl(qf, kf, vf, sq, sk, pq, pk, do, lp, delta, True, 512,
                      512, scale, impl="plain")
    for a, b in zip(gk, gp):
        if dtype == torch.float32:
            assert _rel(a, b) <= 1e-4
        else:
            _assert_bf16_close(a, b)


def _bwd_raw_case(BH, Sq, Skv, D, dtype, qpos=None, kpos=None, qseg=None,
                  kseg=None, seed=0):
    """Inputs of the raw backward pair on the folded layout: random q, k,
    v, dO; segments 1 and positions 0.. unless given; lse from the plain
    forward; delta = rowsum(dO * O) plus noise, as a ring-attention chunk
    gets a global delta, so that no row's ds cancels to rounding (a row
    that sees one key has p = 1 and dp = rowsum(dO * O) exactly)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rows(n):
        return torch.randn(BH, n, D, generator=g, device="cuda").to(dtype)

    def ints(t, n, fill):
        if t is None:
            t = (torch.arange(n, device="cuda") if fill is None
                 else torch.full((n,), fill, device="cuda"))
        t = t.to(device="cuda", dtype=torch.int32)
        return t.expand(BH, n).reshape(BH, 1, n).contiguous()
    q, k, v, do = rows(Sq), rows(Skv), rows(Skv), rows(Sq)
    sq, sk = ints(qseg, Sq, 1), ints(kseg, Skv, 1)
    pq, pk = ints(qpos, Sq, None), ints(kpos, Skv, None)
    scale = 1.0 / D ** 0.5
    out, lse = fa._fwd_plain(q, k, v, sq, sk, pq, pk, True, scale)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    delta = delta + torch.randn(delta.shape, generator=g, device="cuda")
    return (q, k, v, sq, sk, pq, pk, do, lse, delta, True, scale)


def _check_bwd_pair(args, dtype):
    """The dq and dk/dv kernels against their plain versions; returns the
    kernels' (dq, dk, dv)."""
    before = (fac.flash_bwd_dq.launches, fac.flash_bwd_dkv.launches)
    got = (fac.flash_bwd_dq(*args), *fac.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert (fac.flash_bwd_dq.launches, fac.flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = (fa._bwd_dq_plain(*args), *fa._bwd_dkv_plain(*args))
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32:
            assert _rel(a, b) <= 1e-4
        else:
            _assert_bf16_close(a, b)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 63, 65, 1000])
def test_flash_bwd_pair_at_tile_edges(S, dtype):
    """Sequences shorter than, one short of, one past and far from a
    multiple of the kernels' 64-row tiles."""
    _need_card()
    _check_bwd_pair(_bwd_raw_case(3, S, S, 128, dtype, seed=S), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_pair_on_a_ring_chunk(dtype):
    """Sq != Skv with offset global positions, as ring attention drives
    _bwd_impl: a q chunk at positions 300.. against a kv chunk at 250..,
    so some tiles are all live, some mixed and some skipped."""
    _need_card()
    Sq, Skv = 320, 200
    args = _bwd_raw_case(2, Sq, Skv, 64, dtype,
                         qpos=torch.arange(300, 300 + Sq),
                         kpos=torch.arange(250, 250 + Skv) * 2, seed=7)
    got = _check_bwd_pair(args, dtype)
    via_impl = fa._bwd_impl(*args[:10], True, 512, 512, args[-1],
                            impl="kernel")
    for a, b in zip(got, via_impl):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_pair_with_rows_that_see_no_key(dtype):
    """q rows whose segment no key has (lse NEG_INF): their dq is zero,
    and they add nothing to dk/dv."""
    _need_card()
    S = 200
    qseg = torch.ones(S, dtype=torch.int32)
    qseg[70:140] = 5                         # no key is in segment 5
    args = _bwd_raw_case(2, S, S, 128, dtype, qseg=qseg, seed=3)
    assert bool((args[8][:, 70:140] < fa.NEG_INF / 2).all())
    dq, _, _ = _check_bwd_pair(args, dtype)
    assert not bool(dq[:, 70:140].any())


@pytest.mark.gpu
def test_flash_bwd_pair_at_gpt_1b_shape():
    """B=1, S=2048, 16 heads, D=128, bf16, causal: the training shape."""
    _need_card()
    _check_bwd_pair(_bwd_raw_case(16, 2048, 2048, 128, torch.bfloat16,
                                  seed=11), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_pair_is_deterministic(dtype):
    """Two calls on the same inputs give the same bits (no atomics; every
    output element is written by one block)."""
    _need_card()
    args = _bwd_raw_case(4, 700, 700, 128, dtype, seed=13)
    first = (fac.flash_bwd_dq(*args), *fac.flash_bwd_dkv(*args))
    second = (fac.flash_bwd_dq(*args), *fac.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _fwd_args(args):
    """The forward's arguments from a ``_bwd_raw_case``: q, k, v, segments,
    positions, causal, scale."""
    return args[:7] + args[10:]


def _check_fwd(args, dtype):
    """The forward kernel against its plain version: out and lse (fp32 1e-5;
    bf16 ``_assert_bf16_close`` and lse 1e-4), lse exactly NEG_INF and out
    zero on rows that see no key. Returns the kernel's (out, lse)."""
    before = fac.flash_fwd.launches
    out, lse = fac.flash_fwd(*args)
    torch.cuda.synchronize()
    assert fac.flash_fwd.launches == before + 1
    ref_out, ref_lse = fa._fwd_plain(*args)
    assert out.dtype == dtype and out.shape == ref_out.shape
    assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    live = ref_lse > fa.NEG_INF / 2
    assert torch.equal(lse[~live], ref_lse[~live])
    assert not bool(out[~live[..., 0]].any())
    if bool(live.any()):
        lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
        assert (lse[live] - ref_lse[live]).abs().max().item() <= lse_tol
    if dtype == torch.float32:
        assert (out - ref_out).abs().max().item() <= 1e-5
    else:
        _assert_bf16_close(out, ref_out)
    return out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 63, 65, 1000])
def test_flash_fwd_at_tile_edges(S, dtype):
    """The forward at sequences shorter than, one short of, one past and far
    from a multiple of its 64-row tiles."""
    _need_card()
    _check_fwd(_fwd_args(_bwd_raw_case(3, S, S, 128, dtype, seed=S)), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_start", [250, 100])
def test_flash_fwd_on_a_ring_chunk(kv_start, dtype):
    """Sq != Skv with offset global positions, as ring attention drives
    _fwd: a q chunk at positions 300.. against a kv chunk at kv_start..
    times 2. From 250 the kv tiles are skipped or mixed; from 100 some are
    all live too."""
    _need_card()
    Sq, Skv = 320, 200
    args = _fwd_args(_bwd_raw_case(
        2, Sq, Skv, 64, dtype, qpos=torch.arange(300, 300 + Sq),
        kpos=torch.arange(kv_start, kv_start + Skv) * 2, seed=7))
    got = _check_fwd(args, dtype)
    via_impl = fa._fwd(*args[:8], 512, 512, args[-1], impl="kernel")
    for a, b in zip(got, via_impl):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_with_rows_that_see_no_key(dtype):
    """q rows whose segment no key has, and padded (segment 0) keys: out
    zero and lse exactly NEG_INF on the empty rows."""
    _need_card()
    S = 200
    qseg = torch.ones(S, dtype=torch.int32)
    qseg[70:140] = 5                         # no key is in segment 5
    kseg = torch.ones(S, dtype=torch.int32)
    kseg[-30:] = 0                           # a padded tail
    args = _fwd_args(_bwd_raw_case(2, S, S, 128, dtype, qseg=qseg, kseg=kseg,
                                   seed=3))
    _, lse = _check_fwd(args, dtype)
    assert bool((lse[:, 70:140] == fa.NEG_INF).all())


@pytest.mark.gpu
def test_flash_fwd_at_gpt_1b_shape():
    """B=1, S=2048, 16 heads, D=128, bf16, causal: the training shape."""
    _need_card()
    _check_fwd(_fwd_args(_bwd_raw_case(16, 2048, 2048, 128, torch.bfloat16,
                                       seed=11)), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_is_deterministic(dtype):
    """Two forward calls on the same inputs give the same bits."""
    _need_card()
    args = _fwd_args(_bwd_raw_case(4, 700, 700, 128, dtype, seed=13))
    first, second = fac.flash_fwd(*args), fac.flash_fwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_refuses_what_it_cannot_run():
    _need_card()
    q, k, v, _, _ = _flash_case(1, 64, 2, 2, 48, torch.bfloat16, False)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)                       # head dim 48
    q, k, v, _, _ = _flash_case(1, 64, 2, 2, 64, torch.float16, False)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)                       # fp16


def _adam_leaf(shape, mu_dtype, nu_dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(shape, generator=g, device="cuda")
    grad = torch.randn(shape, generator=g, device="cuda") * 1e-2
    mu = (torch.randn(shape, generator=g, device="cuda") * 1e-3).to(mu_dtype)
    nu = (torch.rand(shape, generator=g, device="cuda") * 1e-5).to(nu_dtype)
    return p, grad, mu, nu


@pytest.mark.gpu
@pytest.mark.parametrize("mu_dtype,nu_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(256, 512), (1000, 333), (5, 70001)])
def test_adamw_kernel_bitwise_equal_to_plain(shape, wd, mu_dtype, nu_dtype):
    _need_card()
    p, grad, mu, nu = _adam_leaf(shape, mu_dtype, nu_dtype, seed=len(shape))
    count = torch.tensor(6, dtype=torch.int32, device="cuda")
    lr = torch.tensor(3e-4, device="cuda")
    clip = torch.tensor(0.37, device="cuda")
    kp, kmu, knu = p.clone(), mu.clone(), nu.clone()
    before = adamw_kernel.launches
    fu.fused_adamw_apply([kp], [grad], [kmu], [knu], count, lr=lr, b1=0.9,
                         b2=0.95, eps=1e-8, weight_decay=wd,
                         decay_mask=[True], clip_scale=clip)
    torch.cuda.synchronize()
    assert adamw_kernel.launches == before + 1
    fu.fused_adamw_apply([p], [grad], [mu], [nu], count, lr=lr, b1=0.9,
                         b2=0.95, eps=1e-8, weight_decay=wd,
                         decay_mask=[True], clip_scale=clip,
                         use_kernel=False)
    assert torch.equal(kp, p) and torch.equal(kmu, mu) and torch.equal(knu, nu)


# -- the multi-leaf AdamW launch ----------------------------------------------

_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16))
_MIXED_SHAPES = ((5, 70001), (256, 512), (1000, 333), (300, 1), (17,),
                 (4097,), (3,))


def _mixed_leaves(pairs=_PAIRS, shapes=_MIXED_SHAPES, unaligned=True):
    """Leaves of every shape in every (mu, nu) dtype pair, and (where
    ``unaligned``) a leaf of views one element into their storage; a decay
    mask that alternates."""
    leaves = []
    for mdt, ndt in pairs:
        for shape in shapes:
            leaves.append(_adam_leaf(shape, mdt, ndt, seed=len(leaves)))
    if unaligned:
        flat = _adam_leaf((3 * 70001 + 1,), torch.float32, torch.float32, 99)
        leaves.append(tuple(t[1:].view(3, 70001) for t in flat))
    wds = [0.1 if i % 2 else 0.0 for i in range(len(leaves))]
    return leaves, wds


def _adam_scalars():
    return fu.adam_scalars(torch.tensor(6, device="cuda"),
                           torch.tensor(3e-4, device="cuda"), 0.9, 0.95,
                           torch.tensor(0.37, device="cuda"))


def _multi(leaves, wds, scalars):
    from distributed_llm_training_and_inference_system_tpu_torch.ops.\
        adamw_cuda import adamw_multi_kernel
    return adamw_multi_kernel(*zip(*leaves), scalars, b1=0.9, b2=0.95,
                              eps=1e-8, wds=wds)


def _graph_kernels(fn):
    """Kernel nodes of a CUDA graph captured around one call of ``fn``:
    what the call launches on the card, as the graph API lists it. (The
    profiler's CUDA activity dropped kernels of whole windows in a full
    run of this file on an H100, and the launch tests that came after
    then read too few.)"""
    import ctypes
    fn()                                  # built and warm before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return kinds.count(0)                 # CU_GRAPH_NODE_TYPE_KERNEL


@pytest.mark.gpu
@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("pairs", [_PAIRS, _PAIRS[:1], _PAIRS[2:]])
def test_adamw_multi_kernel_bitwise_equal_to_plain(pairs, unaligned):
    """Leaves of odd sizes in several dtype pairs, a view that is not
    16-byte aligned and a mixed decay mask, in one call: p, mu and nu equal
    bit for bit to ``_leaf_math`` leaf by leaf; one launch a dtype pair
    (the unaligned fp32 leaf joins the fp32 pair)."""
    _need_card()
    leaves, wds = _mixed_leaves(pairs, unaligned=unaligned)
    scalars = _adam_scalars()
    s = scalars.unbind()
    ref = [fu._leaf_math(p, g, m, v, *s, b1=0.9, b2=0.95, eps=1e-8, wd=wd,
                         mu_dtype=m.dtype, nu_dtype=v.dtype)
           for (p, g, m, v), wd in zip(leaves, wds)]
    before = (adamw_kernel.launches, adamw_kernel.leaves)
    launches = _multi(leaves, wds, scalars)
    torch.cuda.synchronize()
    assert launches == len(set(pairs) | ({_PAIRS[0]} if unaligned else set()))
    assert (adamw_kernel.launches - before[0],
            adamw_kernel.leaves - before[1]) == (launches, len(leaves))
    for (p, _, m, v), (rp, rm, rv) in zip(leaves, ref):
        assert torch.equal(p, rp) and torch.equal(m, rm) and torch.equal(v, rv)


@pytest.mark.gpu
@pytest.mark.parametrize("pairs,kernels", [(_PAIRS[:1], 1), (_PAIRS, 3)])
def test_adamw_launches_one_cuda_kernel_per_dtype_pair(pairs, kernels):
    """Kernels on the card, not only the Python counter: one kernel for
    every leaf of a dtype pair, and fused_adamw_apply over gpt-like leaves
    launches one beside the kernels that make its scalars."""
    _need_card()
    leaves, wds = _mixed_leaves(pairs, unaligned=False)
    scalars = _adam_scalars()
    assert _graph_kernels(lambda: _multi(leaves, wds, scalars)) == kernels
    shapes = [(512, 1024), (1024, 512), (2048, 256)]
    ps, gs, ms, vs = zip(*(_adam_leaf(s, torch.float32, torch.float32, i)
                           for i, s in enumerate(shapes)))
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    lr = torch.tensor(1e-3, device="cuda")
    clip = torch.tensor(1.0, device="cuda")

    def step():
        fu.fused_adamw_apply(ps, gs, ms, vs, count, lr=lr, b1=0.9, b2=0.95,
                             eps=1e-8, weight_decay=0.1,
                             decay_mask=[True] * 3, clip_scale=clip)
    before = (adamw_kernel.launches, adamw_kernel.leaves)
    step()
    assert (adamw_kernel.launches - before[0],
            adamw_kernel.leaves - before[1]) == (1, 3)
    assert _graph_kernels(step) - _graph_kernels(
        lambda: fu.adam_scalars(count, lr, 0.9, 0.95, clip)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("count", [257, 600])
def test_adamw_past_the_tables_capacity_runs_the_planned_launches(count):
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        adamw_cuda as ac)
    _need_card()
    leaves = [_adam_leaf((100 + i,), torch.float32, torch.float32, i)
              for i in range(count)]
    wds = [0.1] * count
    plan = ac.adamw_plan([(p.numel(), m.dtype, v.dtype)
                          for p, _, m, v in leaves])
    assert len(plan) == -(-count // ac.CAPACITY)
    scalars = _adam_scalars()
    s = scalars.unbind()
    ref = [fu._leaf_math(p, g, m, v, *s, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
                         mu_dtype=m.dtype, nu_dtype=v.dtype)
           for p, g, m, v in leaves]
    before = adamw_kernel.launches
    assert _multi(leaves, wds, scalars) == len(plan)
    torch.cuda.synchronize()
    assert adamw_kernel.launches - before == len(plan)
    for (p, _, m, v), (rp, rm, rv) in zip(leaves, ref):
        assert torch.equal(p, rp) and torch.equal(m, rm) and torch.equal(v, rv)
    assert _graph_kernels(lambda: _multi(leaves, wds, scalars)) == len(plan)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", _PAIRS)
def test_adamw_repeated_calls_give_identical_bits(pair):
    _need_card()
    leaves, wds = _mixed_leaves((pair,))
    copies = [tuple(t.clone() for t in leaf) for leaf in leaves]
    scalars = _adam_scalars()
    for _ in range(2):
        _multi(leaves, wds, scalars)
        _multi(copies, wds, scalars)
    torch.cuda.synchronize()
    for a, b in zip(leaves, copies):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_adamw_multi_kernel_refuses_what_it_cannot_run():
    from distributed_llm_training_and_inference_system_tpu_torch.ops.\
        adamw_cuda import adamw_multi_kernel
    _need_card()
    p, g, m, v = _adam_leaf((64, 64), torch.float32, torch.float32, 0)
    scalars = _adam_scalars()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    with pytest.raises(ValueError):               # fp16 moment
        adamw_multi_kernel([p], [g], [m.half()], [v], scalars, wds=[0.0],
                           **kw)
    with pytest.raises(ValueError):               # shapes differ
        adamw_multi_kernel([p], [g[:32]], [m], [v], scalars, wds=[0.0], **kw)
    with pytest.raises(ValueError):               # not contiguous
        adamw_multi_kernel([p.t()], [g.t()], [m.t()], [v.t()], scalars,
                           wds=[0.0], **kw)
    with pytest.raises(ValueError):               # a leaf on the CPU
        adamw_multi_kernel([p.cpu()], [g.cpu()], [m.cpu()], [v.cpu()],
                           scalars, wds=[0.0], **kw)
    with pytest.raises(ValueError):               # a decay per leaf
        adamw_multi_kernel([p], [g], [m], [v], scalars, wds=[], **kw)


@pytest.mark.gpu
def test_train_step_on_card_kernels_against_plain():
    """One training step of a small model in bf16 on the card: through the
    kernels (flash, fused AdamW) and through the plain versions, from the
    same state. Loss and grad norm agree within 1e-2 (bf16 compute)."""
    _need_card()
    import dataclasses
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import OptimizerConfig, ParallelConfig
    from distributed_llm_training_and_inference_system_tpu_torch.exec.\
        train_step import TrainState, make_train_step
    from distributed_llm_training_and_inference_system_tpu_torch.io.data \
        import SyntheticDataset
    cfg = dataclasses.replace(get_model_config("gpt-test"), hidden_size=256,
                              num_heads=4, num_kv_heads=2, head_dim=64,
                              ffn_size=512)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(SyntheticDataset(2, 128, cfg.vocab_size))
             .items()}
    batch["tokens"] = batch["tokens"].long()
    metrics = []
    for attn, fused in (("flash", True), ("xla", False)):
        model = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        step, init, _ = make_train_step(
            cfg, OptimizerConfig(fused=fused),
            ParallelConfig(activation_checkpoint="selective"),
            attn_impl=attn)
        state = TrainState.create(model, init)
        launches = adamw_kernel.launches
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        assert (adamw_kernel.launches > launches) == fused
    (l0, g0), (l1, g1) = metrics
    assert abs(l0 - l1) <= 1e-2 * abs(l1)
    assert abs(g0 - g1) <= 1e-2 * abs(g1)


@pytest.mark.gpu
def test_fp32_head_product_on_card():
    """bf16 operands through the tensor cores with an fp32 output: the
    widened product up to summation order, forward and backward."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(3, 70, 256, generator=g, device="cuda").bfloat16()
    w = torch.randn(256, 1000, generator=g, device="cuda").bfloat16()
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = gpt.matmul_f32(xs, ws)
    assert out.dtype == torch.float32
    ref = x.float() @ w.float()
    assert (out - ref).abs().max().item() <= 1e-4
    out.sum().backward()
    assert xs.grad.dtype == torch.bfloat16 and ws.grad.dtype == torch.bfloat16
    ones = torch.ones_like(ref)
    assert _rel(xs.grad, ones @ w.float().t()) <= 1e-2
    assert _rel(ws.grad, x.float().reshape(-1, 256).t()
                @ ones.reshape(-1, 1000)) <= 1e-2


@pytest.mark.gpu
def test_entry_forward_on_card():
    """The port's entry(): a gpt-1b [1, 1024] bf16 forward through the
    flash kernel."""
    _need_card()
    fn, args = gpt.entry()
    before = fac.flash_fwd.launches
    logits = fn(*args)
    torch.cuda.synchronize()
    assert logits.shape == (1, 1024, 50304) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert fac.flash_fwd.launches - before == 24


# -- quantized serving: int8/int4 pages, W8/W4 matmuls, RMSNorm ---------------
#
# Tolerances: a kernel and its plain version repeat the same arithmetic, so
# what is left is the order of the fp32 sums: 1e-5 (paged attention, fp32)
# or 1e-4 of the output's largest value (the matmuls' longer sums); bf16
# outputs add one rounding of the result, 2e-2 absolute at unit scale
# (paged attention; its plain version also rounds the dequantized pages to
# bf16) or 1e-2 of the output's largest value (matmuls).

def _quant_pages(kind, pages):
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        quantization as tq)
    if kind == "int8":
        return pa.QuantPages(*tq.quantize_int8_rows(pages))
    qv, sc = tq.quantize_int4_rows(pages)
    return pa.Int4Pages(tq.pack_int4_rows(qv, axis=-2), sc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("T", [1, 3, 20])
@pytest.mark.parametrize("geom", [
    (32, 8, 128, 64),      # Nq, Nkv, D, PS: llama-8b-gqa
    (4, 2, 16, 8),         # gpt-test
    (12, 12, 64, 16),      # MHA, D=64
    (8, 1, 256, 32),       # MQA, the largest head dim
])
def test_quantized_page_kernels_match_plain(geom, T, kind, dtype):
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        paged_attention_cuda as pac)
    Nq, Nkv, D, PS = geom
    lengths = [max(n, T) for n in (1, PS, PS + 1, 5 * PS + 3, 300)]
    q, kp, vp, tables, starts = _case(len(lengths), T, Nq, Nkv, D, PS,
                                      lengths, torch.float32, seed=T)
    q = q.to(dtype)
    kq, vq = _quant_pages(kind, kp), _quant_pages(kind, vp)
    kernel = getattr(pac, f"paged_attention_{kind}_kernel")
    before = (kernel.launches, paged_attention_kernel.launches)
    out = pa.paged_attention_multi(q, kq, vq, tables, starts)
    torch.cuda.synchronize()
    assert (kernel.launches, paged_attention_kernel.launches) == (
        before[0] + 1, before[1])
    ref = pa.paged_attention_multi(q, kq, vq, tables, starts, impl="gather")
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
def test_quantized_page_kernels_refuse_what_they_cannot_run():
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        paged_attention_cuda as pac)
    q, kp, vp, tables, starts = _case(2, 1, 8, 2, 128, 16, [40, 7],
                                      torch.float32)
    k8, v8 = _quant_pages("int8", kp), _quant_pages("int8", vp)
    k4 = _quant_pages("int4", kp)
    with pytest.raises(ValueError):        # fp wrapper, quantized pages
        paged_attention_kernel(q, k8, v8, tables, starts)
    with pytest.raises(ValueError):        # int8 wrapper, int4 pages
        pac.paged_attention_int8_kernel(q, k4, k4, tables, starts)
    with pytest.raises(ValueError):        # int4 wrapper, int8 pages
        pac.paged_attention_int4_kernel(q, k8, v8, tables, starts)
    with pytest.raises(ValueError):        # scales of another dtype
        pac.paged_attention_int8_kernel(
            q, pa.QuantPages(k8.values, k8.scale.double()), v8, tables,
            starts)


# -- paged attention split over blocks: llama-8b-gqa geometry over serving's
# 32-page table (8 splits of 256 keys at T = 1) --------------------------------

def _split_case(T, lengths, kind, dtype, seed=0):
    """q in ``dtype``; pages of ``kind`` (fp pages in q's dtype) over a
    32-page table of 64; a length of 0 leaves a slot's table all scratch
    with its window at position 300."""
    Nq, Nkv, D, PS, maxP = 32, 8, 128, 64, 32
    B = len(lengths)
    g = torch.Generator(device="cuda").manual_seed(seed)
    NP = B * maxP + 1
    perm = (torch.randperm(NP - 1, generator=g, device="cuda") + 1).tolist()
    tables = torch.zeros(B, maxP, dtype=torch.int32)
    starts = []
    for b, n in enumerate(lengths):
        used = -(-n // PS)
        tables[b, :used] = torch.tensor(perm[b * maxP:b * maxP + used],
                                        dtype=torch.int32)
        starts.append(max(n, T) - T if n else 300)
    q = torch.randn(B, T, Nq, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(NP, Nkv, PS, D, generator=g, device="cuda")
    vp = torch.randn(NP, Nkv, PS, D, generator=g, device="cuda")
    if kind == "fp":
        kp, vp = kp.to(dtype), vp.to(dtype)
    else:
        kp, vp = _quant_pages(kind, kp), _quant_pages(kind, vp)
    return (q, kp, vp, tables.cuda(),
            torch.tensor(starts, dtype=torch.int32, device="cuda"))


def _split_counter(kind):
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        paged_attention_cuda as pac)
    return {"fp": pac.paged_attention_kernel,
            "int8": pac.paged_attention_int8_kernel,
            "int4": pac.paged_attention_int4_kernel}[kind]


def _split_check(args, kind, dtype):
    kernel = _split_counter(kind)
    before = kernel.launches
    out = pa.paged_attention_multi(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1        # one a wrapper call
    assert out.dtype == dtype and out.shape == args[0].shape
    assert torch.isfinite(out.float()).all()
    ref = pa.paged_attention_multi(*args, impl="gather")
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    return out


KINDS = ["fp", "int8", "int4"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_split_kernel_on_and_one_past_split_boundaries(kind, dtype):
    _need_card()
    args = _split_case(1, [256, 257, 512, 513, 63, 64, 65, 1793], kind,
                       dtype, seed=1)
    _split_check(args, kind, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_split_kernel_one_key_beside_a_full_table(kind, dtype):
    """Slot 0's seven later splits hold no key and exit; slot 1 fills all
    eight."""
    _need_card()
    args = _split_case(1, [1, 2048, 1, 2048], kind, dtype, seed=2)
    _split_check(args, kind, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_split_kernel_all_scratch_table(kind, T):
    """Every slot's table is page 0: the kernel reads the scratch page as
    the plain version does, over two splits."""
    _need_card()
    args = _split_case(T, [0, 0, 0], kind, torch.float32, seed=3)
    assert int(args[3].abs().sum()) == 0
    _split_check(args, kind, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T", [1, 4, 44])
def test_split_kernel_windows_at_llama_geometry(T, kind, dtype):
    """Decode (8 splits), phase 3's T = 4 (4 splits) and the 44-token
    suffix prefill (one split)."""
    _need_card()
    args = _split_case(T, [2048, 1, 64, 65, 777, 1500, 130, 2000], kind,
                       dtype, seed=T)
    _split_check(args, kind, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T", [1, 4])
def test_split_kernel_two_calls_give_identical_bits(T, kind, dtype):
    """The combine adds the splits in a fixed order, so the same inputs
    give the same bits."""
    _need_card()
    args = _split_case(T, [2048, 1, 300, 1500], kind, dtype, seed=5)
    a = pa.paged_attention_multi(*args)
    b = pa.paged_attention_multi(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_split_kernel_counts_one_launch_a_wrapper_call():
    """Three calls through each wrapper, with splits (T = 1) and without
    (T = 44): three launches each, and none on the other wrappers."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        paged_attention_cuda as pac)
    for kind in KINDS:
        for T in (1, 44):
            args = _split_case(T, [2048, 100], kind, torch.bfloat16)
            before = {k: _split_counter(k).launches for k in KINDS}
            for _ in range(3):
                pac.paged_attention_launch(*args)
            torch.cuda.synchronize()
            assert {k: _split_counter(k).launches - before[k]
                    for k in KINDS} == {k: 3 * (k == kind) for k in KINDS}


def _w8_case(rows, n_in, n_out, dtype, seed=0):
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        quantization as tq)
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02
    x = torch.randn(rows, n_in, generator=g, device="cuda").to(dtype)
    values, scale = tq.quantize_int8(w)
    return x, values, scale


MATMUL_SHAPES = [(256, 128), (4096, 1024), (4096, 14336), (14336, 4096),
                 (1000, 192)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 20, 44, 64])
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_w8_kernels_match_plain(shape, rows, dtype):
    """Both entry points; 44 rows is the serving path's suffix prefill."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int8_matmul as w8)
    x, values, scale = _w8_case(rows, *shape, dtype)
    ref = w8.matmul_w8_plain(x, values, scale).float()
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    for kernel in (w8.int8_matmul_kernel, w8.int8_matmul_ksplit_kernel):
        before = kernel.launches
        out = kernel(x, values, scale)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert out.dtype == dtype and out.shape == (rows, shape[1])
        assert (out.float() - ref).abs().max().item() <= tol
        again = kernel(x, values, scale)
        assert torch.equal(again, out)      # no atomics: identical bits
    # the dispatcher follows the route predicate
    counts = (w8.int8_matmul_kernel.launches,
              w8.int8_matmul_ksplit_kernel.launches)
    w8.matmul_w8(x, values, scale)
    grew = (w8.int8_matmul_kernel.launches - counts[0],
            w8.int8_matmul_ksplit_kernel.launches - counts[1])
    assert grew == ((0, 1) if w8.w8_route(*shape) == "ksplit" else (1, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 44])
@pytest.mark.parametrize("shape", [
    (16, 128),          # one k-step: a single split
    (8, 128),           # half a k-step
    (100, 128),         # one split ending in a short tail
    (1000, 192),        # 8 splits, the last 6.5 k-steps, a half tile
    (2000, 64),         # a lone half tile, splits of 256 rows
    (4096, 320),        # 3 column tiles, the last a half
])
def test_w8_kernels_at_split_boundaries(shape, rows, dtype):
    """Reductions of one k-step, of a split with a short tail and of no
    multiple of 16, and outputs whose last column tile is half (out % 128
    == 64), against the plain version."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int8_matmul as w8)
    x, values, scale = _w8_case(rows, *shape, dtype, seed=shape[0] + rows)
    ref = w8.matmul_w8_plain(x, values, scale).float()
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    for kernel in (w8.int8_matmul_kernel, w8.int8_matmul_ksplit_kernel):
        out = kernel(x, values, scale)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (rows, shape[1])
        assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [8, 64])
@pytest.mark.parametrize("shape", [(4096, 14336), (14336, 4096)])
def test_w8_kernels_are_deterministic(shape, rows, dtype):
    """The splits' partials are added in split order on the chip: three
    calls of either entry point on the same inputs give identical bits,
    and the two entry points agree bit for bit."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int8_matmul as w8)
    x, values, scale = _w8_case(rows, *shape, dtype, seed=7)
    first = w8.int8_matmul_kernel(x, values, scale)
    for kernel in (w8.int8_matmul_kernel, w8.int8_matmul_ksplit_kernel):
        for _ in range(2):
            assert torch.equal(kernel(x, values, scale), first)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 14336), (14336, 4096), (1000, 192)])
def test_w8_kernels_launch_once_a_call(shape):
    """One W8 kernel on the card a call, for either entry point: no second
    reduce kernel (the profiler's CUDA activity)."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int8_matmul as w8)
    x, values, scale = _w8_case(8, *shape, torch.bfloat16)
    for kernel in (w8.int8_matmul_kernel, w8.int8_matmul_ksplit_kernel):
        kernel(x, values, scale)                # built and warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kernel(x, values, scale)
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "int8_matmul" in e.key}
        assert sum(kernels.values()) == 3, kernels


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 44])
def test_w8_kernels_on_views_that_are_not_16_byte_aligned(rows, dtype):
    """x and scale as contiguous views one element into their storage, and
    rows of 100 channels: the kernel folds them by element loads in place
    of 16-byte ones, with the same bits. A weight view that is not 16-byte
    aligned is refused."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int8_matmul as w8)
    for n_in in (1024, 100):
        x, values, scale = _w8_case(rows, n_in, 128, dtype, seed=3)
        scale = scale.reshape(-1)
        xs = torch.empty(rows * n_in + 1, dtype=dtype, device="cuda")
        xs[1:] = x.reshape(-1)
        ss = torch.empty(n_in + 1, device="cuda")
        ss[1:] = scale
        xv, sv = xs[1:].view(rows, n_in), ss[1:]
        assert xv.data_ptr() % 16 and sv.data_ptr() % 16
        ref = w8.matmul_w8_plain(x, values, scale).float()
        tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max()
        for kernel in (w8.int8_matmul_kernel, w8.int8_matmul_ksplit_kernel):
            out = kernel(xv, values, sv)
            assert (out.float() - ref).abs().max().item() <= tol.item()
            assert torch.equal(out, kernel(x, values, scale))
    x, values, scale = _w8_case(rows, 256, 128, dtype, seed=3)
    vs = torch.empty(256 * 128 + 1, dtype=torch.int8, device="cuda")
    vs[1:] = values.reshape(-1)
    with pytest.raises(ValueError):
        w8.int8_matmul_kernel(x, vs[1:].view(256, 128), scale)


def _w4_case(rows, n_in, n_out, group, dtype, seed):
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        quantization as tq)
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02
    x = torch.randn(rows, n_in, generator=g, device="cuda").to(dtype)
    act = torch.rand(n_in, generator=g, device="cuda") + 0.25
    packed, scale, chan = tq.quantize_int4_groupwise(w, group, act_scale=act)
    assert (chan != 1).any()
    return x, packed, scale, chan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 20, 44, 64])
@pytest.mark.parametrize("group", [8, 16, 64, 128])
@pytest.mark.parametrize("shape", MATMUL_SHAPES[:4] + [(1024, 192)])
def test_w4_kernel_matches_plain(shape, group, rows, dtype):
    """Groups 8 (scales looked up a packed row) and 16-128 (a scale row a
    k-step); 44 rows is the serving path's suffix prefill."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4)
    n_in, n_out = shape
    x, packed, scale, chan = _w4_case(rows, n_in, n_out, group, dtype,
                                      n_in + rows)
    ref = w4.matmul_w4_plain(x, packed, scale, chan, group).float()
    before = w4.int4_matmul_kernel.launches
    out = w4.matmul_w4(x, packed, scale, chan, group)
    torch.cuda.synchronize()
    assert w4.int4_matmul_kernel.launches == before + 1
    assert out.dtype == dtype and out.shape == (rows, n_out)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 44])
@pytest.mark.parametrize("group", [2, 24])
def test_w4_kernel_small_groups_match_plain(group, rows, dtype):
    """The template for groups that are no multiple of 16 (a scale looked
    up for each packed row) on a small shape whose 120 channels end in half
    a k-step."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4)
    x, packed, scale, chan = _w4_case(rows, 120, 128, group, dtype, rows)
    ref = w4.matmul_w4_plain(x, packed, scale, chan, group).float()
    out = w4.int4_matmul_kernel(x, packed, scale, chan, group)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (rows, 128)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8])
def test_w4_kernel_on_views_that_are_not_16_byte_aligned(rows, dtype):
    """x and chan as contiguous views one element into their storage, and
    a row of 100 channels (200 bytes in bf16): the kernel copies them by
    element loads in place of 16-byte cp.async, with the same results."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4)
    for n_in, group in ((1024, 128), (100, 4)):
        x, packed, scale, chan = _w4_case(rows, n_in, 128, group, dtype, 3)
        xs = torch.empty(rows * n_in + 1, dtype=dtype, device="cuda")
        xs[1:] = x.reshape(-1)
        cs = torch.empty(n_in + 1, device="cuda")
        cs[1:] = chan
        xv, cv = xs[1:].view(rows, n_in), cs[1:]
        assert xv.data_ptr() % 16 and cv.data_ptr() % 16
        ref = w4.matmul_w4_plain(x, packed, scale, chan, group).float()
        out = w4.int4_matmul_kernel(xv, packed, scale, cv, group)
        tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max()
        assert (out.float() - ref).abs().max().item() <= tol.item()
        assert torch.equal(out, w4.int4_matmul_kernel(x, packed, scale,
                                                      chan, group))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 44])
@pytest.mark.parametrize("group", [8, 128])
def test_w4_kernel_rounds_as_plain(group, rows):
    """Bit for bit, where every output is one product: a weight of 1 a
    column turns y into bf16(x / chan) (x and chan spanning magnitudes on
    both sides of 2^+-64 and zeros), and one-hot rows of x with chan = 1
    turn it into the bf16 weights; fp32 outputs equal the plain version's
    exactly."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4)
    n = 256
    g = torch.Generator(device="cuda").manual_seed(rows + group)
    # activations: packed[i, 2i] = 1 (low nibble), packed[i, 2i + 1] = 16
    # (high nibble): channel c meets column c with weight 1
    packed = torch.zeros(n // 2, n, dtype=torch.uint8, device="cuda")
    i = torch.arange(n // 2, device="cuda")
    packed[i, 2 * i] = 0x01
    packed[i, 2 * i + 1] = 0x10
    ones = torch.ones(n // group, n, device="cuda")
    x = torch.randn(rows, n, generator=g, device="cuda")
    x[0, :8] = torch.tensor([1e-30, -1e-25, 1e25, -3e18, 0.0, -0.0, 5e-20,
                             2e19])
    chan = torch.rand(n, generator=g, device="cuda") + 0.25
    chan[8:12] = torch.tensor([1e-25, 3e22, 2e-19, 6e19])
    out = w4.int4_matmul_kernel(x, packed, ones, chan, group)
    ref = w4.matmul_w4_plain(x, packed, ones, chan, group)
    assert torch.equal(out, ref)
    assert torch.equal(out, w4.fold_chan(x, chan).float())
    # weights: x one-hot, chan = 1: row r of y is weight row 3r + 1
    packed = torch.randint(0, 256, (n // 2, n), generator=g,
                           device="cuda").to(torch.uint8)
    scale = torch.rand(n // group, n, generator=g, device="cuda") * 0.03
    x = torch.zeros(rows, n, device="cuda")
    x[torch.arange(rows), 3 * torch.arange(rows) + 1] = 1.0
    out = w4.int4_matmul_kernel(x, packed, scale, torch.ones(n,
                                device="cuda"), group)
    ref = w4.matmul_w4_plain(x, packed, scale, torch.ones(n, device="cuda"),
                             group)
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [8, 64])
@pytest.mark.parametrize("shape", [(4096, 14336), (14336, 4096)])
def test_w4_kernel_is_deterministic(shape, rows, dtype):
    """The warps' partials are added in a fixed order: two calls on the
    same inputs give identical bits."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4)
    x, packed, scale, chan = _w4_case(rows, *shape, 128, dtype, 5)
    first = w4.int4_matmul_kernel(x, packed, scale, chan, 128)
    again = w4.int4_matmul_kernel(x, packed, scale, chan, 128)
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_matmul_kernels_refuse_what_they_cannot_run():
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4, int8_matmul as w8, quantization as tq)
    x, values, scale = _w8_case(8, 256, 128, torch.bfloat16)
    with pytest.raises(ValueError):        # more than 64 rows
        w8.int8_matmul_kernel(x.repeat(9, 1), values, scale)
    with pytest.raises(ValueError):        # out not a multiple of the tile
        w8.int8_matmul_kernel(x, values[:, :100].contiguous(), scale)
    with pytest.raises(ValueError):        # a CPU tensor
        w8.int8_matmul_ksplit_kernel(x.cpu(), values, scale)
    with pytest.raises(ValueError):        # values of another dtype
        w8.int8_matmul_kernel(x, values.float(), scale)
    packed, s4, chan = tq.quantize_int4_groupwise(values.float(), 64)
    with pytest.raises(ValueError):        # group does not divide in
        w4.int4_matmul_kernel(x, packed, s4, chan, group=96)
    with pytest.raises(ValueError):
        w4.int4_matmul_kernel(x.half(), packed, s4, chan, group=64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (3, 5, 64), (4096, 4096),
                                   (2, 16384), (7, 2048)])
def test_rmsnorm_kernel_matches_plain(shape, dtype):
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import layers
    from distributed_llm_training_and_inference_system_tpu_torch.ops.rmsnorm \
        import rmsnorm_kernel
    g = torch.Generator(device="cuda").manual_seed(shape[-1])
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
    scale = (torch.randn(shape[-1], generator=g, device="cuda") * 0.1
             ).to(dtype)
    before = rmsnorm_kernel.launches
    out = layers.rms_norm(x, scale, 1e-5, impl="cuda")
    torch.cuda.synchronize()
    assert rmsnorm_kernel.launches == before + 1
    ref = layers.rms_norm(x, scale, 1e-5)
    assert out.dtype == dtype and out.shape == x.shape
    # fp32: the order of the sum of squares; bf16: one rounding of the
    # output, 2^-8 relative, on values up to ~12
    tol = 2e-5 if dtype == torch.float32 else 6e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    with pytest.raises(RuntimeError):       # forward only
        layers.rms_norm(x.float().requires_grad_(True), scale.float(),
                        impl="cuda")
    with pytest.raises(ValueError):         # H not a multiple of 8
        rmsnorm_kernel(x[..., :60].contiguous(), scale[:60])


def _norm_case(rows, H, x_dtype, s_dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, H, generator=g, device="cuda") * 3).to(x_dtype)
    scale = (torch.randn(H, generator=g, device="cuda") * 0.1).to(s_dtype)
    return x, scale


_NORM_DTYPES = [(torch.float32, torch.float32),
                (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,s_dtype", _NORM_DTYPES)
@pytest.mark.parametrize("H", [64, 2048, 4096, 5120])
@pytest.mark.parametrize("rows", [1, 7, 1024, 8192])
def test_rmsnorm_kernel_in_every_dtype_pair(rows, H, x_dtype, s_dtype):
    """x and scale each in fp32 or bf16 (the scale read in its own dtype),
    a warp a row (H <= 4096 in bf16, <= 2048 in fp32) or a block a row:
    within the tolerances of test_rmsnorm_kernel_matches_plain."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import layers
    x, scale = _norm_case(rows, H, x_dtype, s_dtype, seed=rows + H)
    out = layers.rms_norm(x, scale, 1e-5, impl="cuda")
    ref = layers.rms_norm(x, scale, 1e-5)
    assert out.dtype == x_dtype and out.shape == x.shape
    tol = 2e-5 if x_dtype == torch.float32 else 6e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,s_dtype", _NORM_DTYPES)
@pytest.mark.parametrize("shape", [(1, 1024, 2048), (8, 4096), (3, 8192)])
def test_rmsnorm_runs_one_cuda_kernel_a_call(shape, x_dtype, s_dtype):
    """No conversion of the scale ahead of the norm: a CUDA graph of one
    call holds one kernel."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops.rmsnorm \
        import rmsnorm_kernel
    x, scale = _norm_case(int(torch.tensor(shape[:-1]).prod()), shape[-1],
                          x_dtype, s_dtype)
    x = x.view(shape)
    assert _graph_kernels(lambda: rmsnorm_kernel(x, scale)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype,s_dtype", _NORM_DTYPES)
@pytest.mark.parametrize("rows,H", [(1024, 2048), (8192, 4096), (5, 16384)])
def test_rmsnorm_repeated_calls_give_identical_bits(rows, H, x_dtype,
                                                    s_dtype):
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops.rmsnorm \
        import rmsnorm_kernel
    x, scale = _norm_case(rows, H, x_dtype, s_dtype, seed=7)
    first = rmsnorm_kernel(x, scale)
    assert all(torch.equal(first, rmsnorm_kernel(x, scale))
               for _ in range(3))


@pytest.mark.gpu
def test_rmsnorm_kernel_refusals():
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import layers
    from distributed_llm_training_and_inference_system_tpu_torch.ops.rmsnorm \
        import rmsnorm_kernel
    x, scale = _norm_case(4, 64, torch.bfloat16, torch.bfloat16)
    with pytest.raises(ValueError):         # H not a multiple of 8
        rmsnorm_kernel(x[:, :60].contiguous(), scale[:60])
    flat = torch.empty(4 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):         # x 2 bytes into its storage
        rmsnorm_kernel(flat[1:].view(4, 64), scale)
    with pytest.raises(ValueError):         # a scale neither fp32 nor bf16
        rmsnorm_kernel(x, scale.half())
    with pytest.raises(RuntimeError):       # forward only
        layers.rms_norm(x.float().requires_grad_(True), scale, impl="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("quantization,kv,w8", [
    ("int8", "int8", True), ("int4", "int4", False), ("int8", "int4", False),
    ("none", "int8", False)])
def test_quantized_engine_on_card_matches_engine_on_cpu(quantization, kv,
                                                        w8):
    """A small model whose shapes reach the kernels (out % 128 == 0,
    D % 16 == 0), fp32: the card engine's launches are what the code
    implies. With full-precision weights the card engine (page kernel) and
    the CPU engine (gather version) produce the same greedy tokens. The
    matmul kernels round activations and weights to bf16 where the dequant
    route keeps fp32, so there one decode step through the kernels is held
    to the same step through the dequant route within 3e-2 of the largest
    logit."""
    _need_card()
    import dataclasses
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4m, int8_matmul as w8m, paged_attention_cuda as pac)
    cfg = dataclasses.replace(
        get_model_config("gpt-test"), num_layers=2, hidden_size=256,
        ffn_size=512, num_heads=4, num_kv_heads=2, head_dim=64,
        dtype="float32")
    scfg = ServeConfig(model=cfg.name, max_batch_size=4, max_seq_len=128,
                       prefill_chunk=32, kv_block_size=8, dtype="float32",
                       quantization=quantization, kv_quantization=kv,
                       int8_pallas_matmul=w8)
    model = gpt.init(cfg, torch.Generator(device="cuda").manual_seed(5),
                     device="cuda")
    cpu_model = gpt.GPT(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    prompts = [list(range(3, 30)), [7, 8, 9], list(range(100, 140))]
    greedy = SamplingParams(temperature=0.0, max_tokens=10)
    kernels = {"w8": w8m.int8_matmul_kernel,
               "w8k": w8m.int8_matmul_ksplit_kernel,
               "w4": w4m.int4_matmul_kernel,
               "p8": pac.paged_attention_int8_kernel,
               "p4": pac.paged_attention_int4_kernel,
               "pf": paged_attention_kernel}
    before = {k: f.launches for k, f in kernels.items()}
    eng = InferenceEngine(cfg, scfg, params=model)
    out = eng.generate(prompts, greedy)
    grew = {k: f.launches - before[k] for k, f in kernels.items()}
    assert all(len(r.generated_tokens) == 10 for r in out)
    assert eng.stats()["nonfinite_logits"] == 0
    if quantization == "none":
        ref = InferenceEngine(cfg, scfg, params=cpu_model, device="cpu"
                              ).generate(prompts, greedy)
        assert [r.generated_tokens for r in out] == \
            [r.generated_tokens for r in ref]
    else:
        from distributed_llm_training_and_inference_system_tpu_torch.serve.\
            decode import decode_step_forward
        eng.kv.allocate(0, 16)
        args = (eng.params, torch.tensor([5, 6], device="cuda"),
                torch.tensor([3, 0], device="cuda"), eng.kv.k_pages,
                eng.kv.v_pages,
                torch.from_numpy(eng.kv.block_tables[:2].copy()).cuda(), cfg)
        saved = {k: f.launches for k, f in kernels.items()}
        fast = decode_step_forward(*args, w8_kernel_ok=w8)[0]
        slow = decode_step_forward(*args, w4_kernel_ok=False,
                                   w8_kernel_ok=False)[0]
        for k, f in kernels.items():
            f.launches = saved[k]
        assert (fast - slow).abs().max() <= 3e-2 * slow.abs().max()
    steps = eng.total_dispatched_steps
    paged = {"int8": "p8", "int4": "p4"}[kv]
    assert grew[paged] == cfg.num_layers * steps
    assert grew["pf"] == 0
    mm = 7 * cfg.num_layers * steps
    assert grew["w4"] == (mm if quantization == "int4" else 0)
    assert grew["w8"] + grew["w8k"] == (mm if w8 else 0)
    assert eng.stats()["quantization"] == quantization
    assert eng.stats()["kv"]["kv_quantization"] == kv


# -- engine features: verify and chunk windows, swap payloads -----------------
#
# The paged kernel at the windows that speculation (T = 8 verify windows)
# and chunked prefill (T up to 512) give it, against its plain version with
# the tolerances above; a slot's pages extracted to pinned host memory and
# restored, bit for bit; verify windows of B * T rows at the 64-row line
# where quantized weights leave the W8/W4 kernels for the dequant route.

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("T", [8, 512])
def test_kernel_at_verify_and_chunk_windows(T, kind, dtype):
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        paged_attention_cuda as pac)
    lengths = [max(n, T) for n in (8, 70, 600, 1500)]
    q, kp, vp, tables, starts = _case(len(lengths), T, 32, 8, 128, 64,
                                      lengths, torch.float32, seed=T)
    q = q.to(dtype)
    if kind == "fp":
        kp, vp = kp.to(dtype), vp.to(dtype)
        kernel = paged_attention_kernel
    else:
        kp, vp = _quant_pages(kind, kp), _quant_pages(kind, vp)
        kernel = getattr(pac, f"paged_attention_{kind}_kernel")
    before = kernel.launches
    out = pa.paged_attention_multi(q, kp, vp, tables, starts)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = pa.paged_attention_multi(q, kp, vp, tables, starts, impl="gather")
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["none", "int8", "int4"])
def test_swap_payload_round_trip_on_card_is_bitwise(kind):
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        import kv_cache
    cfg = get_model_config("gpt-test")
    kv = kv_cache.PagedKVCache(cfg, num_slots=4, max_seq_len=128,
                               page_size=8, num_pages=40,
                               dtype=torch.bfloat16, device="cuda",
                               quantized=kind)
    g = torch.Generator(device="cuda").manual_seed(1)
    for buf in (kv.k_pages, kv.v_pages):
        for t in (buf.tensors() if kind != "none" else (buf,)):
            if t.dtype.is_floating_point:
                t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
            else:
                t.copy_(torch.randint(-100, 100, t.shape, generator=g,
                                      device="cuda").to(t.dtype))
    kv.allocate(0, 50)                       # 7 pages
    payload = kv.extract_slot(0)
    leaves = [p for part in (payload["k"], payload["v"])
              for p in (part.values() if isinstance(part, dict) else (part,))]
    assert all(p.device.type == "cpu" and p.is_pinned() for p in leaves)
    host = kv_cache.payload_numpy(payload)
    kv.release(0)
    kv.allocate(1, 30)                       # takes some of the old pages
    kv.allocate(2, 30)
    assert kv.restore_slot(3, payload)
    back = kv_cache.payload_numpy(kv.extract_slot(3))
    for name in ("k", "v"):
        a, b = host[name], back[name]
        pairs = ([(a[p], b[p]) for p in ("values", "scale")]
                 if isinstance(a, dict) else [(a, b)])
        for x, y in pairs:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [64, 72])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_verify_window_rows_at_the_kernel_line(quant, rows):
    """A verify window of ``rows`` = B x T rows through decode.mm: 64 rows
    (8 slots x T = 8) launch the W8/W4 kernel, 72 take the dequant route;
    both agree with the dequant route within the matmul tolerance."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4m, int8_matmul as w8m, quantization as tq)
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        import decode
    dtype = torch.bfloat16
    if quant == "int8":
        x, values, scale = _w8_case(rows, 4096, 1024, dtype, seed=rows)
        w = tq.QuantTensor(values, scale)
        kernels = (w8m.int8_matmul_kernel, w8m.int8_matmul_ksplit_kernel)
    else:
        x, packed, scale, chan = _w4_case(rows, 4096, 1024, 128, dtype,
                                          seed=rows)
        w = tq.Quant4Tensor(packed, scale, chan, group=128)
        kernels = (w4m.int4_matmul_kernel,)
    x = x.reshape(rows // 8, 8, 4096)       # [B, T, H] as the verify window
    before = [k.launches for k in kernels]
    out = decode.mm(x, w, dtype, w8_kernel_ok=True)
    torch.cuda.synchronize()
    launched = sum(k.launches - b for k, b in zip(kernels, before))
    assert launched == (1 if rows <= decode.KERNEL_MAX_ROWS else 0)
    ref = x @ w.dequant(dtype)
    assert out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= \
        1e-2 * ref.float().abs().max().item()


@pytest.mark.gpu
def test_engine_features_on_card_match_engine_on_cpu():
    """gpt-test in fp32 with swap preemption, chunked prefill and n-gram
    speculation all on: the card (verify and chunk windows through the
    paged kernel) gives the CPU engine's tokens and stats, and the kernel's
    launches are one a layer for every decode step, suffix prefill, chunk
    and verify window."""
    _need_card()
    cfg = get_model_config("gpt-test")
    scfg = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
                prefill_chunk=32, kv_block_size=8, dtype="float32",
                chunked_prefill_tokens=16, speculative="ngram",
                speculative_tokens=4, preemption="swap", kv_num_blocks=14,
                decode_steps_per_dispatch=4)
    cpu_model = gpt.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    card_model = gpt.GPT(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    rep = [7, 8, 9, 10] * 4
    prompts = [rep + list(range(20, 30)), list(range(40, 56)), rep * 2]
    greedy = SamplingParams(temperature=0.0, max_tokens=36)
    cpu = InferenceEngine(cfg, ServeConfig(**scfg), params=cpu_model,
                          device="cpu")
    ref = cpu.generate(prompts, greedy)
    before = paged_attention_kernel.launches
    eng = InferenceEngine(cfg, ServeConfig(**scfg), params=card_model)
    out = eng.generate(prompts, greedy)
    assert [r.generated_tokens for r in out] == \
        [r.generated_tokens for r in ref]
    st, cst = eng.stats(), cpu.stats()
    for key in ("swap_ins", "spec_dispatches", "spec_accepted",
                "prefill_chunks", "decode_steps"):
        assert st[key] == cst[key], key
    assert st["swap_ins"] > 0 and st["spec_dispatches"] > 0
    assert st["prefill_chunks"] > 0 and st["nonfinite_logits"] == 0
    assert paged_attention_kernel.launches - before == cfg.num_layers * (
        st["dispatched_steps"] + st["extend_prefills"]
        + st["prefill_chunks"] + st["spec_dispatches"])


# -- the MoE family -----------------------------------------------------------

import dataclasses  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from distributed_llm_training_and_inference_system_tpu_torch.models import (  # noqa: E402
    layers as tl)


def _moe_cfg():
    """gpt-test-moe widened to 8 experts over H = 256, F = 512."""
    c = get_model_config("gpt-test-moe")
    return dataclasses.replace(c, hidden_size=256, ffn_size=512,
                               moe=dataclasses.replace(c.moe, num_experts=8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [8, 512])
def test_moe_block_on_card_matches_cpu(N, dtype):
    """The same kept and dropped choices in the same buffer slots as the
    CPU (router in fp32, TF32 off), out within 1e-5 (fp32) or 2e-2 (bf16)
    of its largest element, aux within 1e-5 of itself."""
    _need_card()
    cfg = _moe_cfg()
    g = torch.Generator().manual_seed(N)
    H, F, E = cfg.hidden_size, cfg.ffn_size, cfg.moe.num_experts
    w = {"moe_router": 0.02 * torch.randn(H, E, generator=g),
         "moe_gate": 0.02 * torch.randn(E, H, F, generator=g),
         "moe_up": 0.02 * torch.randn(E, H, F, generator=g),
         "moe_down": 0.01 * torch.randn(E, F, H, generator=g)}
    x = torch.randn(1, N, H, generator=g).to(dtype)
    res = {}
    for dev in ("cpu", "cuda"):
        layer = SimpleNamespace(**{k: v.to(dev, dtype) for k, v in w.items()})
        xx = x.to(dev)
        with torch.no_grad():
            out, aux = tl.moe_block(xx, layer, cfg)
            probs = torch.softmax(xx[0].float() @ layer.moe_router.float(),
                                  dim=-1)
            d = tl.moe_dispatch(probs, cfg)
        res[dev] = (out.float().cpu(), aux.item(), d.slot.cpu())
    (co, ca, cs), (ko, ka, ks) = res["cpu"], res["cuda"]
    assert torch.equal(cs, ks)
    assert (ko - co).abs().max().item() <= TOL[dtype] * co.abs().max().item()
    assert abs(ka - ca) <= 1e-5 * abs(ca)


@pytest.mark.gpu
def test_moe_engine_on_card_matches_engine_on_cpu():
    """gpt-test-moe in fp32 with chunked prefill, n-gram speculation and
    swap preemption: the card gives the CPU engine's tokens (idle slots
    route too, so a difference in any row's contents would show), and the
    paged kernel launches one a layer for every forward over the pages."""
    _need_card()
    cfg = get_model_config("gpt-test-moe")
    scfg = dict(model=cfg.name, max_batch_size=4, max_seq_len=128,
                prefill_chunk=32, kv_block_size=8, dtype="float32",
                chunked_prefill_tokens=16, speculative="ngram",
                speculative_tokens=4, preemption="swap", kv_num_blocks=14,
                decode_steps_per_dispatch=4)
    cpu_model = gpt.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    card_model = gpt.GPT(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    rep = [7, 8, 9, 10] * 4
    prompts = [rep + list(range(20, 30)), list(range(40, 56)), rep * 2, [5]]
    greedy = SamplingParams(temperature=0.0, max_tokens=36)
    cpu = InferenceEngine(cfg, ServeConfig(**scfg), params=cpu_model,
                          device="cpu")
    ref = cpu.generate(prompts, greedy)
    before = paged_attention_kernel.launches
    eng = InferenceEngine(cfg, ServeConfig(**scfg), params=card_model)
    out = eng.generate(prompts, greedy)
    assert [r.generated_tokens for r in out] == \
        [r.generated_tokens for r in ref]
    st, cst = eng.stats(), cpu.stats()
    for key in ("swap_ins", "spec_dispatches", "prefill_chunks",
                "decode_steps", "weight_bytes"):
        assert st[key] == cst[key], key
    assert st["nonfinite_logits"] == 0
    assert paged_attention_kernel.launches - before == cfg.num_layers * (
        st["dispatched_steps"] + st["extend_prefills"]
        + st["prefill_chunks"] + st["spec_dispatches"])


@pytest.mark.gpu
def test_moe_train_step_on_card_matches_cpu():
    """One gpt-test-moe training step (fp32, plain attention, loss + aux
    differentiated through the sort-based dispatch) on the card and on the
    CPU from the same state: loss and gradient norm within 1e-5."""
    _need_card()
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import schema
    from distributed_llm_training_and_inference_system_tpu_torch.exec import (
        train_step as ts)
    cfg = get_model_config("gpt-test-moe")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        model = gpt.init(cfg, torch.Generator().manual_seed(1), device="cpu")
        model = model.to(dev)
        step, init, _ = ts.make_train_step(
            cfg, schema.OptimizerConfig(fused=dev == "cuda"),
            schema.ParallelConfig(activation_checkpoint="full"),
            loss_chunk=16)
        _, m = step(ts.TrainState.create(model, init),
                    {"tokens": tokens.to(dev)})
        out[dev] = (m["loss"].item(), m["grad_norm"].item())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b)
