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
