#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of llmctl on one NVIDIA card (H100).

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run (non-zero exit) if it fails:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel from csrc/ for sm_90a (-Xptxas -v);
3. kernel  — the paged-attention kernel against its plain PyTorch version
             at llama-8b-gqa geometry (32 q heads over 8 kv heads, D=128,
             pages of 64, 8 slots with ragged lengths up to 2048), windows
             T in {1, 4, 8, 128, 512} (decode, verify windows, suffix and
             chunk prefill), fp32 (tolerance 1e-5) and bf16 (2e-2: the
             output is rounded to bf16);
4. timing  — CUDA-event times of the kernel, its plain version and one
             PyTorch library call at the decode shape (T=1, B=8), beside
             the bound (live K+V bytes over 3.35 TB/s); the kernel's share
             of its bound, its ratio to SDPA, the live blocks of its split
             plan and ptxas's registers and spills of its fp templates
             (printed, not gated). The kernel splits each slot's keys
             over up to 8 blocks of one cluster (8 splits of 256 keys at
             this shape), which combine their partials in a fixed order
             through distributed shared memory;
5. serve   — the port's main path at full width: InferenceServer over
             llama-8b-gqa (32 layers, random bf16 weights from seed 0),
             default ServeConfig, 8 /v1/completions (greedy and sampled,
             two sharing a 256-token prefix), /health, and the kernel's
             launch count checked against the engine's decode steps;
6. paged vs dense — one greedy request's per-step paged decode logits
             (through the kernel) and the dense bf16 forward over the full
             context, both against an fp32 dense forward of the same
             weights: the paged path may be at most 1.5x further from it;
7. flash   — the three flash-attention kernels (forward, dq, dk/dv)
             against their plain versions at gpt-1b (B=4 as the training
             path runs it, S=2048, 16/16 heads, D=128) and llama-8b-gqa
             (B=2, S=1024, 32 q over 8 kv heads) geometry: causal and
             packed rows through the differentiable flash_attention, and
             the raw _fwd/_bwd_impl pair with positions restarting per
             document; fp32 (out/lse 1e-5, gradients 1e-4 of their max)
             and bf16 (2e-2 of the max; each element within one bf16
             rounding of itself plus 2.5e-2 of its row's rms; rms error
             5e-3 of the rms; lse 1e-4); every CUDA call counted at its
             kernel; the raw bf16 forward and backward, each run twice,
             give equal bits;
8. adamw   — the fused AdamW kernel bitwise equal to its plain version on
             every gpt-1b leaf shape, fp32 and bf16 moments, with and
             without decay, clip scale < 1, a leaf a call; then all of
             them in one multi-leaf call (one launch a dtype pair);
9. train timing — CUDA-event times of the three flash kernels at the
             training shape (micro-batch x 2048, bf16, causal) and of one
             AdamW update of every gpt-1b leaf, beside their plain versions,
             SDPA / torch._fused_adamw_ and their bounds; each flash
             kernel's share of its bound, the forward over SDPA's forward
             and the backward pair over SDPA's backward (printed, not
             gated) and ptxas's registers and spills of the bf16 flash
             kernels; AdamW's launches a call, share of its bound, ratio
             to torch._fused_adamw_ and ptxas figures (printed);
10. train  — the port's training path: TrainingEngine trains gpt-1b at
             full width and depth (24 layers, H=2048, vocab 50304; random
             fp32 masters from seed 42, synthetic data, S=2048, fused AdamW
             warmed up over 2 steps, selective remat) for 8 steps and saves
             a checkpoint to a temporary directory; the loss is finite and
             falls, and each kernel's launches equal what the code implies
             (AdamW: the planned launches a step, one at fp32 moments,
             and 170 leaves a step);
             the step time and MFU beside those of the earlier
             backward kernels (another run);
             then the checkpoint is restored (step, data cursor, state) and
             one step through the kernels agrees with one through the plain
             versions within 1e-2;
11. quantized kernels — paged attention over int8 and int4 pages at phase
             3's geometry and windows (fp32 1e-5; bf16 2e-2 and phase 7's
             row-scaled limits); the W8A16 whole-reduction and k-split
             kernels and the W4A16 kernel (group 128, channel scales not
             all ones) at every llama-8b-gqa projection shape, rows 1, 8
             and 64, against their
             plain versions (each bf16 element within one bf16 rounding of
             itself plus 1e-2 of its row's rms; fp32 out 1e-4 of the row's
             rms); each W8 kernel twice with identical bits (both split the
             reduction over a cluster of blocks and add the splits in a
             fixed order); RMSNorm at [8, 4096], [4096, 4096] and the entry
             forward's [1, 1024, 2048];
12. quantized timing — CUDA-event times, L2 flushed, beside bound and
             library call: W8 and W4 at 8 rows for 4096 -> 14336 and
             14336 -> 4096 (library: x @ the dequantized bf16 weight, which
             reads 2 bytes a weight), paged attention over int8/int4 pages
             at phase 4's decode shape, RMSNorm; the W8 and W4 kernels'
             shares of their bounds and their ratios to x @ w_bf16 at both
             shapes, the paged kernel's share of its bound over int8/int4
             pages, and ptxas's registers and spills of the W8, W4 and
             paged kernels' templates, RMSNorm's shares of its bound, its
             ratio to F.rms_norm and ptxas figures (printed, not gated);
13. serve quantized — llama-8b-gqa at full width and depth from phase 5's
             bf16 weights, twice: A = int8 weights through the W8 kernels
             (int8_pallas_matmul) with int8 KV pages, B = int4 weights with
             int4 KV pages; phase 5's traffic; every kernel's launches
             against what the code implies (224 matmul launches per decode
             step, 192 whole-reduction + 32 k-split in A; 32 paged launches
             per step); /health reports the quantization and the pool's
             bytes per kind; one decode step through the kernels against
             the same step through the dequant route and the gather
             attention, within 0.1 of the largest logit;
14. RMSNorm on a path — the port's entry() forward (gpt-1b, [1, 1024],
             bf16, flash attention) with every norm through the kernel
             (2L + 1 launches) against the same forward without it; the
             CUDA kernels of its norms (one a norm) and its device time
             with norm_impl "xla" and "cuda" (torch.profiler; printed);
15. serve features — run after 13, on phase 5's weights: llama-8b-gqa at
             full width and depth, max_seq_len 4096, served with swap
             preemption, chunked prefill (512) and n-gram speculation (T =
             8) on a pool of 141 pages, and again with the three off; 8
             prompts of 64-3000 tokens with spans that recur, 64 new
             tokens each, 5 greedy and 3 seeded-sampled: at least one
             swap-in, one speculative dispatch and two chunked prefills,
             no NaN/inf, the paged kernel launched 32 x (decode steps +
             suffix prefills + chunks + verify windows), /v1/stats; every
             token of both runs within the near-tie bound 2 x 0.5 of the
             dense forward's best (sampled: over the temperature, Gumbel
             noise added), and where the runs part, the features-off
             run's top two within it; a 24-page slot extracted and
             restored bit for bit (the run's bf16 pool, int8 and int4
             pages); TTFT of a 3000-token prompt chunked and dense, decode
             tok/s with speculation on and off, the acceptance rate and
             the swap times and bytes (printed);
16. MoE    — run last: (a) moe_block at gpt-moe-8x1b's widths (H 2048,
             F 5632, 8 experts, top-2) on the card against the same
             function on the CPU at N = 8 and 2048, fp32 and bf16: the same
             choices kept and dropped in the same buffer slots, out within
             1e-5 (fp32) / 2e-2 (bf16) of its max, aux within 1e-5; its
             dispatch and whole-block times at N = 8 beside the bound of
             reading every expert once; (b) gpt-moe-8x1b at full width
             and depth (16 layers, 4.90B random bf16 parameters from seed
             0) through InferenceServer, 8 slots, 12 greedy requests of
             40-1500 tokens (one sharing another's prefix), 24 new tokens
             each: plain, then with chunked prefill (512) and n-gram
             speculation (T = 8), then 4 requests with int8 weights through
             the W8 kernels (q/k/v/o; router and experts dequantized); each
             run's paged launches = 16 x (decode steps + suffix prefills +
             chunks + verify windows), W8's = 4 x 16 x decode steps; every
             forward each engine issued replayed in order on a fresh pool
             through the plain paged attention (and the dequant route),
             with its tokens, pad rows and routing held: every position
             whose logits the engine read within the near-tie bound 2 x
             0.5 of the replay's best, and where the replay's own router
             would choose otherwise, within 0.05 of probability; TTFT,
             decode tok/s, wall ms a step and the share of choices dropped
             per step (printed); (c) gpt-moe-1b at full width and depth (12
             layers, 0.98B parameters) trained through
             runtime/train_entry.py for 6 steps (flash kernels, fused
             AdamW, selective remat, micro-batch 4 x 2048): the loss
             finite, the flash launches 2 x 12 / 12 / 12 a step; then
             3 kernel steps on one repeated batch (the loss falls) and the
             first of them against the plain step within 1e-2; tokens/s and
             MFU over active parameters (printed).

The last line is {"ok": true, "device": {...}}; the line before it is the
{"kernels": [...]} record. Without a CUDA card, or without the rest of the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PORT = "distributed_llm_training_and_inference_system_tpu_torch"

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core bf16
            "float32": 67e12}        # fp32 outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# paged decode against the dense forward, both in bf16 and both measured
# against an fp32 dense forward of the same weights: the paged path (the
# kernel keeps fp32 probabilities, the dense path rounds them to bf16) may
# be at most this factor further from fp32 than the dense bf16 path is
DENSE_ERR_FACTOR = 1.5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float) -> None:
    print(f"== {name} (t={time.time() - t0:.1f}s)", flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# cycles the card spins before each timed call (~1 ms), so that the host
# has queued the whole call before its start event is reached: the events
# then time the device alone, not a host slower than the kernels (SDPA's
# backward goes through autograd's engine and read 0.48-0.94 ms without it)
HOLD_CYCLES = 2_000_000


def time_ms(torch, fn, iters: int = 50, warmup: int = 5, flush=None) -> float:
    """Mean device time of ``fn`` from CUDA events around each call; with
    ``flush`` the L2 cache is overwritten before every timed call (a decode
    step meets each layer's pages cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# -- phase 3/4: the kernel against its plain version ------------------------

# query windows the serving paths give the kernel: decode (1), a short
# window (4), speculation's verify window (8), a suffix prefill bucket (128)
# and a chunk of chunked prefill (512)
PAGED_WINDOWS = (1, 4, 8, 128, 512)

# (query heads, KV heads, head_dim, page size) of llama-8b-gqa's decode
LLAMA_PAGED = (32, 8, 128, 64)


def paged_case(torch, T: int, dtype, seed: int = 0, geom=LLAMA_PAGED):
    """A decode geometry ``geom`` (llama-8b-gqa's unless given): 8 slots,
    ragged lengths up to 2048, each slot's pages scattered over the pool
    in random order."""
    B, (Nq, Nkv, D, PS) = 8, geom
    maxP = -(-2048 // PS)
    NP = B * maxP + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = [2048, 1, 64, 65, 777, 1500, 130, 2000]
    lengths = [max(n, T) for n in base]
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
    return q, kp, vp, tables.cuda(), starts, lengths


def kernel_against_plain(torch, pa, kernel, dtypes=None,
                         windows=PAGED_WINDOWS, geom=LLAMA_PAGED) -> float:
    """The paged kernel against the gather version on the same inputs, at
    every window T of ``windows`` and dtype of ``dtypes`` (fp32 and bf16
    unless given), at ``geom``; returns the largest difference."""
    worst = 0.0
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for T in windows:
            q, kp, vp, tables, starts, _ = paged_case(torch, T, dtype, seed=T,
                                                      geom=geom)
            before = kernel.launches
            out = pa.paged_attention_multi(q, kp, vp, tables, starts)
            torch.cuda.synchronize()
            check(kernel.launches == before + 1,
                  "a CUDA tensor did not go through the kernel")
            ref = pa.paged_attention_multi(q, kp, vp, tables, starts,
                                           impl="gather")
            err = (out.float() - ref.float()).abs().max().item()
            check(bool(torch.isfinite(out.float()).all()),
                  f"non-finite kernel output ({name}, T={T})")
            print(f"kernel vs plain  {name:8s} T={T:<4d} heads "
                  f"{geom[0]}/{geom[1]} D={geom[2]} PS={geom[3]} "
                  f"max_abs_err={err:.3e}  tol={TOL[name]:.0e}", flush=True)
            check(err <= TOL[name], f"kernel disagrees with plain ({name}, "
                  f"T={T}): {err} > {TOL[name]}")
            worst = max(worst, err)
    return worst


def paged_ptxas_lines(build_log: str, kinds) -> dict:
    """ptxas's registers and spill bytes of the paged kernel's templates
    of the given page kinds, printed."""
    from distributed_llm_training_and_inference_system_tpu_torch import (
        profile_kernel as pk)
    figs = {n: f for n, f in pk.paged_ptxas(build_log).items()
            if any(f"<{k}," in n for k in kinds)}
    for name, f in figs.items():
        print(f"ptxas {name}: {f.get('registers')} registers, spill "
              f"stores/loads {f.get('spill_stores')}/{f.get('spill_loads')} B",
              flush=True)
    if not figs:
        print("ptxas: the build log holds no paged-attention figures (the "
              "library was built before this run)", flush=True)
    return figs


def decode_timing(torch, F, pa, kernel, build_log: str = "") -> dict:
    """Kernel, plain and library times at the decode shape (T=1, B=8,
    bf16), and the bound for this run's inputs; the kernel's share of the
    bound, its ratio to the library call, the split plan's live blocks and
    ptxas's figures of the fp templates (from ``build_log``), printed."""
    from distributed_llm_training_and_inference_system_tpu_torch import (
        profile_kernel as pk)
    dtype = torch.bfloat16
    q, kp, vp, tables, starts, lengths = paged_case(torch, 1, dtype, seed=99)
    B, T, Nq, D = q.shape
    Nkv, PS = kp.shape[1], kp.shape[2]
    item = q.element_size()
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    saved = kernel.launches
    k_ms = time_ms(torch, lambda: pa.paged_attention_multi(
        q, kp, vp, tables, starts), flush=flush)
    p_ms = time_ms(torch, lambda: pa.paged_attention_multi(
        q, kp, vp, tables, starts, impl="gather"), flush=flush)
    kernel.launches = saved        # timing launches are not the main path

    # library yardstick: one SDPA call over the pre-gathered cache
    kg = pa._gather_pages(kp, tables)                  # [B, Nkv, L, D]
    vg = pa._gather_pages(vp, tables)
    L = kg.shape[2]
    mask = (torch.arange(L, device="cuda")[None, :]
            < (starts.long() + 1)[:, None])[:, None, None, :]
    ql = q[:, 0, :, None, :]                           # [B, Nq, 1, D]

    def lib():
        return F.scaled_dot_product_attention(ql, kg, vg, attn_mask=mask,
                                              enable_gqa=True)
    l_ms = time_ms(torch, lib, flush=flush)
    lib_err = (lib()[:, :, 0].float() - pa.paged_attention_multi(
        q, kp, vp, tables, starts)[:, 0].float()).abs().max().item()
    kernel.launches = saved

    live = sum(lengths)                                # K/V rows read
    bytes_moved = (2 * q.numel() * item + 2 * live * Nkv * D * item
                   + tables.numel() * 4 + starts.numel() * 4)
    ops = 4 * Nq * D * live                            # QK^T and PV, T=1
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["bfloat16"] * 1e3
    res = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": bytes_moved, "ops": ops, "library_max_abs_err": lib_err,
           "shape": {"B": B, "T": T, "Nq": Nq, "Nkv": Nkv, "D": D, "PS": PS,
                     "lengths": lengths, "dtype": "bfloat16"}}
    print(f"decode timing (B=8, T=1, bf16, lengths {lengths}): "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"library {l_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}, {bytes_moved} B) -> "
          f"{res['bound_ms'] / k_ms:.1%} of bound; "
          f"library vs kernel max_abs_err {lib_err:.3e}", flush=True)
    res["share_of_bound"] = res["bound_ms"] / k_ms
    res["over_library"] = k_ms / l_ms
    res["split"] = pk.split_report(
        lengths, maxp=tables.shape[1],
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    sp = res["split"]
    print(f"paged_attention (fp pages): {res['share_of_bound']:.1%} of its "
          f"bound, {res['over_library']:.2f}x SDPA (printed, not gated); "
          f"{sp['n_splits']} splits of {sp['keys_per_split']} keys, "
          f"{sp['live_blocks']} of {sp['grid_blocks']} blocks live",
          flush=True)
    res["ptxas"] = paged_ptxas_lines(build_log, ("fp",))
    return res


# -- phase 5: the serving path ---------------------------------------------

WORDS = ("the model serves tokens from paged memory while the scheduler "
         "admits requests and the kernel streams every live page once per "
         "head so decode time follows the true context length").split()


def text(rng: random.Random, n_bytes: int) -> str:
    out = ""
    while len(out) < n_bytes:
        out += rng.choice(WORDS) + " "
    return out[:n_bytes]


def post(port: int, body: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"/v1/completions status {r.status}")
        return json.loads(r.read())


def drive_traffic(torch, srv, cfg, kernels: dict) -> dict:
    """The serving traffic of phases 5 and 13: starts the server, then a
    warm-up, then one greedy request that publishes a 256-token prefix,
    then 7 concurrent requests (greedy and sampled, one sharing the
    prefix), 32 new tokens each. Every counter of ``kernels`` is set to 0
    just before the first measured request and read just after the last.
    Stops the server; checks every answer and /health."""
    eng, port = srv.engine, srv.start()
    max_tokens = 32
    rng = random.Random(0)
    shared = text(rng, 256)                         # 256-token prefix
    lengths = [1500, 64, 900, 300, 1200, 128, 700]
    bodies = []
    for i, n in enumerate(lengths):
        sampled = i % 2 == 1
        bodies.append({"prompt": text(rng, n), "max_tokens": max_tokens,
                       "temperature": 0.8 if sampled else 0.0,
                       "top_k": 40 if sampled else 0,
                       "top_p": 0.95 if sampled else 1.0, "seed": 100 + i})
    bodies[3]["prompt"] = shared + text(rng, 300 - len(shared))
    first = {"prompt": shared + text(rng, 140), "max_tokens": max_tokens,
             "temperature": 0.0}
    try:
        post(port, {"prompt": "warm up", "max_tokens": 4,
                    "temperature": 0.0})            # set-up, not measured
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {k: getattr(eng, k) for k in (
            "total_dispatched_steps", "total_extend_prefills",
            "total_prefix_cached_tokens")}
        for k in kernels.values():
            k.launches = 0                           # the main path starts
        t0 = time.time()
        results = [post(port, first)]                # publishes the prefix
        t1 = time.time()
        out = [None] * len(bodies)

        def worker(i):
            out[i] = post(port, bodies[i])
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t2 = time.time()
        launches = {n: k.launches for n, k in kernels.items()}  # it ended
        check(all(r is not None for r in out), "a request did not return")
        results += out
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=60) as r:
            check(r.status == 200, f"/health status {r.status}")
            health = json.loads(r.read())
    finally:
        srv.stop()
    check(health["status"] == "healthy", f"/health: {health['status']}")
    st = health["engine"]
    eos = srv.tokenizer.eos_token_id
    for r in results:
        toks = r["choices"][0]["token_ids"]
        reason = r["choices"][0]["finish_reason"]
        check(all(0 <= t < cfg.vocab_size for t in toks), "token out of range")
        check(len(toks) == max_tokens or (reason == "stop"
                                          and toks[-1] == eos),
              f"request ended after {len(toks)} tokens ({reason})")
    check(st["nonfinite_logits"] == 0,
          f"{st['nonfinite_logits']} logits tensors held NaN/inf")
    steps = eng.total_dispatched_steps - before["total_dispatched_steps"]
    extends = eng.total_extend_prefills - before["total_extend_prefills"]
    cached = (eng.total_prefix_cached_tokens
              - before["total_prefix_cached_tokens"])
    check(extends >= 1 and cached >= 128,
          "the shared-prefix request did not hit the prefix cache")
    ttfts = sorted(r["metrics"]["ttft_ms"] for r in results)
    gen = sum(r["usage"]["completion_tokens"] for r in results)
    conc_tokens = sum(r["usage"]["completion_tokens"] for r in out)
    per_req = sorted(
        (r["usage"]["completion_tokens"] - 1)
        / ((r["metrics"]["latency_ms"] - r["metrics"]["ttft_ms"]) / 1e3)
        for r in results)
    return {
        "requests": len(results), "completion_tokens": gen,
        "ttft_p50_ms": ttfts[len(ttfts) // 2],
        "ttft_max_ms": ttfts[-1],
        "concurrent_phase_s": t2 - t1,
        "concurrent_tok_per_s": conc_tokens / (t2 - t1),
        "per_request_decode_tok_per_s_p50": per_req[len(per_req) // 2],
        "first_request_s": t1 - t0,
        "peak_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "decode_steps": steps,
        "extend_prefills": extends, "prefix_cached_tokens": cached,
        "engine": st,
        "shared_prefix_prompt_tokens": out[3]["usage"]["prompt_tokens"],
        "greedy": {"prompt": first["prompt"],
                   "tokens": results[0]["choices"][0]["token_ids"]},
    }


def traffic_line(res: dict) -> str:
    return (f"served {res['requests']} requests, "
            f"{res['completion_tokens']} tokens: TTFT p50 "
            f"{res['ttft_p50_ms']:.1f} ms (max {res['ttft_max_ms']:.1f}), "
            f"{res['concurrent_tok_per_s']:.1f} tok/s over the 7 concurrent "
            f"requests, per-request decode p50 "
            f"{res['per_request_decode_tok_per_s_p50']:.1f} tok/s, peak "
            f"max_memory_allocated {res['peak_memory_allocated_gb']:.2f} GB")


def serve_main_path(torch, mods, kernel, card: str) -> dict:
    cfg = mods["get_model_config"]("llama-8b-gqa")
    scfg = mods["ServeConfig"](model=cfg.name, host="127.0.0.1", port=0)
    t_init = time.time()
    srv = mods["InferenceServer"](cfg, scfg, seed=0)
    torch.cuda.synchronize()
    eng = srv.engine
    init_s = time.time() - t_init
    print(f"llama-8b-gqa: {cfg.num_layers} layers, H={cfg.hidden_size}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, D={cfg.head_dim}, "
          f"vocab {cfg.vocab_size}; {cfg.param_count / 1e9:.3f}B params "
          f"random-initialised in {init_s:.1f}s; KV pool "
          f"{eng.kv.num_pages} pages of {eng.kv.page_size}", flush=True)
    res = drive_traffic(torch, srv, cfg, {"paged_attention": kernel})
    launches = res["launches"] = res["launches"]["paged_attention"]
    steps, extends = res["decode_steps"], res["extend_prefills"]
    expected = cfg.num_layers * (steps + extends)
    print(f"kernel launches on the main path: {launches} = {cfg.num_layers} "
          f"layers x ({steps} decode steps + {extends} suffix prefills); "
          f"expected {expected}; prefix-cached tokens "
          f"{res['prefix_cached_tokens']}", flush=True)
    check(launches > 0, "the main path never launched the kernel")
    check(launches == expected, f"launches {launches} != {expected}")
    res["init_s"] = init_s
    print(f"{traffic_line(res)} [{card}]", flush=True)
    res["params"] = eng.params
    res["tokenizer"] = srv.tokenizer
    res["cfg"] = cfg
    eng.release()
    return res


# -- phase 6: paged decode against the dense forward ------------------------

def paged_against_dense(torch, mods, served: dict, steps: int = 16) -> dict:
    cfg, model = served["cfg"], served["params"]
    gpt = mods["gpt"]
    eng = mods["InferenceEngine"](
        cfg, mods["ServeConfig"](model=cfg.name, max_batch_size=1),
        params=model)
    prompt = served["tokenizer"].encode(served["greedy"]["prompt"])
    n = len(prompt)
    PS = eng.kv.page_size
    eng.kv.allocate(0, n + steps)
    bucket = eng._bucket(n)
    entries = [0] * (bucket // PS)
    used = eng.kv.pages_needed(n)
    entries[:used] = [int(p) for p in eng.kv.block_tables[0, :used]]
    tokens = np.zeros((1, bucket), np.int64)
    tokens[0, :n] = prompt
    logits = eng._prefill_dense(tokens, n, np.asarray(entries))
    tables = torch.from_numpy(eng.kv.block_tables[:1].copy()).cuda()
    # an fp32 copy of the same weights: the reference both bf16 paths are
    # measured against
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = gpt.GPT(cfg32, device="cuda", dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    ctx = list(prompt)
    worst, scale, agree, paged_tokens = 0.0, 0.0, 0, []
    err32 = {"paged_bf16": 0.0, "dense_bf16": 0.0}
    for step in range(steps + 1):
        toks = torch.tensor([ctx], device="cuda")
        dense = gpt.forward(model, toks, cfg)[:, -1]
        ref32 = gpt.forward(model32, toks, cfg32)[:, -1]
        err32["paged_bf16"] = max(err32["paged_bf16"],
                                  (logits - ref32).abs().max().item())
        err32["dense_bf16"] = max(err32["dense_bf16"],
                                  (dense - ref32).abs().max().item())
        check(bool(torch.isfinite(logits).all()), "non-finite paged logits")
        worst = max(worst, (logits - dense).abs().max().item())
        scale = max(scale, dense.abs().max().item())
        tok = int(logits.argmax(-1))
        agree += int(tok == int(dense.argmax(-1)))
        paged_tokens.append(tok)
        if step == steps:
            break
        ctx.append(tok)
        logits, _, _ = mods["decode_step_forward"](
            model, torch.tensor([tok], device="cuda"),
            torch.tensor([len(ctx) - 1], device="cuda"), eng.kv.k_pages,
            eng.kv.v_pages, tables, cfg)
    served_toks = served["greedy"]["tokens"]
    same_as_served = sum(a == b for a, b in zip(paged_tokens, served_toks))
    print(f"paged vs dense over {steps + 1} steps (prompt {n} tokens): max "
          f"|dlogit| {worst:.4f} ({worst / scale:.1%} of max |logit| "
          f"{scale:.3f}); greedy agreement {agree}/{steps + 1}; same tokens "
          f"as the served request: {same_as_served}/"
          f"{min(len(paged_tokens), len(served_toks))}; against the fp32 "
          f"dense reference: paged bf16 max |dlogit| "
          f"{err32['paged_bf16']:.4f}, dense bf16 {err32['dense_bf16']:.4f} "
          f"(limit {DENSE_ERR_FACTOR}x the dense error)", flush=True)
    check(err32["paged_bf16"] <= DENSE_ERR_FACTOR * err32["dense_bf16"],
          f"paged decode is {err32['paged_bf16']} from fp32, more than "
          f"{DENSE_ERR_FACTOR} x the dense path's {err32['dense_bf16']}")
    eng.release()
    del model32
    return {"max_abs_diff": worst, "max_abs_logit": scale,
            "fp32_reference_max_abs_diff": err32,
            "greedy_agreement": agree, "steps": steps + 1,
            "same_as_served": same_as_served}


# -- phase 7: the flash kernels against plain --------------------------------

TRAIN_MICRO_BATCH = 4          # sequences of 2048 per step (accumulation 1)

# (name, B, S, Nq, Nkv, D): gpt-1b at the training path's micro-batch, and
# llama-8b-gqa for the GQA fold
FLASH_GEOMS = (("gpt-1b", TRAIN_MICRO_BATCH, 2048, 16, 16, 128),
               ("llama-8b-gqa", 2, 1024, 32, 8, 128))
# fp32: out/lse absolute, gradients relative to their max; bf16: every
# output relative to its max (the kernels round p and ds to bf16 where the
# plain version does, so the rest is summation order), lse of live rows
# absolute (fp32 sums of exact bf16 products)
FLASH_TOL = {"float32": {"out": 1e-5, "lse": 1e-5, "grad": 1e-4},
             "bfloat16": {"out": 2e-2, "lse": 1e-4, "grad": 2e-2}}
# bf16 outputs are further held element by element to their own row's
# scale, because the tensor's max is set by a few early causal rows (a
# query over few keys keeps |v|) while most rows average over thousands of
# keys and are tens of times smaller: |kernel - plain| <= BF16_ULP * |plain| (one
# rounding of the bf16 output either way) + FLASH_ROW_TOL * the plain
# row's rms over D. A row far below the tensor's rms is a value left by
# cancellation (dq of a query that sees only its own key is
# p * (dp - delta) = 0 up to rounding), so its scale is floored at
# FLASH_ROW_FLOOR of the tensor's rms. The tensor's rms error over its rms,
# which a small bias spread over every element moves, stays under
# FLASH_RMS_TOL.
BF16_ULP = 2.0 ** -7
FLASH_ROW_TOL = 2.5e-2
FLASH_ROW_FLOOR = 0.1
FLASH_RMS_TOL = 5e-3
# the kernel that computes out, dq, dk and dv
FLASH_OUTPUTS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv")


def flash_inputs(torch, B, S, Nq, Nkv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(B, S, n, D, generator=g, device="cuda").to(dtype)
                 for n in (Nq, Nkv, Nkv, Nq))            # q, k, v, dO


def packed_rows(torch, B, S):
    """Three documents a row (segment ids 1..3) whose positions restart at
    0, and a padded tail (segment 0) on the last row."""
    cut = [0, S // 3, S // 3 + S // 4, S]
    segs = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    pos = torch.zeros(B, S, dtype=torch.int32, device="cuda")
    for i in range(3):
        segs[:, cut[i]:cut[i + 1]] = i + 1
        pos[:, cut[i]:cut[i + 1]] = torch.arange(
            cut[i + 1] - cut[i], dtype=torch.int32, device="cuda")
    segs[-1, -(S // 16):] = 0
    return segs, pos


class FlashErrors:
    """Compares kernel outputs with plain ones, fails past the tolerances,
    and keeps the worst absolute error per kernel and, for bf16, the worst
    row-scaled and rms errors."""

    def __init__(self):
        names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        self.worst = dict.fromkeys(names, 0.0)
        self.bf16_row = dict.fromkeys(names, 0.0)
        self.bf16_rms = dict.fromkeys(names, 0.0)

    def __call__(self, kernel, what, got, ref, dtype, label, name=None):
        """Checks one output; returns its line for the log."""
        name = name or what
        tol = FLASH_TOL[dtype]
        got, ref = got.float(), ref.float()
        if what == "lse":                 # empty rows: NEG_INF in both
            live = ref > -1e37
            check(bool((got[~live] == ref[~live]).all()),
                  f"{label}: lse of empty rows differs")
            got, ref = got[live], ref[live]
        diff = (got - ref).abs()
        err = diff.max().item()
        scale = 1.0
        if what == "grad" or (what == "out" and dtype == "bfloat16"):
            scale = max(ref.abs().max().item(), 1e-30)
        limit = tol[what] * scale
        self.worst[kernel] = max(self.worst[kernel], err)
        check(err <= limit, f"{label}: {kernel} {name} max_abs_err {err:.3e}"
              f" > {limit:.3e}")
        line = f"{name} {err:.2e} (tol {limit:.1e})"
        if dtype != "bfloat16" or what == "lse":
            return line
        row_err = row_scaled_error(diff, ref).max().item()
        rms_err = (diff.pow(2).mean().sqrt()
                   / ref.pow(2).mean().sqrt().clamp(min=1e-30)).item()
        self.bf16_row[kernel] = max(self.bf16_row[kernel], row_err)
        self.bf16_rms[kernel] = max(self.bf16_rms[kernel], rms_err)
        check(row_err <= FLASH_ROW_TOL,
              f"{label}: {kernel} {name} differs by {row_err:.3e} of its "
              f"row's rms past one bf16 rounding (> {FLASH_ROW_TOL:.1e})")
        check(rms_err <= FLASH_RMS_TOL,
              f"{label}: {kernel} {name} rms error {rms_err:.3e} of its rms "
              f"(> {FLASH_RMS_TOL:.0e})")
        return f"{line} row {row_err:.1e} rms {rms_err:.1e}"


def row_scaled_error(diff, ref, floor=FLASH_ROW_FLOOR):
    """Each element's error past one bf16 rounding of itself, in units of
    its row's rms over D (at least ``floor`` of the tensor's rms). A zero
    scale (a tensor of zeros) admits no error: inf where one is."""
    excess = (diff - BF16_ULP * ref.abs()).clamp(min=0.0)
    rms = ref.pow(2).mean().sqrt()
    row = ref.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=floor * rms)
    zero = row == 0
    return (excess / row.masked_fill(zero, 1.0)).masked_fill(
        zero & (excess > 0), float("inf"))


def flash_against_plain(torch, fa, fac) -> dict:
    errs = FlashErrors()
    kernels = (fac.flash_fwd, fac.flash_bwd_dq, fac.flash_bwd_dkv)
    for name, B, S, Nq, Nkv, D in FLASH_GEOMS:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).removeprefix("torch.")
            q, k, v, do = flash_inputs(torch, B, S, Nq, Nkv, D, dtype,
                                       seed=S + Nq)
            segs, pos = packed_rows(torch, B, S)
            # the public, differentiable entry point: causal, and packed
            # rows kept apart by their segment ids
            for kind, seg_arg in (("causal", None), ("packed", segs)):
                label = f"{name} {dt} {kind}"
                res = {}
                for impl in ("kernel", "plain"):
                    before = [kn.launches for kn in kernels]
                    qs, ks, vs = (t.clone().requires_grad_(True)
                                  for t in (q, k, v))
                    out = fa.flash_attention(qs, ks, vs, segment_ids=seg_arg,
                                             impl=impl)
                    out.backward(do)
                    torch.cuda.synchronize()
                    res[impl] = (out.detach(), qs.grad, ks.grad, vs.grad)
                    grew = [kn.launches - b for kn, b in zip(kernels, before)]
                    check(grew == ([1, 1, 1] if impl == "kernel"
                                   else [0, 0, 0]),
                          f"{label}: launches {grew} through impl={impl}")
                lines = [errs(kn, what, a, b, dt, label, name=nm)
                         for kn, what, nm, a, b in zip(
                             FLASH_OUTPUTS, ("out",) + ("grad",) * 3,
                             ("out", "dq", "dk", "dv"), res["kernel"],
                             res["plain"])]
                print(f"flash vs plain  {label:30s} " + "  ".join(lines),
                      flush=True)
            # the raw pair on the folded layout, positions restarting per
            # document (as ring attention drives it)
            label = f"{name} {dt} raw restart"
            qf, kf, vf, sq, pq, sk, pk, _ = fa.fold_gqa(q, k, v, segs, pos)
            dof = fa.fold_gqa(do, k, v, segs, pos)[0]
            scale = 1.0 / D ** 0.5
            ok, lk = fa._fwd(qf, kf, vf, sq, sk, pq, pk, True, 512, 512,
                             scale, impl="kernel")
            op, lp = fa._fwd(qf, kf, vf, sq, sk, pq, pk, True, 512, 512,
                             scale, impl="plain")
            if dtype == torch.bfloat16:     # one block a row: the same bits
                again = fa._fwd(qf, kf, vf, sq, sk, pq, pk, True, 512, 512,
                                scale, impl="kernel")
                same = [torch.equal(a, b) for a, b in zip((ok, lk), again)]
                check(all(same), f"{label}: a second kernel forward is not "
                      f"bitwise equal (out, lse: {same})")
                print(f"flash determinism {label}: out, lse of two kernel "
                      f"forward calls bitwise equal", flush=True)
                del again
            delta = (dof.float() * op.float()).sum(-1, keepdim=True)
            grads = [fa._bwd_impl(qf, kf, vf, sq, sk, pq, pk, dof, lp, delta,
                                  True, 512, 512, scale, impl=impl)
                     for impl in ("kernel", "plain")]
            if dtype == torch.bfloat16:     # no atomics: the same bits again
                again = fa._bwd_impl(qf, kf, vf, sq, sk, pq, pk, dof, lp,
                                     delta, True, 512, 512, scale,
                                     impl="kernel")
                same = [torch.equal(a, b) for a, b in zip(grads[0], again)]
                check(all(same), f"{label}: a second kernel backward is not "
                      f"bitwise equal (dq, dk, dv: {same})")
                print(f"flash determinism {label}: dq, dk, dv of two kernel "
                      f"calls bitwise equal", flush=True)
                del again
            torch.cuda.synchronize()
            lines = [errs("flash_fwd", "out", ok, op, dt, label),
                     errs("flash_fwd", "lse", lk, lp, dt, label)]
            lines += [errs(kn, "grad", a, b, dt, label, name=nm)
                      for kn, nm, a, b in zip(FLASH_OUTPUTS[1:],
                                              ("dq", "dk", "dv"), grads[0],
                                              grads[1])]
            print(f"flash vs plain  {label:30s} " + "  ".join(lines),
                  flush=True)
            del q, k, v, do, qf, kf, vf, dof, grads
            torch.cuda.empty_cache()
    for kn in errs.worst:
        print(f"flash bf16 worst {kn}: {errs.bf16_row[kn]:.2e} of a row's "
              f"rms past one rounding (tol {FLASH_ROW_TOL:.1e}), rms error "
              f"{errs.bf16_rms[kn]:.2e} (tol {FLASH_RMS_TOL:.0e})",
              flush=True)
    return {"max_abs_err": errs.worst, "bf16_row_err": errs.bf16_row,
            "bf16_rms_err": errs.bf16_rms}


# -- phase 8: the AdamW kernel against plain ---------------------------------

GPT1B_LEAVES = ((2048, 2048), (2048, 5632), (5632, 2048), (50304, 2048),
                (2048, 50304))


def adamw_against_plain(torch, fu, kernel) -> float:
    count = torch.tensor(6, dtype=torch.int32, device="cuda")
    lr = torch.tensor(3e-4, device="cuda")
    clip = torch.tensor(0.37, device="cuda")           # a clipping step
    f32, bf16 = torch.float32, torch.bfloat16
    cases, worst = 0, 0.0
    for i, shape in enumerate(GPT1B_LEAVES):
        for mdt, ndt in ((f32, f32), (bf16, f32), (bf16, bf16)):
            for wd in (0.0, 0.1):
                g = torch.Generator(device="cuda").manual_seed(i)
                p = torch.randn(shape, generator=g, device="cuda")
                grad = torch.randn(shape, generator=g, device="cuda") * 1e-2
                mu = (torch.randn(shape, generator=g, device="cuda")
                      * 1e-3).to(mdt)
                nu = (torch.rand(shape, generator=g, device="cuda")
                      * 1e-5).to(ndt)
                kp, kmu, knu = p.clone(), mu.clone(), nu.clone()
                kw = dict(lr=lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd,
                          decay_mask=[True], clip_scale=clip)
                before = kernel.launches
                fu.fused_adamw_apply([kp], [grad], [kmu], [knu], count, **kw)
                torch.cuda.synchronize()
                check(kernel.launches == before + 1,
                      f"adamw {shape}: the leaf did not reach the kernel")
                fu.fused_adamw_apply([p], [grad], [mu], [nu], count,
                                     use_kernel=False, **kw)
                same = (torch.equal(kp, p), torch.equal(kmu, mu),
                        torch.equal(knu, nu))
                worst = max([worst] + [(a.float() - b.float()).abs().max()
                                       .item() for a, b in ((kp, p),
                                                            (kmu, mu),
                                                            (knu, nu))])
                check(all(same), f"adamw {shape} mu {mdt} nu {ndt} wd {wd}: "
                      f"p/mu/nu bitwise equal {same}")
                cases += 1
        print(f"adamw vs plain  leaf {shape}: p, mu, nu bitwise equal "
              f"(fp32/fp32, bf16/fp32, bf16/bf16 moments; wd 0 and 0.1; "
              f"clip 0.37)", flush=True)
    print(f"adamw: {cases} cases bitwise equal (max |kernel - plain| over "
          f"p, mu, nu: {worst})", flush=True)

    # every leaf shape in every dtype pair, in one multi-leaf call
    from distributed_llm_training_and_inference_system_tpu_torch.ops.\
        adamw_cuda import adamw_multi_kernel
    scalars = fu.adam_scalars(count, lr, 0.9, 0.95, clip)
    s = scalars.unbind()
    leaves, wds = [], []
    for mdt, ndt in ((f32, f32), (bf16, f32), (bf16, bf16)):
        for i, shape in enumerate(GPT1B_LEAVES):
            g = torch.Generator(device="cuda").manual_seed(50 + len(leaves))
            leaves.append((
                torch.randn(shape, generator=g, device="cuda"),
                torch.randn(shape, generator=g, device="cuda") * 1e-2,
                (torch.randn(shape, generator=g, device="cuda")
                 * 1e-3).to(mdt),
                (torch.rand(shape, generator=g, device="cuda")
                 * 1e-5).to(ndt)))
            wds.append(0.1 * (i % 2))
    ref = [fu._leaf_math(p, g, m, v, *s, b1=0.9, b2=0.95, eps=1e-8, wd=wd,
                         mu_dtype=m.dtype, nu_dtype=v.dtype)
           for (p, g, m, v), wd in zip(leaves, wds)]
    before = (kernel.launches, kernel.leaves)
    n = adamw_multi_kernel(*zip(*leaves), scalars, b1=0.9, b2=0.95,
                           eps=1e-8, wds=wds)
    torch.cuda.synchronize()
    grew = (kernel.launches - before[0], kernel.leaves - before[1])
    check(n == 3 and grew == (3, len(leaves)),
          f"adamw multi-leaf call: {n} launches, counters grew {grew}")
    for (p, _, m, v), (rp, rm, rv) in zip(leaves, ref):
        same = (torch.equal(p, rp), torch.equal(m, rm), torch.equal(v, rv))
        check(all(same), f"adamw multi-leaf {tuple(p.shape)} mu {m.dtype} "
              f"nu {v.dtype}: p/mu/nu bitwise equal {same}")
    print(f"adamw: {len(leaves)} leaves (every gpt-1b shape in 3 dtype "
          f"pairs, decay alternating) in one multi-leaf call: {n} launches, "
          f"bitwise equal to plain", flush=True)
    return worst


# -- phase 9: kernel timing ----------------------------------------------------

def flash_timing(torch, F, fa, fac, cfg, B: int, build_log: str = "") -> dict:
    """The three flash kernels at the training shape (B x 2048, bf16,
    causal), beside their plain versions, SDPA and their bounds; the
    ptxas figures of the bf16 flash kernels from ``build_log``."""
    from distributed_llm_training_and_inference_system_tpu_torch import (
        profile_flash as pf)
    S, Nq, Nkv, D = 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v, do = flash_inputs(torch, B, S, Nq, Nkv, D, torch.bfloat16, 11)
    segs = torch.ones(B, S, dtype=torch.int32, device="cuda")
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    qf, kf, vf, sq, pq, sk, pk, _ = fa.fold_gqa(q, k, v, segs, pos)
    dof = fa.fold_gqa(do, k, v, segs, pos)[0]
    scale = 1.0 / D ** 0.5
    out, lse = fa._fwd(qf, kf, vf, sq, sk, pq, pk, True, 512, 512, scale,
                       impl="kernel")
    delta = (dof.float() * out.float()).sum(-1, keepdim=True)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    fwd_args = (qf, kf, vf, sq, sk, pq, pk, True, scale)
    bwd_args = (qf, kf, vf, sq, sk, pq, pk, dof, lse, delta, True, scale)
    saved = [kn.launches for kn in (fac.flash_fwd, fac.flash_bwd_dq,
                                    fac.flash_bwd_dkv)]
    t = {
        "flash_fwd": time_ms(torch, lambda: fac.flash_fwd(*fwd_args),
                             flush=flush),
        "flash_bwd_dq": time_ms(torch, lambda: fac.flash_bwd_dq(*bwd_args),
                                flush=flush),
        "flash_bwd_dkv": time_ms(torch, lambda: fac.flash_bwd_dkv(*bwd_args),
                                 flush=flush),
    }
    for kn, n in zip((fac.flash_fwd, fac.flash_bwd_dq, fac.flash_bwd_dkv),
                     saved):
        kn.launches = n             # timing launches are not the main path
    plain = {
        "flash_fwd": time_ms(torch, lambda: fa._fwd_plain(*fwd_args),
                             iters=10, flush=flush),
        "flash_bwd_dq": time_ms(torch, lambda: fa._bwd_dq_plain(*bwd_args),
                                iters=10, flush=flush),
        "flash_bwd_dkv": time_ms(torch, lambda: fa._bwd_dkv_plain(*bwd_args),
                                 iters=10, flush=flush),
    }
    plain_bwd = time_ms(torch, lambda: fa._bwd_plain(*bwd_args), iters=10,
                        flush=flush)
    # library yardstick: SDPA (flash backend) on [B, N, S, D]
    ql, kl, vl, dol = (t_.transpose(1, 2).contiguous()
                       for t_ in (q, k, v, do))
    gqa = dict(enable_gqa=True) if Nq != Nkv else {}
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True, **gqa), flush=flush)
    qr, kr, vr = (t_.detach().requires_grad_(True) for t_ in (ql, kl, vl))
    lib_out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                             **gqa)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), dol, retain_graph=True), flush=flush)
    ref = fa.flash_attention(q, k, v)              # the kernel, unfolded
    lib_err = (lib_out.detach().transpose(1, 2).float()
               - ref.float()).abs().max().item()
    fac.flash_fwd.launches = saved[0]

    # the bound: causal pairs of this run (every row attends row + 1 keys),
    # counted by profile_flash, which times the kernels alone
    work = {name: (w["ops"], w["bytes"]) for name, w in dict(
        flash_fwd=pf.fwd_work(B, S, Nq, Nkv, D),
        **pf.bwd_work(B, S, Nq, Nkv, D)).items()}
    res = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS["bfloat16"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": t[name], "plain_ms": plain[name],
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "library_ms": None, "ops": ops,
                     "bytes": nbytes}
    res["flash_fwd"]["library_ms"] = lib_fwd
    res["backward"] = {"kernels_ms": t["flash_bwd_dq"] + t["flash_bwd_dkv"],
                       "plain_ms": plain_bwd, "library_ms": lib_bwd,
                       "bound_ms": res["flash_bwd_dq"]["bound_ms"]
                       + res["flash_bwd_dkv"]["bound_ms"]}
    res["shape"] = {"B": B, "S": S, "Nq": Nq, "Nkv": Nkv, "D": D,
                    "dtype": "bfloat16", "causal": True}
    res["library_vs_kernel_max_abs_err"] = lib_err
    for name in work:
        r = res[name]
        lib = ("none alone" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"{name} (B={B}, S={S}, {Nq}/{Nkv} heads, D={D}, bf16): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) -> "
              f"{r['bound_ms'] / r['ms']:.1%} of bound, "
              f"{r['ops'] / r['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    b = res["backward"]
    print(f"flash backward (dq + dkv kernels) {b['kernels_ms']:.4f} ms, plain "
          f"{b['plain_ms']:.4f} ms, SDPA backward {b['library_ms']:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms; SDPA forward vs kernel max_abs_err "
          f"{lib_err:.3e}", flush=True)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        r = res[name]
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        print(f"{name}: {r['share_of_bound']:.1%} of its bound "
              f"({r['bound_ms']:.4f} / {r['ms']:.4f} ms)", flush=True)
    f = res["flash_fwd"]
    f["over_library"] = f["ms"] / f["library_ms"]
    print(f"flash forward / SDPA forward: {f['over_library']:.2f}x "
          f"(printed, not gated)", flush=True)
    b["over_library"] = b["kernels_ms"] / b["library_ms"]
    print(f"flash backward pair / SDPA backward: {b['over_library']:.2f}x "
          f"(printed, not gated)", flush=True)
    figs = {**pf.fwd_ptxas(build_log, S), **pf.bwd_ptxas(build_log, S)}
    for name, f in figs.items():
        print(f"ptxas {name}: {f.get('registers')} registers, spill "
              f"stores/loads {f.get('spill_stores')}/{f.get('spill_loads')} "
              f"B, {f['smem_bytes']} B shared a block at S={S}, "
              f"{f['resident_blocks']} blocks an SM", flush=True)
    if not figs:
        print("ptxas: the build log holds no bf16 flash figures (the "
              "library was built before this run)", flush=True)
    res["ptxas"] = figs
    return res


def adamw_timing(torch, gpt, fu, kernel, cfg, build_log: str = "") -> dict:
    """One update of every kernel-eligible gpt-1b leaf (fp32 p, g, mu, nu):
    the kernel path, the plain path, torch._fused_adamw_ and the bound;
    launches a call, share of the bound, ratio to the library call and
    the kernel's ptxas figures (from ``build_log``), printed."""
    from distributed_llm_training_and_inference_system_tpu_torch import (
        profile_norm_adamw as pn)
    meta = gpt.GPT(cfg, device="meta")
    shapes = [tuple(p.shape) for p in meta.parameters()
              if p.dim() >= 2 and p.numel() >= fu.KERNEL_MIN_ELEMENTS]
    g = torch.Generator(device="cuda").manual_seed(21)
    P = [torch.randn(s, generator=g, device="cuda") for s in shapes]
    G = [torch.randn(s, generator=g, device="cuda") * 1e-2 for s in shapes]
    M = [torch.randn(s, generator=g, device="cuda") * 1e-3 for s in shapes]
    V = [torch.rand(s, generator=g, device="cuda") * 1e-5 for s in shapes]
    count = torch.tensor(6, dtype=torch.int32, device="cuda")
    lr = torch.tensor(3e-4, device="cuda")
    clip = torch.tensor(0.37, device="cuda")
    kw = dict(lr=lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              decay_mask=[True] * len(shapes), clip_scale=clip)
    saved = (kernel.launches, kernel.leaves)
    fu.fused_adamw_apply(P, G, M, V, count, **kw)
    launches = kernel.launches - saved[0]
    k_ms = time_ms(torch, lambda: fu.fused_adamw_apply(P, G, M, V, count,
                                                       **kw), iters=10,
                   warmup=2)
    kernel.launches, kernel.leaves = saved
    p_ms = time_ms(torch, lambda: fu.fused_adamw_apply(
        P, G, M, V, count, use_kernel=False, **kw), iters=5, warmup=1)
    steps = [torch.full((), 6.0, device="cuda") for _ in shapes]
    inv_clip = (1.0 / clip).reshape(1)

    def lib():
        torch._fused_adamw_(P, G, M, V, [], steps, lr=3e-4, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False,
                            grad_scale=inv_clip, found_inf=None)
    l_ms = time_ms(torch, lib, iters=10, warmup=2)
    n = sum(p.numel() for p in P)
    # read p, g, mu, nu; write p, mu, nu (28 B a param); ~20 fp32 ops
    work = pn.adamw_work(n)
    res = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
           "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
           "leaves": len(shapes), "params": n, "bytes": work["bytes"],
           "launches_a_call": launches,
           "share_of_bound": work["bound_ms"] / k_ms,
           "over_library": k_ms / l_ms,
           "ptxas": pn.kernel_ptxas(build_log)}
    print(f"adamw over {len(shapes)} gpt-1b leaves ({n} params, fp32 "
          f"moments): kernel {k_ms:.3f} ms ({launches} launch(es) a call), "
          f"plain {p_ms:.3f} ms, torch._fused_adamw_ {l_ms:.3f} ms, bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']}, {work['bytes']} B) "
          f"-> {res['share_of_bound']:.1%} of bound, "
          f"{res['over_library']:.2f}x torch._fused_adamw_ (printed, not "
          f"gated)", flush=True)
    for name, f in res["ptxas"].items():
        print(f"ptxas {name}: {f.get('registers')} registers, spill "
              f"stores/loads {f.get('spill_stores')}/{f.get('spill_loads')} "
              f"B", flush=True)
    if not res["ptxas"]:
        print("ptxas: the build log holds no AdamW figures (the library was "
              "built before this run)", flush=True)
    del P, G, M, V
    torch.cuda.empty_cache()
    return res


# -- phase 10: train gpt-1b at full width and depth ---------------------------

TRAIN_STEPS = 8
# the step with the earlier backward kernels (scalar B fragments,
# synchronous tile loads; profile_train.py, H100 80GB HBM3 at 700 W,
# micro-batch 4)
EARLIER_STEP_MS, EARLIER_MFU = 441.1, 0.173
STEP_AGREEMENT = 1e-2          # kernels vs plain step, relative (bf16)


def train_cfg(mods, ckdir: str, **training):
    return mods["load_run_config"](cli_overrides={
        "model": {"name": "gpt-1b"},
        "parallel": {"global_batch_size": TRAIN_MICRO_BATCH,
                     "activation_checkpoint": "selective"},
        "data": {"train": "synthetic", "val": "synthetic",
                 "max_length": 2048},
        # the default AdamW; a warmup of 2 steps (not 100), so that 8 steps
        # show the synthetic stream being learnt
        "optimizer": {"scheduler": {"warmup_steps": 2}},
        "checkpoint": {"path": ckdir, "interval_steps": 10 ** 9},
        "training": {"max_steps": TRAIN_STEPS, "log_interval": 1,
                     "eval_interval": 10 ** 9, **training}}, environ={})


def checksum(torch, state) -> list[float]:
    opt = state.opt_state
    return [float(t.detach().double().sum()) for t in (
        state.model.lm_head, state.model.blocks[-1].down, opt.mu[-1],
        opt.nu[0])]


def train_main_path(torch, mods, kernels: dict, card: str) -> dict:
    import gc
    import shutil
    import tempfile
    with tempfile.TemporaryDirectory(prefix="llmctl-smoke-") as ckdir:
        print(f"checkpoints to {ckdir} "
              f"({shutil.disk_usage(ckdir).free / 1e9:.1f} GB free)",
              flush=True)
        cfg = train_cfg(mods, ckdir)
        log: list[dict] = []

        def observer(event, payload):
            if event == "train_step":
                log.append(dict(payload))
        eng = mods["TrainingEngine"](cfg, observer=observer)
        check(eng.attn_impl == "flash", f"attn_impl {eng.attn_impl}")
        mc = cfg.model
        eng.initialize(resume=False)
        model = eng.state.model
        eligible = [i for i, p in enumerate(model.parameters())
                    if p.dim() >= 2
                    and p.numel() >= mods["KERNEL_MIN_ELEMENTS"]]
        mu = eng.state.opt_state.mu
        nu = eng.state.opt_state.nu
        plan = mods["adamw_plan"]([(mu[i].numel(), mu[i].dtype, nu[i].dtype)
                                   for i in eligible])
        print(f"gpt-1b: {mc.num_layers} layers, H={mc.hidden_size}, "
              f"{mc.num_heads}/{mc.num_kv_heads} heads, D={mc.head_dim}, "
              f"F={mc.ffn_size}, vocab {mc.vocab_size}, tied "
              f"{mc.tie_word_embeddings}; "
              f"{sum(p.numel() for p in model.parameters()) / 1e9:.4f}B "
              f"params; micro-batch {TRAIN_MICRO_BATCH} x "
              f"{cfg.data.max_length}; {len(eligible)} kernel-eligible "
              f"leaves in {len(plan)} planned AdamW launch(es) a step",
              flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kn in kernels.values():
            kn.launches = 0                      # the main path starts
        kernels["adamw"].leaves = 0
        t0 = time.time()
        final = eng.train(resume=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: kn.launches for name, kn in kernels.items()}
        adamw_leaves = kernels["adamw"].leaves
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [m["loss"] for m in log]
        check(len(losses) == TRAIN_STEPS, f"{len(losses)} logged steps")
        check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        expected = {"flash_fwd": 2 * mc.num_layers * TRAIN_STEPS,
                    "flash_bwd_dq": mc.num_layers * TRAIN_STEPS,
                    "flash_bwd_dkv": mc.num_layers * TRAIN_STEPS,
                    "adamw": len(plan) * TRAIN_STEPS}
        print(f"kernel launches on the training path: {launches}; expected "
              f"{expected} (per step: flash fwd 2 x {mc.num_layers} layers "
              f"under selective remat, dq and dkv {mc.num_layers}, adamw "
              f"{len(plan)} planned launch(es)); adamw updated "
              f"{adamw_leaves} leaves, expected {len(eligible)} x "
              f"{TRAIN_STEPS} = {len(eligible) * TRAIN_STEPS}", flush=True)
        for name, n in expected.items():
            check(launches[name] == n, f"{name} launches {launches[name]} "
                  f"!= {n}")
        check(adamw_leaves == len(eligible) * TRAIN_STEPS,
              f"adamw leaves {adamw_leaves} != {len(eligible)} x "
              f"{TRAIN_STEPS}")
        rates = sorted(m["tokens_per_sec"] for m in log[1:])
        tok_s = rates[len(rates) // 2]
        mfu = tok_s * mods["flops_per_token"](mc, cfg.data.max_length) \
            / (cfg.hardware.peak_bf16_tflops * 1e12)
        step_s = TRAIN_MICRO_BATCH * cfg.data.max_length / tok_s
        print(f"trained {TRAIN_STEPS} steps in {wall:.1f}s (save included): "
              f"loss {' '.join(f'{x:.4f}' for x in losses)}; grad_norm "
              f"{log[0]['grad_norm']:.3f} -> {log[-1]['grad_norm']:.3f}; "
              f"median over steps 2..{TRAIN_STEPS}: {step_s * 1e3:.1f} ms "
              f"per step, {tok_s:.0f} tok/s, MFU {mfu:.1%} of "
              f"{cfg.hardware.peak_bf16_tflops:.0f} TF/s; peak "
              f"max_memory_allocated {peak:.2f} GB [{card}]", flush=True)
        print(f"step {step_s * 1e3:.1f} ms, MFU {mfu:.1%} [{card}]; the "
              f"earlier backward kernels gave {EARLIER_STEP_MS} ms, MFU "
              f"{EARLIER_MFU:.1%} (profile_train.py, micro-batch "
              f"{TRAIN_MICRO_BATCH}, another run, maybe on another card)",
              flush=True)
        trained = checksum(torch, eng.state)
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()

        # from the saved state: one step through the kernels, one through
        # the plain versions; restore puts back step, data cursor, state
        step_res = {}
        for label, attn, fused in (("kernels", "flash", True),
                                   ("plain", "xla", False)):
            c = train_cfg(mods, ckdir, attn_impl=attn)
            c.optimizer.fused = fused
            e = mods["TrainingEngine"](c)
            start = e.initialize(resume=True)
            check(start == TRAIN_STEPS and e.state.step == TRAIN_STEPS
                  and e.train_data.state_dict()["step"] == TRAIN_STEPS,
                  f"resume: start {start}, step {e.state.step}, data "
                  f"{e.train_data.state_dict()}")
            check(checksum(torch, e.state) == trained,
                  "restored state differs from the trained one")
            before = {name: kn.launches for name, kn in kernels.items()}
            batch = e._device_batch(next(e.train_data))
            _, m = e.train_step(e.state, batch)
            step_res[label] = (float(m["loss"]), float(m["grad_norm"]))
            grew = {name: kn.launches - before[name]
                    for name, kn in kernels.items()}
            check(all((n > 0) == fused for n in grew.values()),
                  f"{label} step launched {grew}")
            del e, batch
            gc.collect()
            torch.cuda.empty_cache()
        (lk, gk), (lp, gp) = step_res["kernels"], step_res["plain"]
        d_loss, d_gn = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
        print(f"resumed at step {TRAIN_STEPS} (data cursor "
              f"{TRAIN_STEPS}, state checksums equal); step "
              f"{TRAIN_STEPS + 1} kernels vs plain: loss {lk:.5f} vs "
              f"{lp:.5f} (rel {d_loss:.2e}), grad_norm {gk:.4f} vs {gp:.4f} "
              f"(rel {d_gn:.2e}), limit {STEP_AGREEMENT:.0e}", flush=True)
        check(d_loss <= STEP_AGREEMENT and d_gn <= STEP_AGREEMENT,
              "kernel and plain steps disagree")
    return {"launches": launches, "expected": expected,
            "adamw_leaves": adamw_leaves, "losses": losses,
            "steps": log, "tokens_per_sec": tok_s, "mfu": mfu,
            "step_ms": step_s * 1e3, "wall_s": wall,
            "peak_memory_allocated_gb": peak, "final": final,
            "micro_batch": TRAIN_MICRO_BATCH, "kernel_vs_plain_step":
            {"kernels": step_res["kernels"], "plain": step_res["plain"]}}



# -- phase 11: the quantized-serving kernels against plain --------------------

# [in, out] of llama-8b-gqa's projections: q/o, k/v, gate/up, down
LLAMA_PROJECTIONS = ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096))
MATMUL_ROWS = (1, 8, 64)
# a matmul kernel and its plain version sum the same products in another
# order: a bf16 output may differ by one rounding of itself (BF16_ULP) plus
# this share of its row's rms; an fp32 output by MATMUL_F32_TOL of it
MATMUL_ROW_TOL = 1e-2
MATMUL_F32_TOL = 1e-4
RMSNORM_SHAPES = ((8, 4096), (4096, 4096), (1, 1024, 2048))
ENTRY_NORM_SHAPE = (1, 1024, 2048)      # what entry() gives the norm


def quantize_pages(qm, kind: str, pages):
    tq, pa = qm["tq"], qm["pa"]
    if kind == "int8":
        return pa.QuantPages(*tq.quantize_int8_rows(pages))
    qv, sc = tq.quantize_int4_rows(pages)
    return pa.Int4Pages(tq.pack_int4_rows(qv, axis=-2), sc)


def w8_case(torch, tq, rows, n_in, n_out, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02
    x = torch.randn(rows, n_in, generator=g, device="cuda").to(dtype)
    values, scale = tq.quantize_int8(w)
    return x, values, scale


def w4_case(torch, tq, rows, n_in, n_out, dtype, seed, group=128):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02
    x = torch.randn(rows, n_in, generator=g, device="cuda").to(dtype)
    act = torch.rand(n_in, generator=g, device="cuda") + 0.25
    packed, scale, chan = tq.quantize_int4_groupwise(w, group, act_scale=act)
    check(bool((chan != 1).any()), "the channel scales are all ones")
    return x, packed, scale, chan


def matmul_error(torch, out, ref, dtype, label) -> float:
    """Holds a matmul kernel's output to its plain version's, row by row;
    returns the largest absolute difference."""
    check(out.dtype == ref.dtype and out.shape == ref.shape,
          f"{label}: {out.dtype} {tuple(out.shape)} against {ref.dtype} "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite")
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        worst = row_scaled_error(diff, ref.float()).max().item()
        limit = MATMUL_ROW_TOL
    else:
        rms = ref.float().pow(2).mean(-1, keepdim=True).sqrt()
        worst = (diff / rms.clamp(min=1e-30)).max().item()
        limit = MATMUL_F32_TOL
    check(worst <= limit, f"{label}: {worst:.3e} of the row's rms > "
          f"{limit:.0e}")
    return diff.max().item()


def matmul_kernels_against_plain(torch, qm, projections,
                                 row_counts=MATMUL_ROWS) -> dict:
    """The W8 (whole-K and k-split) and W4 kernels against their plain
    versions at every [in, out] of ``projections`` and row count of
    ``row_counts``, bf16 and fp32; W8 through ``matmul_w8`` takes JAX's
    route. Returns the largest difference of each kernel."""
    w8, w4, tq, kn = qm["w8"], qm["w4"], qm["tq"], qm["kernels"]
    worst = dict.fromkeys(("int8_matmul", "int8_matmul_ksplit",
                           "int4_matmul"), 0.0)
    for n_in, n_out in projections:
        route = w8.w8_route(n_in, n_out)
        errs = dict.fromkeys(("int8_matmul", "int8_matmul_ksplit",
                              "int4_matmul"), 0.0)
        for rows in row_counts:
            for dtype in (torch.bfloat16, torch.float32):
                dt = str(dtype).removeprefix("torch.")
                label = f"[{rows}x{n_in}] x [{n_in}x{n_out}] {dt}"
                x, values, scale = w8_case(torch, tq, rows, n_in, n_out,
                                           dtype, seed=rows + n_out)
                ref = w8.matmul_w8_plain(x, values, scale)
                outs = {}
                for name in ("int8_matmul", "int8_matmul_ksplit"):
                    before = kn[name].launches
                    out = kn[name](x, values, scale)
                    torch.cuda.synchronize()
                    check(kn[name].launches == before + 1,
                          f"{name} {label}: launch not counted")
                    errs[name] = max(errs[name], matmul_error(
                        torch, out, ref, dtype, f"{name} {label}"))
                    again = kn[name](x, values, scale)
                    check(torch.equal(again, out),
                          f"{name} {label}: two calls differ in bits")
                    outs[name] = out
                before = [kn[n].launches for n in ("int8_matmul",
                                                   "int8_matmul_ksplit")]
                routed = w8.matmul_w8(x, values, scale)
                grew = [kn[n].launches - b for n, b in zip(
                    ("int8_matmul", "int8_matmul_ksplit"), before)]
                check(grew == ([0, 1] if route == "ksplit" else [1, 0]),
                      f"matmul_w8 {label}: launches {grew} on route {route}")
                check(torch.equal(routed, outs["int8_matmul_ksplit"
                                               if route == "ksplit"
                                               else "int8_matmul"]),
                      f"matmul_w8 {label}: the routed result differs")
                x, packed, s4, chan = w4_case(torch, tq, rows, n_in, n_out,
                                              dtype, seed=rows + n_in)
                ref = w4.matmul_w4_plain(x, packed, s4, chan, 128)
                before = kn["int4_matmul"].launches
                out = w4.matmul_w4(x, packed, s4, chan, 128)
                torch.cuda.synchronize()
                check(kn["int4_matmul"].launches == before + 1,
                      f"int4_matmul {label}: launch not counted")
                errs["int4_matmul"] = max(errs["int4_matmul"], matmul_error(
                    torch, out, ref, dtype, f"int4_matmul {label}"))
                del x, values, scale, packed, s4, chan, ref, out
        print(f"matmul kernels vs plain  in={n_in:<6d} out={n_out:<6d} rows "
              f"{row_counts} bf16+fp32 (JAX route {route}): max_abs_err "
              + "  ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f"; row limits bf16 {MATMUL_ROW_TOL:.0e} past one rounding, "
              f"fp32 {MATMUL_F32_TOL:.0e}; W8 bits repeat", flush=True)
        for n, e in errs.items():
            worst[n] = max(worst[n], e)
        torch.cuda.empty_cache()
    return worst


def quant_kernels_against_plain(torch, qm) -> dict:
    pa, kn = qm["pa"], qm["kernels"]
    worst = dict.fromkeys(("paged_attention_int8", "paged_attention_int4",
                           "int8_matmul", "int8_matmul_ksplit",
                           "int4_matmul", "rmsnorm"), 0.0)
    # 1b: phase 3's geometry over quantized pages
    for kind in ("int8", "int4"):
        name = f"paged_attention_{kind}"
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).removeprefix("torch.")
            for T in PAGED_WINDOWS:
                q, kp, vp, tables, starts, _ = paged_case(
                    torch, T, torch.float32, seed=T)
                q = q.to(dtype)
                kq = quantize_pages(qm, kind, kp)
                vq = quantize_pages(qm, kind, vp)
                before = kn[name].launches
                out = pa.paged_attention_multi(q, kq, vq, tables, starts)
                torch.cuda.synchronize()
                check(kn[name].launches == before + 1,
                      f"{name}: a CUDA tensor did not go through the kernel")
                ref = pa.paged_attention_multi(q, kq, vq, tables, starts,
                                               impl="gather")
                check(bool(torch.isfinite(out.float()).all()),
                      f"{name}: non-finite output ({dt}, T={T})")
                err = (out.float() - ref.float()).abs().max().item()
                line = (f"{name} vs plain  {dt:8s} T={T:<4d} "
                        f"max_abs_err={err:.3e}  tol={TOL[dt]:.0e}")
                check(err <= TOL[dt], f"{name} disagrees with plain ({dt}, "
                      f"T={T}): {err} > {TOL[dt]}")
                if dtype == torch.bfloat16:
                    # the gather version rounds the dequantized pages and
                    # the probabilities to bf16, the kernel keeps both in
                    # fp32 (as the TPU kernel does); the row-scaled limits
                    # hold the kernel to the gather version over the pages
                    # dequantized in fp32, which repeats its arithmetic
                    exact = pa.paged_attention_multi(
                        q, kq.dequant(torch.float32),
                        vq.dequant(torch.float32), tables, starts,
                        impl="gather").float()
                    diff = (out.float() - exact).abs()
                    row = row_scaled_error(diff, exact).max().item()
                    rms = (diff.pow(2).mean().sqrt()
                           / exact.pow(2).mean().sqrt()).item()
                    line += (f"  row {row:.1e} (tol {FLASH_ROW_TOL:.1e})  "
                             f"rms {rms:.1e} (tol {FLASH_RMS_TOL:.0e})")
                    check(row <= FLASH_ROW_TOL and rms <= FLASH_RMS_TOL,
                          f"{name} ({dt}, T={T}): row error {row:.3e}, rms "
                          f"error {rms:.3e}")
                print(line, flush=True)
                worst[name] = max(worst[name], err)
    # rows 7-9 at every projection shape
    for n, e in matmul_kernels_against_plain(torch, qm,
                                             LLAMA_PROJECTIONS).items():
        worst[n] = e
    # row 5
    layers, rn = qm["layers"], qm["rn"]
    for shape in RMSNORM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype).removeprefix("torch.")
            g = torch.Generator(device="cuda").manual_seed(shape[-1])
            x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
            sc = (torch.randn(shape[-1], generator=g, device="cuda")
                  * 0.1).to(dtype)
            before = rn.rmsnorm_kernel.launches
            out = layers.rms_norm(x, sc, 1e-5, impl="cuda")
            torch.cuda.synchronize()
            check(rn.rmsnorm_kernel.launches == before + 1,
                  f"rmsnorm {shape}: launch not counted")
            ref = layers.rms_norm(x, sc, 1e-5)
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            # fp32: the order of the sum of squares; bf16: one rounding of
            # the output either way
            if dtype == torch.float32:
                ok, lim = err <= 2e-5, "2e-5"
            else:
                ok = bool((diff <= BF16_ULP * ref.float().abs() + 1e-30)
                          .all())
                lim = "one bf16 rounding"
            print(f"rmsnorm vs plain  {str(shape):16s} {dt:8s} "
                  f"max_abs_err={err:.3e}  tol {lim}", flush=True)
            check(ok, f"rmsnorm {shape} {dt}: {err} past {lim}")
            worst["rmsnorm"] = max(worst["rmsnorm"], err)
    return worst


# -- phase 12: timing of the quantized-serving kernels ------------------------

def bound_record(k_ms, p_ms, l_ms, nbytes, ops, peak) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def quant_kernel_timing(torch, F, qm, build_log: str = "",
                        paged_log: str = "", w8_log: str = "",
                        norm_log: str = "") -> dict:
    """The quantized-serving kernels' times beside plain, library and
    bound; the W4 and W8 kernels' shares of their bounds, their ratios to
    x @ w_bf16 and ptxas's figures of their templates (from ``build_log``
    and ``w8_log``), the paged kernel's share of its bound over
    int8/int4 pages and ptxas's figures of those templates (from
    ``paged_log``), and RMSNorm's shares of its bound, ratios to
    F.rms_norm and ptxas figures (from ``norm_log``), printed."""
    from distributed_llm_training_and_inference_system_tpu_torch import (
        profile_matmul as pm, profile_norm_adamw as pn)
    pa, w8, w4, tq = qm["pa"], qm["w8"], qm["w4"], qm["tq"]
    layers, rn = qm["layers"], qm["rn"]
    kn = qm["kernels"]
    saved = {n: k.launches for n, k in kn.items()}
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    res = {}
    bf16 = torch.bfloat16
    rows = 8
    # rows 7-9 at the decode batch; the record of each kernel is the shape
    # the JAX route gives it on the main path
    for n_in, n_out in ((4096, 14336), (14336, 4096)):
        x, values, scale = w8_case(torch, tq, rows, n_in, n_out, bf16, 5)
        name = ("int8_matmul_ksplit" if w8.w8_route(n_in, n_out) == "ksplit"
                else "int8_matmul")
        w_bf16 = tq.dequantize_int8(values, scale, bf16)
        work = pm.w8_work(rows, n_in, n_out)
        r = bound_record(
            time_ms(torch, lambda: kn[name](x, values, scale), flush=flush),
            time_ms(torch, lambda: w8.matmul_w8_plain(x, values, scale),
                    iters=10, flush=flush),
            time_ms(torch, lambda: x @ w_bf16, flush=flush),
            work["bytes"], work["ops"], PEAK_OPS["bfloat16"])
        r["shape"] = {"rows": rows, "in": n_in, "out": n_out}
        res[name] = r
        del w_bf16
        x, packed, s4, chan = w4_case(torch, tq, rows, n_in, n_out, bf16, 6)
        w_bf16 = tq.dequantize_int4_groupwise(packed, s4, chan, 128, bf16)
        work = pm.w4_work(rows, n_in, n_out, 128)
        r4 = bound_record(
            time_ms(torch, lambda: w4.matmul_w4(x, packed, s4, chan, 128),
                    flush=flush),
            time_ms(torch, lambda: w4.matmul_w4_plain(x, packed, s4, chan,
                                                      128),
                    iters=10, flush=flush),
            time_ms(torch, lambda: x @ w_bf16, flush=flush),
            work["bytes"], work["ops"], PEAK_OPS["bfloat16"])
        r4["shape"] = {"rows": rows, "in": n_in, "out": n_out}
        res["int4_matmul" if n_in == 4096 else "int4_matmul_down"] = r4
        del w_bf16, x, values, scale, packed, s4, chan
        for nm, rr in ((name, r), ("int4_matmul", r4)):
            print(f"{nm} ({rows} x {n_in} -> {n_out}, bf16): kernel "
                  f"{rr['ms']:.4f} ms, plain {rr['plain_ms']:.4f} ms, library "
                  f"(x @ dequantized bf16 weight, 2 bytes a weight) "
                  f"{rr['library_ms']:.4f} ms, bound {rr['bound_ms']:.4f} ms "
                  f"({rr['bound_by']}, {rr['bytes']} B) -> "
                  f"{rr['bound_ms'] / rr['ms']:.1%} of bound", flush=True)
        torch.cuda.empty_cache()
    for name in ("int8_matmul", "int8_matmul_ksplit", "int4_matmul",
                 "int4_matmul_down"):
        r = res[name]
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["over_library"] = r["ms"] / r["library_ms"]
        print(f"{name.removesuffix('_down')} {r['shape']['in']} -> "
              f"{r['shape']['out']} ({rows} rows): "
              f"{r['share_of_bound']:.1%} of its bound, "
              f"{r['over_library']:.2f}x x @ w_bf16 (printed, not gated)",
              flush=True)
    for key, parse, log, what in (("int4_ptxas", pm.w4_ptxas, build_log,
                                   "W4"),
                                  ("int8_ptxas", pm.w8_ptxas, w8_log, "W8")):
        res[key] = parse(log)
        for name, f in res[key].items():
            print(f"ptxas {name}: {f.get('registers')} registers, spill "
                  f"stores/loads {f.get('spill_stores')}/"
                  f"{f.get('spill_loads')} B", flush=True)
        if not res[key]:
            print(f"ptxas: the build log holds no {what} figures (the "
                  f"library was built before this run)", flush=True)
    # row 1b at phase 4's decode shape
    q, kp, vp, tables, starts, lengths = paged_case(torch, 1, torch.float32,
                                                    seed=99)
    q = q.to(bf16)
    B, T, Nq, D = q.shape
    Nkv = kp.shape[1]
    live = sum(lengths)
    for kind, row_bytes in (("int8", D + 4), ("int4", D // 2 + 4)):
        kq, vq = quantize_pages(qm, kind, kp), quantize_pages(qm, kind, vp)
        nbytes = (2 * q.numel() * 2 + 2 * live * Nkv * row_bytes
                  + tables.numel() * 4 + starts.numel() * 4)
        r = bound_record(
            time_ms(torch, lambda: pa.paged_attention_multi(
                q, kq, vq, tables, starts), flush=flush),
            time_ms(torch, lambda: pa.paged_attention_multi(
                q, kq, vq, tables, starts, impl="gather"), flush=flush),
            None, nbytes, 4 * Nq * D * live, PEAK_OPS["bfloat16"])
        r["shape"] = {"B": B, "T": T, "Nq": Nq, "Nkv": Nkv, "D": D,
                      "lengths": lengths}
        res[f"paged_attention_{kind}"] = r
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        print(f"paged_attention_{kind} (B=8, T=1, bf16 q, lengths "
              f"{lengths}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library none, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes} B) -> "
              f"{r['share_of_bound']:.1%} of bound (printed, not gated)",
              flush=True)
    res["paged_ptxas"] = paged_ptxas_lines(paged_log, ("int8", "int4"))
    # row 5; the record is the entry forward's shape
    for shape in ((8, 4096), (8192, 4096), ENTRY_NORM_SHAPE):
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(shape, generator=g, device="cuda").to(bf16)
        sc = (torch.randn(shape[-1], generator=g, device="cuda") * 0.1
              ).to(bf16)
        weight = 1 + sc
        work = pn.rmsnorm_work(x.numel() // shape[-1], shape[-1])
        r = bound_record(
            time_ms(torch, lambda: layers.rms_norm(x, sc, 1e-5, impl="cuda"),
                    flush=flush),
            time_ms(torch, lambda: layers.rms_norm(x, sc, 1e-5), flush=flush),
            time_ms(torch, lambda: F.rms_norm(x, (shape[-1],), weight, 1e-5),
                    flush=flush),
            work["bytes"], work["ops"], PEAK_OPS["float32"])
        r["shape"] = list(shape)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["over_library"] = r["ms"] / r["library_ms"]
        res["rmsnorm" if shape == ENTRY_NORM_SHAPE
            else f"rmsnorm_{shape[0]}x{shape[1]}"] = r
        print(f"rmsnorm {shape} bf16: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (F.rms_norm) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) -> {r['share_of_bound']:.1%} of bound, "
              f"{r['over_library']:.2f}x F.rms_norm (printed, not gated)",
              flush=True)
    print(f"rmsnorm {ENTRY_NORM_SHAPE}: its bound lies below the ~10 us "
          f"that every cold call of time_ms costs (cuBLAS too), so its "
          f"share of the bound is not a goal", flush=True)
    res["rmsnorm_ptxas"] = pn.kernel_ptxas(norm_log)
    for name, f in res["rmsnorm_ptxas"].items():
        print(f"ptxas {name}: {f.get('registers')} registers, spill "
              f"stores/loads {f.get('spill_stores')}/{f.get('spill_loads')} "
              f"B", flush=True)
    if not res["rmsnorm_ptxas"]:
        print("ptxas: the build log holds no RMSNorm figures (the library "
              "was built before this run)", flush=True)
    for n, k in kn.items():
        k.launches = saved[n]       # timing launches are not the main path
    return res


# -- phase 13: quantized serving at full width and depth ----------------------

QUANT_CONFIGS = {
    "A": dict(quantization="int8", kv_quantization="int8",
              int8_pallas_matmul=True),
    "B": dict(quantization="int4", kv_quantization="int4",
              int8_pallas_matmul=False),
}
QUANT_STEP_LIMIT = 0.1      # kernel step vs dequant/gather step, share of
                            # the largest logit (bf16 roundings placed
                            # differently through 32 layers)


def serve_quantized(torch, mods, qm, cfg, model, name: str, card: str,
                    **settings) -> dict:
    kn = qm["kernels"]
    L = cfg.num_layers
    scfg = mods["ServeConfig"](model=cfg.name, host="127.0.0.1", port=0,
                               **settings)
    t_init = time.time()
    srv = mods["InferenceServer"](cfg, scfg, params=model, seed=0)
    torch.cuda.synchronize()
    eng = srv.engine
    init_s = time.time() - t_init
    bf16_bytes = model.weight_bytes()
    print(f"config {name}: {settings}; weights {bf16_bytes / 1e9:.2f} GB "
          f"bf16 -> {eng.params.weight_bytes() / 1e9:.2f} GB, quantized in "
          f"{init_s:.1f}s; KV pool {eng.kv.num_pages} pages, "
          f"{eng.kv.hbm_bytes() / 1e9:.3f} GB", flush=True)
    res = drive_traffic(torch, srv, cfg, kn)
    st, launches = res["engine"], res["launches"]
    # what /health says of the quantization and the pool
    kv = settings["kv_quantization"]
    D, Nkv, PS = cfg.head_dim, cfg.num_kv_heads, eng.kv.page_size
    row_bytes = {"int8": D + 4, "int4": D // 2 + 4}[kv]
    want_bytes = 2 * L * eng.kv.num_pages * Nkv * PS * row_bytes
    bf16_pool = 2 * L * eng.kv.num_pages * Nkv * PS * D * 2
    check(st["quantization"] == settings["quantization"]
          and st["kv"]["kv_quantization"] == kv,
          f"/health reports {st['quantization']}/"
          f"{st['kv']['kv_quantization']}")
    check(st["kv"]["num_pages"] == scfg.max_batch_size
          * (scfg.max_seq_len // PS) + 1,
          f"KV pool of {st['kv']['num_pages']} pages")
    check(st["kv"]["hbm_bytes"] == want_bytes,
          f"pool bytes {st['kv']['hbm_bytes']} != {want_bytes}")
    check(st["weight_bytes"] < 0.6 * bf16_bytes,
          f"weights {st['weight_bytes']} B, bf16 {bf16_bytes} B")
    # every kernel's launches against what the code implies
    steps, extends = res["decode_steps"], res["extend_prefills"]
    check(extends == 1, f"{extends} suffix prefills")
    # the suffix prefill goes to the matmul kernels only at <= 64 rows
    suffix = res["shared_prefix_prompt_tokens"] - res["prefix_cached_tokens"]
    kernel_passes = steps + (1 if eng._suffix_bucket(suffix) <= 64 else 0)
    per_layer = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
                 "o": (4096, 4096), "gate": (4096, 14336),
                 "up": (4096, 14336), "down": (14336, 4096)}
    n_split = sum(qm["w8"].w8_route(*s) == "ksplit"
                  for s in per_layer.values())
    a = settings["int8_pallas_matmul"]
    w4 = settings["quantization"] == "int4"
    expected = {
        "paged_attention": 0,
        "paged_attention_int8": L * (steps + extends) if kv == "int8" else 0,
        "paged_attention_int4": L * (steps + extends) if kv == "int4" else 0,
        "int8_matmul": L * (7 - n_split) * kernel_passes if a else 0,
        "int8_matmul_ksplit": L * n_split * kernel_passes if a else 0,
        "int4_matmul": L * 7 * kernel_passes if w4 else 0,
        "rmsnorm": 0,
    }
    print(f"config {name} launches on the main path: {launches}; expected "
          f"{expected} ({steps} decode steps, {extends} suffix prefill of "
          f"{suffix} tokens in a bucket of {eng._suffix_bucket(suffix)}; per "
          f"step and layer 7 matmuls, {n_split} of them k-split, and 1 paged "
          f"attention)", flush=True)
    check(launches == expected, f"config {name}: launches {launches} != "
          f"{expected}")
    bf16_pool_share = st["kv"]["hbm_bytes"] / bf16_pool
    res.update(settings=settings, expected=expected, init_s=init_s,
               weight_bytes=st["weight_bytes"], bf16_weight_bytes=bf16_bytes,
               kv_hbm_bytes=st["kv"]["hbm_bytes"],
               kv_share_of_bf16_pool=bf16_pool_share)
    print(f"config {name} {traffic_line(res)} (the bf16 source weights, "
          f"{bf16_bytes / 1e9:.2f} GB, included); weights "
          f"{st['weight_bytes'] / 1e9:.2f} GB, KV pool "
          f"{st['kv']['hbm_bytes'] / 1e9:.3f} GB = {bf16_pool_share:.3f} of "
          f"a bf16 pool [{card}]", flush=True)

    # one decode step over a prefilled prompt: the kernels against the
    # dequant route and the gather attention, on the same pages
    with torch.inference_mode():
        prompt = srv.tokenizer.encode(res["greedy"]["prompt"])
        n = len(prompt)
        eng.kv.allocate(0, n + 1)
        bucket = eng._bucket(n)
        entries = np.zeros(bucket // PS, np.int64)
        used = eng.kv.pages_needed(n)
        entries[:used] = eng.kv.block_tables[0, :used]
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = prompt
        tok = eng._prefill_dense(tokens, n, entries).argmax(-1)
        tables = torch.from_numpy(eng.kv.block_tables[:1].copy()).cuda()
        pos = torch.tensor([n], device="cuda")
        counts = {k: f.launches for k, f in kn.items()}
        fast = mods["decode_step_forward"](
            eng.params, tok, pos, eng.kv.k_pages, eng.kv.v_pages, tables,
            cfg, w8_kernel_ok=a)[0]
        grew = {k: f.launches - counts[k] for k, f in kn.items()}
        check(grew == {k: (v // kernel_passes if "matmul" in k
                           else v // (steps + extends))
                       for k, v in expected.items()},
              f"config {name}: one decode step launched {grew}")
        slow = mods["decode_step_forward"](
            eng.params, tok, pos, eng.kv.k_pages, eng.kv.v_pages, tables,
            cfg, w4_kernel_ok=False, w8_kernel_ok=False,
            attn_impl="gather")[0]
        torch.cuda.synchronize()
    check(bool(torch.isfinite(fast).all()), "non-finite decode logits")
    diff = (fast - slow).abs().max().item()
    top = slow.abs().max().item()
    same = int(fast.argmax(-1)) == int(slow.argmax(-1))
    print(f"config {name} decode step at position {n}: kernels vs dequant "
          f"route + gather attention max |dlogit| {diff:.4f} = "
          f"{diff / top:.2%} of max |logit| {top:.3f} (limit "
          f"{QUANT_STEP_LIMIT:.0%}); same greedy token: {same}", flush=True)
    check(diff <= QUANT_STEP_LIMIT * top, f"config {name}: the kernel step "
          f"is {diff} from the dequant step, over {QUANT_STEP_LIMIT} x {top}")
    res["step_vs_dequant"] = {"max_abs_diff": diff, "max_abs_logit": top,
                              "same_greedy_token": same}
    eng.release()
    del srv, eng
    torch.cuda.empty_cache()
    return res


# -- phase 14: the RMSNorm kernel on the entry forward ------------------------

NORM_PATH_LIMIT = 2e-2      # share of the largest logit (a norm output that
                            # rounds the other way, carried through 24 layers)


def rmsnorm_on_entry(torch, gpt, qm) -> dict:
    kernel = qm["rn"].rmsnorm_kernel
    fn, (model, tokens) = gpt.entry(norm_impl="cuda")
    cfg = model.cfg
    kernel.launches = 0                              # the main path starts
    logits = fn(model, tokens)
    torch.cuda.synchronize()
    launches = kernel.launches                       # the main path ended
    want = 2 * cfg.num_layers + 1
    with torch.inference_mode():
        ref = gpt.forward(model, tokens, cfg, attn_impl="flash")
    check(kernel.launches == launches, "the plain forward launched the norm "
          "kernel")
    check(tuple(logits.shape) == (1, 1024, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"entry logits {tuple(logits.shape)}")
    diff = (logits - ref).abs().max().item()
    top = ref.abs().max().item()
    print(f"entry forward (gpt-1b, [1, 1024], bf16) with norm_impl=cuda: "
          f"{launches} rmsnorm launches (expected 2 x {cfg.num_layers} + 1 = "
          f"{want}); max |dlogit| against the plain norms {diff:.4f} = "
          f"{diff / top:.2%} of max |logit| {top:.3f} (limit "
          f"{NORM_PATH_LIMIT:.0%})", flush=True)
    check(launches == want, f"rmsnorm launches {launches} != {want}")
    check(diff <= NORM_PATH_LIMIT * top, "the norm kernel moved the logits")
    # printed, not gated: the CUDA kernels of the norms (one a norm: no
    # conversion ahead of it) and the forward's device time either way
    from distributed_llm_training_and_inference_system_tpu_torch import (
        profile_norm_adamw as pn)
    with_kernel = pn.cuda_activity(lambda: fn(model, tokens), calls=2)

    def plain():
        with torch.inference_mode():
            gpt.forward(model, tokens, cfg, attn_impl="flash")
    without = pn.cuda_activity(plain, calls=2)
    kernel.launches = launches                   # not the main path
    norm_kernels = pn.launches_of(with_kernel, "rmsnorm")
    ms = {impl: sum(a["ms"] for a in act.values())
          for impl, act in (("cuda", with_kernel), ("xla", without))}
    print(f"entry forward under torch.profiler: {norm_kernels:g} rmsnorm "
          f"CUDA kernels a forward (one a norm: {want}), "
          f"{pn.launches_of(with_kernel):g} CUDA kernels in all; device "
          f"time {ms['cuda']:.3f} ms with norm_impl=cuda, {ms['xla']:.3f} ms "
          f"with norm_impl=xla ({pn.launches_of(without):g} CUDA kernels) "
          f"(printed, not gated)", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_diff": diff, "max_abs_logit": top,
            "norm_cuda_kernels": norm_kernels,
            "cuda_kernels_a_forward": {"cuda": pn.launches_of(with_kernel),
                                       "xla": pn.launches_of(without)},
            "device_ms": ms}


# -- phase 15: swap preemption, chunked prefill and speculation ---------------

FEATURES = dict(chunked_prefill_tokens=512, speculative="ngram",
                speculative_tokens=8, preemption="swap", admission="ondemand")
FEATURE_SEQ_LEN = 4096        # room for the 3000-token prompt
# sent longest first, so that admission packs the pool: the eight
# admissions take 142 pages (each prompt + 15 tokens of lookahead), so a
# pool of 140 usable pages leaves the last one waiting and no slack, and
# the first stream whose decode crosses a page boundary preempts the newest
FEATURE_LENGTHS = (3000, 2200, 1500, 900, 600, 300, 128, 64)
FEATURE_POOL_PAGES = 140
FEATURE_SAMPLED = (1, 4, 6)   # indices of the seeded-sampled requests
FEATURE_TOKENS = 64
FEATURE_TEMPERATURE = 0.8
# The near-tie bound. delta is the largest change that one bf16 serving path
# makes to a logit of llama-8b-gqa (random weights from seed 0) against the
# dense bf16 forward: phase 6 measures it for paged decode after a dense
# prefill (0.2739 in every run of PR 1-10); verify windows (T = 8) and
# chunks (T = 512) are the same arithmetic at other row counts (bf16
# projections, the kernel's fp32 softmax, K/V stored in bf16), so delta
# allows them 1.8x that, and the phase fails if phase 6 reads more. If two
# paths' logits each lie within delta of the dense forward's r, a path's pick
# a = argmax satisfies max(r) - r(a) <= 2 delta, and two paths that pick
# a != b from one context have |r(a) - r(b)| <= 2 delta. A sampled row picks
# the argmax of logits / temperature + Gumbel noise, so there the bound is
# 2 delta / temperature.
NEAR_TIE_DELTA = 0.5
FEATURE_COUNTERS = ("total_dispatched_steps", "total_extend_prefills",
                    "total_prefill_chunks", "total_spec_dispatches",
                    "total_chunked_prefills", "total_swap_ins",
                    "total_swap_outs", "total_swap_out_bytes",
                    "total_swap_fallbacks", "total_spec_drafts",
                    "total_spec_accepted", "total_preemptions")


def feature_prompts(seed: int = 15) -> list:
    """Token-id prompts of FEATURE_LENGTHS, each made of a few random spans
    of 16-48 tokens that recur inside it (so the n-gram proposer finds
    drafts) and short random runs; ids below 256, as the byte tokenizer
    gives them."""
    rng = random.Random(seed)
    out = []
    for n in FEATURE_LENGTHS:
        spans = [[rng.randrange(256) for _ in range(rng.randint(16, 48))]
                 for _ in range(4)]
        ids = []
        while len(ids) < n:
            ids += (rng.choice(spans) if rng.random() < 0.7 else
                    [rng.randrange(256) for _ in range(rng.randint(1, 8))])
        out.append(ids[:n])
    return out


def feature_body(i: int, prompt: list, max_tokens: int = FEATURE_TOKENS
                 ) -> dict:
    sampled = i in FEATURE_SAMPLED
    return {"prompt": prompt, "max_tokens": max_tokens, "seed": 100 + i,
            "temperature": FEATURE_TEMPERATURE if sampled else 0.0}


def feature_traffic(torch, srv, prompts, kernels: dict) -> dict:
    """Serve ``prompts`` through /v1/completions, started 30 ms apart in
    order and running concurrently; the counts of ``kernels`` are set to 0
    just before the first request and read after the last. Then /v1/stats,
    and three rounds of two solo requests: a fresh prompt of the longest
    length (its TTFT) and a fresh 1024-token prompt decoding 64 greedy
    tokens (its decode rate). Stops the server."""
    eng, port = srv.engine, srv.start()
    try:
        post(port, {"prompt": [1, 2, 3], "max_tokens": 2,
                    "temperature": 0.0})           # set-up, not measured
        torch.cuda.synchronize()
        before = {k: getattr(eng, k) for k in FEATURE_COUNTERS}
        for k in kernels.values():
            k.launches = 0                           # the main path starts
        out = [None] * len(prompts)

        def worker(i):
            out[i] = post(port, feature_body(i, prompts[i]))
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.time()
        for t in threads:
            t.start()
            time.sleep(0.03)
        for t in threads:
            t.join(timeout=900)
        wall = time.time() - t0
        launches = {n: k.launches for n, k in kernels.items()}  # it ended
        check(all(r is not None for r in out), "a request did not return")
        counts = {k.removeprefix("total_"): getattr(eng, k) - before[k]
                  for k in FEATURE_COUNTERS}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats",
                                    timeout=60) as r:
            check(r.status == 200, f"/v1/stats status {r.status}")
            stats = json.loads(r.read())
        ttft, rate = [], []
        for seed in (16, 17, 18):
            fresh = feature_prompts(seed=seed)
            longest = post(port, {"prompt": fresh[0], "max_tokens": 2,
                                  "temperature": 0.0})
            ttft.append(longest["metrics"]["ttft_ms"])
            solo = post(port, {"prompt": fresh[1][:1024],
                               "max_tokens": FEATURE_TOKENS,
                               "temperature": 0.0})
            m = solo["metrics"]
            rate.append((solo["usage"]["completion_tokens"] - 1)
                        / ((m["latency_ms"] - m["ttft_ms"]) / 1e3))
    finally:
        srv.stop()
    return {
        "results": out, "launches": launches, "counts": counts,
        "stats": stats, "wall_s": wall,
        "tokens": sum(r["usage"]["completion_tokens"] for r in out),
        "ttft_longest_ms": ttft, "solo_decode_tok_per_s": rate,
        "per_request_decode_tok_per_s_p50": sorted(
            (r["usage"]["completion_tokens"] - 1)
            / ((r["metrics"]["latency_ms"] - r["metrics"]["ttft_ms"]) / 1e3)
            for r in out)[len(out) // 2],
    }


def teacher_forced(torch, mods, model, cfg, prompt, tokens, body) -> dict:
    """The dense bf16 forward over ``prompt + tokens``: for each generated
    token, how far its score (logit; for a sampled row logit / temperature
    + the request's Gumbel noise at its position) lies below the best
    score (the deficit), with the scores [K, V]."""
    gpt = mods["gpt"]
    n, K = len(prompt), len(tokens)
    ctx = torch.tensor([prompt + tokens[:-1]], device="cuda")
    with torch.inference_mode():
        logits = gpt.forward(model, ctx, cfg)[0, n - 1:n - 1 + K].float()
        if body["temperature"] > 0:
            noise = mods["gumbel_noise"](
                torch.full((K,), body["seed"], device="cuda"),
                torch.arange(n, n + K, device="cuda"), cfg.vocab_size)
            logits = logits / body["temperature"] + noise
    picked = logits.gather(1, torch.tensor(tokens, device="cuda")[:, None])
    deficit = (logits.max(dim=1).values - picked[:, 0]).cpu().tolist()
    return {"scores": logits, "deficit": deficit}


def swap_round_trip(torch, mods, cfg, kind: str, pool=None) -> dict:
    """A 1500-token slot (24 pages) of llama-8b-gqa extracted to pinned
    host memory and restored into another slot on the card; the restored
    pages must equal the originals byte for byte. ``pool`` is a cache to
    use (the features-on engine's, holding the run's K/V); else a fresh one
    of ``kind`` filled with random bytes. Two rounds: the first ("cold")
    allocates the pinned host buffers, the second ("warm") reuses them
    from PyTorch's pinned-memory cache, as a swap in a running engine
    does; each call timed by CUDA events (device) and on the host's clock
    until it returns (host). Bytes of the payload."""
    kvc = mods["kv_cache"]
    if pool is None:
        pool = kvc.PagedKVCache(cfg, num_slots=3, max_seq_len=2048,
                                page_size=64, num_pages=60,
                                dtype=torch.bfloat16, device="cuda",
                                quantized=kind)
        g = torch.Generator(device="cuda").manual_seed(7)
        for buf in (pool.k_pages, pool.v_pages):
            for t in (buf.tensors() if pool.quantized else (buf,)):
                if t.dtype.is_floating_point:
                    t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
                else:
                    t.copy_(torch.randint(0, 255, t.shape, generator=g,
                                          device="cuda").to(t.dtype))
    src, dst = 0, 1
    times = {}

    def timed(fn):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.record()
        out = fn()
        e.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return out, s.elapsed_time(e), host_ms

    for rnd in ("cold", "warm"):
        for slot in (src, dst):
            pool.release(slot)
        pool.allocate(src, 1500)
        payload, dev_ms, host_ms = timed(lambda: pool.extract_slot(src))
        times[f"swap_out_{rnd}_ms"] = dev_ms
        times[f"swap_out_{rnd}_host_ms"] = host_ms
        host = kvc.payload_numpy(payload)
        pool.release(src)
        pool.allocate(2, 300)                # the freed pages move on
        ok, dev_ms, host_ms = timed(lambda: pool.restore_slot(dst, payload))
        check(ok, f"swap-in of {kind} pages found no room")
        times[f"swap_in_{rnd}_ms"] = dev_ms
        times[f"swap_in_{rnd}_host_ms"] = host_ms
        pool.release(2)
        del payload                 # its pinned blocks go back to the cache
    back = kvc.payload_numpy(pool.extract_slot(dst))
    nbytes, same = 0, True
    for name in ("k", "v"):
        a, b = host[name], back[name]
        for x, y in ([(a[p], b[p]) for p in ("values", "scale")]
                     if isinstance(a, dict) else [(a, b)]):
            same &= x.dtype == y.dtype and x.tobytes() == y.tobytes()
            nbytes += x.nbytes
    for slot in (src, dst):
        pool.release(slot)
    check(same, f"{kind} pages restored on the card differ from the "
          f"extracted ones")
    return {"kind": kind, "pages": 24, "bytes": nbytes, **times}


def serve_features(torch, mods, kernel, model, cfg, card: str,
                   dense_max_abs_diff: float) -> dict:
    """Phase 15: llama-8b-gqa at full width and depth from phase 5's
    weights, served twice through /v1/completions: with swap preemption,
    chunked prefill and n-gram speculation on (a pool that forces
    preemption), and with the three off; every stream held to the dense
    forward within the near-tie bound; swap round trips bit for bit."""
    check(dense_max_abs_diff <= NEAR_TIE_DELTA,
          f"phase 6 read paged decode {dense_max_abs_diff} from the dense "
          f"forward, over the near-tie delta {NEAR_TIE_DELTA}")
    L = cfg.num_layers
    prompts = feature_prompts()
    runs = {}
    for name, over in (("on", dict(FEATURES,
                                   kv_num_blocks=FEATURE_POOL_PAGES + 1)),
                       ("off", {})):
        scfg = mods["ServeConfig"](model=cfg.name, host="127.0.0.1", port=0,
                                   max_seq_len=FEATURE_SEQ_LEN, **over)
        srv = mods["InferenceServer"](cfg, scfg, params=model, seed=0)
        runs[name] = feature_traffic(torch, srv, prompts,
                                     {"paged_attention": kernel})
        runs[name]["pool_pages"] = srv.engine.kv.num_pages
        if name == "on":
            # the engine's own pool, holding the run's K/V, bit for bit
            swaps = [swap_round_trip(torch, mods, cfg, "bf16",
                                     pool=srv.engine.kv)]
        srv.engine.release()
        del srv
        torch.cuda.empty_cache()
    on, off = runs["on"], runs["off"]
    c, st = on["counts"], on["stats"]
    for run in (on, off):
        for r in run["results"]:
            toks = r["choices"][0]["token_ids"]
            reason = r["choices"][0]["finish_reason"]
            check(len(toks) == FEATURE_TOKENS or reason == "stop",
                  f"a stream ended after {len(toks)} tokens ({reason})")
    check(st["nonfinite_logits"] == 0 and off["stats"]["nonfinite_logits"]
          == 0, "a logits tensor held NaN/inf")
    check(c["swap_ins"] >= 1, f"no swap-in ({c['swap_outs']} swap-outs, "
          f"{c['preemptions']} preemptions)")
    check(c["spec_dispatches"] >= 1, "no speculative dispatch")
    check(c["chunked_prefills"] >= 2, f"{c['chunked_prefills']} chunked "
          f"prefills")
    for key in ("swap_ins", "spec_dispatches", "spec_acceptance",
                "prefill_chunks", "chunked_prefills", "swapped_host_bytes"):
        check(key in st, f"/v1/stats has no {key}")
    passes = (c["dispatched_steps"] + c["extend_prefills"]
              + c["prefill_chunks"] + c["spec_dispatches"])
    launches = on["launches"]["paged_attention"]
    print(f"features on: paged kernel launches {launches} = {L} layers x "
          f"({c['dispatched_steps']} decode steps + {c['extend_prefills']} "
          f"suffix prefills + {c['prefill_chunks']} chunks + "
          f"{c['spec_dispatches']} verify windows); expected {L * passes}",
          flush=True)
    check(launches == L * passes, f"paged launches {launches} != "
          f"{L * passes}")

    # every stream against the dense forward; the two runs against each
    # other at their first differing token. Every stream is read before
    # the phase fails, so a failure shows how far past the bound it lies.
    compared, faults = [], []
    for i, prompt in enumerate(prompts):
        body = feature_body(i, prompt)
        bound = 2 * NEAR_TIE_DELTA / (body["temperature"] or 1.0)
        a = on["results"][i]["choices"][0]["token_ids"]
        b = off["results"][i]["choices"][0]["token_ids"]
        ref_on = teacher_forced(torch, mods, model, cfg, prompt, a, body)
        ref_off = teacher_forced(torch, mods, model, cfg, prompt, b, body)
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        rec = {"prompt_tokens": len(prompt), "sampled": body["temperature"]
               > 0, "bound": bound, "first_difference": first,
               "on_max_deficit": max(ref_on["deficit"]),
               "off_max_deficit": max(ref_off["deficit"])}
        if first is not None:
            sc = ref_on["scores"][first]
            top = sc.max().item()
            rec["gap_at_difference"] = abs(sc[a[first]].item()
                                           - sc[b[first]].item())
            rec["off_deficit_at_difference"] = top - sc[b[first]].item()
            if max(rec["gap_at_difference"],
                   rec["off_deficit_at_difference"]) > bound:
                faults.append(
                    f"stream {i}: the runs part at token {first} where the "
                    f"features-off run's top two lie "
                    f"{rec['gap_at_difference']:.4f} apart (bound {bound})")
        print(f"stream {i} ({len(prompt)} prompt tokens, "
              f"{'sampled' if rec['sampled'] else 'greedy'}): first "
              f"difference on/off at token {first}"
              + (f" (score gap {rec['gap_at_difference']:.4f})"
                 if first is not None else "")
              + f"; largest deficit under the dense forward: on "
              f"{rec['on_max_deficit']:.4f}, off {rec['off_max_deficit']:.4f}"
              f" (bound {bound:.3f})", flush=True)
        worst = max(rec["on_max_deficit"], rec["off_max_deficit"])
        if worst > bound:
            faults.append(f"stream {i}: a token lies {worst:.4f} under the "
                          f"dense forward's best (bound {bound})")
        compared.append(rec)
        del ref_on, ref_off
    torch.cuda.empty_cache()
    check(not faults, "; ".join(faults))

    swaps += [swap_round_trip(torch, mods, cfg, kind)
              for kind in ("int8", "int4")]
    acceptance = c["spec_accepted"] / max(c["spec_drafts"], 1)
    print(f"features on: {c['chunked_prefills']} chunked prefills in "
          f"{c['prefill_chunks']} chunks, {c['spec_dispatches']} speculative "
          f"dispatches, acceptance {acceptance:.4f} ({c['spec_accepted']} of "
          f"{c['spec_drafts']} drafts), {c['preemptions']} preemptions, "
          f"{c['swap_outs']} swap-outs ({c['swap_out_bytes']} B), "
          f"{c['swap_ins']} swap-ins, {c['swap_fallbacks']} fallbacks; pool "
          f"{on['pool_pages']} pages [{card}]", flush=True)
    def listed(xs, fmt=".1f"):
        return ", ".join(f"{x:{fmt}}" for x in xs)
    print(f"TTFT of a {FEATURE_LENGTHS[0]}-token prompt alone, 3 fresh "
          f"prompts: chunked {listed(on['ttft_longest_ms'])} ms, dense "
          f"{listed(off['ttft_longest_ms'])} ms [{card}]", flush=True)
    print(f"decode tok/s of one greedy stream alone (64 tokens, 1024-token "
          f"prompt, 3 fresh prompts): speculation on "
          f"{listed(on['solo_decode_tok_per_s'])}, off "
          f"{listed(off['solo_decode_tok_per_s'])}; per-request p50 over "
          f"the 8 streams: on "
          f"{on['per_request_decode_tok_per_s_p50']:.1f}, off "
          f"{off['per_request_decode_tok_per_s_p50']:.1f}; traffic wall on "
          f"{on['wall_s']:.2f} s, off {off['wall_s']:.2f} s [{card}]",
          flush=True)
    for sw in swaps:
        print(f"swap round trip, {sw['kind']} pages, {sw['pages']} pages of "
              f"llama-8b-gqa, {sw['bytes']} B, device (host) ms: swap-out "
              f"warm {sw['swap_out_warm_ms']:.3f} "
              f"({sw['swap_out_warm_host_ms']:.3f}), cold "
              f"{sw['swap_out_cold_ms']:.3f} "
              f"({sw['swap_out_cold_host_ms']:.3f}); swap-in warm "
              f"{sw['swap_in_warm_ms']:.3f} "
              f"({sw['swap_in_warm_host_ms']:.3f}), cold "
              f"{sw['swap_in_cold_ms']:.3f} ({sw['swap_in_cold_host_ms']:.3f})"
              f"; {sw['bytes'] / sw['swap_out_warm_ms'] / 1e6:.1f} GB/s out, "
              f"{sw['bytes'] / sw['swap_in_warm_ms'] / 1e6:.1f} GB/s in; "
              f"restored bytes equal [{card}]", flush=True)
    for run in (on, off):
        run.pop("results")
    return {"launches": launches, "counts": c, "acceptance": acceptance,
            "streams": compared, "swaps": swaps, "on": on, "off": off}


# -- phase 16: the MoE family ---------------------------------------------------

MOE_SERVE = "gpt-moe-8x1b"
MOE_TRAIN = "gpt-moe-1b"
MOE_BLOCK_N = (8, 2048)          # a decode step's 8 slots; a prefill bucket
# moe_block on the card against the same function on the CPU: the same
# choices kept and dropped, in the same buffer slots; out within this share
# of its largest element (fp32: summation order, TF32 off; bf16: one
# rounding of the expert products' bf16 outputs either way); the aux loss
# within MOE_AUX_TOL of itself (fp32 means of the same probabilities)
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MOE_AUX_TOL = 1e-5
# the replay holds the engine's routing fixed and reads its own router:
# where its top-K differs from the engine's choice, the probability of its
# own K-th choice may exceed that of the engine's weakest by at most this
# (a near-tie that the two attention paths' bf16 rounding can flip). A
# control reads the same gap against the routing of the engine's previous
# call (another layer's router over the same rows: routing that is wrong),
# and must exceed the limit, or the gate could not fail
MOE_ROUTE_TIE = 0.05
MOE_LENGTHS = (1500, 64, 900, 300, 1200, 128, 700, 40, 520, 260, 90, 1000)
MOE_SHARED = 3                   # this request shares request 0's 256 tokens
MOE_TOKENS = 24
MOE_FEATURES = dict(chunked_prefill_tokens=512, speculative="ngram",
                    speculative_tokens=8)
MOE_COUNTERS = ("total_dispatched_steps", "total_extend_prefills",
                "total_prefill_chunks", "total_spec_dispatches",
                "total_decode_steps", "total_prefix_cached_tokens")
MOE_TRAIN_STEPS = 6
MOE_REPEAT_STEPS = 3             # steps on one repeated batch


def moe_layer(torch, cfg, dtype, seed: int):
    """Random router [H, E] and experts at ``cfg``'s widths, drawn on the
    CPU in fp32 (init's scales: 0.02, down 0.02 / sqrt(2L)), in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    H, F, E = cfg.hidden_size, cfg.ffn_size, cfg.moe.num_experts
    resid = 0.02 / (2 * cfg.num_layers) ** 0.5

    def draw(*shape, std=0.02):
        return (torch.randn(shape, generator=g) * std).to(dtype)
    return {"moe_router": draw(H, E), "moe_gate": draw(E, H, F),
            "moe_up": draw(E, H, F), "moe_down": draw(E, F, H, std=resid)}


def moe_block_against_cpu(torch, layers, cfg, card: str) -> dict:
    """Phase 16a: moe_block at ``cfg``'s widths on the card against the
    same function on the CPU, at N tokens of MOE_BLOCK_N, fp32 and bf16;
    the dispatch and the whole block timed on the card (N = 8, bf16) beside
    the bound of reading every expert once."""
    from types import SimpleNamespace
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        w = moe_layer(torch, cfg, dtype, seed=16)
        cpu = SimpleNamespace(**w)
        dev = SimpleNamespace(**{k: v.cuda() for k, v in w.items()})
        for N in MOE_BLOCK_N:
            g = torch.Generator().manual_seed(N)
            x = torch.randn((1, N, cfg.hidden_size), generator=g).to(dtype)
            res = {}
            for where, layer, xx in (("cpu", cpu, x), ("card", dev, x.cuda())):
                t0 = time.perf_counter()
                with torch.inference_mode():
                    o, aux = layers.moe_block(xx, layer, cfg)
                    probs = torch.softmax(
                        xx.reshape(N, -1).float() @ layer.moe_router.float(),
                        dim=-1)
                    d = layers.moe_dispatch(probs, cfg)
                if where == "card":
                    torch.cuda.synchronize()
                res[where] = {"out": o.float().cpu(), "aux": float(aux),
                              "slot": d.slot.cpu(), "probs": probs.cpu(),
                              "s": time.perf_counter() - t0}
            c, k = res["cpu"], res["card"]
            same = torch.equal(c["slot"], k["slot"])
            if not same:
                p = c["probs"].sort(dim=-1, descending=True).values
                gap = (p[:, 1] - p[:, 2]).abs().min().item()
                check(False, f"moe_block {name} N={N}: the card keeps other "
                      f"choices than the CPU (closest 2nd/3rd gap {gap:.2e})")
            ref = c["out"]
            err = (k["out"] - ref).abs().max().item()
            scale = ref.abs().max().item()
            aux_err = abs(k["aux"] - c["aux"])
            dropped = int((c["slot"] < 0).sum())
            print(f"moe_block {name} N={N} (H={cfg.hidden_size}, "
                  f"F={cfg.ffn_size}, E={cfg.moe.num_experts}, K="
                  f"{cfg.moe.experts_per_token}, C="
                  f"{layers.moe_capacity(cfg, N)}): same kept/dropped "
                  f"choices as the CPU ({dropped} of "
                  f"{N * cfg.moe.experts_per_token} dropped); max abs err "
                  f"{err:.3e} ({err / scale:.2e} of max {scale:.3e}, limit "
                  f"{MOE_TOL[name]:.0e}); aux {k['aux']:.6f} vs "
                  f"{c['aux']:.6f}; CPU {c['s']:.2f} s, card {k['s']:.3f} s",
                  flush=True)
            check(err <= MOE_TOL[name] * scale, f"moe_block {name} N={N}: "
                  f"error {err:.3e} over {MOE_TOL[name]} x {scale:.3e}")
            check(aux_err <= MOE_AUX_TOL * abs(c["aux"]),
                  f"moe_block {name} N={N}: aux {k['aux']} vs {c['aux']}")
            out[f"{name}_N{N}"] = {"max_abs_err": err, "max_abs_ref": scale,
                                   "aux_err": aux_err, "dropped": dropped,
                                   "cpu_s": c["s"]}
        if dtype is torch.bfloat16:
            x = torch.randn((1, 8, cfg.hidden_size), device="cuda",
                            dtype=dtype)

            def dispatch():
                probs = torch.softmax(
                    x.reshape(8, -1).float() @ dev.moe_router.float(), dim=-1)
                return layers.moe_dispatch(probs, cfg)
            with torch.inference_mode():
                d_ms = time_ms(torch, dispatch)
                b_ms = time_ms(torch, lambda: layers.moe_block(x, dev, cfg))
            nbytes = sum(t.numel() * t.element_size()
                         for t in vars(dev).values())
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"moe_block bf16 at a decode step's N=8: router + dispatch "
                  f"{d_ms:.4f} ms, whole block {b_ms:.4f} ms; bound "
                  f"{bound:.4f} ms ({nbytes} B of router and experts read "
                  f"once), {bound / b_ms:.1%} of it [{card}]", flush=True)
            out["timing_bf16_N8"] = {"dispatch_ms": d_ms, "block_ms": b_ms,
                                     "bound_ms": bound}
        del cpu, dev, w
    torch.cuda.empty_cache()
    return out


class CallRecorder:
    """Records every forward one engine issues, in issue order, so that a
    replay can repeat them: a dense prefill (its bucket tokens, length and
    page entries) or a paged forward (``extend_step_forward``: tokens,
    starts, block tables, write mask, whether the head runs), each with
    the argmax of the engine's logits; every MoE routing decision
    (``moe_dispatch``'s top-K choices, and how many it dropped); and the
    time of every run of decode steps (``decode_scan``, from the engine and
    after a verify window: CUDA events around it, and the host's time to
    issue it)."""

    def __init__(self, torch, mm):
        self.torch, self.mm = torch, mm
        self.events, self.routes, self.dropped = [], [], []
        self.scans = []
        self._saved = []

    def install(self, eng) -> None:
        mm, rec, torch = self.mm, self, self.torch
        orig_ext = mm["decode"].extend_step_forward
        orig_dense = eng._prefill_dense
        orig_route = mm["layers"].moe_dispatch
        orig_scan = mm["decode"].decode_scan

        def ext(model, tokens, start, kp, vp, tables, cfg, **kw):
            out = orig_ext(model, tokens, start, kp, vp, tables, cfg, **kw)
            wo = kw.get("write_ok")
            rec.events.append({
                "kind": "extend", "tokens": tokens.clone(),
                "start": start.clone(), "tables": tables.clone(),
                "write_ok": None if wo is None else wo.clone(),
                "logits": kw.get("logits", True),
                "w8": kw.get("w8_kernel_ok", False),
                "argmax": None if out[0] is None else out[0].argmax(-1)})
            return out

        def dense(tokens, n, entries):
            logits = orig_dense(tokens, n, entries)
            rec.events.append({"kind": "dense", "tokens": tokens.copy(),
                               "n": n, "entries": entries.copy(),
                               "argmax": logits.argmax(-1)})
            return logits

        def route(probs, cfg):
            d = orig_route(probs, cfg)
            rec.routes.append(d.top_e.clone())
            rec.dropped.append((probs.shape[0], (d.slot < 0).sum()))
            return d

        def scan(*args, **kw):
            steps = kw["num_steps"] if "num_steps" in kw else args[12]
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            t = time.perf_counter()
            out = orig_scan(*args, **kw)
            host = time.perf_counter() - t
            end.record()
            rec.scans.append((steps, host, start, end))
            return out
        for mod in ("decode", "engine", "speculative"):
            self._saved.append((mm[mod], "extend_step_forward",
                                getattr(mm[mod], "extend_step_forward")))
            setattr(mm[mod], "extend_step_forward", ext)
        self._saved.append((mm["layers"], "moe_dispatch", orig_route))
        mm["layers"].moe_dispatch = route
        for mod in ("engine", "speculative"):
            self._saved.append((mm[mod], "decode_scan", orig_scan))
            setattr(mm[mod], "decode_scan", scan)
        eng._prefill_dense = dense
        self._eng = eng

    def remove(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []
        del self._eng._prefill_dense

    def decode_steps(self) -> dict:
        """Decode steps alone: per step, the device timeline's span of a
        decode dispatch (from its first operation to its last, idle gaps
        while the host issues included; queued work before it excluded),
        total and p50 over dispatches, and the host's time to issue it."""
        self.torch.cuda.synchronize()
        steps = sum(n for n, _, _, _ in self.scans)
        span = [a.elapsed_time(b) for _, _, a, b in self.scans]
        per = sorted(ms / n for (n, _, _, _), ms in zip(self.scans, span))
        return {"dispatches": len(self.scans), "steps": steps,
                "device_span_ms": sum(span) / max(steps, 1),
                "device_span_ms_p50": per[len(per) // 2] if per else 0.0,
                "host_issue_ms": sum(h for _, h, _, _ in self.scans) * 1e3
                / max(steps, 1)}

    def drop_shares(self, slots: int, K: int) -> dict:
        """Mean share of the choices dropped per call (one layer of one
        forward), by the call's rows: decode steps (``slots`` rows), verify
        windows and prefills (the rest); idle and pad rows included."""
        out = {}
        for label, pick in (("decode", lambda n: n == slots),
                            ("other", lambda n: n != slots)):
            sel = [(n, c) for n, c in self.dropped if pick(n)]
            if sel:
                shares = self.torch.stack([c.float() / (n * K)
                                           for n, c in sel])
                out[label] = {"calls": len(sel),
                              "mean": float(shares.mean()),
                              "max": float(shares.max())}
        return out


def moe_replay(torch, mm, model, cfg, kv: dict, rec: CallRecorder) -> dict:
    """Repeat ``rec``'s forwards in order on a fresh pool of the engine's
    geometry ``kv`` (PagedKVCache's arguments), through the plain paged attention (the gather path) and the
    dequant route for quantized weights, with the engine's tokens, pad rows
    and routing held fixed. For every position whose logits the engine
    read, the deficit of the engine's pick under the replay's logits; for
    every routing call, where the replay's own top-K differs from the
    engine's, how far its own K-th choice lies above the engine's weakest;
    and the same gap against the engine's previous routing call of the
    same rows, a control that the limit must reject."""
    from types import SimpleNamespace
    layers = mm["layers"]
    dev = model.device
    pool = mm["kv_cache"].PagedKVCache(cfg, device=dev, **kv)
    K = cfg.moe.experts_per_token
    routes = rec.routes
    orig_route = layers.moe_dispatch
    gaps, differ, control = [], [], []
    calls = iter(range(len(routes)))

    def gap_to(probs, own_p, own_e, want):
        mismatch = (own_e[:, :K].sort(dim=-1).values
                    != want.sort(dim=-1).values).any(dim=-1)
        weakest = torch.gather(probs, 1, want).min(dim=-1).values
        gap = torch.where(mismatch, own_p[:, K - 1] - weakest,
                          torch.zeros_like(weakest))
        return gap.max(), mismatch.sum()

    def forced(probs, cfg_):
        i = next(calls, None)
        check(i is not None, "the replay made more routing calls than the "
              "engine")
        want = routes[i]
        check(want.shape[0] == probs.shape[0], f"replay out of step: a "
              f"routing call of {probs.shape[0]} rows against the "
              f"engine's {want.shape[0]}")
        own_p, own_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        gap, n = gap_to(probs, own_p, own_e, want)
        gaps.append(gap)
        differ.append(n)
        if i and routes[i - 1].shape == want.shape:
            control.append(gap_to(probs, own_p, own_e, routes[i - 1])[0])
        top_p = torch.gather(probs, 1, want)
        top_w = top_p / top_p.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return layers.moe_assign(want, top_w, cfg_)
    shim = SimpleNamespace(cfg=cfg, kv=pool, device=dev, params=model)
    deficits, checked = [], 0
    layers.moe_dispatch = forced
    try:
        with torch.inference_mode():
            for ev in rec.events:
                if ev["kind"] == "dense":
                    lg = mm["InferenceEngine"]._prefill_dense(
                        shim, ev["tokens"], ev["n"], ev["entries"])
                    am = ev["argmax"]
                    deficits.append(lg.max(-1).values
                                    - lg.gather(-1, am[:, None])[:, 0])
                    checked += 1
                    continue
                lg, _, _ = mm["decode"].extend_step_forward(
                    model, ev["tokens"], ev["start"], pool.k_pages,
                    pool.v_pages, ev["tables"], cfg, write_ok=ev["write_ok"],
                    w8_kernel_ok=False, attn_impl="gather",
                    logits=ev["logits"])
                if lg is None:
                    continue
                am = ev["argmax"]
                d = lg.max(-1).values - lg.gather(-1, am[..., None])[..., 0]
                mask = (ev["write_ok"] if ev["write_ok"] is not None
                        else torch.ones_like(d, dtype=torch.bool))
                deficits.append(torch.where(mask, d, torch.zeros_like(d))
                                .reshape(-1))
                checked += int(mask.sum())
    finally:
        layers.moe_dispatch = orig_route
    check(next(calls, None) is None, "the replay made fewer routing calls "
          "than the engine")
    dall = torch.cat([d.reshape(-1) for d in deficits])
    res = {"events": len(rec.events), "positions": checked,
           "max_deficit": float(dall.max()),
           "over_bound": int((dall > 2 * NEAR_TIE_DELTA).sum()),
           "routing_calls": len(gaps),
           "routing_rows_differing": int(torch.stack(differ).sum()),
           "max_routing_gap": float(torch.stack(gaps).max()),
           "control_calls": len(control),
           "control_routing_gap": float(torch.stack(control).max())}
    del pool
    torch.cuda.empty_cache()
    return res


def moe_prompts(seed: int = 16) -> list:
    """MOE_LENGTHS prompts of byte-tokenizer ids, built as feature_prompts
    builds them (recurring spans, for the n-gram proposer); request
    MOE_SHARED starts with request 0's first 256 tokens."""
    rng = random.Random(seed)
    out = []
    for n in MOE_LENGTHS:
        spans = [[rng.randrange(256) for _ in range(rng.randint(16, 48))]
                 for _ in range(4)]
        ids = []
        while len(ids) < n:
            ids += (rng.choice(spans) if rng.random() < 0.7 else
                    [rng.randrange(256) for _ in range(rng.randint(1, 8))])
        out.append(ids[:n])
    out[MOE_SHARED] = out[0][:256] + out[MOE_SHARED][:n - 256]
    return out


def moe_traffic(torch, srv, prompts, kernels: dict, max_tokens: int) -> dict:
    """A warm-up request (set-up, not measured), then request 0 alone (it
    publishes its prefix), then the rest 30 ms apart and concurrently, all
    greedy; the counts of ``kernels`` and the engine's counters are read
    around the measured traffic. Stops the server."""
    eng, port = srv.engine, srv.start()
    try:
        post(port, {"prompt": [1, 2, 3], "max_tokens": 2,
                    "temperature": 0.0})           # set-up, not measured
        torch.cuda.synchronize()
        before = {k: getattr(eng, k) for k in MOE_COUNTERS}
        for k in kernels.values():
            k.launches = 0                           # the main path starts
        t0 = time.time()
        out = [post(port, {"prompt": prompts[0], "max_tokens": max_tokens,
                           "temperature": 0.0})] + [None] * (len(prompts) - 1)

        def worker(i):
            out[i] = post(port, {"prompt": prompts[i],
                                 "max_tokens": max_tokens,
                                 "temperature": 0.0})
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(1, len(prompts))]
        for t in threads:
            t.start()
            time.sleep(0.03)
        for t in threads:
            t.join(timeout=900)
        wall = time.time() - t0
        launches = {n: k.launches for n, k in kernels.items()}  # it ended
        check(all(r is not None for r in out), "a request did not return")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats",
                                    timeout=60) as r:
            check(r.status == 200, f"/v1/stats status {r.status}")
            stats = json.loads(r.read())
    finally:
        srv.stop()
    counts = {k.removeprefix("total_"): getattr(eng, k) - before[k]
              for k in MOE_COUNTERS}
    for r in out:
        toks = r["choices"][0]["token_ids"]
        check(len(toks) == max_tokens or r["choices"][0]["finish_reason"]
              == "stop", f"a stream ended after {len(toks)} tokens")
    per_tok = sorted((r["metrics"]["latency_ms"] - r["metrics"]["ttft_ms"])
                     / max(r["usage"]["completion_tokens"] - 1, 1)
                     for r in out)
    ttft = sorted(r["metrics"]["ttft_ms"] for r in out)
    return {"launches": launches, "counts": counts, "stats": stats,
            "wall_s": wall, "tokens": sum(r["usage"]["completion_tokens"]
                                          for r in out),
            "ttft_first_ms": out[0]["metrics"]["ttft_ms"],
            "ttft_p50_ms": ttft[len(ttft) // 2],
            "decode_ms_per_token_p50": per_tok[len(per_tok) // 2],
            "decode_tok_per_s_p50": 1e3 / per_tok[len(per_tok) // 2]}


def moe_kernels_against_plain(torch, qm, kernel, cfg, page_size: int,
                              card: str) -> dict:
    """Phase 16b's kernels at its shapes, before it serves: the paged
    kernel at ``cfg``'s heads and head_dim over pages of ``page_size`` (the
    engine's), bf16, at every window the engine issues, and the W8 and W4
    kernels at 8 rows over ``cfg``'s q/k/v/o projections, each against its
    plain version on the same inputs."""
    geom = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, page_size)
    out = {"paged_attention": kernel_against_plain(
        torch, qm["pa"], kernel, dtypes=(torch.bfloat16,), geom=geom)}
    H, D = cfg.hidden_size, cfg.head_dim
    projections = sorted({(H, cfg.num_heads * D), (H, cfg.num_kv_heads * D),
                          (cfg.num_heads * D, H)})
    out.update(matmul_kernels_against_plain(torch, qm, projections,
                                            row_counts=(8,)))
    print(f"{cfg.name} kernels vs plain: paged heads {geom[0]}/{geom[1]} "
          f"D={geom[2]} PS={geom[3]} T {PAGED_WINDOWS} bf16, matmuls "
          f"{projections} at 8 rows: max_abs_err "
          + "  ".join(f"{n} {e:.2e}" for n, e in out.items())
          + f" [{card}]", flush=True)
    return out


def serve_moe(torch, mods, mm, kernels: dict, card: str,
              page_size: int) -> dict:
    """Phase 16b: gpt-moe-8x1b at full width and depth (random bf16 weights
    from seed 0) through InferenceServer: the MOE_LENGTHS traffic plain,
    then with chunked prefill and n-gram speculation, then a short int8
    pass through the W8 kernels; every run recorded and replayed, and the
    paged kernel's launches (and W8's) against what the counters imply.
    The engines' pages are of ``page_size``, the geometry the kernels were
    checked at."""
    cfg = mods["get_model_config"](MOE_SERVE)
    L = cfg.num_layers
    t_init = time.time()
    model = mods["gpt"].init(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda",
                             dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    print(f"{MOE_SERVE}: {L} layers, H={cfg.hidden_size}, F={cfg.ffn_size}, "
          f"{cfg.moe.num_experts} experts, top-{cfg.moe.experts_per_token}, "
          f"capacity factor {cfg.moe.capacity_factor}; {nparams / 1e9:.4f}B "
          f"params ({model.weight_bytes() / 1e9:.3f} GB bf16) "
          f"random-initialised in {time.time() - t_init:.1f}s", flush=True)
    prompts = moe_prompts()
    runs = {}
    paged = kernels["paged_attention"]
    w8 = {"int8_matmul": kernels["int8_matmul"],
          "int8_matmul_ksplit": kernels["int8_matmul_ksplit"]}
    for name, over, reqs, toks in (
            ("plain", {}, prompts, MOE_TOKENS),
            ("features", MOE_FEATURES, prompts, MOE_TOKENS),
            ("int8", dict(quantization="int8", int8_pallas_matmul=True),
             prompts[4:8], 16)):
        scfg = mods["ServeConfig"](model=cfg.name, host="127.0.0.1", port=0,
                                   **over)
        srv = mods["InferenceServer"](cfg, scfg, params=model, seed=0)
        eng = srv.engine
        check(eng.kv.page_size == page_size, f"{name}: pages of "
              f"{eng.kv.page_size}, the kernels were checked at {page_size}")
        rec = CallRecorder(torch, mm)
        rec.install(eng)
        try:
            res = moe_traffic(torch, srv, reqs,
                              {"paged_attention": paged, **w8}, toks)
        finally:
            rec.remove()
        res["decode_step"] = ds = rec.decode_steps()
        c = res["counts"]
        check(res["stats"]["nonfinite_logits"] == 0,
              f"{name}: a logits tensor held NaN/inf")
        passes = (c["dispatched_steps"] + c["extend_prefills"]
                  + c["prefill_chunks"] + c["spec_dispatches"])
        got = res["launches"]["paged_attention"]
        print(f"{name}: paged kernel launches {got} = {L} layers x "
              f"({c['dispatched_steps']} decode steps + "
              f"{c['extend_prefills']} suffix prefills + "
              f"{c['prefill_chunks']} chunks + {c['spec_dispatches']} verify "
              f"windows); expected {L * passes}", flush=True)
        check(got == L * passes, f"{name}: paged launches {got} != "
              f"{L * passes}")
        if name == "int8":
            n_w8 = sum(res["launches"][k] for k in w8)
            want = 4 * L * c["dispatched_steps"]
            print(f"int8: W8 launches {res['launches']} = 4 projections "
                  f"(q, k, v, o; router and experts dequantized) x {L} x "
                  f"{c['dispatched_steps']} decode steps; expected {want}",
                  flush=True)
            check(n_w8 == want, f"int8: W8 launches {n_w8} != {want}")
        if name == "plain":
            check(c["extend_prefills"] >= 1 and c["prefix_cached_tokens"]
                  >= 256, "the shared-prefix request did not hit the cache")
        if name == "features":
            check(c["prefill_chunks"] >= 2 and c["spec_dispatches"] >= 1,
                  f"features: {c['prefill_chunks']} chunks, "
                  f"{c['spec_dispatches']} verify windows")
        kv = {k: getattr(eng.kv, k) for k in ("num_slots", "max_seq_len",
                                              "page_size", "num_pages",
                                              "dtype")}
        kv["quantized"] = eng.kv.quant_kind
        res["weight_bytes"] = eng.stats()["weight_bytes"]
        served = eng.params              # int8: the quantized copy
        eng.release()
        del srv, eng
        torch.cuda.empty_cache()
        res["drop_share"] = rec.drop_shares(8, cfg.moe.experts_per_token)
        res["replay"] = rp = moe_replay(torch, mm, served, cfg, kv, rec)
        del served, rec
        torch.cuda.empty_cache()
        dec = res["drop_share"].get("decode", {})
        print(f"{name}: {len(reqs)} requests, {res['tokens']} tokens in "
              f"{res['wall_s']:.2f} s; TTFT of request 0 alone "
              f"{res['ttft_first_ms']:.1f} ms, p50 {res['ttft_p50_ms']:.1f} "
              f"ms; decode p50 {res['decode_tok_per_s_p50']:.1f} tok/s a "
              f"request ({res['decode_ms_per_token_p50']:.1f} ms a token); "
              f"{c['decode_steps']} decode steps; a decode step alone "
              f"{ds['device_span_ms']:.2f} ms on the device timeline (p50 "
              f"{ds['device_span_ms_p50']:.2f} over {ds['dispatches']} "
              f"dispatches of {ds['steps']} steps), issued by the host in "
              f"{ds['host_issue_ms']:.2f} ms; traffic wall over decode steps "
              f"{res['wall_s'] * 1e3 / max(c['decode_steps'], 1):.1f} ms "
              f"(prefills included); choices dropped per decode step "
              f"{dec.get('mean', 0):.4f} of {8 * cfg.moe.experts_per_token} "
              f"a layer (max {dec.get('max', 0):.4f}; idle slots included), "
              f"other calls {res['drop_share'].get('other', {})}; weight "
              f"bytes {res['weight_bytes']} [{card}]", flush=True)
        print(f"{name}: replay of {rp['events']} forwards through the plain "
              f"paged attention with the engine's tokens, pad rows and "
              f"routing: {rp['positions']} positions, largest deficit "
              f"{rp['max_deficit']:.4f} (bound {2 * NEAR_TIE_DELTA}), "
              f"{rp['over_bound']} over; {rp['routing_rows_differing']} of "
              f"the routed rows of {rp['routing_calls']} calls would route "
              f"otherwise, the largest probability gap "
              f"{rp['max_routing_gap']:.2e} (limit {MOE_ROUTE_TIE}); control, "
              f"the previous call's routing: gap {rp['control_routing_gap']:.2e}"
              f" over {rp['control_calls']} calls (must exceed the limit)",
              flush=True)
        check(rp["over_bound"] == 0, f"{name}: {rp['over_bound']} tokens "
              f"lie over the near-tie bound under the replay")
        check(rp["max_routing_gap"] <= MOE_ROUTE_TIE,
              f"{name}: the replay routes a row otherwise by "
              f"{rp['max_routing_gap']:.3e} of probability")
        check(rp["control_routing_gap"] > MOE_ROUTE_TIE,
              f"{name}: the routing gate cannot fail: wrong routing reads a "
              f"gap of {rp['control_routing_gap']:.3e}, under the limit")
        runs[name] = res
    return {"runs": runs, "params": nparams, "cfg": cfg, "model": model}


def train_moe(torch, mods, mm, kernels: dict, card: str) -> dict:
    """Phase 16c: gpt-moe-1b at full width and depth through
    runtime/train_entry.py (flash kernels, fused AdamW, selective remat,
    synthetic data, S = 2048, micro-batch TRAIN_MICRO_BATCH): the loss
    finite, the kernels' launches as the code implies; then
    from one seeded state, MOE_REPEAT_STEPS kernel steps on one repeated
    batch (the loss falls) and the first of them against the same step
    through the plain attention and unfused AdamW."""
    import gc
    import logging
    import tempfile
    cfg = mods["get_model_config"](MOE_TRAIN)
    L = cfg.num_layers
    steps_log = []

    class Steps(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("step "):
                steps_log.append(record.args)
    handler = Steps()
    log = logging.getLogger("llmctl.engine")
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    run = {"model": {"name": MOE_TRAIN},
           "parallel": {"global_batch_size": TRAIN_MICRO_BATCH,
                        "activation_checkpoint": "selective"},
           "data": {"train": "synthetic", "val": "synthetic",
                    "max_length": 2048},
           "optimizer": {"scheduler": {"warmup_steps": 2}},
           "checkpoint": {"interval_steps": 10 ** 9},
           "training": {"log_interval": 1, "eval_interval": 10 ** 9}}
    try:
        with tempfile.TemporaryDirectory(prefix="llmctl-moe-") as tmp:
            run["checkpoint"]["path"] = tmp + "/ck"
            path = Path(tmp) / "run.json"
            path.write_text(json.dumps(run))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kn in kernels.values():
                kn.launches = 0                      # the main path starts
            t0 = time.time()
            rc = mm["train_entry"].main(
                ["--config", str(path), "--model", MOE_TRAIN,
                 "--max-steps", str(MOE_TRAIN_STEPS), "--no-resume"])
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {n: kn.launches for n, kn in kernels.items()}
            peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    check(rc == 0, f"train_entry exited {rc}")
    losses = [float(a[1]) for a in steps_log]
    rates = sorted(float(a[4]) for a in steps_log[1:])
    # the stream gives a new batch a step, and the warmup's first step has
    # lr 0: learning is checked on the repeated batch below
    check(len(losses) == MOE_TRAIN_STEPS, f"{len(losses)} logged steps")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    tok_s = rates[len(rates) // 2]
    peak_tflops = mods["load_run_config"](environ={}).hardware\
        .peak_bf16_tflops
    fpt = mods["flops_per_token"](cfg, 2048)
    mfu = tok_s * fpt / (peak_tflops * 1e12)
    nparams = cfg.param_count
    print(f"{MOE_TRAIN}: {L} layers, H={cfg.hidden_size}, F="
          f"{cfg.ffn_size}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.experts_per_token}, {nparams / 1e9:.4f}B params; "
          f"train_entry {MOE_TRAIN_STEPS} steps in {wall:.1f}s (init and "
          f"save included): loss {' '.join(f'{x:.4f}' for x in losses)}; "
          f"median over steps 2..{MOE_TRAIN_STEPS}: {tok_s:.0f} tok/s, MFU "
          f"{mfu:.1%} of {peak_tflops:.0f} TF/s over active parameters "
          f"({fpt / 1e9:.3f} GFLOP a token: 6 x the matmul parameters of "
          f"{cfg.moe.experts_per_token} experts + attention); peak "
          f"max_memory_allocated {peak:.2f} GB [{card}]", flush=True)
    # AdamW: the planned launches a step over the kernel-eligible leaves
    # (fp32 moments), the router and expert stacks among them
    shapes = mods["gpt"].GPT(cfg, device="meta").parameters()
    plan = mods["adamw_plan"]([
        (p.numel(), torch.float32, torch.float32) for p in shapes
        if p.dim() >= 2 and p.numel() >= mods["KERNEL_MIN_ELEMENTS"]])
    expected = {"flash_fwd": 2 * L * MOE_TRAIN_STEPS,
                "flash_bwd_dq": L * MOE_TRAIN_STEPS,
                "flash_bwd_dkv": L * MOE_TRAIN_STEPS,
                "adamw": len(plan) * MOE_TRAIN_STEPS}
    print(f"training launches {launches}; expected {expected} (per step: "
          f"flash fwd 2 x {L} layers under selective remat, dq and dkv "
          f"{L}, adamw {len(plan)} planned launch(es))", flush=True)
    for name, n in expected.items():
        check(launches[name] == n, f"{name} launches {launches[name]} != "
              f"{n}")
    gc.collect()
    torch.cuda.empty_cache()

    # one seeded state, one batch: the kernels' steps repeat it; the plain
    # step takes the first of them from the same state
    res = {}
    with tempfile.TemporaryDirectory(prefix="llmctl-moe-") as tmp:
        run["checkpoint"]["path"] = tmp
        cfg_run = mods["load_run_config"](cli_overrides=run, environ={})
        for label, attn, fused in (("kernels", "flash", True),
                                   ("plain", "xla", False)):
            cfg_run.training.attn_impl = attn
            cfg_run.optimizer.fused = fused
            e = mods["TrainingEngine"](cfg_run)
            e.init_state(seed=7)
            batch = e._device_batch(next(e.train_data))
            out = []
            for _ in range(MOE_REPEAT_STEPS if fused else 1):
                _, m = e.train_step(e.state, batch)
                out.append((float(m["loss"]), float(m["grad_norm"])))
            res[label] = out
            del e, batch
            gc.collect()
            torch.cuda.empty_cache()
    rep = [x for x, _ in res["kernels"]]
    check(all(np.isfinite(rep)) and rep[-1] < rep[0],
          f"the loss did not fall on a repeated batch: {rep}")
    (lk, gk), (lp, gp) = res["kernels"][0], res["plain"][0]
    d_loss, d_gn = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    print(f"{MOE_TRAIN} on one repeated batch: loss "
          f"{' '.join(f'{x:.4f}' for x in rep)}; first step kernels vs "
          f"plain: loss {lk:.5f} vs {lp:.5f} (rel {d_loss:.2e}), grad_norm "
          f"{gk:.4f} vs {gp:.4f} (rel {d_gn:.2e}), limit "
          f"{STEP_AGREEMENT:.0e} [{card}]", flush=True)
    check(d_loss <= STEP_AGREEMENT and d_gn <= STEP_AGREEMENT,
          "kernel and plain MoE steps disagree")
    return {"launches": launches, "losses": losses, "tokens_per_sec": tok_s,
            "mfu_active": mfu, "wall_s": wall, "peak_gb": peak,
            "repeated_batch": res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the measurements here (JSON)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAILED: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / PORT).is_dir():
        print(f"chip_smoke: FAILED: {PORT}/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import ServeConfig, get_model_config
    from distributed_llm_training_and_inference_system_tpu_torch.device \
        import device_report
    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import gpt
    from distributed_llm_training_and_inference_system_tpu_torch.ops import \
        build, paged_attention as pa
    from distributed_llm_training_and_inference_system_tpu_torch.ops.\
        paged_attention_cuda import paged_attention_kernel
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        import InferenceEngine, InferenceServer, kv_cache
    from distributed_llm_training_and_inference_system_tpu_torch.serve.\
        sampling import gumbel_noise
    from distributed_llm_training_and_inference_system_tpu_torch.serve.\
        decode import decode_step_forward
    from distributed_llm_training_and_inference_system_tpu_torch.config.\
        loader import load_run_config
    from distributed_llm_training_and_inference_system_tpu_torch.exec \
        import fused_update as fu
    from distributed_llm_training_and_inference_system_tpu_torch.ops import \
        attention as fa, attention_cuda as fac
    from distributed_llm_training_and_inference_system_tpu_torch.ops.\
        adamw_cuda import adamw_kernel, adamw_plan
    from distributed_llm_training_and_inference_system_tpu_torch.runtime.\
        engine import TrainingEngine
    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import layers
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        int4_matmul as w4, int8_matmul as w8, paged_attention_cuda as pac,
        quantization as tq, rmsnorm as rn)
    from distributed_llm_training_and_inference_system_tpu_torch.serve \
        import decode as sdecode, engine as sengine, speculative as sspec
    from distributed_llm_training_and_inference_system_tpu_torch.runtime \
        import train_entry
    qmods = {"pa": pa, "pac": pac, "w4": w4, "w8": w8, "tq": tq, "rn": rn,
             "layers": layers,
             "kernels": {
                 "paged_attention": paged_attention_kernel,
                 "paged_attention_int8": pac.paged_attention_int8_kernel,
                 "paged_attention_int4": pac.paged_attention_int4_kernel,
                 "int8_matmul": w8.int8_matmul_kernel,
                 "int8_matmul_ksplit": w8.int8_matmul_ksplit_kernel,
                 "int4_matmul": w4.int4_matmul_kernel,
                 "rmsnorm": rn.rmsnorm_kernel}}
    mods = {"ServeConfig": ServeConfig, "get_model_config": get_model_config,
            "gpt": gpt, "InferenceEngine": InferenceEngine,
            "InferenceServer": InferenceServer,
            "decode_step_forward": decode_step_forward,
            "load_run_config": load_run_config,
            "TrainingEngine": TrainingEngine,
            "KERNEL_MIN_ELEMENTS": fu.KERNEL_MIN_ELEMENTS,
            "adamw_plan": adamw_plan,
            "flops_per_token": gpt.flops_per_token,
            "kv_cache": kv_cache, "gumbel_noise": gumbel_noise}
    moe_mods = {"decode": sdecode, "engine": sengine, "speculative": sspec,
                "layers": layers, "kv_cache": kv_cache,
                "InferenceEngine": InferenceEngine,
                "train_entry": train_entry}
    train_kernels = {"flash_fwd": fac.flash_fwd,
                     "flash_bwd_dq": fac.flash_bwd_dq,
                     "flash_bwd_dkv": fac.flash_bwd_dkv,
                     "adamw": adamw_kernel}

    t0 = time.time()
    record: dict = {}
    try:
        phase("1 device", t0)
        smi = nvidia_smi_line()
        dev = device_report()
        print(f"card: {smi} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {dev['count']} device(s)", flush=True)
        check(dev["count"] >= 1, "no card")
        record["device"] = {"nvidia_smi": smi, **dev,
                            "torch": torch.__version__,
                            "cuda": torch.version.cuda}

        phase("2 build", t0)
        build_logs = build.build()
        for name, log in build_logs.items():
            print(f"built {name}: {build.library_path(name).name}")
            for line in log.splitlines():
                if "ptxas" in line or "error" in line.lower():
                    print("  " + line.strip())
        torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32

        phase("3 kernel against plain", t0)
        max_err = kernel_against_plain(torch, pa, paged_attention_kernel)

        phase("4 kernel timing", t0)
        timing = decode_timing(torch, F, pa, paged_attention_kernel,
                               build_logs.get("paged_attention", ""))

        phase("5 serve llama-8b-gqa at full width", t0)
        served = serve_main_path(torch, mods, paged_attention_kernel, smi)

        phase("6 paged against dense", t0)
        with torch.inference_mode():          # serving is gradient-free
            dense = paged_against_dense(torch, mods, served)
        # phase 13 quantizes from these weights: they wait on the host
        bf16_model = served.pop("params").to("cpu")
        served.pop("tokenizer", None)
        llama_cfg = served.pop("cfg")
        torch.cuda.empty_cache()

        phase("7 flash kernels against plain", t0)
        flash = flash_against_plain(torch, fa, fac)

        phase("8 adamw kernel against plain", t0)
        adamw_err = adamw_against_plain(torch, fu, adamw_kernel)

        phase("9 training kernel timing", t0)
        cfg1b = get_model_config("gpt-1b")
        train_timing = flash_timing(torch, F, fa, fac, cfg1b,
                                    TRAIN_MICRO_BATCH,
                                    build_logs.get("flash_attention", ""))
        train_timing["adamw"] = adamw_timing(torch, gpt, fu, adamw_kernel,
                                             cfg1b,
                                             build_logs.get("adamw", ""))

        phase("10 train gpt-1b at full width and depth", t0)
        trained = train_main_path(torch, mods, train_kernels, smi)

        phase("11 quantized kernels against plain", t0)
        quant_err = quant_kernels_against_plain(torch, qmods)

        phase("12 quantized kernel timing", t0)
        quant_timing = quant_kernel_timing(
            torch, F, qmods, build_logs.get("int4_matmul", ""),
            build_logs.get("paged_attention", ""),
            build_logs.get("int8_matmul", ""),
            build_logs.get("rmsnorm", ""))

        phase("13 serve quantized llama-8b-gqa at full width and depth", t0)
        bf16_model = bf16_model.to("cuda")
        quant_served = {
            name: serve_quantized(torch, mods, qmods, llama_cfg, bf16_model,
                                  name, smi, **settings)
            for name, settings in QUANT_CONFIGS.items()}

        # numbered 15, run while phase 5's weights are still on the card
        phase("15 serve llama-8b-gqa with swap preemption, chunked prefill "
              "and n-gram speculation", t0)
        t15 = time.time()
        features = serve_features(torch, mods, paged_attention_kernel,
                                  bf16_model, llama_cfg, smi,
                                  dense["max_abs_diff"])
        features["seconds"] = time.time() - t15
        print(f"phase 15 took {features['seconds']:.1f} s", flush=True)
        del bf16_model
        torch.cuda.empty_cache()

        phase("14 RMSNorm on the entry forward", t0)
        norm_path = rmsnorm_on_entry(torch, gpt, qmods)

        phase("16 the MoE family: moe_block, gpt-moe-8x1b served, "
              "gpt-moe-1b trained", t0)
        t16 = time.time()
        moe_cfg = get_model_config(MOE_SERVE)
        moe_pages = ServeConfig(model=MOE_SERVE).kv_block_size
        moe = {"block": moe_block_against_cpu(torch, layers, moe_cfg, smi),
               "kernels": moe_kernels_against_plain(
                   torch, qmods, paged_attention_kernel, moe_cfg, moe_pages,
                   smi)}
        moe_served = serve_moe(torch, mods, moe_mods,
                               {**qmods["kernels"],
                                "paged_attention": paged_attention_kernel},
                               smi, moe_pages)
        moe_served.pop("model")
        moe_served.pop("cfg")
        moe["serve"] = moe_served
        torch.cuda.empty_cache()
        moe["train"] = train_moe(torch, mods, moe_mods, train_kernels, smi)
        moe["seconds"] = time.time() - t16
        print(f"phase 16 took {moe['seconds']:.1f} s", flush=True)
    except (SmokeFailure, RuntimeError, ValueError, OSError,
            subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    src = f"{PORT}/csrc/"
    jax_pkg = "distributed_llm_training_and_inference_system_tpu/"
    replaces = {"flash_fwd": "ops/attention.py:92",
                "flash_bwd_dq": "ops/attention.py:186",
                "flash_bwd_dkv": "ops/attention.py:219",
                "adamw": "exec/fused_update.py:55"}
    errors = dict(flash["max_abs_err"], adamw=adamw_err)
    train_records = []
    moe_runs = moe["serve"]["runs"].values()
    for name, where in replaces.items():
        tm = train_timing[name]
        train_records.append({
            "name": name, "route": "cuda",
            "source": src + ("adamw.cu" if name == "adamw"
                             else "flash_attention.cu"),
            "replaces": jax_pkg + where,
            "launches": (trained["launches"][name]
                         + moe["train"]["launches"][name]),
            "max_abs_err": errors[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})

    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": f"{PORT}/csrc/paged_attention.cu",
        "replaces": "distributed_llm_training_and_inference_system_tpu/ops/"
                    "paged_attention_pallas.py:47",
        "launches": (served["launches"] + features["launches"]
                     + sum(r["launches"]["paged_attention"]
                           for r in moe_runs)),
        "max_abs_err": max(max_err, moe["kernels"]["paged_attention"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }] + train_records
    quant_replaces = {
        "paged_attention_int8": ("paged_attention.cu",
                                 "ops/paged_attention_pallas.py:47"),
        "paged_attention_int4": ("paged_attention.cu",
                                 "ops/paged_attention_pallas.py:47"),
        "int4_matmul": ("int4_matmul.cu", "ops/int4_matmul_pallas.py:45"),
        "int8_matmul": ("int8_matmul.cu", "ops/int8_matmul_pallas.py:44"),
        "int8_matmul_ksplit": ("int8_matmul.cu",
                               "ops/int8_matmul_pallas.py:54"),
        "rmsnorm": ("rmsnorm.cu", "ops/rmsnorm.py:20")}
    quant_launches = {"rmsnorm": norm_path["launches"]}
    for res in [*quant_served.values(), moe["serve"]["runs"]["int8"]]:
        for name, n in res["launches"].items():
            if name in quant_replaces and n:
                quant_launches[name] = quant_launches.get(name, 0) + n
    for name, (source, where) in quant_replaces.items():
        tm = quant_timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": jax_pkg + where,
            "launches": quant_launches.get(name, 0),
            "max_abs_err": max(quant_err[name],
                               moe["kernels"].get(name, 0.0)),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched on its "
              f"main path")
    if args.out:
        record.update(quant_max_abs_err=quant_err, quant_timing=quant_timing,
                      serve_quantized=quant_served, rmsnorm_path=norm_path,
                      serve_features=features, moe=moe)
        record.update(kernels=kernels, timing=timing, serve=served,
                      paged_vs_dense=dense, flash_vs_plain=flash,
                      adamw_max_abs_err=adamw_err, train_timing=train_timing,
                      train=trained, seconds=time.time() - t0)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    print(f"== done in {time.time() - t0:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
