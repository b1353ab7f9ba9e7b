"""Where a training step's time goes, on the card.

    python -m distributed_llm_training_and_inference_system_tpu_torch.profile_train \
        [--model gpt-1b] [--micro-batch 4] [--steps 4] [--out profile.json]

Builds the ``TrainingEngine`` at full width and depth (random fp32 masters,
synthetic data, S=2048, the default fused AdamW and selective remat), takes
two warm-up steps, then measures steps: wall time per step (host clock
around work that ends in a synchronise, profiler off) and, in a second
window under ``torch.profiler`` (CUDA activity only), device time by
kernel. The device's idle share is 1 - device time / unprofiled wall time.
The chunked loss (LM head and cross-entropy, forward and backward) is also
timed alone with CUDA events at the same shape; its head products are
matmuls, so that time is inside the matmul share. Prints a table and one
JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from .config.loader import load_run_config
from .models.gpt import flops_per_token
from .models.loss import chunked_next_token_loss
from .profiling import device_breakdown, print_breakdown
from .runtime.engine import TrainingEngine

KERNELS = ((("flash_fwd",), "flash forward kernel"),
           (("flash_bwd",), "flash backward kernels"),
           (("adamw_kernel",), "adamw kernel"))


def _loss_ms(engine, batch, iters: int = 5) -> float:
    """Device ms of the chunked loss, forward and backward, on random
    final-normed hidden states of the step's shape."""
    model, cfg = engine.state.model, engine.cfg.model
    tokens = batch["tokens"]
    hidden = torch.randn(*tokens.shape, cfg.hidden_size, device=tokens.device,
                         dtype=getattr(torch, cfg.dtype), requires_grad=True)
    head = model.embed if cfg.tie_word_embeddings else model.lm_head

    def run():
        loss, _ = chunked_next_token_loss(hidden, head, tokens,
                                          batch.get("segment_ids"),
                                          tied=cfg.tie_word_embeddings)
        torch.autograd.grad(loss, (hidden, head))
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt-1b")
    ap.add_argument("--micro-batch", type=int, default=4,
                    help="sequences of --seq-len per step")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")

    with tempfile.TemporaryDirectory(prefix="llmctl-profile-") as ckdir:
        cfg = load_run_config(cli_overrides={
            "model": {"name": args.model},
            "parallel": {"global_batch_size": args.micro_batch},
            "data": {"max_length": args.seq_len},
            "checkpoint": {"path": ckdir}}, environ={})
        engine = TrainingEngine(cfg)
        engine.initialize(resume=False)

        def steps(n):
            for _ in range(n):
                batch = engine._device_batch(next(engine.train_data))
                engine.state, metrics = engine.train_step(engine.state,
                                                          batch)
            return batch, metrics

        steps(2)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batch, metrics = steps(args.steps)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps(args.steps)
            torch.cuda.synchronize()
        by_cat, top = device_breakdown(prof, args.steps, KERNELS)
        loss_ms = _loss_ms(engine, batch)

    device_ms = sum(by_cat.values())
    tokens = args.micro_batch * args.seq_len
    tok_s = tokens / (wall_ms / 1e3)
    res = {
        "model": cfg.model.name, "micro_batch": args.micro_batch,
        "seq_len": args.seq_len, "steps": args.steps,
        "card": torch.cuda.get_device_name(0), "loss": loss,
        "wall_ms_per_step": wall_ms, "tokens_per_sec": tok_s,
        "mfu": tok_s * flops_per_token(cfg.model, args.seq_len)
        / (cfg.hardware.peak_bf16_tflops * 1e12),
        "peak_memory_allocated_gb": peak_gb,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_ms_per_step_by_category": by_cat,
        "chunked_loss_fwd_bwd_ms": loss_ms,
        "top_kernels": top,
    }
    print(f"{cfg.model.name}, micro-batch {args.micro_batch} x "
          f"{args.seq_len}: {wall_ms:.1f} ms/step wall ({tok_s:.0f} tok/s, "
          f"MFU {res['mfu']:.1%}), device busy {device_ms:.1f} ms/step, idle "
          f"share {res['device_idle_share']:.1%}, peak "
          f"max_memory_allocated {peak_gb:.2f} GB")
    print_breakdown(by_cat, top)
    print(f"  chunked loss alone (fwd + bwd, head products included) "
          f"{loss_ms:.2f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
