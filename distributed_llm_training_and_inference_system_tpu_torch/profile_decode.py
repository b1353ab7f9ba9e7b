"""Where a decode step's time goes, on the card.

    python -m distributed_llm_training_and_inference_system_tpu_torch.profile_decode \
        [--model llama-8b-gqa] [--slots 8] [--steps 24] [--out profile.json]
        [--quantization int8|int4] [--kv-quantization int8|int4]
        [--int8-kernel]

Builds the serving engine at full width (random bf16 weights from seed 0,
default ServeConfig but for the quantization settings: ``--int8-kernel``
is ``int8_pallas_matmul``, the W8 kernels in place of the dequant route),
admits one greedy request per slot with prompts of
64-2000 tokens, runs until every slot decodes, then measures decode
dispatches: wall time per step (host clock around work that ends in a
synchronise, profiler off) and, in a second window under
``torch.profiler`` (CUDA activity only), device time by kernel. The
device's idle share is 1 - device time / unprofiled wall time. Prints a
table and one JSON line; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .config import ServeConfig, get_model_config
from .profiling import device_breakdown, print_breakdown
from .serve import InferenceEngine, Request, SamplingParams

PROMPTS = (2000, 64, 1500, 300, 1200, 128, 700, 900)
KERNELS = ((("paged_attention",), "paged_attention kernel"),
           (("int8_matmul",), "int8_matmul kernels"),
           (("int4_matmul",), "int4_matmul kernel"),
           (("sort", "radix"), "sort (sampling)"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-8b-gqa")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--steps", type=int, default=24,
                    help="decode steps measured (multiple of 8)")
    ap.add_argument("--quantization", default="none",
                    choices=("none", "int8", "int4"))
    ap.add_argument("--kv-quantization", default="none",
                    choices=("none", "int8", "int4"))
    ap.add_argument("--int8-kernel", action="store_true",
                    help="int8 weights through the W8 kernels")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA card")

    cfg = get_model_config(args.model)
    scfg = ServeConfig(model=cfg.name, max_batch_size=args.slots,
                       quantization=args.quantization,
                       kv_quantization=args.kv_quantization,
                       int8_pallas_matmul=args.int8_kernel)
    eng = InferenceEngine(cfg, scfg, seed=0)
    K = scfg.decode_steps_per_dispatch
    # outlives the admission steps (which decode too) and both windows
    budget = 4 * args.steps + 8 * K
    for i in range(args.slots):
        n = min(PROMPTS[i % len(PROMPTS)], scfg.max_seq_len - budget)
        ok = eng.scheduler.add_request(Request(
            request_id=f"p{i}",
            prompt_tokens=[(7 * i + 13 * t) % 250 for t in range(n)],
            sampling=SamplingParams(temperature=0.0, max_tokens=budget)))
        if not ok:
            raise SystemExit(f"profile_decode: request {i} refused")
    for _ in range(4 * args.slots):                # admissions + prefills
        if not eng.scheduler.queue_depth and eng.active.all():
            break
        eng.step()
    else:
        raise SystemExit("profile_decode: slots did not fill")
    eng.step()                                     # warm the decode path
    torch.cuda.synchronize()

    n_disp = max(args.steps // K, 1)
    t0 = time.perf_counter()
    for _ in range(n_disp):
        eng.step()
    eng._drain_pending()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (n_disp * K)
    lengths = [int(p) for p in eng.positions]

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(n_disp):
            eng.step()
        eng._drain_pending()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    steps = n_disp * K
    by_cat, top = device_breakdown(prof, steps, KERNELS)
    device_ms = sum(by_cat.values())
    if not eng.active.all():
        raise SystemExit("profile_decode: a request ended inside the window")
    res = {
        "model": cfg.name, "slots": args.slots, "steps": steps,
        "quantization": args.quantization,
        "kv_quantization": args.kv_quantization,
        "int8_kernel": args.int8_kernel,
        "weight_bytes": eng.stats()["weight_bytes"],
        "kv_hbm_bytes": eng.kv.hbm_bytes(),
        "context_lengths": lengths,
        "card": torch.cuda.get_device_name(0),
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms / steps,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_ms_per_step_by_category": by_cat,
        "top_kernels": top,
    }
    print(f"{cfg.name} (weights {args.quantization}, kv "
          f"{args.kv_quantization}), {args.slots} slots, contexts {lengths}: "
          f"{wall_ms:.2f} ms/step wall ({1e3 / wall_ms * args.slots:.1f} "
          f"tok/s), device busy {device_ms:.2f} ms/step, idle share "
          f"{res['device_idle_share']:.1%}")
    print_breakdown(by_cat, top)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    eng.release()


if __name__ == "__main__":
    main()
