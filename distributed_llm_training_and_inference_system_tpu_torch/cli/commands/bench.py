"""`llmctl-torch bench` — benchmarks (the JAX package's ``bench kernels``,
``e2e``, ``kv-decode``, ``dataloader`` and ``battery``), with the JAX
command's options and JSON keys, on the global ``--device``.

- ``kernels``: a bf16 matmul, the plain masked attention
  (``attention_xla``) and on a card the flash kernels
  (``attention_flash``, ``ops/attention.flash_attention``), RMSNorm and
  rope of ``models/layers.py``; ``utils/timing.time_fn`` (CUDA events on a
  card).
- ``e2e``: ``train`` steps of ``exec/train_step.py`` (flash kernels on a
  card), ``serve`` through ``InferenceEngine.generate``, and the single
  engine's ``serve-load`` sweeps through ``serve/loadgen.py`` (Poisson and
  closed loop, ``--device-times``, quantized weights and pages, an
  artifact). On a card, as the JAX command does on a TPU: bf16, pages of
  64 and the flash kernels. With ``--serve-replicas > 1`` each sweep
  point is an in-process ``ServeFleet`` (``--serve-disagg`` splits it into
  prefill and decode roles, ``--serve-courier-chaos`` seeds chunk faults,
  ``--serve-courier-codec`` picks the wire codec, ``--serve-stream``
  streams, ``--serve-max-retries`` honours 429s), and
  ``--serve-long-prompts`` adds the JAX command's pipelined-prefill A/B,
  ``--serve-returning N`` its returning-conversation A/B (the fleet KV
  store on and off, the pool sized so the filler must evict the
  histories), and ``--serve-scenario`` its scenario matrix (autoscale on
  and off over one seeded plan, ``--serve-ttft-target-ms`` the
  interactive class's target).
- ``kv-decode``: one layer's paged attention plus the KV append a step,
  over fp, int8 and int4 pages (on a card through
  ``csrc/paged_attention.cu``), with the traffic and capacity ledgers, and
  the JAX command's courier wire-codec A/B: one activation-shaped page
  payload of each kind through the courier's encoder and reassembler
  under each codec (host work).
- ``dataloader``: dataset throughput, and the prefetch loader's stall
  under a simulated step.
- ``battery``: a TOML/JSON list of commands run with per-item timeouts,
  resume and dry run, holding an ``flock`` on ``--chip-lock``; before each
  item it probes for a CUDA card in a child process.
- ``comms``: every collective pattern of ``comms/bench.py`` over
  ``--devices`` ranks (children of this command line through
  ``runtime.launcher.launch_ranks``; each rank takes its own card where
  there are enough, else they share card 0 and move their collectives over
  gloo through host memory). Rank 0 prints the rows; each names its
  ``backend`` and marks gloo figures ``host_staged``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ...device import resolve_device
from ...utils.timing import time_fn
from ..main import CommandError


def _bool(sub, name: str, default: bool, **kw) -> None:
    sub.add_argument(name, default=default,
                     action=argparse.BooleanOptionalAction, **kw)


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Benchmarks "
                                 "(kernels, end-to-end, dataloader).")
    sub = ap.add_subparsers(
        dest="sub",
        metavar="{kernels,e2e,kv-decode,comms,dataloader,battery}")

    ke = sub.add_parser("kernels", help="Micro-benchmark core ops.")
    ke.add_argument("--op", default="all",
                    choices=["attention", "flash", "matmul", "rmsnorm",
                             "rope", "all"])
    ke.add_argument("--seq-len", default=1024, type=int)
    ke.add_argument("--hidden", default=1024, type=int)
    ke.add_argument("--heads", default=8, type=int)
    ke.add_argument("--batch", default=4, type=int)

    e = sub.add_parser("e2e", help="End-to-end train step throughput / "
                                   "serve TTFT and throughput.")
    e.add_argument("--model", dest="model_name", default="gpt-test")
    e.add_argument("--mode", default="train",
                   choices=["train", "serve", "serve-load", "both"])
    e.add_argument("--steps", default=10, type=int)
    e.add_argument("--batch", default=4, type=int)
    e.add_argument("--seq-len", default=None, type=int)
    e.add_argument("--prompt-len", default=128, type=int)
    e.add_argument("--gen-len", default=64, type=int)
    e.add_argument("--requests", default=8, type=int)
    e.add_argument("--rps", default="2,8,32",
                   help="serve-load: comma-separated offered requests/sec "
                        "sweep.")
    e.add_argument("--concurrency", default="4,16,64",
                   help="serve-load: comma-separated closed-loop sweep.")
    e.add_argument("--admission", default="ondemand",
                   choices=["ondemand", "reserve"])
    e.add_argument("--preemption", default="recompute",
                   choices=["recompute", "swap"])
    e.add_argument("--kv-blocks", default=0, type=int,
                   help="serve-load: fixed KV pool size (0 = auto).")
    _bool(e, "--device-times", True,
          help="serve-load: calibrate on-device prefill/decode times and "
               "report ttft_device_ms.")
    e.add_argument("--latency-dispatch-steps", default=0, type=int)
    e.add_argument("--artifact", default="",
                   help="serve-load: checkpoint dir or `export` file.")
    e.add_argument("--quant", default="none",
                   choices=["none", "int8", "int4", "int4-awq"])
    e.add_argument("--kv-quant", "--serve-kv-quant", dest="kv_quant",
                   default="none", choices=["none", "fp", "int8", "int4"],
                   help="serve-load: KV page quantization ('fp' = none).")
    e.add_argument("--slots", default=0, type=int,
                   help="serve-load: decode slots (0 = from --requests, "
                        "capped at 16).")
    _bool(e, "--pipelined", True,
          help="serve-load: pipelined decode dispatch.")
    _bool(e, "--int8-pallas", False,
          help="serve-load: int8 decode matmuls through the W8A16 kernels.")
    e.add_argument("--serve-hot-prefix", default=0, type=int,
                   help="serve-load: every prompt shares a hot prefix of "
                        "this many tokens (the engine's prefix cache).")
    fleet = e.add_argument_group("fleet options")
    fleet.add_argument("--serve-max-retries", default=0, type=int)
    fleet.add_argument("--serve-replicas", default=1, type=int)
    _bool(fleet, "--serve-disagg", False)
    fleet.add_argument("--serve-courier-chaos", default=0.0, type=float)
    fleet.add_argument("--serve-courier-codec", default="none",
                       choices=["none", "zlib", "delta-zlib"])
    fleet.add_argument("--serve-courier-zlib-level", default=-1, type=int)
    fleet.add_argument("--serve-returning", default=0, type=int)
    fleet.add_argument("--serve-returning-history", default=96, type=int)
    fleet.add_argument("--serve-long-prompts", default=0, type=int)
    fleet.add_argument("--serve-long-prompt-len", default=384, type=int)
    fleet.add_argument("--serve-scenario", default="")
    fleet.add_argument("--serve-scenario-duration", default=10.0,
                       type=float)
    fleet.add_argument("--serve-scenario-base-rps", default=3.0, type=float)
    fleet.add_argument("--serve-scenario-peak-rps", default=12.0,
                       type=float)
    fleet.add_argument("--serve-ttft-target-ms", default=2000.0, type=float)
    _bool(fleet, "--serve-stream", False)

    kv = sub.add_parser("kv-decode", help="Quantized-KV decode A/B.")
    kv.add_argument("--slots", default=16, type=int,
                    help="Decode slots (batch rows).")
    kv.add_argument("--kv-heads", default=32, type=int)
    kv.add_argument("--head-dim", default=128, type=int)
    kv.add_argument("--q-heads", default=0, type=int,
                    help="Query heads (0 = same as --kv-heads).")
    kv.add_argument("--page-size", default=64, type=int)
    kv.add_argument("--context", default=512, type=int,
                    help="Live tokens per slot at measurement.")
    kv.add_argument("--layers", default=32, type=int,
                    help="Layer count for the per-model ledgers (the timed "
                         "step runs ONE layer).")
    kv.add_argument("--steps", default=50, type=int)
    kv.add_argument("--write-mode", default="paged",
                    choices=["paged", "scatter"],
                    help="KV append path: window write vs per-row scatter.")

    co = sub.add_parser("comms", help="Measure real collectives over a "
                                      "mesh of ranks.")
    co.add_argument("--pattern", default="all",
                    choices=["allreduce", "all_gather", "reduce_scatter",
                             "ppermute", "all_to_all", "all"])
    co.add_argument("--size-mb", default=16.0, type=float)
    co.add_argument("--devices", dest="n_devices", default=None, type=int,
                    help="Mesh size (default: all cards).")

    dl = sub.add_parser("dataloader", help="Dataset streaming throughput "
                                           "and stall.")
    dl.add_argument("--path", default="synthetic",
                    help="'synthetic', a shard dir, or a scheme:// URI.")
    dl.add_argument("--batch", default=8, type=int)
    dl.add_argument("--seq-len", default=1024, type=int)
    dl.add_argument("--batches", default=50, type=int)
    dl.add_argument("--prefetch", default=0, type=int,
                    help="PrefetchLoader depth (0 = synchronous).")
    dl.add_argument("--workers", default=2, type=int,
                    help="Remote shard download pool size.")
    dl.add_argument("--step-ms", default=0.0, type=float,
                    help="Simulated device step between fetches.")

    ba = sub.add_parser("battery", help="Run a listed measurement battery.")
    ba.add_argument("--spec", required=True,
                    help="TOML/JSON listing [[item]] entries with name, "
                         "cmd, timeout.")
    ba.add_argument("--out", dest="out_dir", default="battery_results")
    _bool(ba, "--resume", True,
          help="Skip items whose log already records rc=0.")
    _bool(ba, "--wait-for-chip", True,
          help="Probe until a CUDA card answers before each item.")
    ba.add_argument("--probe-interval", default=420, type=int)
    ba.add_argument("--max-probes", default=200, type=int)
    ba.add_argument("--guard", dest="tpu_guard", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="--no-guard runs items without requiring a card.")
    ba.add_argument("--dry-run", action="store_true", default=False)
    ba.add_argument("--chip-lock",
                    default=os.path.join(tempfile.gettempdir(),
                                         "llmctl_chip.lock"),
                    help="flock() this path for the battery ('' "
                         "disables).")
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch bench").print_help()
        return 0
    if args.sub == "comms":
        return comms(args)
    if args.sub == "battery":
        return battery(args)
    if args.sub == "dataloader":
        return dataloader(args)
    device = resolve_device(args.root.device)
    if args.sub == "kernels":
        results = kernels(args, device)
    elif args.sub == "e2e":
        results = e2e(args, device)
    else:
        results = kv_decode(args, device)
    print(json.dumps(results, indent=2))
    return 0


# -- comms -------------------------------------------------------------------

def rank_mesh(args, n: int):
    """On a rank of ``launch_ranks``: join the group of ``n`` ranks and
    return the one-axis mesh ("dp") over them."""
    from ...config.schema import ParallelConfig
    from ...parallel.mesh import build_mesh, init_distributed, rank_device
    device = rank_device(resolve_device(args.root.device), n)
    init_distributed(device)
    return build_mesh(ParallelConfig(data_parallel=n), device)


def comm_ranks(args) -> int:
    """The ranks a collective command runs on: ``--devices``, else every
    card (one on the CPU)."""
    n = args.n_devices
    if n is None:
        n = (torch.cuda.device_count()
             if resolve_device(args.root.device).type == "cuda" else 1)
    if n < 2:
        raise CommandError(
            "need >=2 ranks for collectives: pass --devices N (ranks share "
            "a card, or the CPU, over gloo where there are fewer cards)")
    return n


def comms(args) -> int:
    """Measure the collectives over a mesh of ranks."""
    from ...comms.bench import bench_all, bench_collective
    from ...runtime.launcher import launch_ranks, this_rank

    n = comm_ranks(args)
    if this_rank() is None:
        return launch_ranks(args.argv, n)
    mesh = rank_mesh(args, n)
    if args.pattern == "all":
        rows = bench_all(mesh, "dp", args.size_mb)
    else:
        rows = [bench_collective(mesh, "dp", args.pattern, args.size_mb)]
    if mesh.rank == 0:
        print(json.dumps(rows, indent=2))
    return 0


# -- kernels -----------------------------------------------------------------

def kernels(args, device: torch.device) -> dict:
    """Micro-benchmark core ops; {op: {"time_ms": ...}}."""
    from ...models import layers

    op, S, H, N, B = args.op, args.seq_len, args.hidden, args.heads, args.batch
    D = H // N
    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    results = {}

    def timed(fn, *xs):
        return time_fn(fn, *xs, device=device)

    if op in ("matmul", "all"):
        a = torch.randn((S * B, H), generator=gen, device=device, dtype=bf16)
        w = torch.randn((H, H), generator=gen, device=device, dtype=bf16)
        sec = timed(lambda x, y: x @ y, a, w)
        results["matmul"] = {"time_ms": sec * 1e3,
                             "tflops": 2 * a.shape[0] * H * H / sec / 1e12}

    if op in ("attention", "flash", "all"):
        q, k, v = (torch.randn((B, S, N, D), generator=gen, device=device,
                               dtype=bf16) for _ in range(3))
        pos = torch.arange(S, dtype=torch.int32,
                           device=device)[None].expand(B, S)
        mask = layers.attention_mask(pos, pos)
        sec = timed(lambda q, k, v: layers.dot_product_attention(
            q, k, v, mask), q, k, v)
        results["attention_xla"] = {"time_ms": sec * 1e3}
        if device.type == "cuda" and op in ("flash", "all"):
            from ...ops.attention import flash_attention
            sec_f = timed(lambda q, k, v: flash_attention(
                q, k, v, causal=True), q, k, v)
            results["attention_flash"] = {"time_ms": sec_f * 1e3,
                                          "speedup_vs_xla": sec / sec_f}

    if op in ("rmsnorm", "all"):
        x = torch.randn((B, S, H), generator=gen, device=device, dtype=bf16)
        s = torch.zeros((H,), device=device, dtype=bf16)
        sec = timed(lambda x, s: layers.rms_norm(x, s), x, s)
        results["rmsnorm"] = {"time_ms": sec * 1e3}

    if op in ("rope", "all"):
        x = torch.randn((B, S, N, D), generator=gen, device=device,
                        dtype=bf16)
        pos = torch.arange(S, dtype=torch.int32,
                           device=device)[None].expand(B, S)
        freqs = layers.rope_frequencies(D, device=device)
        sec = timed(lambda x, p: layers.apply_rope(x, p, freqs), x, pos)
        results["rope"] = {"time_ms": sec * 1e3}
    return results


# -- e2e ---------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_counters(eng) -> None:
    """Zero every counter the sweep point's stats derive from, after its
    warm-up request."""
    eng.total_prefill_tokens = 0
    eng.total_decode_steps = 0
    eng.total_padded_slot_steps = 0
    eng.total_short_dispatches = 0
    eng.total_dispatched_steps = 0
    eng.total_extend_prefills = 0
    eng.total_prefill_chunks = 0


def _release(eng, device: torch.device) -> None:
    eng.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def engine_counters(eng) -> dict:
    """The JAX command's engine counters of a sweep point, and the port's
    dispatched steps, suffix prefills and chunks (the paged kernel runs
    once a layer for each)."""
    st = eng.stats()
    keys = ("short_dispatches", "decode_steps", "padded_slot_steps",
            "prefill_tokens", "preemptions", "requeue_cached_tokens",
            "prefix_cached_tokens", "prefix_fetched_tokens",
            "dispatched_steps", "extend_prefills", "prefill_chunks")
    agg = {k: st.get(k) or 0 for k in keys}
    B = eng.serve_cfg.max_batch_size
    agg["decode_slot_utilization"] = round(
        1.0 - agg["padded_slot_steps"] / max(agg["decode_steps"] * B, 1), 4)
    return agg


def _train(args, cfg, device, seq_len: int) -> dict:
    from ...config.schema import OptimizerConfig, ParallelConfig
    from ...exec.train_step import TrainState, make_train_step
    from ...models import gpt

    B = args.batch
    par = ParallelConfig(micro_batch_size=B, global_batch_size=B,
                         activation_checkpoint="selective")
    step_fn, opt_init, _ = make_train_step(
        cfg, OptimizerConfig(lr=1e-4), par,
        attn_impl="flash" if device.type == "cuda" else "xla")
    gen = torch.Generator(device=device).manual_seed(0)
    state = TrainState.create(gpt.init(cfg, gen, device=device), opt_init)
    batch = {"tokens": torch.ones((B, seq_len), dtype=torch.int64,
                                  device=device)}
    state, metrics = step_fn(state, batch)            # warm-up
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step_fn(state, batch)
    float(metrics["loss"])                            # waits for the card
    dt = time.perf_counter() - t0
    tok_s = args.steps * B * seq_len / dt
    return {"tokens_per_sec": tok_s, "step_ms": dt / args.steps * 1e3,
            "model_tflops_per_sec":
                tok_s * gpt.flops_per_token(cfg, seq_len) / 1e12}


def _serve(args, cfg, device, on_card: bool) -> dict:
    from ...config.schema import ServeConfig
    from ...serve import InferenceEngine, SamplingParams

    eng = InferenceEngine(cfg, ServeConfig(
        model=args.model_name, max_batch_size=min(args.requests, 8),
        max_seq_len=min(args.prompt_len + args.gen_len + 16,
                        cfg.max_position_embeddings),
        kv_block_size=64 if on_card else 16,
        dtype="bfloat16" if on_card else "float32"), device=device)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=args.prompt_len)]
               for _ in range(args.requests)]
    eng.generate([prompts[0]], SamplingParams(temperature=0.0, max_tokens=2))
    t0 = time.perf_counter()
    reqs = eng.generate(prompts, SamplingParams(temperature=0.0,
                                                max_tokens=args.gen_len))
    dt = time.perf_counter() - t0
    ttfts = sorted(r.ttft_ms for r in reqs)
    total_tokens = sum(len(r.generated_tokens) for r in reqs)
    _release(eng, device)
    return {"p50_ttft_ms": ttfts[len(ttfts) // 2], "p99_ttft_ms": ttfts[-1],
            "tokens_per_sec": total_tokens / dt, "requests": args.requests}


def _fleet_counters(fleet) -> dict:
    """engine_counters summed over a fleet's replicas."""
    per = [engine_counters(r.engine) for r in fleet.replicas]
    agg = {k: sum(p[k] for p in per) for k in per[0]
           if k != "decode_slot_utilization"}
    B = fleet.replicas[0].engine.serve_cfg.max_batch_size
    agg["decode_slot_utilization"] = round(
        1.0 - agg["padded_slot_steps"] / max(agg["decode_steps"] * B, 1), 4)
    return agg


def _drop(target, device: torch.device) -> None:
    """Release a sweep point's engine or shut down its fleet."""
    if hasattr(target, "router"):
        target.shutdown()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    else:
        _release(target, device)


def _serve_load(args, cfg, device, on_card: bool) -> dict:
    from ...config.schema import FleetConfig, ServeConfig
    from ...serve import InferenceEngine, SamplingParams
    from ...serve.fleet import FaultPlan, ServeFleet
    from ...serve.loadgen import run_closed_loop, run_poisson

    def point_serve_cfg():
        return ServeConfig(
            model=args.model_name,
            max_batch_size=args.slots or min(max(args.requests, 8), 16),
            max_seq_len=min(args.prompt_len + args.gen_len + 16,
                            cfg.max_position_embeddings),
            kv_block_size=64 if on_card else 16,
            kv_num_blocks=args.kv_blocks,
            admission=args.admission, preemption=args.preemption,
            latency_dispatch_steps=args.latency_dispatch_steps,
            pipelined_decode=args.pipelined,
            int8_pallas_matmul=args.int8_pallas,
            artifact=args.artifact, quantization=args.quant,
            kv_quantization="none" if args.kv_quant == "fp"
            else args.kv_quant,
            dtype="bfloat16" if on_card else "float32")

    def warm(eng, lengths=(args.prompt_len,)):
        for n in lengths:
            eng.generate([list(range(1, n + 1))],
                         SamplingParams(temperature=0.0, max_tokens=2))
        _reset_counters(eng)

    def warmed_fleet():
        """A sweep point's fleet: each replica warmed before its thread
        starts, counters zeroed, then live."""
        fc = dict(replicas=args.serve_replicas,
                  courier_codec=args.serve_courier_codec,
                  courier_zlib_level=args.serve_courier_zlib_level)
        if args.serve_disagg and args.serve_replicas >= 2:
            n_pre = max(args.serve_replicas // 2, 1)
            fc["roles"] = ",".join(["prefill"] * n_pre + ["decode"] * (
                args.serve_replicas - n_pre))
        plan = None
        if args.serve_courier_chaos > 0:
            # lossy link: small chunks so every payload spans many frames,
            # a generous retry budget so the run measures the stall
            fc.update(courier_chunk_bytes=1024, courier_max_retries=12,
                      courier_retry_backoff_ms=0.5,
                      courier_retry_backoff_max_ms=8.0,
                      courier_chunk_deadline_ms=50.0)
            rate = args.serve_courier_chaos / 3.0
            plan = FaultPlan(seed=0, chunk_drop_rate=rate,
                             chunk_corrupt_rate=rate, chunk_delay_rate=rate,
                             chunk_delay_ms=60.0)
        fleet = ServeFleet(cfg, point_serve_cfg(), FleetConfig(**fc),
                           fault_plan=plan, device=device)
        for r in fleet.replicas:
            warm(r.engine)
        fleet.start()
        return fleet

    def warmed_target():
        """A fresh engine (or fleet) a sweep point, warmed by one request
        before its counters are zeroed (the previous point's is released
        first)."""
        if args.serve_replicas > 1:
            return warmed_fleet()
        eng = InferenceEngine(cfg, point_serve_cfg(), device=device)
        warm(eng)
        return eng

    def counters(target) -> dict:
        return (_fleet_counters(target) if hasattr(target, "router")
                else engine_counters(target))

    common = dict(num_requests=args.requests, prompt_len=args.prompt_len,
                  max_tokens=args.gen_len, seed=0,
                  hot_prefix_len=args.serve_hot_prefix,
                  max_retries=args.serve_max_retries,
                  stream=args.serve_stream,
                  device_times=args.device_times)
    out = {"admission": args.admission, "preemption": args.preemption,
           "open_loop": [], "closed_loop": []}
    for r in [float(x) for x in str(args.rps).split(",") if x]:
        target = warmed_target()
        s = run_poisson(target, offered_rps=r, **common).summary()
        s["engine"] = counters(target)
        out["open_loop"].append(s)
        _drop(target, device)
    for c in [int(x) for x in str(args.concurrency).split(",") if x]:
        target = warmed_target()
        s = run_closed_loop(target, concurrency=c, **common).summary()
        s["concurrency"] = c
        s["engine"] = counters(target)
        out["closed_loop"].append(s)
        _drop(target, device)
    if args.serve_returning > 0:
        out["returning"] = _returning_ab(args, cfg, device, point_serve_cfg,
                                         warm)
    if args.serve_long_prompts > 0:
        out["pipeline"] = _pipeline_ab(args, cfg, device, point_serve_cfg,
                                       warm)
    if args.serve_scenario:
        out["scenario_matrix"] = _scenario_matrix(args, cfg, device,
                                                  point_serve_cfg, warm)
    return out


def _returning_ab(args, cfg, device, point_serve_cfg, warm) -> dict:
    """The JAX command's returning-conversation A/B: one fleet an arm, the
    KV pool sized so that the filler turns must evict the conversations'
    pages; the store-on arm demotes them to the fleet KV store and restores
    them on the return turn, the store-off arm prefills them again. The
    arms' returning turns must give the same tokens."""
    from ...config.schema import FleetConfig
    from ...serve.fleet import ServeFleet
    from ...serve.loadgen import run_returning

    hist = args.serve_returning_history
    B = args.slots or 4
    ps = 64 if device.type == "cuda" else 16
    per_req = -(-(hist + 4 + args.gen_len + 16) // ps)     # ceil pages
    blocks = (B + 1) * per_req + 2

    def arm(store_on: bool):
        scfg = point_serve_cfg()
        scfg.max_batch_size = B
        scfg.max_seq_len = min(hist + 4 + args.gen_len + 16,
                               cfg.max_position_embeddings)
        scfg.kv_num_blocks = blocks
        fleet = ServeFleet(
            cfg, scfg,
            FleetConfig(replicas=max(args.serve_replicas, 1),
                        kv_store=store_on, kv_store_dram_mb=256.0,
                        courier_codec=args.serve_courier_codec,
                        courier_zlib_level=args.serve_courier_zlib_level),
            supervise=False, device=device)
        for r in fleet.replicas:
            warm(r.engine, (hist + 4,))
            r.engine.kv.flush_prefix_cache()
        fleet.start()
        try:
            return run_returning(
                fleet, conversations=args.serve_returning, history_len=hist,
                tail_len=4, max_tokens=args.gen_len,
                filler_requests=max(2 * args.serve_returning, 2 * B, 8),
                filler_len=hist, seed=0)
        finally:
            _drop(fleet, device)

    off = arm(False)
    on = arm(True)
    on_t = on.returning["return_p50_ttft_ms"]
    off_t = off.returning["return_p50_ttft_ms"]
    ab = {"store_on": on.summary(), "store_off": off.summary(),
          "token_identical": (on.returning["token_lists"]
                              == off.returning["token_lists"]),
          "ttft_speedup_p50": (round(off_t / on_t, 3)
                               if on_t and off_t else None)}
    for a in ("store_on", "store_off"):
        ab[a].get("returning", {}).pop("token_lists", None)
    return ab


def _scenario_matrix(args, cfg, device, point_serve_cfg, warm) -> dict:
    """The JAX command's scenario matrix: for each scenario an
    autoscale-on/off A/B over one seeded offered plan. The ON arm may grow
    the fleet by one replica under pressure, retire it on the fade (its
    pages flushed to the KV store) and preempt best-effort residents for
    the interactive class's TTFT target; the OFF arm holds its size.
    Tokens of requests completed in both arms must agree."""
    from ...config.schema import FleetConfig
    from ...serve.fleet import ServeFleet
    from ...serve.loadgen import SCENARIOS, run_scenario

    names = [n.strip() for n in str(args.serve_scenario).split(",")
             if n.strip()]
    if names == ["all"]:
        names = list(SCENARIOS)
    bad = [n for n in names if n not in SCENARIOS]
    if bad:
        raise CommandError(f"unknown --serve-scenario {bad}; choose from "
                           f"{SCENARIOS}")
    target = args.serve_ttft_target_ms
    ttft_targets = {"interactive": target, "standard": target * 3}

    def arm(name: str, autoscale_on: bool):
        L = args.serve_long_prompt_len if name == "long-context" else 0
        scfg = point_serve_cfg()
        scfg.max_seq_len = min(
            max(args.prompt_len * 3, L, args.prompt_len * 5)
            + 2 * args.gen_len + 16, cfg.max_position_embeddings)
        base = max(args.serve_replicas, 2)
        fleet = ServeFleet(
            cfg, scfg,
            FleetConfig(
                replicas=base, kv_store=True, max_pending=96,
                autoscale=autoscale_on, autoscale_min_replicas=base,
                autoscale_max_replicas=base + 1,
                autoscale_up_queue_per_replica=2.0,
                autoscale_down_queue_per_replica=0.25,
                autoscale_hysteresis_polls=10, autoscale_cooldown_polls=40,
                priority_headroom_requests=80 if autoscale_on else 0,
                interactive_ttft_target_ms=target if autoscale_on else 0.0,
                probe_interval_s=0.05,
                courier_codec=args.serve_courier_codec),
            device=device)
        lengths, n = [], 8
        while n <= min(512, scfg.max_seq_len - 4):
            lengths.append(n)
            n <<= 1
        for r in fleet.replicas:
            warm(r.engine, lengths)
            with r.engine.lock:
                r.engine.kv.flush_prefix_cache()
        fleet.start()
        fleet.wait_warm_spares()
        try:
            return run_scenario(
                fleet, scenario=name, duration_s=args.serve_scenario_duration,
                base_rps=args.serve_scenario_base_rps,
                peak_rps=args.serve_scenario_peak_rps,
                prompt_len=args.prompt_len, max_tokens=args.gen_len,
                long_prompt_len=args.serve_long_prompt_len, seed=0,
                max_retries=args.serve_max_retries,
                ttft_targets_ms=ttft_targets)
        finally:
            _drop(fleet, device)

    matrix = {}
    for name in names:
        off = arm(name, False)
        on = arm(name, True)
        tl_on = on.scenario.pop("token_lists", [])
        tl_off = off.scenario.pop("token_lists", [])
        both = [i for i in range(min(len(tl_on), len(tl_off)))
                if tl_on[i] is not None and tl_off[i] is not None]
        cell = {"autoscale_on": on.summary(), "autoscale_off": off.summary(),
                "token_identical": all(tl_on[i] == tl_off[i] for i in both),
                "common_completed": len(both)}
        ia_on = on.scenario.get("classes", {}).get("interactive", {})
        ia_off = off.scenario.get("classes", {}).get("interactive", {})
        if ia_on.get("attainment") is not None \
                and ia_off.get("attainment") is not None:
            cell["interactive_attainment_on"] = ia_on["attainment"]
            cell["interactive_attainment_off"] = ia_off["attainment"]
        downs = [e for e in on.scenario.get("scaling", {}).get("events", [])
                 if e.get("kind") == "scale_down"]
        if downs:
            cell["scale_down_flushed_pages"] = sum(
                e.get("flushed_pages", 0) for e in downs)
        matrix[name] = cell
    return matrix


def _pipeline_ab(args, cfg, device, point_serve_cfg, warm) -> dict:
    """The JAX command's pipelined-prefill A/B: one fleet an arm, the same
    traffic with ``--serve-long-prompts`` long prompts; the OFF arm
    prefills each on one replica, the ON arm splits it across the prefill
    pool, and a chaos arm (a stage crash and chunk faults) must collapse
    to single-replica prefill. Tokens must agree across the arms."""
    from ...config.schema import FleetConfig
    from ...serve.fleet import FaultPlan, ServeFleet
    from ...serve.loadgen import run_poisson

    L = args.serve_long_prompt_len
    n_reps = max(args.serve_replicas, 2)
    chunk = 64
    rps = [float(x) for x in str(args.rps).split(",") if x][0]
    min_on = max(args.prompt_len + 1, L // 2)

    def arm(min_tokens, fault_plan=None, warm_lap=True):
        scfg = point_serve_cfg()
        scfg.max_seq_len = min(L + args.gen_len + 16,
                               cfg.max_position_embeddings)
        scfg.chunked_prefill_tokens = chunk
        scfg.prefill_budget_tokens = chunk
        fleet = ServeFleet(
            cfg, scfg,
            FleetConfig(replicas=n_reps, prefix_fetch=True,
                        pipeline_prefill_min_tokens=min_tokens,
                        pipeline_prefill_max_stages=min(n_reps, 4),
                        pipeline_prefill_stage_timeout_ms=240_000.0,
                        courier_codec=args.serve_courier_codec,
                        courier_zlib_level=args.serve_courier_zlib_level),
            fault_plan=fault_plan, supervise=False, device=device)
        for r in fleet.replicas:
            warm(r.engine, (L, args.prompt_len))
        fleet.start()
        try:
            def lap(seed):
                return run_poisson(
                    fleet, offered_rps=rps, num_requests=args.requests,
                    prompt_len=args.prompt_len, max_tokens=args.gen_len,
                    seed=seed, max_retries=args.serve_max_retries,
                    long_prompts=args.serve_long_prompts, long_prompt_len=L)
            if warm_lap:
                lap(0)
                fleet.pipeline.reset_counters()
                for r in fleet.replicas:
                    _reset_counters(r.engine)
                    with r.engine.lock:
                        r.engine.kv.flush_prefix_cache()
            return lap(1)
        finally:
            _drop(fleet, device)

    off = arm(0)
    on = arm(min_on)
    # no warm lap: the injected stage crash fires once
    chaos = arm(min_on, warm_lap=False, fault_plan=FaultPlan(
        seed=0, chunk_drop_rate=0.1, chunk_corrupt_rate=0.1,
        crash_request_substr="::stage", crash_request_after_steps=4))
    ref = off.pipeline.get("token_lists")
    pl = {"replicas": n_reps, "stages_planned": min(n_reps, 4),
          "long_prompts": args.serve_long_prompts, "long_prompt_len": L,
          "pipeline_on": on.summary(), "pipeline_off": off.summary(),
          "chaos": chaos.summary(),
          "token_identical": on.pipeline.get("token_lists") == ref,
          "chaos_token_identical": chaos.pipeline.get("token_lists") == ref}
    on_t, off_t = (on.pipeline.get("p50_long_ttft_ms"),
                   off.pipeline.get("p50_long_ttft_ms"))
    if on_t and off_t:
        pl["long_ttft_speedup_p50"] = round(off_t / on_t, 3)
    on_d, off_d = (on.pipeline.get("p99_short_tpot_ms"),
                   off.pipeline.get("p99_short_tpot_ms"))
    if on_d and off_d:
        pl["short_tpot_p99_ratio_on_vs_off"] = round(on_d / off_d, 3)
    for a in ("pipeline_on", "pipeline_off", "chaos"):
        pl[a].get("pipeline", {}).pop("token_lists", None)
    return pl


def e2e(args, device: torch.device) -> dict:
    """End-to-end train step throughput, serve TTFT and throughput, and the
    single engine's load sweeps."""
    from ...config.presets import get_model_config

    cfg = get_model_config(args.model_name)
    on_card = device.type == "cuda"
    seq_len = args.seq_len or min(1024 if on_card else 128,
                                  cfg.max_position_embeddings)
    results = {}
    if args.mode in ("train", "both"):
        results["train"] = _train(args, cfg, device, seq_len)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    if args.mode in ("serve", "both"):
        results["serve"] = _serve(args, cfg, device, on_card)
    if args.mode == "serve-load":
        results["serve_load"] = _serve_load(args, cfg, device, on_card)
    return results


# -- kv-decode ---------------------------------------------------------------

KV_KINDS = ("bf16", "int8", "int4")


def kv_decode_inputs(slots: int, kv_heads: int, head_dim: int, q_heads: int,
                     page_size: int, context: int, device: torch.device
                     ) -> dict:
    """The seeded inputs of one kv-decode step: fp pages [NP, Nkv, PS, D]
    (bf16 on a card, fp32 on the CPU), tables, lengths, the query and the
    appended token."""
    q_heads = q_heads or kv_heads
    B, Nkv, Nq, D, PS = slots, kv_heads, q_heads, head_dim, page_size
    maxP = (context + PS - 1) // PS
    NP = B * maxP + 1
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    return {
        "kf": torch.randn((NP, Nkv, PS, D), generator=gen, device=device,
                          dtype=dtype),
        "tables": torch.arange(1, NP, dtype=torch.int32,
                               device=device).reshape(B, maxP),
        "lengths": torch.full((B,), context, dtype=torch.int32,
                              device=device),
        "q": torch.randn((B, Nq, D), generator=gen, device=device,
                         dtype=dtype),
        "new_kv": torch.randn((B, 1, Nkv, D), generator=gen, device=device,
                              dtype=dtype),
    }


def kv_decode_pages(kind: str, kf: torch.Tensor):
    """fp pages as they are, or quantized: int8 QuantPages, packed-int4
    Int4Pages (per-token scales)."""
    from ...ops.paged_attention import Int4Pages, QuantPages, \
        quantize_kv_token
    from ...ops.quantization import pack_int4_rows, quantize_int4_rows
    if kind == "int8":
        return QuantPages(*quantize_kv_token(kf))
    if kind == "int4":
        qv, sc = quantize_int4_rows(kf)
        return Int4Pages(pack_int4_rows(qv, axis=-2), sc)
    return kf.clone()


def kv_decode_step(pages, inp: dict, write_mode: str, impl: str = "auto"):
    """One decode step of one layer: append the token (window write or
    per-row scatter) and attend over the pages."""
    from ...ops.paged_attention import (paged_attention,
                                        write_token_to_pages,
                                        write_window_to_pages)
    tables, lengths = inp["tables"], inp["lengths"]
    if write_mode == "paged":
        pages = write_window_to_pages(pages, inp["new_kv"], tables,
                                      lengths - 1)
    else:
        pages = write_token_to_pages(pages, inp["new_kv"][:, 0], tables,
                                     lengths - 1)
    return paged_attention(inp["q"], pages, pages, tables, lengths,
                           impl=impl)


def kv_decode(args, device: torch.device) -> dict:
    """Quantized-KV decode A/B: ms a layer step per page kind, the HBM
    traffic ledger and the capacity ledger."""
    inp = kv_decode_inputs(args.slots, args.kv_heads, args.head_dim,
                           args.q_heads, args.page_size, args.context,
                           device)
    B, Nkv, D, PS = args.slots, args.kv_heads, args.head_dim, args.page_size
    context, layers = args.context, args.layers
    row_bytes = {"bf16": Nkv * D * inp["kf"].element_size(),
                 "int8": Nkv * (D + 4), "int4": Nkv * (D // 2 + 4)}
    results: dict = {}
    with torch.inference_mode():
        for name in KV_KINDS:
            pages = kv_decode_pages(name, inp["kf"])
            kv_decode_step(pages, inp, args.write_mode)          # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                out = kv_decode_step(pages, inp, args.write_mode)
            _sync(device)
            float(out.float().sum())
            sec = (time.perf_counter() - t0) / args.steps
            del pages
            row = row_bytes[name]
            read_attn = 2 * B * context * row
            write_rw = (2 * B * 2 * PS * row if args.write_mode == "paged"
                        else 2 * B * row)
            slot_bytes = 2 * layers * context * row
            results[name] = {
                "ms_per_layer_step": round(sec * 1e3, 3),
                "est_model_decode_ms": round(sec * 1e3 * layers, 1),
                "hbm_ledger_per_step_mb": {
                    "attn_kv_read": round(layers * read_attn / 1e6, 4),
                    "kv_append_rw": round(layers * write_rw / 1e6, 4),
                },
                "capacity": {
                    "bytes_per_slot": slot_bytes,
                    "mb_per_slot": round(slot_bytes / 1e6, 3),
                    "slots_per_gb": round(1e9 / slot_bytes, 2),
                },
            }
    b, i8 = (results["bf16"]["ms_per_layer_step"],
             results["int8"]["ms_per_layer_step"])
    results["int8_vs_bf16_speedup"] = round(b / i8, 3) if i8 else None
    i4 = results["int4"]["ms_per_layer_step"]
    results["int4_vs_bf16_speedup"] = round(b / i4, 3) if i4 else None
    results["int4_vs_int8_slots_per_hbm_byte"] = round(
        results["int8"]["capacity"]["bytes_per_slot"]
        / results["int4"]["capacity"]["bytes_per_slot"], 3)
    results["int4_vs_bf16_slots_per_hbm_byte"] = round(
        results["bf16"]["capacity"]["bytes_per_slot"]
        / results["int4"]["capacity"]["bytes_per_slot"], 3)
    maxP = (context + PS - 1) // PS
    results["courier_codec_ab"] = codec_ab = courier_codec_ab(
        maxP, Nkv, PS, D)
    results["delta_zlib_vs_none_int8_wire"] = round(
        codec_ab["int8"]["none"]["bytes_wire"]
        / max(codec_ab["int8"]["delta-zlib"]["bytes_wire"], 1), 3)
    results["write_mode"] = args.write_mode
    results["backend"] = "gpu" if device.type == "cuda" else device.type
    return results


def courier_codec_ab(maxP: int, Nkv: int, PS: int, D: int) -> dict:
    """What one extracted page payload of each KV kind costs on the wire
    under none / zlib / delta-zlib, with the host's encode-and-frame and
    reassemble-and-decode times (the JAX command's section, the same
    arrays). The pages are activation-shaped (channel-static structure, a
    few large stable outlier channels, AR(1) drift along the tokens), not
    iid noise, which would make every codec look useless."""
    from ...serve.fleet.transport import (ChunkReassembler, encode_payload,
                                          make_chunks)
    rng = np.random.default_rng(0)
    n_pages = min(maxP, 8)
    *lead, _PS, _D = shp = (2, n_pages, max(Nkv // 8, 1), PS, D)

    def activation_planes():
        base = rng.standard_normal((*lead, 1, _D)).astype(np.float32)
        hot = rng.choice(_D, size=max(_D // 16, 1), replace=False)
        base[..., hot] *= 10.0
        drift = np.zeros(shp, np.float32)
        drift[..., 0, :] = 0.1 * rng.standard_normal((*lead, _D))
        for t in range(1, _PS):
            drift[..., t, :] = (0.99 * drift[..., t - 1, :]
                                + 0.1 * rng.standard_normal((*lead, _D)))
        return base + drift

    def quant(x, levels):
        scale = np.abs(x).max(-1) / levels + 1e-9
        return (np.clip(np.round(x / scale[..., None]), -levels,
                        levels).astype(np.int8), scale)

    def extract_payload(kind):
        k, v = activation_planes(), activation_planes()
        if kind == "bf16":
            pages = {"k": k, "v": v}
        else:
            pages = {}
            for name, x in (("k", k), ("v", v)):
                q, sc = quant(x, 127 if kind == "int8" else 7)
                if kind == "int4":           # two slots a byte
                    q = ((q[..., 0::2, :] & 0xF)
                         | ((q[..., 1::2, :] & 0xF) << 4)).astype(np.uint8)
                pages[name] = {"values": q, "scale": sc.astype(np.float32)}
        return {"pages": {**pages, "num_pages": n_pages},
                "positions": n_pages * PS, "last_token": 1}

    out: dict = {}
    for kind in KV_KINDS:
        payload = extract_payload(kind)
        arms = {}
        for codec in ("none", "zlib", "delta-zlib"):
            t0 = time.perf_counter()
            manifest, blob = encode_payload(payload, codec=codec)
            chunks = make_chunks("bench", manifest, blob, 256 * 1024)
            enc_ms = (time.perf_counter() - t0) * 1e3
            wire = sum(len(c.data) for c in chunks)
            t0 = time.perf_counter()
            r = ChunkReassembler(len(chunks))
            for c in chunks:
                r.add(c)
            r.payload()
            dec_ms = (time.perf_counter() - t0) * 1e3
            arms[codec] = {
                "bytes_raw": manifest["nbytes"], "bytes_wire": wire,
                "compression_ratio": round(manifest["nbytes"]
                                           / max(wire, 1), 3),
                "encode_ms": round(enc_ms, 3),
                "decode_ms": round(dec_ms, 3)}
        out[kind] = arms
    return out


# -- dataloader ----------------------------------------------------------------

def dataloader(args) -> int:
    """Dataset streaming throughput and stall under a simulated step."""
    from ...io.data import PrefetchLoader, make_dataset

    ds = make_dataset(args.path, args.batch, args.seq_len, vocab_size=50304,
                      seed=0, num_workers=args.workers,
                      prefetch=args.prefetch)
    try:
        next(ds)  # warm
        stall0 = ds.stall_seconds if isinstance(ds, PrefetchLoader) else None
        t0 = time.perf_counter()
        stall_sync = 0.0
        for _ in range(args.batches):
            f0 = time.perf_counter()
            next(ds)
            stall_sync += time.perf_counter() - f0
            if args.step_ms > 0:
                time.sleep(args.step_ms / 1e3)      # the simulated step
        dt = time.perf_counter() - t0
    finally:
        if hasattr(ds, "close"):    # PrefetchLoader closes its inner one
            ds.close()
    toks = args.batches * args.batch * args.seq_len
    out = {"tokens_per_sec": toks / dt, "batches_per_sec": args.batches / dt,
           "MB_per_sec": toks * 4 / dt / 1e6}
    if isinstance(ds, PrefetchLoader):
        out["stall_ms_per_batch"] = ((ds.stall_seconds - stall0)
                                     / args.batches * 1e3)
    else:
        out["fetch_ms_per_batch"] = stall_sync / args.batches * 1e3
    if args.step_ms > 0:
        out["step_ms_simulated"] = args.step_ms
    print(json.dumps(out, indent=2))
    return 0


# -- battery -------------------------------------------------------------------

def _open_chip_lock(path: str):
    """Open (creating if needed) the world-writable lock file: the mode is
    widened after creation, since the umask strips group/other write."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
    try:
        os.chmod(path, 0o666)
    except OSError:
        pass            # another user's file: they widened it already
    return os.fdopen(fd, "w")


def probe_card() -> bool:
    """True when a child process sees a CUDA card (the child carries its
    own timeout, so a hung card never hangs the battery)."""
    import subprocess
    code = ("import sys, torch; "
            "sys.exit(0 if torch.cuda.is_available() else 1)")
    try:
        return subprocess.run(
            [sys.executable, "-c", code], timeout=90,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL).returncode == 0
    except subprocess.TimeoutExpired:
        return False


def battery(args) -> int:
    """Run a listed measurement battery with per-item timeouts, resume and
    card-outage parking; exit 1 if an item failed, 2 if parked."""
    import shlex
    import subprocess
    from pathlib import Path

    spec_path = Path(args.spec)
    if not spec_path.is_file():
        raise CommandError(f"no battery spec {args.spec}")
    if spec_path.suffix == ".json":
        items_spec = json.loads(spec_path.read_text())
    else:
        from ...utils.tomlio import loads_toml
        items_spec = loads_toml(spec_path.read_text())
    items = items_spec.get("item") or items_spec.get("items") or []
    if not items:
        raise CommandError(f"{args.spec}: no [[item]] entries")
    spec_env = {str(k): str(v)
                for k, v in (items_spec.get("env") or {}).items()}
    item_env = {**os.environ, **spec_env} if spec_env else None

    out = Path(args.out_dir)
    manifest_path = out / "battery_manifest.json"
    manifest = {"spec": str(spec_path), "items": {}}
    if args.resume and manifest_path.exists():
        try:
            manifest = json.loads(manifest_path.read_text())
        except json.JSONDecodeError:
            pass
        if not isinstance(manifest, dict):
            manifest = {"spec": str(spec_path)}
        manifest.setdefault("items", {})

    def plan_item(i, it):
        """(argv, timeout_s, done under --resume) of one item: the one
        place the resume rule lives, so --dry-run shows what a run
        skips."""
        if not it.get("name") or not it.get("cmd"):
            raise CommandError(f"{args.spec}: item {i} needs 'name' and "
                               "'cmd'")
        cmd = it["cmd"]
        try:
            argv = shlex.split(cmd) if isinstance(cmd, str) else \
                [str(a) for a in cmd]
            timeout_s = float(it.get("timeout", 900))
        except ValueError as e:
            raise CommandError(f"{args.spec}: item {i} ({it['name']!r}): "
                               f"{e}")
        prior = manifest["items"].get(it["name"], {})
        # resume keys on (name, cmd): an edited item is another measurement
        done = (args.resume and prior.get("rc") == 0
                and prior.get("cmd") == argv)
        return argv, timeout_s, done

    # the whole spec is checked before any item runs or the lock is waited
    plans = [plan_item(i, it) for i, it in enumerate(items)]
    if args.dry_run:
        for it, (argv, timeout_s, done) in zip(items, plans):
            print(f"{'skip' if done else 'run '}  {it['name']}  "
                  f"(timeout {timeout_s:.0f}s)  "
                  f"{' '.join(argv[:6])}{' ...' if len(argv) > 6 else ''}")
        if spec_env:
            print("env: " + ", ".join(f"{k}={v}"
                                      for k, v in spec_env.items()))
        return 0
    out.mkdir(parents=True, exist_ok=True)

    def wait_card() -> bool:
        if not args.tpu_guard:
            return True
        for attempt in range(1, args.max_probes + 1):
            if probe_card():
                return True
            if not args.wait_for_chip or attempt == args.max_probes:
                return False
            print(f"card probe {attempt}/{args.max_probes} failed; "
                  f"sleeping {args.probe_interval}s", file=sys.stderr)
            time.sleep(args.probe_interval)
        return False

    lock_fh = None
    if args.chip_lock:
        # one battery at a time on the card: waiting here is cheaper than
        # re-running a measurement another battery disturbed
        import fcntl
        lock_fh = _open_chip_lock(args.chip_lock)
        try:
            fcntl.flock(lock_fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            print(f"waiting for chip lock {args.chip_lock} (another battery "
                  "is running)...", file=sys.stderr)
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
    try:
        ran = skipped = failed = 0
        parked = False
        for it, (argv, timeout_s, done) in zip(items, plans):
            name = it["name"]
            if done:
                print(f"=== {name}: already done (rc=0), skipping ===")
                skipped += 1
                continue
            if not wait_card():
                parked = True
                print(f"=== {name}: card unavailable — battery parked "
                      "(resume with the same command) ===", file=sys.stderr)
                break
            log_path = out / f"{name}.log"
            print(f"=== {name} (timeout {timeout_s:.0f}s) ===", flush=True)
            t0 = time.time()
            with open(log_path, "w") as log:
                try:
                    rc = subprocess.run(argv, stdout=log,
                                        stderr=subprocess.STDOUT,
                                        env=item_env,
                                        timeout=timeout_s).returncode
                except subprocess.TimeoutExpired:
                    rc = -9
                    log.write(f"\nbattery watchdog: item exceeded "
                              f"{timeout_s:.0f}s and was killed\n")
                except FileNotFoundError as e:
                    rc = 127
                    log.write(f"\n{e}\n")
            dt = time.time() - t0
            with open(log_path, "r+b") as log:
                # a killed item's output can end mid-line: the rc marker
                # goes on a line of its own
                log.seek(0, 2)
                if log.tell() > 0:
                    log.seek(-1, 2)
                    if log.read(1) != b"\n":
                        log.write(b"\n")
                log.write(f"rc={rc}\n".encode())
            with open(log_path, "rb") as log:     # a bounded tail
                log.seek(0, 2)
                log.seek(max(log.tell() - 4096, 0))
                tail = log.read().decode(errors="replace").splitlines()[-4:-1]
            for line in tail:
                print(f"  {line}")
            manifest["items"][name] = {"rc": rc, "seconds": round(dt, 1),
                                       "cmd": argv, "log": str(log_path)}
            manifest_path.write_text(json.dumps(manifest, indent=2))
            if rc == 0:
                ran += 1
            else:
                failed += 1
                print(f"  item {name} rc={rc}", file=sys.stderr)
        print(json.dumps({"ran": ran, "skipped": skipped, "failed": failed,
                          "parked": parked,
                          "manifest": str(manifest_path)}))
        if parked:
            return 2         # nothing failed: the card never answered
        return 1 if failed else 0
    finally:
        if lock_fh is not None:
            lock_fh.close()
