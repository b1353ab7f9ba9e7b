"""`llmctl-torch serve` — start the inference server (the JAX package's
``serve start`` for one engine).

The single-engine options keep the JAX command's names and defaults.
``build_server(args)`` turns a parsed ``serve start`` line into an
``InferenceServer`` (not started) on the global ``--device``:

- ``--dtype`` defaults to bfloat16 on the card and float32 on the CPU;
- ``--prometheus-port P`` (0 = a free port) starts the process's
  observability manager with a scrape endpoint on P (``server.metrics`` is
  its exporter, ``server.metrics.port`` the bound port), feeds it every
  finished request and serves the same registry at the server's
  ``/metrics``; the global ``--otlp-endpoint`` adds OTLP spans;
- ``--replicas > 1`` and every ``--fleet-*`` option raise (the fleet is
  ROADMAP queue 1 item 9); ``--tensor-parallel > 1`` raises in the engine
  (item 7).

``start`` binds ``--host:--port`` (0 = a free port), prints one line with
the bound ports, and serves until SIGTERM or SIGINT, then stops the
server, the engine thread and the scrape endpoint and exits 0.
"""

from __future__ import annotations

import argparse
import signal
import threading

FLEET = "ROADMAP queue 1 item 9"


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description="Inference serving.")
    sub = ap.add_subparsers(dest="sub", metavar="{start}")
    s = sub.add_parser("start", help="Start the OpenAI-compatible inference "
                                     "server.")
    add = s.add_argument
    add("--model", dest="model_name", default="gpt-125m",
        help="Model template name.")
    add("--artifact", default="",
        help="Checkpoint dir (the port's or the JAX package's), or an "
             "`export convert` safetensors/npz file (pre-quantized exports "
             "load to the card quantized).")
    add("--host", default="0.0.0.0")
    add("--port", default=8080, type=int)
    add("--max-batch-size", default=8, type=int)
    add("--max-seq-len", default=2048, type=int)
    add("--kv-block-size", default=64, type=int,
        help="Tokens per KV page.")
    add("--kv-hbm-gb", default=4.0, type=float,
        help="Device memory budget for the paged KV cache.")
    add("--scheduler", default="continuous",
        choices=["continuous", "static"])
    add("--dtype", default=None, choices=["bfloat16", "float32"],
        help="Serving dtype (default bf16 on the card, fp32 on the CPU).")
    add("--prometheus-port", default=None, type=int,
        help="Also start a Prometheus scrape endpoint (0 = a free port).")
    add("--speculative", default="off", choices=["off", "ngram"],
        help="Speculative decoding (ngram = host prompt-lookup drafts, "
             "device verification; greedy output unchanged).")
    add("--spec-tokens", default=8, type=int,
        help="Speculative verify window (drafts per dispatch + 1).")
    add("--prefix-cache", default=True,
        action=argparse.BooleanOptionalAction,
        help="Share full prompt-prefix KV pages between requests.")
    add("--tensor-parallel", default=1, type=int,
        help="Shard the model over this many cards (ROADMAP queue 1 item "
             "7; only 1 is ported).")
    add("--quantization", default="none",
        choices=["none", "int8", "int4", "int4-awq"],
        help="Weight-only quantization: int8 (W8A16) or group-wise int4 / "
             "int4-awq (W4A16).")
    add("--chunked-prefill", default=0, type=int,
        help="Prefill prompts longer than this in chunks of this many "
             "tokens, interleaved with decode (0 = off).")
    add("--prefill-budget-tokens", default=2048, type=int,
        help="Max prompt tokens prefilled between two decode steps.")
    add("--decode-steps", default=8, type=int,
        help="Decode iterations fused into one device dispatch.")
    add("--max-queue", default=256, type=int,
        help="Queued-request bound; beyond it submissions are rejected.")
    add("--swap-space-gb", default=4.0, type=float,
        help="Host-memory budget for swapped-out KV (--preemption swap).")
    add("--spec-ngram", default=3, type=int,
        help="Longest n-gram the speculative proposer tries.")
    add("--spec-min-acceptance", default=0.05, type=float,
        help="Fall back to plain decode when measured draft acceptance "
             "stays below this.")
    add("--kv-quantization", default="none", choices=["none", "int8", "int4"],
        help="Quantized KV pages (+per-token scales).")
    add("--admission", default="ondemand", choices=["ondemand", "reserve"],
        help="KV admission: ondemand grows page chains as decode advances; "
             "reserve holds prompt+max_tokens up front.")
    add("--preemption", default="recompute", choices=["recompute", "swap"],
        help="Evicted-KV policy: re-prefill, or round-trip the pages "
             "through host memory.")
    add("--latency-dispatch-steps", default=0, type=int,
        help="Shrink decode dispatches to this many steps while requests "
             "wait with a free slot (0 disables).")
    add("--pipelined-decode", default=True,
        action=argparse.BooleanOptionalAction,
        help="Keep one un-fetched decode dispatch in flight.")
    add("--int8-pallas", dest="int8_pallas", default=False,
        action=argparse.BooleanOptionalAction,
        help="Route int8 decode matmuls through the W8A16 kernels instead "
             "of the dequant route.")
    add("--cors-origins", default="*",
        help="CORS allowed origins: '*', a comma-separated list, or '' to "
             "disable.")
    add("--replicas", default=1, type=int,
        help="Engine replicas behind the fleet router (ROADMAP queue 1 "
             "item 9; only 1 is ported).")
    add("--stream-abort-on-disconnect",
        dest="stream_abort_on_disconnect", default=True,
        action=argparse.BooleanOptionalAction,
        help="Abort a streamed request whose client disconnected.")
    return ap


def refuse_unknown(unknown: list[str]) -> None:
    fleet = [a for a in unknown if a.startswith("--fleet-")]
    if fleet:
        raise NotImplementedError(
            f"{fleet[0].split('=')[0]}: the serving fleet is not ported to "
            f"the PyTorch package yet ({FLEET})")


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch serve").print_help()
        return 0
    return start(args)


def build_server(args):
    """The ``InferenceServer`` of a parsed ``serve start`` line (not
    started)."""
    from ...config.presets import get_model_config
    from ...config.schema import ServeConfig
    from ...device import resolve_device
    from ...metrics.observability import (reset_observability,
                                          setup_observability)
    from ...serve.server import InferenceServer

    if args.replicas > 1:
        raise NotImplementedError(
            f"--replicas {args.replicas}: the serving fleet is not ported to "
            f"the PyTorch package yet ({FLEET})")
    device = resolve_device(args.root.device)
    dtype = args.dtype or ("bfloat16" if device.type == "cuda"
                           else "float32")
    model_cfg = get_model_config(args.model_name)
    serve_cfg = ServeConfig(
        model=args.model_name, artifact=args.artifact, host=args.host,
        port=args.port, max_batch_size=args.max_batch_size,
        max_seq_len=min(args.max_seq_len, model_cfg.max_position_embeddings),
        kv_block_size=args.kv_block_size, kv_hbm_budget_gb=args.kv_hbm_gb,
        scheduler=args.scheduler, dtype=dtype, speculative=args.speculative,
        speculative_tokens=args.spec_tokens, prefix_caching=args.prefix_cache,
        speculative_ngram=args.spec_ngram,
        speculative_min_acceptance=args.spec_min_acceptance,
        tensor_parallel=args.tensor_parallel, quantization=args.quantization,
        chunked_prefill_tokens=args.chunked_prefill,
        prefill_budget_tokens=args.prefill_budget_tokens,
        decode_steps_per_dispatch=args.decode_steps, max_queue=args.max_queue,
        swap_space_gb=args.swap_space_gb,
        kv_quantization=args.kv_quantization, admission=args.admission,
        preemption=args.preemption,
        latency_dispatch_steps=args.latency_dispatch_steps,
        pipelined_decode=args.pipelined_decode,
        int8_pallas_matmul=args.int8_pallas,
        cors_origins=args.cors_origins,
        stream_abort_on_disconnect=args.stream_abort_on_disconnect)
    serve_cfg.validate()
    observer = exporter = None
    if args.prometheus_port is not None or args.root.otlp_endpoint:
        obs = setup_observability(prometheus_port=args.prometheus_port,
                                  otlp_endpoint=args.root.otlp_endpoint)
        exporter = obs.prometheus

        def observer(event: str, payload: dict) -> None:
            if event == "inference_request":
                obs.record_inference(payload)
    try:
        return InferenceServer(model_cfg, serve_cfg, device=device,
                               observer=observer, metrics=exporter)
    except BaseException:
        reset_observability()        # no scrape endpoint outlives a refusal
        raise


def start(args) -> int:
    """Start the OpenAI-compatible inference server; serve until SIGTERM
    or SIGINT."""
    from ...metrics.observability import reset_observability

    server = build_server(args)
    stop = threading.Event()
    previous = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        port = server.start()
        metrics = (f", metrics on :{server.metrics.port}"
                   if server.metrics is not None else "")
        print(f"serving {args.model_name} on {args.host}:{port} "
              f"(device={server.engine.device}, "
              f"dtype={server.serve_cfg.dtype}, "
              f"scheduler={args.scheduler}{metrics})", flush=True)
        while not stop.wait(0.5):
            pass
    finally:
        server.stop()
        reset_observability()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    print("server stopped", flush=True)
    return 0
