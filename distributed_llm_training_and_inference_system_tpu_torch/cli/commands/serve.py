"""`llmctl-torch serve` — start the inference server (the JAX package's
``serve start``).

The options keep the JAX command's names and defaults. ``build_server(args)``
turns a parsed ``serve start`` line into an ``InferenceServer`` (not
started) on the global ``--device``, or with ``--replicas > 1`` a fleet
front (``serve/fleet/http.py``) over in-process replicas and, with
``--fleet-remote-replicas`` and ``--fleet-endpoint``, fleet worker
processes:

- ``--dtype`` defaults to bfloat16 on the card and float32 on the CPU;
- ``--prometheus-port P`` (0 = a free port) starts the process's
  observability manager with a scrape endpoint on P (``server.metrics`` is
  its exporter, ``server.metrics.port`` the bound port), feeds it every
  finished request and serves the same registry at the server's
  ``/metrics``; the global ``--otlp-endpoint`` adds OTLP spans;
- the ``--fleet-*`` options build the ``FleetConfig`` as the JAX command
  does, the fleet KV store's (``--fleet-kv-store*``) and the
  autoscaler's (``--fleet-autoscale*``) included;
- ``--tensor-parallel N > 1`` serves one engine from N ranks
  (``serve/tp.py``): this process is rank 0, the server; it starts ranks
  1..N-1 as children of the same command line through
  ``runtime.launcher.LocalLauncher`` (``RANK``/``WORLD_SIZE`` set), which
  follow its descriptors. Each rank takes ``cuda:{rank}`` where there are
  N cards and shares ``cuda:0`` where there are fewer; the backend is
  NCCL where each rank has its own card, gloo otherwise. Each rank prints
  ``LLMCTL_SERVE_LAUNCHES {json}`` (its kernel launches and paged passes,
  ``InferenceEngine.launch_report``) on stderr at exit. A fleet of such
  replicas waits for ROADMAP queue 1 item 7b.

``start`` binds ``--host:--port`` (0 = a free port), prints one line with
the bound ports, and serves until SIGTERM or SIGINT, then stops the
server, the engine threads, the follower ranks and the scrape endpoint
and exits 0. With
``--fleet-fronts N > 1`` it runs the HA front tier instead: N `fleet
front` processes over the shared ``--fleet-state-store-dir``, babysat
(fenced, counted, respawned) until SIGTERM.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

# the fleet options of `serve start`: (flag, FleetConfig field, default,
# type or choices); a bool default makes a --fleet-x/--fleet-no-x toggle
FLEET_OPTIONS = (
    ("--fleet-max-pending", "max_pending", 512, int),
    ("--fleet-probe-interval", "probe_interval_s", 0.5, float),
    ("--fleet-probe-failures", "probe_failures", 3, int),
    ("--fleet-restart-backoff", "restart_backoff_s", 0.5, float),
    ("--fleet-max-restarts", "max_restarts", 0, int),
    ("--fleet-max-requeues", "max_requeues", 3, int),
    ("--fleet-prefix-inventory-max", "prefix_inventory_max", 512, int),
    ("--fleet-affinity-tokens", "affinity_prefix_tokens", 64, int),
    ("--fleet-migrate-on-drain", "migrate_on_drain", True, bool),
    ("--fleet-rebalance-ratio", "rebalance_imbalance_ratio", 0.0, float),
    ("--fleet-rebalance-hysteresis", "rebalance_poll_hysteresis", 3, int),
    ("--fleet-max-migrations", "max_concurrent_migrations", 2, int),
    ("--fleet-roles", "roles", "", str),
    ("--fleet-role-balance-ratio", "role_balance_ratio", 0.0, float),
    ("--fleet-courier-transport", "courier_transport", "inproc",
     ("inproc", "http")),
    ("--fleet-courier-codec", "courier_codec", "none",
     ("none", "zlib", "delta-zlib")),
    ("--fleet-courier-zlib-level", "courier_zlib_level", -1, int),
    ("--fleet-courier-chunk-bytes", "courier_chunk_bytes", 256 * 1024, int),
    ("--fleet-courier-retries", "courier_max_retries", 4, int),
    ("--fleet-courier-deadline-ms", "courier_chunk_deadline_ms", 100.0,
     float),
    ("--fleet-courier-endpoint", "courier_endpoint", "", str),
    ("--fleet-courier-ticket-ttl-ms", "courier_ticket_ttl_ms", 60_000.0,
     float),
    ("--fleet-remote-replicas", "remote_replicas", "", str),
    ("--fleet-prefix-fetch", "prefix_fetch", True, bool),
    ("--fleet-prefix-fetch-min-pages", "prefix_fetch_min_pages", 1, int),
    ("--fleet-kv-store", "kv_store", False, bool),
    ("--fleet-kv-store-dram-mb", "kv_store_dram_mb", 256.0, float),
    ("--fleet-kv-store-dir", "kv_store_dir", "", str),
    ("--fleet-kv-store-disk-mb", "kv_store_disk_mb", 1024.0, float),
    ("--fleet-kv-store-ttl-ms", "kv_store_ttl_ms", 0.0, float),
    ("--fleet-kv-store-endpoint", "kv_store_endpoint", "", str),
    ("--fleet-kv-store-endpoints", "kv_store_endpoints", "", str),
    ("--fleet-kv-store-retry-max", "kv_store_retry_max", 2, int),
    ("--fleet-kv-store-retry-backoff-ms", "kv_store_retry_backoff_ms", 10.0,
     float),
    ("--fleet-kv-store-write-ack", "kv_store_write_ack", 1, int),
    ("--fleet-kv-store-hedge-ms", "kv_store_hedge_ms", 0.0, float),
    ("--fleet-pipeline-min-tokens", "pipeline_prefill_min_tokens", 0, int),
    ("--fleet-pipeline-max-stages", "pipeline_prefill_max_stages", 4, int),
    ("--fleet-pipeline-stage-timeout-ms",
     "pipeline_prefill_stage_timeout_ms", 30000.0, float),
    ("--fleet-inventory-ttl-ms", "prefix_inventory_ttl_ms", 0.0, float),
    ("--fleet-stream-ttl-ms", "stream_log_ttl_ms", 60000.0, float),
    ("--fleet-stream-max-buffered", "stream_max_buffered_batches", 256, int),
    ("--fleet-fronts", "fronts", 1, int),
    ("--fleet-state-store", "state_store", "memory", ("memory", "file")),
    ("--fleet-state-store-dir", "state_store_dir", "", str),
    ("--fleet-state-compact-every", "state_compact_every", 1024, int),
    ("--fleet-autoscale", "autoscale", False, bool),
    ("--fleet-autoscale-min-replicas", "autoscale_min_replicas", 1, int),
    ("--fleet-autoscale-max-replicas", "autoscale_max_replicas", 0, int),
    ("--fleet-autoscale-up-queue-per-replica",
     "autoscale_up_queue_per_replica", 4.0, float),
    ("--fleet-autoscale-down-queue-per-replica",
     "autoscale_down_queue_per_replica", 0.5, float),
    ("--fleet-autoscale-hysteresis-polls", "autoscale_hysteresis_polls", 2,
     int),
    ("--fleet-autoscale-cooldown-polls", "autoscale_cooldown_polls", 10,
     int),
    ("--fleet-autoscale-spawn", "autoscale_spawn", "",
     ("", "engine", "worker")),
    ("--fleet-autoscale-up-free-page-ratio", "autoscale_up_free_page_ratio",
     0.0, float),
    ("--fleet-autoscale-spawn-timeout-s", "autoscale_spawn_timeout_s", 30.0,
     float),
    ("--fleet-priority-headroom-requests", "priority_headroom_requests", 0,
     int),
    ("--fleet-interactive-ttft-target-ms", "interactive_ttft_target_ms",
     0.0, float),
)


class _Toggle(argparse.Action):
    """``--fleet-x`` sets True, ``--fleet-no-x`` False (click's pair)."""

    def __init__(self, option_strings, dest, **kw):
        super().__init__(option_strings, dest, nargs=0, **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest,
                not option_string.startswith("--fleet-no-"))


def fleet_dest(flag: str) -> str:
    return flag[2:].replace("-", "_")


def _add_fleet_options(add) -> None:
    for flag, field, default, kind in FLEET_OPTIONS:
        dest = fleet_dest(flag)
        if kind is bool:
            add(flag, "--fleet-no-" + flag[len("--fleet-"):], dest=dest,
                default=default, action=_Toggle)
        elif isinstance(kind, tuple):
            add(flag, dest=dest, default=default, choices=list(kind))
        else:
            add(flag, dest=dest, default=default, type=kind)
    add("--fleet-endpoint", dest="fleet_endpoints", action="append",
        default=[], help="replica=url entries of the fleet's endpoint map "
                         "(repeat per replica).")


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
        help="Shard the model over this many local devices (Megatron TP; "
             "needs num_kv_heads % tp == 0).")
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
        help="Engine replicas behind the fleet router (> 1 serves the "
             "fleet front).")
    _add_fleet_options(add)
    add("--stream-abort-on-disconnect",
        dest="stream_abort_on_disconnect", default=True,
        action=argparse.BooleanOptionalAction,
        help="Abort a streamed request whose client disconnected.")
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch serve").print_help()
        return 0
    return start(args)


def fleet_config(args):
    """The ``FleetConfig`` of a parsed ``serve start`` line (None for one
    engine)."""
    from ...config.schema import FleetConfig, parse_fleet_endpoints

    if args.replicas <= 1:
        return None
    cfg = FleetConfig(
        replicas=args.replicas,
        fleet_endpoints=parse_fleet_endpoints(list(args.fleet_endpoints)),
        **{field: getattr(args, fleet_dest(flag))
           for flag, field, _d, _k in FLEET_OPTIONS})
    cfg.validate()
    return cfg


def front_tier(args, fleet_cfg):
    """The HA front tier of ``--fleet-fronts N > 1``: this process
    babysits N `fleet front` children over the shared state store and the
    same remote workers."""
    from ...serve.fleet.front import FleetFrontTier, default_spawn_cmd
    from ...serve.fleet.state import SharedFileStateStore

    store = SharedFileStateStore(fleet_cfg.state_store_dir, front_id="tier")
    return FleetFrontTier(
        store, default_spawn_cmd(
            model=args.model_name, store_dir=fleet_cfg.state_store_dir,
            replicas=fleet_cfg.replicas, endpoints=fleet_cfg.endpoint_map(),
            remote_replicas=fleet_cfg.remote_replicas, host=args.host,
            artifact=args.artifact,
            extra=["--max-seq-len", str(args.max_seq_len),
                   "--max-batch-size", str(args.max_batch_size),
                   "--kv-block-size", str(args.kv_block_size)]),
        fronts=fleet_cfg.fronts)


MULTI_GPU = "ROADMAP queue 1 item 7b"


def _rank() -> int:
    return int(os.environ.get("RANK", "0"))


def rank_device(args):
    """This rank's device (``parallel.mesh.rank_device``)."""
    from ...device import resolve_device
    from ...parallel.mesh import rank_device as device_of
    return device_of(resolve_device(args.root.device), args.tensor_parallel)


def start_ranks(args, device):
    """Rank 0 of ``--tensor-parallel N``: start ranks 1..N-1 (this command
    line, ``RANK`` set) and join the process group with them. Returns the
    launcher holding the children."""
    from ...parallel.mesh import init_distributed
    from ...runtime.launcher import lead_ranks

    tp = args.tensor_parallel
    launcher = lead_ranks(args.argv, tp)
    try:
        backend = init_distributed(device)
    except BaseException:
        launcher.stop_children()
        raise
    print(f"tensor-parallel serving over {tp} ranks, backend {backend}"
          + (" (host-staged collectives)" if backend == "gloo" else ""),
          flush=True)
    return launcher


def report_launches(engine) -> None:
    """``LLMCTL_SERVE_LAUNCHES {json}`` on stderr: this rank's launches.
    One write of the whole line: the ranks share the stream, and print's
    separate write of the newline let another rank's line in between."""
    sys.stderr.write("LLMCTL_SERVE_LAUNCHES "
                     + json.dumps(engine.launch_report()) + "\n")
    sys.stderr.flush()


def serve_config(args, device):
    """The ``ServeConfig`` of a parsed ``serve start`` line."""
    from ...config.presets import get_model_config
    from ...config.schema import ServeConfig

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
    return model_cfg, serve_cfg


def follow(args) -> int:
    """A follower rank of ``--tensor-parallel N``: build this rank's
    engine, run the leader's descriptors until it stops, report the
    launches."""
    from ...parallel.mesh import init_distributed
    from ...serve.engine import InferenceEngine

    device = rank_device(args)
    init_distributed(device)
    model_cfg, serve_cfg = serve_config(args, device)
    # SIGTERM from the leader's launcher ends the process; the report is
    # printed when the leader stops the followers first
    engine = InferenceEngine(model_cfg, serve_cfg, device=device)
    engine.follow()
    report_launches(engine)
    return 0


def build_server(args):
    """The ``InferenceServer`` of a parsed ``serve start`` line, or with
    ``--replicas > 1`` its ``FleetServer`` (not started). With
    ``--tensor-parallel N > 1`` it first starts the follower ranks and
    joins their process group (``server.tp_ranks`` holds the launcher)."""
    from ...metrics.observability import (reset_observability,
                                          setup_observability)
    from ...serve.server import create_server

    fleet_cfg = fleet_config(args)
    if args.tensor_parallel > 1 and fleet_cfg is not None:
        raise NotImplementedError(
            "fleet replicas with --tensor-parallel > 1 are not ported to "
            f"the PyTorch package yet ({MULTI_GPU})")
    device = rank_device(args)
    model_cfg, serve_cfg = serve_config(args, device)
    ranks = None
    if args.tensor_parallel > 1:
        ranks = start_ranks(args, device)
    observer = exporter = None
    if args.prometheus_port is not None or args.root.otlp_endpoint:
        obs = setup_observability(prometheus_port=args.prometheus_port,
                                  otlp_endpoint=args.root.otlp_endpoint)
        exporter = obs.prometheus

        def observer(event: str, payload: dict) -> None:
            # fleet supervisor snapshots carry the per-replica gauges
            if event == "fleet":
                obs.record_fleet(payload)
            elif event == "inference_request":
                obs.record_inference(payload)
    try:
        server = create_server(model_cfg, serve_cfg, fleet_cfg=fleet_cfg,
                               device=device, observer=observer,
                               metrics=exporter)
    except BaseException:
        reset_observability()        # no scrape endpoint outlives a refusal
        if ranks is not None:
            ranks.stop_children()
        raise
    server.tp_ranks = ranks
    return server


def stop_ranks(server, grace_s: float = 30.0) -> None:
    """Rank 0's exit: release the followers (they print their launches),
    print rank 0's, and wait for the children (then stop them)."""
    ranks = getattr(server, "tp_ranks", None)
    if ranks is None:
        return
    server.engine.stop_followers()
    report_launches(server.engine)
    deadline = time.monotonic() + grace_s
    while any(p.poll() is None for p in ranks.children) \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    ranks.stop_children()


def start(args) -> int:
    """Start the OpenAI-compatible inference server; serve until SIGTERM
    or SIGINT."""
    from ...metrics.observability import reset_observability

    if args.tensor_parallel > 1 and _rank() > 0:
        return follow(args)
    fleet_cfg = fleet_config(args)
    tier = server = None
    if fleet_cfg is not None and fleet_cfg.fronts > 1:
        tier = front_tier(args, fleet_cfg)
    else:
        server = build_server(args)
    stop = threading.Event()
    previous = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        if tier is not None:
            ports = tier.start()
            print(f"HA front tier up: {fleet_cfg.fronts} fronts on ports "
                  f"{ports} over {fleet_cfg.state_store_dir}", flush=True)
            while not stop.wait(0.25):
                tier.poll()
            return 0
        port = server.start()
        metrics = (f", metrics on :{server.metrics.port}"
                   if server.metrics is not None else "")
        replicas = (f", replicas={args.replicas}" if args.replicas > 1
                    else "")
        print(f"serving {args.model_name} on {args.host}:{port} "
              f"(device={args.root.device}, "
              f"dtype={server.serve_cfg.dtype}, "
              f"scheduler={args.scheduler}{replicas}{metrics})", flush=True)
        while not stop.wait(0.5):
            pass
    finally:
        if tier is not None:
            tier.stop()
        if server is not None:
            server.stop()
            stop_ranks(server)
        reset_observability()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    print("server stopped", flush=True)
    return 0
