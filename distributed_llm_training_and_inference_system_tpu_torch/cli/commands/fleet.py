"""`llmctl-torch fleet` — operate a serving fleet (the JAX package's
``llmctl fleet``), on argparse and urllib.

- ``status`` reads ``GET /fleet/status`` and prints a plain-text table
  (``--json``: the snapshot itself, JAX's keys); ``drain``, ``undrain``,
  ``role`` and ``migrate`` post to the front's ``/fleet/*`` routes.
- ``worker`` runs one replica as its own process (serve/fleet/worker.py)
  on the global ``--device``, from ``--artifact`` (an export artifact or
  a checkpoint directory, the JAX package's or the port's) or random
  weights from ``--param-seed``; it prints ``LLMCTL_WORKER_READY port=N``
  on stdout and its weights' checksum on stderr, and at SIGTERM its
  kernel launch counts on stderr.
- ``front`` runs one stateless front of the HA tier over the shared file
  state store (serve/fleet/front.py); it holds no model.
- ``store``, ``ship-weights`` and the worker's ``--store-endpoint(s)`` and
  ``--weights-from-store`` need the fleet KV store tier: they exit 2
  naming ROADMAP queue 1 item 9, step 9d.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request

from ..main import CommandError

STORE_TIER = "ROADMAP queue 1 item 9, step 9d"
URL = "http://127.0.0.1:8080"


def _store_refusal(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet: it needs the "
        f"fleet KV store tier ({STORE_TIER})")


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=prog, description="Serve-fleet operations (router + replica "
                               "supervisor).")
    sub = ap.add_subparsers(
        dest="sub", metavar="{status,drain,undrain,role,migrate,worker,"
                            "front,store,ship-weights}")
    st = sub.add_parser("status", help="Per-replica health, queue depths "
                                       "and the router ledger.")
    st.add_argument("--url", default=URL, help="Fleet server base URL.")
    st.add_argument("--json", dest="as_json", action="store_true",
                    default=False, help="Raw JSON instead of the table.")
    for name, help_ in (("drain", "Gracefully drain REPLICA."),
                        ("undrain", "Return a drained REPLICA to "
                                    "rotation.")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("replica", type=int)
        p.add_argument("--url", default=URL)
    ro = sub.add_parser("role", help="Re-role REPLICA for disaggregated "
                                     "prefill/decode serving.")
    ro.add_argument("replica", type=int)
    ro.add_argument("role", choices=["prefill", "decode", "mixed"])
    ro.add_argument("--url", default=URL)
    mi = sub.add_parser("migrate", help="Live-migrate REQUEST_ID to REPLICA "
                                        "with its KV pages.")
    mi.add_argument("request_id")
    mi.add_argument("replica", type=int)
    mi.add_argument("--url", default=URL)
    _worker_parser(sub)
    _front_parser(sub)
    so = sub.add_parser("store", help="The fleet KV store service "
                                      f"({STORE_TIER}).")
    so.add_argument("--host", default="127.0.0.1")
    so.add_argument("--port", default=0, type=int)
    so.add_argument("--dram-mb", default=256.0, type=float)
    so.add_argument("--dir", dest="spill_dir", default="")
    so.add_argument("--disk-mb", default=1024.0, type=float)
    so.add_argument("--ttl-ms", default=0.0, type=float)
    so.add_argument("--courier-codec", default="none",
                    choices=["none", "zlib", "delta-zlib"])
    so.add_argument("--courier-chunk-bytes", default=256 * 1024, type=int)
    so.add_argument("--member-id", default="")
    so.add_argument("--membership-dir", default="")
    so.add_argument("--peer", dest="peers", action="append", default=[])
    so.add_argument("--sync-interval-ms", default=1000.0, type=float)
    sw = sub.add_parser("ship-weights", help="Register a checkpoint in the "
                                             f"store service ({STORE_TIER}).")
    sw.add_argument("--store-endpoint", default=None)
    sw.add_argument("--write-ack", default=0, type=int)
    sw.add_argument("--model", dest="model_name", default="gpt-125m")
    sw.add_argument("--artifact", default="")
    sw.add_argument("--name", dest="weights_name", default="")
    sw.add_argument("--param-seed", default=-1, type=int)
    return ap


def _worker_parser(sub) -> None:
    w = sub.add_parser("worker", help="Run one fleet replica as its own OS "
                                      "process behind an HTTP front.")
    add = w.add_argument
    add("--model", dest="model_name", default="gpt-125m",
        help="Model template name.")
    add("--artifact", default="",
        help="Export artifact file or checkpoint dir (the JAX package's or "
             "the port's).")
    add("--replica-id", default=0, type=int,
        help="This worker's replica id in the parent fleet (its "
             "--fleet-endpoint entry).")
    add("--role", default="mixed", choices=["prefill", "decode", "mixed"])
    add("--host", default="127.0.0.1")
    add("--port", default=0, type=int,
        help="0 binds a free port; printed as 'LLMCTL_WORKER_READY port=N'.")
    add("--max-batch-size", default=8, type=int)
    add("--max-seq-len", default=2048, type=int)
    add("--prefill-chunk", default=0, type=int,
        help="Chunked prefill size (0 = engine default).")
    add("--kv-block-size", default=64, type=int)
    add("--dtype", default=None, choices=["bfloat16", "float32"],
        help="Serving dtype (default bf16 on the card, fp32 on the CPU).")
    add("--kv-quantization", default="none", choices=["none", "int8", "int4"])
    add("--speculative", default="off", choices=["off", "ngram"])
    add("--spec-tokens", default=8, type=int)
    add("--seed", default=0, type=int, help="Engine sampling seed base.")
    add("--param-seed", default=-1, type=int,
        help="Initialise weights from this seed instead of loading an "
             "artifact (-1 = the artifact, or random init from --seed "
             "without one).")
    add("--courier-codec", default="none",
        choices=["none", "zlib", "delta-zlib"],
        help="Wire codec of this worker's outbound courier pushes.")
    add("--courier-chunk-bytes", default=256 * 1024, type=int)
    add("--courier-retries", default=4, type=int)
    add("--courier-deadline-ms", default=100.0, type=float)
    add("--courier-backoff-ms", default=2.0, type=float)
    add("--courier-backoff-max-ms", default=100.0, type=float)
    add("--ticket-ttl-ms", default=60_000.0, type=float,
        help="Evict unclaimed courier tickets after this long.")
    add("--restart-backoff", default=0.5, type=float,
        help="First local engine-rebuild delay after a crash; doubles per "
             "consecutive crash.")
    add("--migrate-on-drain", default=True,
        action=argparse.BooleanOptionalAction)
    add("--store-endpoint", default="", help=f"({STORE_TIER})")
    add("--store-endpoints", default="", help=f"({STORE_TIER})")
    add("--weights-from-store", action="store_true", default=False,
        help=f"({STORE_TIER})")
    add("--weights-name", default="", help=f"({STORE_TIER})")
    add("--weights-spool", default="", help=f"({STORE_TIER})")
    add("--fault-plan", default="",
        help="JSON FaultPlan for deterministic chaos (testing).")


def _front_parser(sub) -> None:
    f = sub.add_parser("front", help="Run one stateless fleet front as its "
                                     "own OS process.")
    add = f.add_argument
    add("--model", dest="model_name", default="gpt-125m",
        help="Model template name.")
    add("--artifact", default="",
        help="Tokenizer source (fronts never load weights).")
    add("--front-id", default="",
        help="Stable front identity in the shared state store.")
    add("--host", default="127.0.0.1")
    add("--port", default=0, type=int,
        help="0 binds a free port; printed as 'LLMCTL_FRONT_READY port=N "
             "front=ID'.")
    add("--replicas", default=1, type=int,
        help="Fleet size this front routes over (all remote).")
    add("--remote-replicas", default="",
        help="Comma-separated replica ids served by fleet workers (every "
             "replica).")
    add("--fleet-endpoint", dest="fleet_endpoints", action="append",
        default=[], help="replica=url endpoint map entries (repeat).")
    add("--state-store-dir", required=True,
        help="Shared file state store directory.")
    add("--max-batch-size", default=8, type=int)
    add("--max-seq-len", default=2048, type=int)
    add("--kv-block-size", default=64, type=int)
    add("--probe-interval", default=0.1, type=float,
        help="Supervisor poll cadence (also the store heartbeat's).")
    add("--probe-failures", default=3, type=int)
    add("--remote-timeout", default=5.0, type=float)
    add("--max-pending", default=512, type=int)
    add("--stream-ttl-ms", default=60_000.0, type=float)
    add("--affinity-tokens", default=0, type=int,
        help="Prefix-affinity tokens (0 = least outstanding tokens).")
    add("--courier-chunk-bytes", default=256 * 1024, type=int)
    add("--courier-retries", default=4, type=int)
    add("--courier-deadline-ms", default=100.0, type=float)
    add("--fault-plan", default="",
        help="JSON FaultPlan for deterministic chaos (testing).")


# -- the operator verbs --------------------------------------------------------

def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read().decode())


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read().decode())


def _die(e: Exception) -> CommandError:
    if isinstance(e, urllib.error.HTTPError):
        try:
            detail = json.loads(e.read().decode()).get("error", "")
        except Exception:
            detail = ""
        return CommandError(f"HTTP {e.code}: {detail or e.reason}")
    return CommandError(str(e))


def _table(rows: list, head: tuple) -> str:
    widths = [max(len(str(r[i])) for r in [head] + rows)
              for i in range(len(head))]
    return "\n".join("  ".join(str(c).ljust(w) for c, w in zip(r, widths))
                     .rstrip() for r in [head] + rows)


COLUMNS = ("replica", "state", "role", "endpoint", "remote?", "queue",
           "active", "outstanding tok", "restarts", "migr out", "handoffs",
           "streams", "replayed", "courier out", "courier aborts",
           "prefix hit", "pfx fetched", "pfx miss", "spec acc",
           "last error")


def render_status(snap: dict) -> str:
    """The JAX command's table and summary lines, in plain text."""
    per_src = snap.get("courier", {}).get("per_src", {})
    rows = []
    for r in snap["replicas"]:
        hit = r.get("prefix_hit_rate")
        role = r.get("role", "mixed")
        if r.get("promoted_from"):
            role = f"{role} (was {r['promoted_from']})"
        src = per_src.get(str(r["replica"]), {})
        if r.get("spec_drafts"):
            spec = f"{r.get('spec_acceptance', 0.0):.0%}"
            if r.get("spec_resumes"):
                spec += f" +{r['spec_resumes']}res"
        else:
            spec = "-"
        rows.append((r["replica"], r["state"], role,
                     r.get("endpoint", "local"),
                     "yes" if r.get("remote") else "-", r["queue_depth"],
                     r["active"], r["outstanding_tokens"], r["restarts"],
                     r.get("migrations", 0), r.get("handoffs", 0),
                     r.get("active_streams", 0),
                     r.get("stream_replayed_tokens", 0),
                     src.get("transfers", 0), src.get("aborts", 0),
                     f"{hit:.0%}" if hit is not None else "-",
                     r.get("prefix_fetch_pages", 0),
                     r.get("prefix_fetch_misses", 0), spec,
                     (r.get("last_error") or "")[:48]))
    lines = ["Fleet replicas", _table(rows, COLUMNS)]
    rt = snap["router"]
    lines.append(
        f"router: {rt['completed']}/{rt['submitted']} completed, "
        f"{rt['rejected']} rejected (429), {rt['requeues']} requeues, "
        f"{rt['in_flight']} in flight, {rt['parked']} parked")
    mig = snap.get("migration")
    if mig:
        lines.append(
            f"migration: {mig['migrations']} moved "
            f"({mig['migrated_tokens']} KV tokens, "
            f"{mig['reprefill_tokens_avoided']} re-prefill tokens "
            f"avoided, {mig.get('rebalance_migrations', 0)} "
            f"rebalancer-ordered, {mig['in_flight']} in flight)")
    ho = snap.get("handoff")
    if ho and any(ho.get(k) for k in ("handoffs", "local_fallbacks",
                                      "reroles", "promotions",
                                      "demotions")):
        lines.append(
            f"disagg: {ho.get('handoffs', 0)} prefill->decode handoffs "
            f"({ho.get('handoff_tokens', 0)} KV tokens, "
            f"{ho.get('local_fallbacks', 0)} local fallbacks, "
            f"{ho.get('reroles', 0)} re-roles, "
            f"{ho.get('promotions', 0)} promotions, "
            f"{ho.get('demotions', 0)} demotions)")
    s = snap.get("streams")
    if s and (s.get("opened") or s.get("active")):
        lines.append(
            f"streams: {s.get('active', 0)} live / {s.get('opened', 0)} "
            f"opened, {s.get('tokens', 0)} tokens, "
            f"{s.get('duplicates', 0)} producer dups suppressed, "
            f"{s.get('reconnects', 0)} reconnects "
            f"({s.get('replayed', 0)} tokens replayed), "
            f"{s.get('gaps_healed', 0)} gap-healed, "
            f"{s.get('backpressure_drops', 0)} backpressure drops, "
            f"{s.get('identity_mismatches', 0)} identity violations")
    ft = snap.get("front_tier")
    if ft and ft.get("fronts"):
        per_front = ", ".join(
            f"{fid}:{e.get('port', '?')} ["
            + ("up" if e.get("alive") else "fenced" if e.get("fenced")
               else "down") + "]"
            for fid, e in sorted(ft["fronts"].items()))
        lines.append(
            f"front tier: {per_front} — {ft.get('failovers', 0)} failovers, "
            f"{ft.get('reconnects', 0)} failover resumes served here "
            f"(this front: {ft.get('front_id', '?')})")
    sp = snap.get("spec")
    if sp and sp.get("dispatches"):
        lines.append(
            f"speculative: {sp.get('accepted', 0)}/{sp.get('drafts', 0)} "
            f"drafts accepted ({sp.get('acceptance', 0.0):.0%} over "
            f"{sp.get('dispatches', 0)} dispatches, "
            f"{sp.get('resumes', 0)} migrated-state resumes)")
    pf = snap.get("prefix_fetch")
    if pf and (pf.get("pages") or pf.get("misses") or pf.get("aborts")):
        lines.append(
            f"prefix fetch: {pf.get('pages', 0)} pages pulled from "
            f"siblings ({pf.get('bytes', 0)} bytes, "
            f"{pf.get('fetches', 0)} fetches, {pf.get('misses', 0)} "
            f"misses, {pf.get('aborts', 0)} aborts)")
    pl = snap.get("pipeline")
    if pl and (pl.get("pipelines") or pl.get("collapses")):
        overlap = pl.get("overlap_ratio")
        lines.append(
            f"pipelined prefill: {pl.get('completed', 0)}/"
            f"{pl.get('pipelines', 0)} pipelines completed "
            f"({pl.get('stages', 0)} stages, {pl.get('collapses', 0)} "
            f"collapses to single-replica, {pl.get('in_flight', 0)} in "
            f"flight), {pl.get('preshipped_pages', 0)} pages pre-shipped "
            f"({pl.get('preship_hidden_ms', 0)}/{pl.get('preship_ms', 0)} "
            f"ms hidden behind compute, {pl.get('preship_timeouts', 0)} "
            f"pre-ship timeouts"
            + (f", {overlap:.0%} overlap" if overlap is not None else "")
            + ")")
    by_cls = rt.get("submitted_by_class") or {}
    rej_cls = rt.get("rejected_by_class") or {}
    if any(by_cls.values()) or any(rej_cls.values()):
        lines.append("priority: " + ", ".join(
            f"{cls} {by_cls.get(cls, 0)} admitted / {rej_cls.get(cls, 0)} "
            f"shed" for cls in ("interactive", "standard", "best-effort")))
    cour = snap.get("courier")
    if cour and (cour.get("transfers") or cour.get("aborts")
                 or cour.get("in_flight") or cour.get("expired")):
        lines.append(
            f"courier: {cour.get('in_flight', 0)} in flight, "
            f"{cour.get('transfers', 0)} transfers "
            f"({cour.get('bytes_wire', cour.get('bytes_moved', 0))} "
            f"wire / {cour.get('bytes_raw', cour.get('bytes_moved', 0))} "
            f"raw bytes, {cour.get('compression_ratio', 1.0):.2f}x "
            f"compression, {cour.get('chunks', 0)} chunks, "
            f"{cour.get('retries', 0)} retries, "
            f"{cour.get('corruptions', 0)} corruptions, "
            f"{cour.get('resumes', 0)} resumes, {cour.get('aborts', 0)} "
            f"aborts, {cour.get('expired', 0)} expired tickets)")
    return "\n".join(lines)


def status(args) -> int:
    try:
        snap = _get(f"{args.url.rstrip('/')}/fleet/status")
    except Exception as e:
        raise _die(e)
    print(json.dumps(snap, indent=2) if args.as_json
          else render_status(snap))
    return 0


def _verb(args, path: str, body: dict, fmt: str) -> int:
    try:
        out = _post(f"{args.url.rstrip('/')}{path}", body)
    except Exception as e:
        raise _die(e)
    print(fmt.format(**out))
    return 0


# -- worker and front ----------------------------------------------------------

def _fault_plan(text: str):
    from ...serve.fleet.faults import FaultPlan
    if not text:
        return None
    try:
        return FaultPlan(**json.loads(text))
    except (TypeError, ValueError) as e:
        raise CommandError(f"bad --fault-plan JSON: {e}")


def worker_parts(args, device):
    """(model config, serve config, fleet config, params or None) of a
    parsed ``fleet worker`` line. ``--param-seed S`` builds the weights
    the engine builds from seed S (``InferenceEngine`` with no artifact);
    without it the engine loads ``--artifact``."""
    from ...config.presets import get_model_config
    from ...config.schema import FleetConfig, ServeConfig

    for flag, asked in (("--store-endpoint", args.store_endpoint),
                        ("--store-endpoints", args.store_endpoints),
                        ("--weights-from-store", args.weights_from_store)):
        if asked:
            raise _store_refusal(f"fleet worker {flag}")
    dtype = args.dtype or ("bfloat16" if device.type == "cuda"
                           else "float32")
    model_cfg = get_model_config(args.model_name)
    serve_kw = dict(
        model=args.model_name, artifact=args.artifact, host=args.host,
        port=args.port, max_batch_size=args.max_batch_size,
        max_seq_len=min(args.max_seq_len,
                        model_cfg.max_position_embeddings),
        kv_block_size=args.kv_block_size, dtype=dtype,
        kv_quantization=args.kv_quantization,
        speculative=args.speculative, speculative_tokens=args.spec_tokens)
    if args.prefill_chunk > 0:
        serve_kw["prefill_chunk"] = args.prefill_chunk
    serve_cfg = ServeConfig(**serve_kw)
    serve_cfg.validate()
    fleet_cfg = FleetConfig(
        replicas=1, migrate_on_drain=args.migrate_on_drain,
        restart_backoff_s=args.restart_backoff,
        courier_codec=args.courier_codec,
        courier_chunk_bytes=args.courier_chunk_bytes,
        courier_max_retries=args.courier_retries,
        courier_chunk_deadline_ms=args.courier_deadline_ms,
        courier_retry_backoff_ms=args.courier_backoff_ms,
        courier_retry_backoff_max_ms=args.courier_backoff_max_ms,
        courier_ticket_ttl_ms=args.ticket_ttl_ms)
    fleet_cfg.validate()
    params = None
    if args.param_seed >= 0:
        import torch

        from ...models import gpt
        gen = torch.Generator(device=device).manual_seed(args.param_seed)
        params = gpt.init(model_cfg, gen, device=device,
                          dtype=getattr(torch, dtype))
    return model_cfg, serve_cfg, fleet_cfg, params


def worker(args) -> int:
    from ...device import resolve_device
    from ...serve.fleet.worker import (PARAMS_PREFIX, FleetWorker,
                                       params_checksum)

    device = resolve_device(args.root.device)
    model_cfg, serve_cfg, fleet_cfg, params = worker_parts(args, device)
    w = FleetWorker(args.replica_id, model_cfg, serve_cfg,
                    fleet_cfg=fleet_cfg, role=args.role, params=params,
                    seed=args.seed, fault_plan=_fault_plan(args.fault_plan),
                    device=device)
    print(f"{PARAMS_PREFIX} checksum={params_checksum(w.params)!r}",
          file=sys.stderr, flush=True)
    w.run_forever(host=args.host, port=args.port)
    return 0


def front_parts(args):
    """(model config, serve config, fleet config) of a parsed ``fleet
    front`` line."""
    from ...config.presets import get_model_config
    from ...config.schema import (FleetConfig, ServeConfig,
                                  parse_fleet_endpoints)

    model_cfg = get_model_config(args.model_name)
    serve_cfg = ServeConfig(
        model=args.model_name, artifact=args.artifact, host=args.host,
        port=args.port, max_batch_size=args.max_batch_size,
        max_seq_len=min(args.max_seq_len,
                        model_cfg.max_position_embeddings),
        kv_block_size=args.kv_block_size, dtype="float32")
    serve_cfg.validate()
    fleet_cfg = FleetConfig(
        replicas=args.replicas, remote_replicas=args.remote_replicas,
        fleet_endpoints=parse_fleet_endpoints(list(args.fleet_endpoints)),
        state_store="file", state_store_dir=args.state_store_dir,
        probe_interval_s=args.probe_interval,
        probe_failures=args.probe_failures,
        remote_timeout_s=args.remote_timeout, max_pending=args.max_pending,
        stream_log_ttl_ms=args.stream_ttl_ms,
        affinity_prefix_tokens=args.affinity_tokens,
        courier_chunk_bytes=args.courier_chunk_bytes,
        courier_max_retries=args.courier_retries,
        courier_chunk_deadline_ms=args.courier_deadline_ms)
    fleet_cfg.validate()
    return model_cfg, serve_cfg, fleet_cfg


def front(args) -> int:
    from ...serve.fleet.front import run_front

    model_cfg, serve_cfg, fleet_cfg = front_parts(args)
    run_front(model_cfg, serve_cfg, fleet_cfg,
              front_id=args.front_id or None,
              fault_plan=_fault_plan(args.fault_plan))
    return 0


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch fleet").print_help()
        return 0
    if args.sub == "status":
        return status(args)
    if args.sub in ("drain", "undrain"):
        word = ("drain requested" if args.sub == "drain"
                else "back in rotation")
        return _verb(args, f"/fleet/{args.sub}", {"replica": args.replica},
                     "replica {replica}: " + word)
    if args.sub == "role":
        return _verb(args, "/fleet/role",
                     {"replica": args.replica, "role": args.role},
                     "replica {replica}: role set to {role}")
    if args.sub == "migrate":
        return _verb(args, "/fleet/migrate",
                     {"request_id": args.request_id,
                      "replica": args.replica},
                     "request {request_id}: migrating to replica "
                     "{replica}")
    if args.sub == "worker":
        return worker(args)
    if args.sub == "front":
        return front(args)
    raise _store_refusal(f"fleet {args.sub}")
