"""`llmctl-torch fleet` — operate a serving fleet (the JAX package's
``llmctl fleet``), on argparse and urllib.

- ``status`` reads ``GET /fleet/status`` and prints a plain-text table
  (``--json``: the snapshot itself, JAX's keys); ``drain``, ``undrain``,
  ``role`` and ``migrate`` post to the front's ``/fleet/*`` routes.
- ``worker`` runs one replica as its own process (serve/fleet/worker.py)
  on the global ``--device``, from ``--artifact`` (an export artifact or
  a checkpoint directory, the JAX package's or the port's), random
  weights from ``--param-seed``, or the store service
  (``--weights-from-store``, resumable through ``--weights-spool``); it
  prints ``LLMCTL_WORKER_READY port=N`` on stdout and its weights'
  checksum on stderr, and at SIGTERM its kernel launch counts on stderr.
  With ``--store-endpoint(s)`` it demotes to and restores from the store.
- ``front`` runs one stateless front of the HA tier over the shared file
  state store (serve/fleet/front.py); it holds no model.
- ``store`` runs the fleet KV store service (serve/fleet/store_service.py)
  and prints ``LLMCTL_STORE_READY port=N``; it holds no tensor.
- ``ship-weights`` registers a checkpoint (``--artifact`` or
  ``--param-seed``, built on the global ``--device``) in the store
  service, in the JAX package's tree layout.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request

from ..main import CommandError

URL = "http://127.0.0.1:8080"


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
    so = sub.add_parser("store", help="Run the fleet KV store as its own "
                                      "OS process.")
    so.add_argument("--host", default="127.0.0.1")
    so.add_argument("--port", default=0, type=int,
                    help="0 binds a free port; printed as "
                         "'LLMCTL_STORE_READY port=N'.")
    so.add_argument("--dram-mb", default=256.0, type=float,
                    help="DRAM ring capacity, in MB of compressed frames.")
    so.add_argument("--dir", dest="spill_dir", default="",
                    help="Disk-spill directory (empty = DRAM only).")
    so.add_argument("--disk-mb", default=1024.0, type=float,
                    help="Disk-spill capacity bound.")
    so.add_argument("--ttl-ms", default=0.0, type=float,
                    help="Expire entries nobody fetched for this long "
                         "(0 = keep).")
    so.add_argument("--courier-codec", default="none",
                    choices=["none", "zlib", "delta-zlib"],
                    help="Codec of frames encoded here ('none' stores "
                         "zlib).")
    so.add_argument("--courier-chunk-bytes", default=256 * 1024, type=int)
    so.add_argument("--member-id", default="",
                    help="This process's id in a replicated store tier "
                         "(with --membership-dir).")
    so.add_argument("--membership-dir", default="",
                    help="Shared directory of the tier's fenced member "
                         "registry.")
    so.add_argument("--peer", dest="peers", action="append", default=[],
                    help="Static peer member URL for anti-entropy "
                         "(repeatable).")
    so.add_argument("--sync-interval-ms", default=1000.0, type=float,
                    help="Anti-entropy cadence.")
    sw = sub.add_parser("ship-weights", help="Register a checkpoint in the "
                                             "store service over the wire.")
    sw.add_argument("--store-endpoint", required=True,
                    help="Store service URL, or comma-separated member "
                         "URLs of a replicated tier.")
    sw.add_argument("--write-ack", default=0, type=int,
                    help="Members that must hold the whole payload (0 = "
                         "every live member).")
    sw.add_argument("--model", dest="model_name", default="gpt-125m",
                    help="Model template name.")
    sw.add_argument("--artifact", default="",
                    help="Export artifact file or checkpoint dir to ship.")
    sw.add_argument("--name", dest="weights_name", default="",
                    help="Name to register under (default: the model "
                         "name).")
    sw.add_argument("--param-seed", default=-1, type=int,
                    help="Ship the weights initialised from this seed.")
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
    add("--store-endpoint", default="",
        help="A `fleet store` service: evicted prefix pages demote there "
             "and store-held pages restore from it.")
    add("--store-endpoints", default="",
        help="Comma-separated member URLs of a replicated store tier "
             "(overrides --store-endpoint).")
    add("--weights-from-store", action="store_true", default=False,
        help="Boot the weights from the store service instead of an "
             "artifact.")
    add("--weights-name", default="",
        help="Checkpoint name in the store (default: --model).")
    add("--weights-spool", default="",
        help="Directory where fetched weight chunks persist, so a "
             "respawned worker resumes its fetch.")
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
    au = snap.get("autoscale")
    if au and au.get("enabled"):
        retiring = au.get("retiring")
        lines.append(
            f"autoscale: {au.get('replicas', 0)} replicas "
            f"(floor {au.get('floor', 0)}, ceiling {au.get('ceiling', 0)}"
            + (f", retiring {retiring}" if retiring is not None else "")
            + f"), {au.get('scale_ups', 0)} scale-ups / "
            f"{au.get('scale_downs', 0)} scale-downs, "
            f"{au.get('spawn_failures', 0)} spawn failures, "
            f"{au.get('retire_rollbacks', 0)} retire rollbacks, "
            f"{au.get('preemptions', 0)} best-effort preemptions")
    by_cls = rt.get("submitted_by_class") or {}
    rej_cls = rt.get("rejected_by_class") or {}
    if any(by_cls.values()) or any(rej_cls.values()):
        lines.append("priority: " + ", ".join(
            f"{cls} {by_cls.get(cls, 0)} admitted / {rej_cls.get(cls, 0)} "
            f"shed" for cls in ("interactive", "standard", "best-effort")))
    if rt.get("store_hint_remote_skips"):
        lines.append(
            f"store hints: {rt['store_hint_remote_skips']} skipped for "
            f"remote destinations (store tier unreachable from workers)")
    ks = snap.get("kv_store")
    if ks and (ks.get("demotions") or ks.get("hits") or ks.get("misses")):
        lines.append(
            f"kv store: {ks.get('hits', 0)} page hits / "
            f"{ks.get('misses', 0)} misses "
            f"({ks.get('bytes_served', 0)} bytes replayed), "
            f"{ks.get('demotions', 0)} demotions, "
            f"dram {ks.get('dram_entries', 0)} pages / "
            f"{ks.get('dram_bytes', 0)} bytes, "
            f"disk {ks.get('disk_entries', 0)} pages / "
            f"{ks.get('disk_bytes', 0)} bytes, "
            f"{ks.get('evictions', 0)} evictions "
            f"({ks.get('spills', 0)} spills, {ks.get('corrupt', 0)} "
            f"corrupt) [{ks.get('codec', '?')}]")
    if ks and len(ks.get("endpoints") or []) > 1:
        reach = ks.get("members") or {}
        lines.append(
            "store tier: "
            + ", ".join(f"{ep} {'up' if ok else 'DOWN'}"
                        for ep, ok in reach.items())
            + f" | {ks.get('retries', 0)} retries, "
              f"{ks.get('failovers', 0)} failovers, "
              f"{ks.get('hedges', 0)} hedged fetches, "
              f"{ks.get('fenced_rejects', 0)} fenced rejects, "
              f"{ks.get('sync_pulls', 0)} anti-entropy pulls")
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
    ``--weights-from-store`` fetches them from the store service, and
    refuses to start, naming the endpoint, when it cannot; without either
    the engine loads ``--artifact``."""
    from ...config.presets import get_model_config
    from ...config.schema import FleetConfig, ServeConfig

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
        courier_ticket_ttl_ms=args.ticket_ttl_ms,
        kv_store_endpoint=args.store_endpoint,
        kv_store_endpoints=args.store_endpoints,
        # the fetch plane is how store-held pages restore here
        prefix_fetch=bool(args.store_endpoint or args.store_endpoints))
    fleet_cfg.validate()
    params = None
    if args.param_seed >= 0:
        params = seeded_params(model_cfg, args.param_seed, device, dtype)
    elif args.weights_from_store:
        if not (args.store_endpoint or args.store_endpoints):
            raise CommandError("--weights-from-store needs --store-endpoint "
                               "or --store-endpoints")
        import torch

        from ...serve.fleet.weights import WeightCourier, WeightShipError
        from ...weights import params_from_jax
        wc = WeightCourier(fleet_cfg, spool_dir=args.weights_spool)
        try:
            tree = wc.fetch(args.weights_name or args.model_name)
        except WeightShipError as e:
            raise CommandError(str(e))
        params = params_from_jax(tree, model_cfg, device=device,
                                 dtype=getattr(torch, dtype))
    return model_cfg, serve_cfg, fleet_cfg, params


def seeded_params(model_cfg, seed: int, device, dtype: str):
    """The weights ``InferenceEngine`` builds from ``seed`` with no
    artifact: ``gpt.init`` on ``device`` in ``dtype``."""
    import torch

    from ...models import gpt
    gen = torch.Generator(device=device).manual_seed(seed)
    return gpt.init(model_cfg, gen, device=device,
                    dtype=getattr(torch, dtype))


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


def store(args) -> int:
    """Run the fleet KV store service until SIGTERM. It holds no tensor:
    the global ``--device`` is never touched."""
    from ...config.schema import FleetConfig
    from ...serve.fleet.store_service import StoreService

    cfg = FleetConfig(
        replicas=1, prefix_fetch=True, kv_store=True,
        kv_store_dram_mb=args.dram_mb, kv_store_dir=args.spill_dir,
        kv_store_disk_mb=args.disk_mb, kv_store_ttl_ms=args.ttl_ms,
        courier_codec=args.courier_codec,
        courier_chunk_bytes=args.courier_chunk_bytes)
    cfg.validate()
    # warm=False: the disk scan runs behind the /health readiness gate
    StoreService(cfg, member_id=args.member_id,
                 membership_dir=args.membership_dir, peers=list(args.peers),
                 sync_interval_s=args.sync_interval_ms / 1e3,
                 warm=False).run_forever(host=args.host, port=args.port)
    return 0


def ship_weights(args) -> int:
    """Register a checkpoint in the store service: the JAX package's tree
    layout, upload-resumable."""
    from ...config.presets import get_model_config
    from ...device import resolve_device
    from ...serve.fleet.weights import WeightCourier, WeightShipError

    model_cfg = get_model_config(args.model_name)
    device = resolve_device(args.root.device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    if args.param_seed >= 0:
        params = seeded_params(model_cfg, args.param_seed, device, dtype)
    elif args.artifact:
        from types import SimpleNamespace

        import torch

        from ...config.schema import ServeConfig
        from ...serve.engine import InferenceEngine
        # the engine's loader alone: no KV pool is allocated
        serve_cfg = ServeConfig(model=args.model_name,
                                artifact=args.artifact)
        params, model_cfg, _ = InferenceEngine._load_params(
            SimpleNamespace(device=device), model_cfg, serve_cfg, 0,
            getattr(torch, dtype))
    else:
        raise CommandError("ship-weights needs --artifact or --param-seed")
    wc = WeightCourier(endpoint=args.store_endpoint,
                       write_ack=args.write_ack)
    try:
        out = wc.ship(args.weights_name or args.model_name, params)
    except WeightShipError as e:
        raise CommandError(str(e))
    print(f"weights {out['name']!r} registered on {out['members']} "
          f"member(s): {out['sent']} chunks sent, {out['skipped']} already "
          f"held ({out['total']} total)")
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
    if args.sub == "store":
        return store(args)
    return ship_weights(args)
