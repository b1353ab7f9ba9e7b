"""Inference engine: prefill/decode over a paged KV cache, continuous
batching.

Counterpart of the JAX package's ``serve/engine.py`` for the default
serving path:

- **Prefill**: a prompt is padded to a bucket (``prefill_chunk`` multiples),
  run through the dense ``models.gpt.forward`` with a dense cache, and its
  K/V scattered into the slot's pages (the bucket's padded tail goes to
  scratch page 0). With prefix caching, a prompt whose leading full pages
  are cached computes only the suffix through ``decode.extend_step_forward``
  over the cached pages.
- **Decode**: every slot advances one token per step; a dispatch is a
  group of ``units`` x ``unit_len`` steps whose tokens stay on the device
  and are fetched once. At half-full batches or more, one group stays in
  flight: the next group is enqueued, chained on the previous group's
  device-resident tokens, before the previous one is fetched.
- **Weights**: random from the seed, or from ``artifact``: an export
  artifact (``.safetensors``/``.npz``, possibly pre-quantized: quantized
  kernels go to the device as they are stored), a JAX package checkpoint
  directory or one of the port's own (params only).
- **Quantization**: ``quantization`` int8 | int4 | int4-awq quantizes the
  block kernels at construction (W8A16 / group-wise W4A16, int4-awq with
  channel scales calibrated by one forward over 2 x min(256,
  max_seq_len) tokens drawn as the JAX engine draws them; embedding, LM
  head and norms keep full precision), and ``kv_quantization`` int8 | int4
  stores the KV pages quantized, each token quantized as it is written.
  Decode sends W4 weights, and W8 weights with ``int8_pallas_matmul``, to
  the in-kernel-dequant matmuls; prefill dequantizes one layer at a time.
- **Admission**: on demand by default (pages for one dispatch of lookahead;
  chains grow as decode advances, and the newest resident request is
  preempted when the pool runs dry). ``preemption="recompute"`` re-prefills
  the victim on readmission; ``"swap"`` copies its pages to host memory
  (``kv_cache.extract_slot``, up to ``swap_space_gb``) and writes them back
  on readmission with no prefill; a payload the pool cannot take, or a
  malformed one, falls back to re-prefill (counted in ``swap_fallbacks``).
- **Chunked prefill** (``chunked_prefill_tokens`` C > 0): a context longer
  than C prefills C tokens an engine step through ``extend_step_forward``
  over the slot's pages (the paged kernel at windows of up to C rows),
  interleaved with decode; at most ``prefill_budget_tokens`` of chunks a
  step, round-robin over the requests in flight. Intermediate chunks skip
  the head. Windows of more than 64 rows send quantized weights to the
  dequant route.
- **Speculative decoding** (``speculative="ngram"``): while a greedy
  stream is resident, a dispatch is one verify window of
  ``speculative_tokens`` T (host n-gram drafts, ``serve/speculative.py``)
  plus K - 1 decode steps; after 64 dispatches under
  ``speculative_min_acceptance`` it switches itself off.

- **Fleet hooks** (``serve/fleet/``): ``on_prefill_complete`` (the
  disaggregated handoff boundary), ``prefix_fetch_hook`` (pages fetched
  from another replica's prefix cache before a prefill, and the tail of a
  crash-salvaged partial payload), ``pipeline_chunk_hook`` with the
  chunk-by-chunk page publishing of a pipeline-stage request, partial
  restores (a payload's full pages written back, only the tail
  re-prefilled) and ``expect_pure_decode`` (a decode-role replica counts
  the prefills it still runs).

- **Tensor parallelism** (``tensor_parallel`` tp > 1): the engine is
  built on every rank of an initialised process group of tp ranks
  (``parallel.mesh.init_distributed``). Each rank holds its shard of
  every weight (quantized whole first, as the JAX engine does, then cut:
  ``weights.rank_model``) and its Nkv/tp heads of every page. Rank 0 leads
  (``serve/tp.py``): before each device operation it broadcasts a host
  descriptor, and the other ranks run the same operation from
  ``follow()``. Every rank calls its own paged, W8 and W4 kernels on its
  heads and shards, where the JAX engine, under GSPMD, gives them up
  (gather attention, dequantized weights). MoE under tp > 1 waits for
  expert parallelism, and raises naming ROADMAP queue 1 item 7b.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..analysis.annotations import engine_thread_only
from ..config.schema import _parse_bool
from ..device import resolve_device, to_device
from ..io.checkpoint import (CheckpointManager, apply_ckpt_model_overrides,
                             params_from_flat)
from ..io.export import load_exported
from ..models import gpt
from ..ops.paged_attention import (Int4Pages, QuantPages, quantize_kv_token,
                                   quantize_kv_token_int4)
from ..ops.quantization import (QuantTensor, Quant4Tensor, int4_group_for,
                                pack_int4_rows, quantize_int4_groupwise,
                                quantize_int8, to_runtime_quant)
from ..weights import (jax_path, model_from_named, params_from_jax,
                       rank_model)
from .decode import decode_scan, extend_step_forward
from .kv_cache import (PagedKVCache, concat_page_payloads, payload_bytes,
                       prefix_page_hashes, slice_page_payload)
from .sampling import gumbel_noise, prng_key, randint, sample_tokens
from .speculative import SpecState, propose_ngram_draft, verify_and_decode
from .scheduler import (ContinuousBatchingScheduler, Request, RequestState,
                        SamplingParams)
from .tp import STOP, RankLink, on_every_rank

logger = logging.getLogger("llmctl.serve.engine")

MULTI_GPU = "ROADMAP queue 1 item 7b"

QUANT_MIN_SIZE = 4096    # elements of the stacked [L, in, out] kernel


@torch.no_grad()
def quantize_blocks(model: gpt.GPT, kind: str, free_source: bool = False,
                    act: Optional[dict] = None) -> gpt.GPT:
    """A model over ``model``'s embedding, norms and head with its block
    kernels quantized: the per-layer result of the JAX engine's
    ``quantize_tree_int8(blocks, min_ndim=3)`` (``kind`` "int8") or
    ``quantize_tree_int4`` ("int4") over the stacked tree. A kernel
    [in, out] (an MoE router [H, E] too) or an MoE expert stack [E, in,
    out] quantizes when the stacked leaf would (L * numel >=
    ``QUANT_MIN_SIZE``); int4 takes the largest group up to 128 that
    divides ``in`` for a kernel and falls back to int8 where none does.
    Expert stacks take int8 in both modes (the JAX int4 pass groups only
    3-D stacked leaves; the experts' [L, E, in, out] is 4-D). ``act``
    ({stacked JAX path: [L, in]}, ``activation_channel_scales``) gives
    the int4 kernels it covers their AWQ channel scales. Biases and
    norm scales stay as they are. Leaf by leaf, on the model's device; with
    ``free_source`` each full-precision kernel is dropped from ``model`` as
    soon as it is quantized, so the two copies never coexist."""
    L = len(model.blocks)
    act = act or {}
    blocks = []
    for i, blk in enumerate(model.blocks):
        leaves = {}
        for name, p in blk.leaves().items():
            if (isinstance(p, (QuantTensor, Quant4Tensor))
                    or p.dim() not in (2, 3)
                    or L * p.numel() < QUANT_MIN_SIZE):
                leaves[name] = p
                continue
            group = (int4_group_for(p.shape[0])
                     if kind == "int4" and p.dim() == 2 else 0)
            if group:
                scales = act.get(jax_path(f"blocks.{i}.{name}"))
                leaves[name] = Quant4Tensor(
                    *quantize_int4_groupwise(
                        p.detach(), group=group,
                        act_scale=None if scales is None else scales[i]),
                    group=group)
            else:
                leaves[name] = QuantTensor(*quantize_int8(p.detach()))
            if free_source:
                delattr(blk, name)
        blocks.append(leaves)
    return model.with_block_leaves(blocks)


class InferenceEngine:
    def __init__(
        self,
        model_cfg,
        serve_cfg,
        params: Optional[gpt.GPT] = None,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        device=None,
    ):
        serve_cfg.validate()
        self.device = resolve_device(device)
        tp = serve_cfg.tensor_parallel
        self.tp_mesh = self._link = None
        if tp > 1:
            self.tp_mesh = self._tp_mesh(model_cfg, tp)
        self.serve_cfg = serve_cfg
        self.eos_token_id = eos_token_id
        # the effective quantization: what the weights are, which a
        # pre-quantized model or artifact decides whatever the config
        # asks for
        self.quantization = serve_cfg.quantization
        dtype = getattr(torch, serve_cfg.dtype)
        own_params = params is None
        if own_params:
            # an artifact may override architecture facts (a tied
            # embedding): the effective config comes back with the params
            params, model_cfg, self.quantization = self._load_params(
                model_cfg, serve_cfg, seed, dtype)
        elif not isinstance(params, gpt.GPT):
            raise TypeError(
                "params must be a models.gpt.GPT (a JAX params tree goes "
                "through weights.params_from_jax first)")
        elif params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.cfg = model_cfg
        kinds = {type(leaf) for blk in params.blocks
                 for leaf in blk.leaves().values()}
        if Quant4Tensor in kinds or QuantTensor in kinds:
            if not own_params:
                self.quantization = ("int4" if Quant4Tensor in kinds
                                     else "int8")
            logger.info("serving pre-quantized weights (%s)",
                        self.quantization)
        elif serve_cfg.quantization in ("int8", "int4", "int4-awq"):
            act = None
            if serve_cfg.quantization == "int4-awq":
                # one synthetic calibration pass for the AWQ channel
                # statistic, on the JAX engine's tokens
                calib = randint(
                    prng_key(torch.zeros((), dtype=torch.int64,
                                         device=self.device)),
                    (2, min(256, serve_cfg.max_seq_len)), 1,
                    model_cfg.vocab_size)
                act = gpt.activation_channel_scales(params, model_cfg,
                                                    calib)
            # the caller's model is left as it is; a model this engine made
            # gives up each full-precision kernel as it is quantized
            if gpt.tp_mesh_of(params) is not None:
                raise ValueError(
                    "a tensor-parallel rank's weights are quantized whole "
                    "before they are cut (weights.rank_params_from_jax)")
            params = quantize_blocks(
                params, serve_cfg.quantization.split("-")[0],
                free_source=own_params, act=act)
            logger.info("serving with %s block weights",
                        serve_cfg.quantization)
        if tp > 1 and gpt.tp_mesh_of(params) is None:
            # the whole (quantized) model, cut to this rank's shard
            params = rank_model(params, self.tp_mesh, free_source=own_params)
            if own_params and self.device.type == "cuda":
                # the whole model's memory goes back to the card, which
                # the other ranks may share
                torch.cuda.empty_cache()
        self.params = params
        # the int8 kernels are opt-in, as in the JAX engine; the int4 kernel
        # is always on, under tp too (each rank calls it on its shard, where
        # the JAX engine under GSPMD turns it off)
        self._w8_kernel_ok = bool(serve_cfg.int8_pallas_matmul)

        S = serve_cfg.max_batch_size
        self.kv = PagedKVCache(
            model_cfg, num_slots=S, max_seq_len=serve_cfg.max_seq_len,
            page_size=serve_cfg.kv_block_size,
            num_pages=serve_cfg.kv_num_blocks,
            hbm_budget_gb=serve_cfg.kv_hbm_budget_gb, dtype=dtype,
            device=self.device, quantized=serve_cfg.kv_quantization, tp=tp)

        self._req_slot: dict[str, int] = {}
        # pages promised to admitted-but-not-yet-prefilled requests, per
        # request id (a request released before its prefill returns it)
        self._reserved_pages = 0
        self._reserved_by: dict[str, int] = {}
        # prefix-cache pins per request, dropped on release
        self._prefix_pins: dict[str, list[int]] = {}
        self.scheduler = ContinuousBatchingScheduler(
            max_batch_size=S, max_queue=serve_cfg.max_queue,
            max_seq_len=serve_cfg.max_seq_len,
            can_allocate=self._try_reserve,
            on_release=self._on_release,
            can_ever_allocate=lambda r: self.kv.can_ever_allocate(
                r.num_prompt_tokens + r.sampling.max_tokens))
        # guards scheduler/page bookkeeping shared with the server's
        # handler threads; never held across device work
        self.lock = threading.Lock()
        # fired on the engine thread when a request leaves its slot
        self.on_finish: Optional[Callable[[Request], None]] = None
        # fired on the engine thread with each batch of accepted tokens
        self.on_token: Optional[Callable[[Request, list], None]] = None
        # fired on the engine thread, no lock held, for each request still
        # RUNNING after its prefill step and before any decode dispatch:
        # a prefill-role fleet replica hands the sequence off here
        self.on_prefill_complete: Optional[Callable[[Request], None]] = None
        # a decode-role replica: a prefill still runs (a restore that does
        # not fit falls back to one) but is counted and logged
        self.expect_pure_decode = False
        self.total_unexpected_prefills = 0
        # partial payloads restored: their full pages written back, the
        # tail re-prefilled
        self.total_partial_restores = 0
        # (request, uncovered page hashes) -> {"hashes", "pages"} fetched
        # from another replica's prefix cache, or None; called on the
        # engine thread before a prefill. None fetches nothing.
        self.prefix_fetch_hook: Optional[Callable] = None
        # (request, done tokens, finished) after each chunk of a
        # pipeline-stage request, once its full pages are published; no
        # lock held
        self.pipeline_chunk_hook: Optional[Callable] = None
        # context tokens covered by pages fetched from another replica
        self.total_prefix_fetched_tokens = 0
        # of those, tokens fetched onto a partial payload's tail
        self.total_salvage_tail_fetched_tokens = 0

        # per-slot host state
        self.last_tokens = np.zeros(S, np.int64)
        self.positions = np.zeros(S, np.int64)      # cached length per slot
        self.stop_positions = np.zeros(S, np.int64)  # first un-writable pos
        self.active = np.zeros(S, bool)
        self.temperature = np.full(S, 1.0, np.float32)
        self.top_k = np.zeros(S, np.int64)
        self.top_p = np.ones(S, np.float32)
        self._slot_seeds = np.zeros(S, np.int64)
        self._base_seed = seed
        self._admitted_counter = 0
        # admission sequence per slot: preemption victims newest-first
        self._slot_seq = np.zeros(S, np.int64)
        self.total_preemptions = 0
        self.total_swap_ins = 0
        self.total_swap_outs = 0
        self.total_swap_out_bytes = 0
        # swap-ins that fell back to re-prefill (pool full, bad payload)
        self.total_swap_fallbacks = 0
        # per-slot context (prompt + accepted tokens) for the draft
        # proposer, extended in place as tokens are accepted
        self._ctx = np.zeros((S, serve_cfg.max_seq_len), np.int64)
        self._ctx_len = np.zeros(S, np.int64)
        # chunked prefill: request id -> progress; the round-robin resume
        # point is a request id (entries finish or cancel between steps)
        self._partial_prefills: dict[str, dict] = {}
        self._chunk_rr: Optional[str] = None
        self.total_chunked_prefills = 0    # requests that took chunks
        self.total_prefill_chunks = 0      # chunk dispatches

        # the one un-fetched in-flight dispatch group (see step())
        self._pending = None
        # dense prefill buckets run so far (measure_device_times' default)
        self._dense_buckets: set[int] = set()
        K = max(serve_cfg.decode_steps_per_dispatch, 1)
        # latency-adaptive dispatch: unit of L <= K-1 steps, a full group
        # chains ceil(K/L) units; L = 0 means one unit of K steps
        L = min(serve_cfg.latency_dispatch_steps, K - 1)
        self._decode_unit_len = L if L > 0 else K
        self._decode_units = -(-K // L) if L > 0 else 1
        self.total_short_dispatches = 0
        self.total_decode_steps = 0
        self.total_prefill_tokens = 0        # tokens actually computed
        self.total_prefix_cached_tokens = 0  # prompt tokens served by cache
        # prefill tokens a fleet requeue, fetch or partial restore did not
        # compute again (the fleet's reprefill_tokens_avoided)
        self.total_requeue_cached_tokens = 0
        self.total_padded_slot_steps = 0
        # decode steps enqueued (a pipelined group still in flight is
        # counted here, not in total_decode_steps) and suffix prefills:
        # together they say how many paged-attention passes ran per layer
        self.total_dispatched_steps = 0
        self.total_extend_prefills = 0
        # speculation: on until the adaptive check switches it off
        self._spec_on = serve_cfg.speculative == "ngram"
        # draft proposer (ctx, n, max_ngram) -> draft or None; None is the
        # n-gram proposer (an injected one dials acceptance in tests)
        self.draft_fn: Optional[Callable] = None
        self._spec_state: list[Optional[SpecState]] = [None] * S
        self.total_spec_dispatches = 0
        self.total_spec_drafts = 0
        self.total_spec_accepted = 0
        self.total_spec_resumes = 0        # slots armed from a carried state
        # device count of logits tensors with a NaN/inf (read in stats())
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        # paged forward passes this rank ran (decode steps, suffix and
        # chunk prefills, verify windows): each launches the paged kernel
        # once a layer, on every rank alike
        self.total_paged_passes = 0
        # the carry of the last decode unit enqueued (groups chain on it)
        self._carry = None
        # a tp rank's device digest of every token its decode and verify
        # dispatches sampled: equal on every rank
        self.token_digest = torch.zeros((), dtype=torch.int64,
                                        device=self.device)
        # tensor parallelism: the followers' swap payloads by request id,
        # and the ids whose payloads the next descriptor tells them to drop
        self._swap_store: dict[str, dict] = {}
        self._drops: list[str] = []
        if tp > 1:
            self._link = RankLink(self.tp_mesh)

    # -- tensor parallelism --------------------------------------------------

    def _tp_mesh(self, model_cfg, tp: int):
        """The tp mesh of this rank (every rank of an initialised process
        group of tp ranks builds its engine)."""
        import torch.distributed as dist

        from ..config.schema import ParallelConfig
        from ..parallel.mesh import build_mesh
        if model_cfg.is_moe:
            raise NotImplementedError(
                "MoE serving under tensor_parallel > 1 waits for expert "
                f"parallelism ({MULTI_GPU})")
        if model_cfg.num_kv_heads % tp or model_cfg.num_heads % tp:
            raise ValueError(
                f"tensor_parallel={tp} must divide num_heads="
                f"{model_cfg.num_heads} and num_kv_heads="
                f"{model_cfg.num_kv_heads}")
        if not dist.is_initialized() or dist.get_world_size() != tp:
            raise RuntimeError(
                f"tensor_parallel={tp} serves from {tp} ranks: build the "
                f"engine on every rank of an initialised process group of "
                f"{tp} (parallel.mesh.init_distributed; `serve start "
                f"--tensor-parallel {tp}` launches them)")
        return build_mesh(ParallelConfig(tensor_parallel=tp), self.device)

    @property
    def is_follower(self) -> bool:
        return self._link is not None and not self._link.leader

    def _host_state(self) -> dict:
        """The host arrays a decode-side operation reads, for the
        followers to mirror."""
        return {"last_tokens": self.last_tokens, "positions": self.positions,
                "stop_positions": self.stop_positions,
                "slot_seeds": self._slot_seeds, "active": self.active,
                "temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "block_tables": self.kv.block_tables}

    def _take_drops(self) -> list:
        drops, self._drops = self._drops, []
        return drops

    def follow(self) -> None:
        """A follower rank's loop: run the leader's descriptors on this
        rank's shards, in order, until the leader stops (``stop_followers``)
        or fails. Returns at the stop; raises if the leader's channel
        breaks."""
        if not self.is_follower:
            raise RuntimeError("follow() runs on a tensor-parallel follower")
        with torch.inference_mode():
            while True:
                op, args, kwargs, state, drops = self._link.recv()
                for key in drops:
                    self._swap_store.pop(key, None)
                if op == STOP:
                    return
                if state is not None:
                    for name in ("last_tokens", "positions",
                                 "stop_positions", "active", "temperature",
                                 "top_k", "top_p"):
                        setattr(self, name, state[name])
                    self._slot_seeds = state["slot_seeds"]
                    self.kv.block_tables = state["block_tables"]
                getattr(self, op).__wrapped__(self, *args, **kwargs)

    def stop_followers(self) -> None:
        """Release the followers from ``follow`` (the leader, at shutdown;
        a broken channel is ignored: the followers then fail by
        themselves)."""
        if self._link is not None and self._link.leader:
            try:
                self._link.stop()
            except RuntimeError:
                logger.warning("tensor-parallel followers unreachable at "
                               "stop")

    def launch_report(self) -> dict:
        """This rank's kernel launches and the forward passes that drove
        them (read at exit by ``serve start``'s ranks)."""
        from ..ops import int4_matmul, int8_matmul
        from ..ops.paged_attention_cuda import (paged_attention_int4_kernel,
                                                paged_attention_int8_kernel,
                                                paged_attention_kernel)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rank = self.tp_mesh.rank if self.tp_mesh is not None else 0
        return {"rank": rank, "paged_passes": self.total_paged_passes,
                "layers": self.cfg.num_layers,
                "token_digest": int(self.token_digest),
                "paged_attention": paged_attention_kernel.launches,
                "paged_attention_int8": paged_attention_int8_kernel.launches,
                "paged_attention_int4": paged_attention_int4_kernel.launches,
                "int8_matmul": int8_matmul.int8_matmul_kernel.launches,
                "int8_matmul_ksplit":
                    int8_matmul.int8_matmul_ksplit_kernel.launches,
                "int4_matmul": int4_matmul.int4_matmul_kernel.launches}

    def _load_params(self, model_cfg, serve_cfg, seed: int, dtype):
        """(params, effective model config, effective quantization) from
        ``serve_cfg.artifact``: an export artifact file (pre-quantized
        kernels go to the device quantized; architecture facts it records
        or proves override the template), a checkpoint directory (the JAX
        package's or the port's; params only), else random init from
        ``seed``. The caller's ServeConfig is never changed."""
        art = serve_cfg.artifact
        if art and Path(art).is_file():
            tree, meta = load_exported(art)
            art_quant = meta.get("quant") or ""
            want = serve_cfg.quantization
            want = "" if want in ("", "none") else want
            if art_quant and want and art_quant != want:
                raise ValueError(
                    f"artifact {art} is {art_quant}-quantized but serve "
                    f"config asks for {want!r}; requantization from a "
                    "quantized artifact would compound error — re-export")
            if art_quant == "int8-awq":
                raise ValueError(
                    "int8-awq exports are an interchange format; the serve "
                    "runtime consumes int8 / int4 / int4-awq artifacts "
                    "(the awq channel scaling is already folded for int4)")
            tied_meta = meta.get("tie_word_embeddings")
            if tied_meta is not None:
                tied = _parse_bool("artifact tie_word_embeddings", tied_meta)
                if tied != model_cfg.tie_word_embeddings:
                    logger.warning(
                        "artifact records tie_word_embeddings=%s; "
                        "overriding serving template %r", tied,
                        model_cfg.name)
                    model_cfg = dataclasses.replace(
                        model_cfg, tie_word_embeddings=tied)
            has_head = isinstance(tree, dict) and "lm_head" in tree
            if has_head == model_cfg.tie_word_embeddings:
                # structural proof beats both metadata and template
                logger.warning(
                    "artifact %s lm_head — overriding "
                    "tie_word_embeddings=%s on template %r",
                    "has an" if has_head else "has no", not has_head,
                    model_cfg.name)
                model_cfg = dataclasses.replace(
                    model_cfg, tie_word_embeddings=not has_head)
            params = params_from_jax(to_runtime_quant(tree), model_cfg,
                                     device=self.device, dtype=dtype)
            if meta.get("model") and meta["model"] != model_cfg.name:
                logger.warning("artifact was exported from model %r, "
                               "serving as %r", meta["model"], model_cfg.name)
            logger.info("loaded exported artifact %s (quant=%s)", art,
                        art_quant or "none")
            return params, model_cfg, (art_quant or want)
        if art and Path(art).exists():
            ckpt = CheckpointManager(art)
            if ckpt.latest_step() is not None:
                jax_written = ckpt.is_jax()
                state, extra = ckpt.restore()
                model_cfg = apply_ckpt_model_overrides(model_cfg, extra)
                if jax_written:
                    params = params_from_jax(params_from_flat(state),
                                             model_cfg, device=self.device,
                                             dtype=dtype)
                else:
                    params = model_from_named(state["params"], model_cfg,
                                              device=self.device,
                                              dtype=dtype)
                logger.info("loaded params from %s step %s", art,
                            ckpt.latest_step())
                return params, model_cfg, serve_cfg.quantization
        if art:
            logger.warning("no artifact checkpoint found (%r): using "
                           "random init", art)
        # random weights keep smoke and benchmark paths self-contained
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return (gpt.init(model_cfg, gen, device=self.device, dtype=dtype),
                model_cfg, serve_cfg.quantization)

    # -- admission -----------------------------------------------------------

    @property
    def _decode_lookahead(self) -> int:
        """Tokens one dispatch may write per slot. A speculative dispatch
        writes its verify window (T rows from the root) and then K - 1
        decode steps from root + n_emit, n_emit <= T: T + K - 1 tokens. A
        shorter span sends the overflow rows to scratch page 0, and the
        next capacity pass grows the chain over them with fresh pages."""
        k = self._decode_units * self._decode_unit_len
        if self.serve_cfg.speculative == "ngram":
            K = max(self.serve_cfg.decode_steps_per_dispatch, 1)
            k = max(k, self.serve_cfg.speculative_tokens + K - 1)
        return k

    def _admission_tail(self, req: Request) -> int:
        """Tokens beyond the prefill context that admission must cover:
        the whole budget under ``reserve``, one dispatch of lookahead under
        ``ondemand``."""
        if self.serve_cfg.admission == "reserve":
            return req.remaining_tokens
        return min(self._decode_lookahead, req.remaining_tokens)

    def _try_reserve(self, req: Request) -> bool:
        """Admission hook (under self.lock inside admit()): reserve the
        request's admission KV footprint; cached prefix pages are pinned
        here and only the remainder is reserved."""
        ctx = req.context_tokens   # prompt, + generated after a preemption
        n = len(ctx)
        if req.swapped_kv is not None:
            # swap-in: the request brings its own pages; pinning prefix
            # pages would count twice against its restore
            need = self.kv.pages_needed(n + self._admission_tail(req))
            pages = req.swapped_kv.get("pages")
            if isinstance(pages, dict):
                try:
                    need = max(need, int(pages["num_pages"]))
                except (KeyError, TypeError, ValueError):
                    pass      # malformed: the restore refuses it later
            if need > self.kv.free_pages - self._reserved_pages:
                return False
            self._reserved_pages += need
            self._reserved_by[req.request_id] = need
            return True
        pins: list[int] = []
        usable = 0
        if self.serve_cfg.prefix_caching:
            if req.prefix_hashes is None:
                req.prefix_hashes = prefix_page_hashes(ctx,
                                                       self.kv.page_size)
            # keep >= 1 suffix token: the last prompt token must be
            # re-processed to produce the first sampled token's logits
            usable = min(len(req.prefix_hashes),
                         max((n - 1) // self.kv.page_size, 0))
            pins = self.kv.lookup_prefix(req.prefix_hashes[:usable])
            # On a card the kernel reads each cached page once per row
            # tile for all suffix queries, so any hit saves compute. The
            # CPU gather path materialises the whole prefix for the suffix
            # queries: there a small hit on a long tail costs more than a
            # dense prefill and is dropped (the JAX engine's rule off-TPU).
            computed = n - len(pins) * self.kv.page_size
            if pins and self.device.type != "cuda" and computed > max(
                    len(pins) * self.kv.page_size,
                    self.serve_cfg.prefill_chunk):
                pins = []
        # pin BEFORE the capacity check: pinned pages leave the evictable
        # pool, so free_pages no longer counts them
        if pins:
            self.kv.pin_pages(pins)
        need = self.kv.pages_needed(n + self._admission_tail(req)) - len(pins)
        if need > self.kv.free_pages - self._reserved_pages:
            if pins:
                self.kv.unpin_pages(pins)
            return False
        if pins:
            self._prefix_pins[req.request_id] = pins
        self.kv.prefix_queries += usable
        self.kv.prefix_hits += len(pins)
        if pins and req.fleet_requeued:
            # a fleet orphan whose prompt pages are warm here
            self.total_requeue_cached_tokens += len(pins) * self.kv.page_size
        self._reserved_pages += need
        self._reserved_by[req.request_id] = need
        return True

    def _bucket(self, n: int) -> int:
        chunk = max(self.serve_cfg.prefill_chunk, self.kv.page_size)
        chunk = int(math.ceil(chunk / self.kv.page_size)) * self.kv.page_size
        return min(int(math.ceil(max(n, 1) / chunk)) * chunk,
                   int(math.ceil(self.serve_cfg.max_seq_len
                                 / self.kv.page_size)) * self.kv.page_size)

    def _suffix_bucket(self, m: int) -> int:
        """Bucket for the un-cached prompt tail: a power-of-two number of
        pages."""
        pages = max(math.ceil(m / self.kv.page_size), 1)
        pages = 1 << (pages - 1).bit_length()
        return min(pages * self.kv.page_size, self._bucket(m))

    # -- prefill -------------------------------------------------------------

    def _first_token(self, logits: torch.Tensor, req: Request, seed: int,
                     position: int) -> torch.Tensor:
        """Sample a prefill's first token (position ``position``) from its
        [1, V] logits; stays on the device."""
        s = req.sampling
        dev = self.device
        return sample_tokens(
            logits, [s.temperature], [s.top_k], [s.top_p],
            noise=lambda: gumbel_noise(
                to_device(np.array([seed]), dev),
                to_device(np.array([position]), dev),
                self.cfg.vocab_size))[0]

    @on_every_rank()
    @torch.inference_mode()
    def _prefill_dense(self, tokens: np.ndarray, n: int,
                       entries: np.ndarray) -> torch.Tensor:
        """Dense prefill of one bucket-padded prompt, then a scatter of its
        K/V into the pages at ``entries`` (one page id per bucket page;
        0 = scratch for the pages past the prompt). Returns the last
        prompt position's logits [1, V]."""
        cfg, bucket = self.cfg, tokens.shape[1]
        PS = self.kv.page_size
        n_pages = bucket // PS
        dev = self.device
        Nkv = self.kv.kv_heads          # this rank's heads under tp
        zeros = tuple(torch.zeros(
            (cfg.num_layers, 1, bucket, Nkv, cfg.head_dim),
            dtype=self.kv.dtype, device=dev) for _ in range(2))
        logits, (kd, vd) = gpt.forward(
            self.params, to_device(tokens, dev, torch.int64), cfg,
            kv_cache=zeros,
            cache_offset=torch.zeros(1, dtype=torch.int64, device=dev),
            unembed_positions=to_device(np.array([n - 1]), dev))
        # the bucket's pages past the prompt all go to scratch page 0: only
        # the last of them is written, the JAX scatter's last-wins result
        # (an index_put_ with duplicate indices keeps an arbitrary one, and
        # an MoE batch's idle rows read page 0)
        keep = np.sort(len(entries) - 1 - np.unique(
            entries[::-1], return_index=True)[1])
        idx = to_device(entries[keep], dev, torch.int64)
        keep = (None if len(keep) == len(entries)
                else to_device(keep, dev, torch.int64))

        def scatter(pages, dense):
            # [L, 1, bucket, Nkv, D] -> [L, nP, Nkv, PS, D], quantized per
            # (token, kv head) for quantized pages (int4: then packed along
            # the page-slot axis), written at the bucket's table entries
            dense = dense[:, 0].reshape(
                cfg.num_layers, n_pages, PS, Nkv, cfg.head_dim
            ).transpose(2, 3)
            if keep is not None:
                dense = dense[:, keep]
            if isinstance(pages, Int4Pages):
                qv, sc = quantize_kv_token_int4(dense)
                pages.values[:, idx] = pack_int4_rows(qv, axis=-2)
                pages.scale[:, idx] = sc
            elif isinstance(pages, QuantPages):
                qv, sc = quantize_kv_token(dense)
                pages.values[:, idx] = qv
                pages.scale[:, idx] = sc
            else:
                pages[:, idx] = dense

        scatter(self.kv.k_pages, kd)
        scatter(self.kv.v_pages, vd)
        return logits[:, 0]

    @on_every_rank()
    @torch.inference_mode()
    def _prefill_extend(self, tokens: np.ndarray, cached: int, m: int,
                        table_row: np.ndarray, head: bool = True
                        ) -> Optional[torch.Tensor]:
        """Suffix prefill over a cached paged prefix (or one chunk of a
        chunked prefill): the ``m`` un-cached tokens (padded to the suffix
        bucket) run through ``extend_step_forward``, writing through the
        slot's block table. Returns the last real token's logits [1, V],
        or None without ``head`` (an intermediate chunk)."""
        dev = self.device
        bucket = tokens.shape[1]
        self.total_paged_passes += 1
        write_ok = torch.arange(bucket, device=dev)[None] < m
        logits, _, _ = extend_step_forward(
            self.params, to_device(tokens, dev, torch.int64),
            to_device(np.array([cached]), dev), self.kv.k_pages,
            self.kv.v_pages, to_device(table_row[None], dev), self.cfg,
            write_ok=write_ok, w8_kernel_ok=self._w8_kernel_ok, logits=head)
        return logits[:, m - 1] if head else None

    def _assign_seed(self, req: Request, slot: int) -> None:
        """The request's sampling seed and the slot's admission order."""
        s = req.sampling
        if req.assigned_seed is None:
            req.assigned_seed = s.seed if s.seed is not None else (
                self._base_seed + self._admitted_counter)
        self._admitted_counter += 1
        self._slot_seq[slot] = self._admitted_counter  # preemption priority
        self._slot_seeds[slot] = req.assigned_seed
        if req.prefill_dispatch_time is None:
            req.prefill_dispatch_time = time.monotonic()

    @engine_thread_only
    def _maybe_fetch_prefix(self, req: Request) -> None:
        """Fleet prefix fetch, on the engine thread before a prefill, no
        lock held across the hook: when the local cache leaves full pages
        of the context uncovered and the router named a ``prefix_owner``,
        fetch those pages, import them into the cache and pin them for
        this request, so the prefill computes only the rest. Every failure
        (no hook, miss, abort, malformed payload, dry pool) leaves the
        request as it was: a plain prefill."""
        hook = self.prefix_fetch_hook
        if (hook is None or not self.serve_cfg.prefix_caching
                or req.swapped_kv is not None
                or getattr(req, "prefix_owner", None) is None
                or not req.prefix_hashes):
            return
        rid = req.request_id
        n = len(req.context_tokens)
        PS = self.kv.page_size
        # >= 1 suffix token stays to produce the next token's logits
        usable = min(len(req.prefix_hashes), max((n - 1) // PS, 0))
        if usable == 0:
            return
        with self.lock:
            pins = list(self._prefix_pins.get(rid, ()))
            # coverage now, not at admission: a sibling's fetch or
            # prefill may have published the pages since
            chain = self.kv.lookup_prefix(req.prefix_hashes[:usable])
            if len(chain) > len(pins):
                extra = chain[len(pins):]
                self.kv.pin_pages(extra)
                pins += extra
                self._prefix_pins[rid] = pins
        uncovered = req.prefix_hashes[len(pins):usable]
        if not uncovered:
            return
        got = hook(req, uncovered)      # may cross a link: no lock held
        if not got:
            return
        hashes, pages = got.get("hashes") or [], got.get("pages")
        # the owner must answer with a prefix of what was asked
        k = 0
        while k < min(len(hashes), len(uncovered)) \
                and hashes[k] == uncovered[k]:
            k += 1
        if k == 0 or not isinstance(pages, dict):
            return
        with self.lock:
            try:
                inserted = self.kv.insert_prefix_pages(uncovered[:k], pages)
            except (ValueError, KeyError, TypeError) as e:
                logger.warning(
                    "fetched prefix payload for %s rejected (%s); "
                    "re-prefilling", rid, e)
                return
            # pin the longer chain under the same lock as the insert
            chain = self.kv.lookup_prefix(req.prefix_hashes[:usable])
            if len(chain) > len(pins):
                extra = chain[len(pins):]
                self.kv.pin_pages(extra)
                self._prefix_pins[rid] = pins + extra
            if inserted:
                tokens = len(inserted) * PS
                self.total_prefix_fetched_tokens += tokens
                self.total_requeue_cached_tokens += tokens
                logger.info(
                    "prefix fetch for %s: imported %d page(s) (%d "
                    "tokens) from replica %s", rid, len(inserted),
                    tokens, getattr(req, "prefix_owner", None))

    @engine_thread_only
    def _maybe_fetch_salvage_tail(self, req: Request) -> None:
        """A crash-salvaged partial payload whose router hint names an
        owner: fetch the chain pages past the payload's coverage and
        splice them onto it, so the tail prefill shrinks to what no
        replica holds. Every failure leaves the payload as it was."""
        hook = self.prefix_fetch_hook
        kvp = req.swapped_kv
        if (hook is None or not self.serve_cfg.prefix_caching
                or not isinstance(kvp, dict) or not kvp.get("partial")
                or getattr(req, "prefix_owner", None) is None
                or not req.prefix_hashes):
            return
        PS = self.kv.page_size
        n = len(req.context_tokens)
        covered = int(kvp.get("positions", 0)) // PS
        pages = kvp.get("pages")
        if not isinstance(pages, dict) \
                or int(pages.get("num_pages", -1)) != covered:
            return
        usable = min(len(req.prefix_hashes), max((n - 1) // PS, 0))
        if covered >= usable:
            return
        missing = req.prefix_hashes[covered:usable]
        got = hook(req, missing)
        if not got:
            return
        hashes, fetched = got.get("hashes") or [], got.get("pages")
        k = 0
        while k < min(len(hashes), len(missing)) \
                and hashes[k] == missing[k]:
            k += 1
        if k == 0 or not isinstance(fetched, dict):
            return
        try:
            merged = concat_page_payloads(pages,
                                          slice_page_payload(fetched, k))
        except (ValueError, KeyError, TypeError) as e:
            logger.warning(
                "salvage-tail fetch payload for %s rejected (%s); "
                "re-prefilling the tail", req.request_id, e)
            return
        kvp["pages"] = merged
        kvp["positions"] = (covered + k) * PS
        self.total_salvage_tail_fetched_tokens += k * PS
        self.total_prefix_fetched_tokens += k * PS

    def _note_unexpected_prefill(self, req: Request, what: str) -> None:
        if self.expect_pure_decode:
            self.total_unexpected_prefills += 1
            logger.warning(
                "pure-decode engine starting %s for %s (restore fallback "
                "or fleet mis-routing)", what, req.request_id)

    @engine_thread_only
    def _prefill(self, req: Request):
        """Dispatch one prompt's prefill; returns (req, device token). The
        first-token fetch is deferred to ``_finish_prefill`` so a burst of
        admitted prompts pays one host round trip. A partial payload
        (a migration's pre-copy salvaged from a crash) writes its full
        pages back and only the tail is computed."""
        self._maybe_fetch_prefix(req)
        slot = req.slot
        ctx = req.context_tokens   # prompt, + generated after a preemption
        n = len(ctx)
        rid = req.request_id
        PS = self.kv.page_size
        self._note_unexpected_prefill(req, "a prefill")
        self._maybe_fetch_salvage_tail(req)
        partial = (req.swapped_kv if req.swapped_kv is not None
                   and req.swapped_kv.get("partial") else None)
        with self.lock:   # page bookkeeping is shared with cancel/release
            pins = self._prefix_pins.get(rid, [])
            if partial is not None and pins:
                # one source for the chain's head: the payload is written
                # into the slot's own pages from entry 0, never over
                # shared cache pages; a cache that covers as much wins
                if len(pins) * PS >= int(partial.get("positions", 0)):
                    req.swapped_kv = None
                    partial = None
                else:
                    self.kv.unpin_pages(pins)
                    self._prefix_pins.pop(rid, None)
                    pins = []
            self.kv.allocate(slot, n + self._admission_tail(req),
                             prefix_pages=pins)
            self._reserved_pages -= self._reserved_by.pop(rid, 0)
            self._req_slot[rid] = slot
            cached = len(pins) * PS       # context tokens served from cache
            if partial is not None:
                try:
                    self.kv.write_slot_pages(slot, partial["pages"])
                    cached = int(partial["positions"])
                    self.total_partial_restores += 1
                    if req.fleet_requeued:
                        self.total_requeue_cached_tokens += cached
                except (ValueError, KeyError, TypeError) as e:
                    # a malformed payload: a whole prefill over the chain
                    logger.warning(
                        "partial restore payload for %s rejected (%s); "
                        "re-prefilling the whole context", rid, e)
                req.swapped_kv = None
            if cached == 0:
                # table entries for the bucket: beyond-length -> scratch 0
                bucket = self._bucket(n)
                entries = np.zeros(bucket // PS, np.int64)
                used = self.kv.pages_needed(n)
                entries[:used] = self.kv.block_tables[slot, :used]
            table_row = self.kv.block_tables[slot].copy()
        self._assign_seed(req, slot)

        if cached == 0:
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = ctx
            logits = self._prefill_dense(tokens, n, entries)
            req.prefill_bucket = bucket
            self._dense_buckets.add(bucket)
            computed = n
        else:
            computed = n - cached
            bucket = self._suffix_bucket(computed)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :computed] = ctx[cached:]
            logits = self._prefill_extend(tokens, cached, computed,
                                          table_row)
            self.total_prefix_cached_tokens += cached
            self.total_extend_prefills += 1
        self._nonfinite = self._nonfinite + (
            ~torch.isfinite(logits).all()).long()
        token = self._first_token(logits, req, req.assigned_seed, n)

        self._register_prefix(req, len(pins), n)

        self.total_prefill_tokens += computed
        return req, token

    def _register_prefix(self, req: Request, first: int, n: int) -> None:
        """Publish the slot's freshly written full pages [first, n // PS)
        for future prefix hits."""
        if self.serve_cfg.prefix_caching and req.prefix_hashes:
            with self.lock:
                table = self.kv.block_tables[req.slot]
                self.kv.register_pages(
                    [(req.prefix_hashes[i], int(table[i]))
                     for i in range(first, n // self.kv.page_size)])

    # -- chunked prefill -----------------------------------------------------

    @engine_thread_only
    def _start_chunked_prefill(self, req: Request) -> None:
        """Allocate the slot's pages and enqueue the context for chunk-at-
        a-time prefill (one chunk an engine step, interleaved with
        decode)."""
        self._maybe_fetch_prefix(req)
        slot = req.slot
        ctx = req.context_tokens
        rid = req.request_id
        self._note_unexpected_prefill(req, "a chunked prefill")
        with self.lock:
            pins = self._prefix_pins.get(rid, [])
            self.kv.allocate(slot, len(ctx) + self._admission_tail(req),
                             prefix_pages=pins)
            self._reserved_pages -= self._reserved_by.pop(rid, 0)
            self._req_slot[rid] = slot
            table_row = self.kv.block_tables[slot].copy()
        self._assign_seed(req, slot)
        cached = len(pins) * self.kv.page_size
        self.total_prefix_cached_tokens += cached
        self.total_chunked_prefills += 1
        self._partial_prefills[rid] = {
            "req": req, "ctx": ctx, "done": cached, "pins": len(pins),
            "table_row": table_row}

    @engine_thread_only
    def _advance_chunked_prefills(self) -> list:
        """Advance the chunked prefills in flight by at most
        ``prefill_budget_tokens`` of prompt this step in all (at least one
        chunk, so no prefill starves), charged as the suffix bucket each
        chunk computes, round-robin from where the last step stopped.
        Returns [(req, device token)] of the ones that completed."""
        completed = []
        C = self.serve_cfg.chunked_prefill_tokens
        budget = max(self.serve_cfg.prefill_budget_tokens, C)
        spent = 0
        rids = list(self._partial_prefills)
        rr = rids.index(self._chunk_rr) if self._chunk_rr in rids else 0
        self._chunk_rr = None
        for rid in rids[rr:] + rids[:rr]:
            st = self._partial_prefills[rid]
            req: Request = st["req"]
            if req.cancel_requested:        # dispatches nothing: no charge
                with self.lock:
                    self.scheduler.abort_prefill(rid)   # frees slot + pages
                del self._partial_prefills[rid]
                continue
            ctx = st["ctx"]
            n, done = len(ctx), st["done"]
            stage = req.pipeline_stage
            # a stage request takes chunks even with chunking off: then
            # at the prefill bucket's size
            this = min(n - done,
                       C if C > 0 else max(self.serve_cfg.prefill_chunk, 1))
            bucket = self._suffix_bucket(this)
            if spent > 0 and spent + bucket > budget:
                self._chunk_rr = rid    # resume at this request next step
                break
            spent += bucket
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :this] = ctx[done:done + this]
            last = done + this >= n
            # a stage request's product is pages: even its last chunk
            # skips the head
            logits = self._prefill_extend(tokens, done, this,
                                          st["table_row"],
                                          head=last and stage is None)
            self.total_prefill_chunks += 1
            self.total_prefill_tokens += this
            st["done"] = done + this
            if stage is not None:
                self._publish_stage_pages(st)
                if last:
                    # stage done: pages published, the slot freed without
                    # arming decode
                    with self.lock:
                        self.scheduler.finish_prefill_only(rid)
                    del self._partial_prefills[rid]
                if self.pipeline_chunk_hook is not None:
                    self.pipeline_chunk_hook(req, st["done"], last)
            elif last:
                self._nonfinite = self._nonfinite + (
                    ~torch.isfinite(logits).all()).long()
                token = self._first_token(logits, req, req.assigned_seed, n)
                self._register_prefix(req, st["pins"], n)
                completed.append((req, token))
                del self._partial_prefills[rid]
        return completed

    @engine_thread_only
    def _publish_stage_pages(self, st: dict) -> None:
        """Register a pipeline-stage request's newly full pages in the
        prefix cache chunk by chunk, not at the end: the pipeline
        coordinator ships them to the next stage while later chunks
        compute."""
        req: Request = st["req"]
        if not self.serve_cfg.prefix_caching or not req.prefix_hashes:
            return
        full = min(st["done"] // self.kv.page_size, len(req.prefix_hashes))
        pub = st.setdefault("published", st["pins"])
        if full <= pub:
            return
        with self.lock:
            table = self.kv.block_tables[req.slot]
            self.kv.register_pages([(req.prefix_hashes[i], int(table[i]))
                                    for i in range(pub, full)])
        st["published"] = full

    @engine_thread_only
    def _arm_slot(self, req: Request, last_token: int, n_written: int,
                  ctx: list) -> None:
        """Make a slot live for decode: the one place the per-slot decode
        state is set (prefill completion and swap-in). ``n_written`` is the
        number of KV entries present; ``ctx`` the whole token context,
        ``last_token`` included (its KV is written by its decode step)."""
        slot = req.slot
        s = req.sampling
        req.state = RequestState.RUNNING
        self.last_tokens[slot] = last_token
        self._ctx[slot, :len(ctx)] = ctx
        self._ctx_len[slot] = len(ctx)
        self.positions[slot] = n_written
        # first position this slot may NOT write (prompt + max_tokens)
        self.stop_positions[slot] = req.num_prompt_tokens + s.max_tokens
        self.active[slot] = True
        self.temperature[slot] = s.temperature
        self.top_k[slot] = s.top_k
        self.top_p[slot] = s.top_p
        # speculative state: resumed from what the request carries (a
        # preemption), else cold at the full window
        self._spec_state[slot] = None
        if self.serve_cfg.speculative == "ngram":
            T = max(self.serve_cfg.speculative_tokens, 2)
            if isinstance(req.spec_state, dict):
                self._spec_state[slot] = SpecState.from_dict(
                    req.spec_state, max_window=T)
                if self._spec_on:
                    self.total_spec_resumes += 1
            else:
                self._spec_state[slot] = SpecState(window=T)

    @engine_thread_only
    def _finish_prefill(self, req: Request, token) -> None:
        """Resolve a dispatched prefill: fetch its first token and make the
        slot live for decode."""
        ctx = req.context_tokens       # BEFORE recording the new token
        tok = int(token)
        req.record_token(tok)
        if self.on_token is not None:
            self.on_token(req, [tok])
        self._arm_slot(req, tok, len(ctx), ctx + [tok])

    # -- decode --------------------------------------------------------------

    def _short_dispatch_ok(self) -> bool:
        """Should the next dispatch be ONE unit (caller holds self.lock)?
        Only when a queued request could be admitted right now and the
        batch is mostly empty."""
        if self._decode_units <= 1:
            return False
        S = self.serve_cfg.max_batch_size
        occupancy_cap = min(max(S // 4, 1), S - 1)
        if (self.scheduler.queue_depth == 0
                or self.scheduler.active_count > occupancy_cap):
            return False
        head = self.scheduler.waiting[0]
        need = self.kv.pages_needed(
            len(head.context_tokens) + self._admission_tail(head))
        return need <= self.kv.free_pages - self._reserved_pages

    @engine_thread_only
    def _decode_device(self, use_short: bool = False) -> np.ndarray:
        """Dispatch one decode group and fetch its tokens."""
        if use_short:
            self.total_short_dispatches += 1
        group = self._submit_group(1 if use_short else self._decode_units)
        return self._fetch_group(group)

    def _shared_decode_args(self) -> dict:
        """Per-group dispatch state: tables, stops and seeds uploaded once
        (asynchronously), sampling knobs as host copies."""
        dev = self.device
        return {"tables": to_device(self.kv.block_tables, dev),
                "stops": to_device(self.stop_positions, dev),
                "seeds": to_device(self._slot_seeds, dev),
                "temperature": self.temperature.copy(),
                "top_k": self.top_k.copy(), "top_p": self.top_p.copy()}

    @engine_thread_only
    def _submit_decode(self, chain_from=None, shared=None) -> dict:
        """Enqueue ONE decode unit without fetching its results. With
        ``chain_from`` (a previous unit or group), its device-resident
        final tokens/positions feed this unit, so back-to-back units queue
        on the device with no host round trip between them."""
        if chain_from is not None:
            tokens, positions = (chain_from["next_tokens"],
                                 chain_from["next_positions"])
        else:
            tokens = to_device(self.last_tokens, self.device)
            positions = to_device(self.positions, self.device)
        if shared is None:
            shared = self._shared_decode_args()
        (next_toks, next_pos), sampled, nonfinite = decode_scan(
            self.params, tokens, positions, self.kv.k_pages,
            self.kv.v_pages, shared["tables"], shared["stops"],
            shared["seeds"], shared["temperature"], shared["top_k"],
            shared["top_p"], self.cfg, self._decode_unit_len,
            w8_kernel_ok=self._w8_kernel_ok)
        self._nonfinite = self._nonfinite + nonfinite
        self._digest(sampled)
        self.total_dispatched_steps += self._decode_unit_len
        self.total_paged_passes += self._decode_unit_len
        return {
            "sampled": sampled, "next_tokens": next_toks,
            "next_positions": next_pos,
            "req_ids": [r.request_id if r is not None else None
                        for r in self.scheduler.slots],
            "active": self.active.copy(),
        }

    def _digest(self, sampled: torch.Tensor) -> None:
        """Fold a dispatch's sampled tokens into ``token_digest`` (on the
        device, no sync), on a tensor-parallel rank."""
        if self._link is None:
            return
        w = torch.arange(1, sampled.numel() + 1, device=sampled.device)
        self.token_digest = self.token_digest + (
            sampled.reshape(-1).long() * w).sum()

    @on_every_rank(state=True)
    def _enqueue_decode(self, n_units: int, chain: bool) -> list:
        """Enqueue ``n_units`` chained decode units, the first chained on
        the last unit enqueued before (``chain``) or on the host's tokens
        and positions."""
        units = []
        pend = self._carry if chain else None
        shared = self._shared_decode_args()
        for _ in range(n_units):
            pend = self._submit_decode(chain_from=pend, shared=shared)
            units.append(pend)
        self._carry = pend
        return units

    @engine_thread_only
    def _submit_group(self, n_units: int, chain_from=None) -> dict:
        """Chain ``n_units`` unit dispatches; return a group record with
        the same keys as a unit (last unit's carry, first unit's slot
        snapshot), so groups chain onto groups. A group chains only on the
        one enqueued last."""
        assert chain_from is None or self._carry is not None and \
            chain_from["next_tokens"] is self._carry["next_tokens"]
        units = self._enqueue_decode(n_units, chain_from is not None)
        return {
            "units": units,
            "next_tokens": units[-1]["next_tokens"],
            "next_positions": units[-1]["next_positions"],
            "req_ids": units[0]["req_ids"],
            "active": units[0]["active"],
        }

    @engine_thread_only
    def _fetch_group(self, group: dict) -> np.ndarray:
        """One device->host fetch of a group's sampled tokens [K, B]."""
        out = torch.cat([u["sampled"] for u in group["units"]]).cpu().numpy()
        self.total_decode_steps += out.shape[0]
        self.total_padded_slot_steps += out.shape[0] * int(
            self.serve_cfg.max_batch_size - group["active"].sum())
        return out

    @engine_thread_only
    def _drain_pending(self) -> None:
        """Fetch and apply the in-flight pipelined group, if any."""
        prev, self._pending = self._pending, None
        if prev is None:
            return
        sampled = self._fetch_group(prev)
        with self.lock:
            self._apply_decode(sampled, snapshot=prev)
            self.scheduler.step_finished(self.eos_token_id)

    @engine_thread_only
    def _apply_decode(self, sampled_seq: np.ndarray,
                      snapshot: Optional[dict] = None) -> None:
        """Host bookkeeping for K decode steps (under self.lock). Slots that
        hit a stop condition mid-group stop accepting. With ``snapshot``
        (a pipelined group applied one step late), slots whose request
        changed since submission are skipped."""
        for slot, req in enumerate(self.scheduler.slots):
            if req is None or not self.active[slot]:
                continue
            if snapshot is not None and (
                    req.request_id != snapshot["req_ids"][slot]
                    or not snapshot["active"][slot]):
                continue
            accepted = []
            for k in range(sampled_seq.shape[0]):
                self.positions[slot] += 1
                tok = int(sampled_seq[k, slot])
                req.record_token(tok)
                accepted.append(tok)
                self.last_tokens[slot] = tok
                if (req.cancel_requested
                        or req.should_stop(self.eos_token_id) is not None):
                    break
            self._extend_ctx(slot, accepted)
            if accepted and self.on_token is not None:
                self.on_token(req, accepted)

    def _extend_ctx(self, slot: int, accepted: list) -> None:
        end = self._ctx_len[slot] + len(accepted)
        self._ctx[slot, self._ctx_len[slot]:end] = accepted
        self._ctx_len[slot] = end

    # -- speculative decode --------------------------------------------------

    @engine_thread_only
    def spec_state_of(self, slot: int) -> Optional[dict]:
        """The slot's SpecState as a plain-scalar dict; None when
        speculation is off or the slot carries none."""
        if not 0 <= slot < len(self._spec_state):
            return None
        st = self._spec_state[slot]
        return st.to_dict() if st is not None else None

    def _spec_window(self, slot: int) -> tuple[int, int]:
        """(T, this slot's adaptive window w <= T)."""
        T = max(self.serve_cfg.speculative_tokens, 2)
        st = self._spec_state[slot]
        return T, (min(st.window, T) if st is not None else T)

    @engine_thread_only
    def _spec_device(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One fused speculative dispatch: drafts proposed on the host from
        each greedy slot's context, then the verify window and K - 1
        decode steps on the device (the JAX engine's ``_spec_impl``
        program: ``verify_and_decode``), fetched once. Returns (emitted
        [B, T], n_emit [B], decode_seq [K-1, B])."""
        T = max(self.serve_cfg.speculative_tokens, 2)
        B = self.serve_cfg.max_batch_size
        # draftless rows repeat the last token: acceptance checks itself
        # (draft == argmax), so a lucky repeat is correct greedy output
        tokens = np.repeat(self.last_tokens[:, None], T, axis=1)
        n_drafted = 0
        propose = self.draft_fn or propose_ngram_draft
        for slot, req in enumerate(self.scheduler.slots):
            if req is None or not self.active[slot] \
                    or self.temperature[slot] > 0:
                continue
            # only w - 1 drafts are proposed and counted; positions [w, T)
            # keep the repeat (the window bounds the proposals and the
            # acceptance statistics, not the dispatch shape)
            _, w = self._spec_window(slot)
            n_drafted += w - 1
            # bounded lookback keeps a proposal O(window), not O(context)
            ctx = self._ctx[slot, max(self._ctx_len[slot] - 1024, 0):
                            self._ctx_len[slot]]
            draft = propose(ctx, w - 1, self.serve_cfg.speculative_ngram)
            if draft is not None:
                tokens[slot, 1:w] = draft
        out = self._spec_dispatch(tokens).cpu().numpy()   # one fetch
        R = out.shape[1] - T - 1
        self.total_dispatched_steps += R
        emitted, n_emit, decode_seq = out[:, :T], out[:, T], out[:, T + 1:].T
        self.total_spec_dispatches += 1
        self.total_spec_drafts += n_drafted
        self.total_decode_steps += 1 + R
        self.total_padded_slot_steps += (1 + R) * int(B - self.active.sum())
        return emitted, n_emit, decode_seq

    @engine_thread_only
    def _apply_speculative(self, emitted: np.ndarray, n_emit: np.ndarray,
                           decode_seq: np.ndarray) -> None:
        """Host bookkeeping for one fused dispatch (under self.lock): the
        n_emit verified tokens, then the decode rows; positions advance
        with what is recorded, so a slot's length matches its K/V."""
        for slot, req in enumerate(self.scheduler.slots):
            if req is None or not self.active[slot]:
                continue
            stream = [int(emitted[slot, k]) for k in range(int(n_emit[slot]))]
            stream += [int(t) for t in decode_seq[:, slot]]
            accepted = []
            for tok in stream:
                self.positions[slot] += 1
                req.record_token(tok)
                accepted.append(tok)
                self.last_tokens[slot] = tok
                if (req.cancel_requested
                        or req.should_stop(self.eos_token_id) is not None):
                    break
            self._extend_ctx(slot, accepted)
            if self.temperature[slot] <= 0:
                # the device's acceptance (n_emit - 1 drafts), capped at
                # the proposed window: repeat positions past it may verify
                # too, and crediting them would push acceptance past 1
                T, w = self._spec_window(slot)
                acc = min(max(int(n_emit[slot]) - 1, 0), w - 1)
                self.total_spec_accepted += acc
                st = self._spec_state[slot]
                if st is not None:
                    st.observe(acc, w - 1, max_window=T)
            if accepted and self.on_token is not None:
                self.on_token(req, accepted)

    @on_every_rank(state=True)
    def _spec_dispatch(self, tokens: np.ndarray) -> torch.Tensor:
        """The device half of a speculative dispatch: the verify window of
        ``tokens`` [B, T] and K - 1 decode steps. Returns [B, T + 1 + R]:
        the emitted tokens, n_emit and the decode rows."""
        shared = self._shared_decode_args()
        emitted, n_emit, decode_seq, nonfinite = verify_and_decode(
            self.params, to_device(tokens, self.device),
            to_device(self.positions, self.device), self.kv.k_pages,
            self.kv.v_pages, shared["tables"], shared["stops"],
            shared["seeds"], shared["temperature"], shared["top_k"],
            shared["top_p"], self.cfg,
            num_decode_steps=max(
                self.serve_cfg.decode_steps_per_dispatch - 1, 0),
            w8_kernel_ok=self._w8_kernel_ok)
        self._nonfinite = self._nonfinite + nonfinite
        out = torch.cat([emitted, n_emit[:, None], decode_seq.T], dim=1)
        self._digest(out)
        self.total_paged_passes += 1 + decode_seq.shape[0]
        return out

    @on_every_rank()
    def _swap_out(self, key: str, pages: np.ndarray) -> None:
        """A follower copies the pages ``pages`` of a preempted request to
        host memory and keeps the payload (its kv heads) under ``key``
        (the leader's ``extract_slot`` payload goes with the request)."""
        if self.is_follower:
            self._swap_store[key] = self.kv._extract_pages_idx(pages)

    @on_every_rank()
    def _swap_in(self, key: str, pages: np.ndarray) -> None:
        """A follower writes its payload of ``key`` back into ``pages``
        (the leader's ``restore_slot`` has written its own)."""
        content = self._swap_store.pop(key, None)
        if content is not None:
            self.kv._write_pages_idx(pages, content["k"], content["v"])

    # -- lifecycle -----------------------------------------------------------

    def release(self) -> None:
        """Drop this engine's device memory (weights, KV pool). The engine
        is unusable afterwards."""
        self.params = None
        self.kv = None
        self._pending = None
        self._spec_on = False
        self._partial_prefills.clear()

    def _swap_bytes_in_queue(self) -> int:
        """Host bytes held by swapped-out waiting requests (computed when
        asked: the queue is bounded and preemption is rare); under tp the
        ranks' payloads together, as the JAX engine's global payload."""
        return self.kv.tp * sum(payload_bytes(r.swapped_kv["pages"])
                                for r in self.scheduler.waiting
                                if r.swapped_kv is not None)

    @engine_thread_only
    def _restore_swapped(self, req: Request) -> bool:
        """Swap-in: allocate pages, write the saved K/V back and make the
        slot live for decode, with no prefill. False when the pool cannot
        hold the restore or the payload is malformed; the caller then
        re-prefills from the tokens."""
        slot = req.slot
        rid = req.request_id
        saved = req.swapped_kv
        with self.lock:
            try:
                ok = self.kv.restore_slot(slot, saved["pages"])
            except (ValueError, KeyError, TypeError) as e:
                # wrong tokens are the one unacceptable outcome; extra
                # compute is not
                logger.warning("swap-in payload for %s rejected (%s); "
                               "falling back to re-prefill", rid, e)
                ok = False
            if not ok:
                self.total_swap_fallbacks += 1
                self._drops.append(rid)
                return False
            self._reserved_pages -= self._reserved_by.pop(rid, 0)
            self._req_slot[rid] = slot
            if self._link is not None:
                n = int(saved["pages"]["num_pages"])
                self._swap_in(rid, self.kv.block_tables[slot, :n].copy())
        self._assign_seed(req, slot)
        if isinstance(saved.get("spec"), dict):
            req.spec_state = saved["spec"]
        self._arm_slot(req, saved["last_token"], saved["positions"],
                       req.context_tokens)
        req.swapped_kv = None
        self.total_swap_ins += 1
        return True

    @engine_thread_only
    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request (newest-first victim policy) so an older
        stream can grow. The request re-enters the queue head. With
        ``preemption="swap"``, while the queue's swapped bytes stay under
        ``swap_space_gb``, its pages go to host memory and come back on
        readmission; otherwise it re-prefills prompt+generated, from
        prefix-cached pages where caching holds them (its full pages are
        published here). Caller holds self.lock."""
        req = self.scheduler.slots[slot]
        rid = req.request_id
        written = int(self.positions[slot])   # KV entries actually present
        # the tuned speculative state goes with the request
        spec = self.spec_state_of(slot)
        if spec is not None:
            req.spec_state = spec
        if self.serve_cfg.preemption == "swap" and \
                self._swap_bytes_in_queue() < \
                self.serve_cfg.swap_space_gb * 1e9:
            pages = self.kv.extract_slot(slot)
            if self._link is not None:
                self._swap_out(rid, self.kv.block_tables[
                    slot, :self.kv.slot_capacity_tokens(slot)
                    // self.kv.page_size].copy())
            req.swapped_kv = {"pages": pages, "positions": written,
                              "last_token": int(self.last_tokens[slot])}
            if spec is not None:
                req.swapped_kv["spec"] = spec
            self.total_swap_outs += 1
            self.total_swap_out_bytes += payload_bytes(pages) * self.kv.tp
        if self.serve_cfg.prefix_caching:
            ctx = req.context_tokens
            full = written // self.kv.page_size
            hashes = prefix_page_hashes(ctx[:full * self.kv.page_size],
                                        self.kv.page_size)
            table = self.kv.block_tables[slot]
            # register BEFORE release: released hashed pages stay evictable
            self.kv.register_pages(
                [(hashes[j], int(table[j])) for j in range(full)])
        pins = self._prefix_pins.pop(rid, None)
        self.kv.release(slot)
        if pins:
            self.kv.unpin_pages(pins)
        self._req_slot.pop(rid, None)
        self.active[slot] = False
        self.positions[slot] = 0
        self.stop_positions[slot] = 0
        self._ctx_len[slot] = 0
        self._spec_state[slot] = None
        self.scheduler.preempt_slot(slot)
        self.total_preemptions += 1
        logger.info("preempted %s (slot %d, %d tokens generated) to free "
                    "KV pages", rid, slot, len(req.generated_tokens))

    @engine_thread_only
    def _ensure_decode_capacity(self) -> None:
        """Grow every active slot's chain to cover the next dispatch's
        writes (on-demand admission), oldest first; when the pool is dry
        the newest resident request is preempted and the grow retried.
        Caller holds self.lock."""
        if self.serve_cfg.admission != "ondemand":
            return
        # an un-applied pipelined group puts the device a group ahead
        lag = (self._decode_units * self._decode_unit_len
               if self._pending is not None else 0)
        k = self._decode_lookahead + lag
        order = sorted(np.flatnonzero(self.active),
                       key=lambda i: self._slot_seq[i])
        for i in order:
            i = int(i)
            if not self.active[i]:      # already preempted as a victim
                continue
            target = min(int(self.positions[i]) + k,
                         int(self.stop_positions[i]))
            while not self.kv.extend_slot(i, target):
                victims = [int(j) for j in np.flatnonzero(self.active)
                           if int(j) != i]
                if not victims:
                    self._preempt(i)
                    break
                self._preempt(max(victims, key=lambda j: self._slot_seq[j]))

    def _on_release(self, req: Request) -> None:
        if req.swapped_kv is not None and self._link is not None:
            # a swapped request that leaves unrestored: the followers drop
            # its payloads with the next descriptor
            self._drops.append(req.request_id)
        # admitted-but-never-prefilled: return the admission reservation
        self._reserved_pages -= self._reserved_by.pop(req.request_id, 0)
        pins = self._prefix_pins.pop(req.request_id, None)
        if pins:
            self.kv.unpin_pages(pins)
        slot = self._req_slot.pop(req.request_id, None)
        if slot is not None:
            self.kv.release(slot)
            self.active[slot] = False
            self.positions[slot] = 0
            self.stop_positions[slot] = 0
            self._spec_state[slot] = None
        if self.on_finish is not None:
            self.on_finish(req)

    def _speculate_now(self) -> bool:
        """Should this step's dispatch be speculative? Only while a greedy
        stream is resident (a sampled row gets one token from a verify
        window, K from plain decode), and not once 64 dispatches have
        measured an acceptance under ``speculative_min_acceptance``: then
        the verify window is a pure loss and speculation switches off."""
        if (self._spec_on and self.total_spec_dispatches >= 64
                and self.total_spec_accepted
                < self.serve_cfg.speculative_min_acceptance
                * self.total_spec_drafts):
            logger.warning(
                "speculative decode disabled: acceptance %.3f < %.3f after "
                "%d dispatches",
                self.total_spec_accepted / max(self.total_spec_drafts, 1),
                self.serve_cfg.speculative_min_acceptance,
                self.total_spec_dispatches)
            self._spec_on = False
        return self._spec_on and bool(
            (self.temperature[self.active] <= 0).any())

    @torch.inference_mode()
    @engine_thread_only
    def step(self) -> int:
        """One engine iteration: admit + prefill (a swap-in restores, a
        long context starts chunks, chunks in flight advance), then one
        decode dispatch for all running slots. Returns the number of
        requests in slots. Device work runs outside the lock; only
        bookkeeping is locked."""
        static = self.serve_cfg.scheduler == "static"
        with self.lock:
            if static:
                admitted = ([] if self.scheduler.active_count > 0
                            else self.scheduler.admit())
            else:
                admitted = self.scheduler.admit(
                    self.serve_cfg.prefill_budget_tokens)
        C = self.serve_cfg.chunked_prefill_tokens
        pending = []
        for req in admitted:
            if req.swapped_kv is not None \
                    and not req.swapped_kv.get("partial"):
                # a whole payload restores with no prefill; a partial one
                # (a salvaged pre-copy) goes to _prefill, which writes its
                # pages and computes the tail
                if self._restore_swapped(req):
                    continue
                req.swapped_kv = None
            # route on the whole re-prefill context: a preempted request
            # resumes with prompt + generated, which may pass C; a
            # pipeline-stage request always takes chunks (its pages are
            # published chunk by chunk)
            if req.swapped_kv is None and (
                    (C > 0 and len(req.context_tokens) > C)
                    or req.pipeline_stage is not None):
                self._start_chunked_prefill(req)
            else:
                pending.append(self._prefill(req))
        # every chunked prefill in flight advances (within the budget);
        # the ones that completed join this step's first tokens
        pending += self._advance_chunked_prefills()
        for req, token in pending:
            self._finish_prefill(req, token)
        if pending:
            with self.lock:
                # prompt-is-whole-request edge: finished on the first token
                self.scheduler.step_finished(self.eos_token_id)
            if self.on_prefill_complete is not None:
                # the disaggregated handoff boundary: no lock held, before
                # any decode dispatch of these requests
                for req, _tok in pending:
                    if req.state is RequestState.RUNNING:
                        self.on_prefill_complete(req)
        with self.lock:
            # grow chains for one dispatch of writes, preempting if needed,
            # BEFORE the dispatch reads the block tables
            self._ensure_decode_capacity()
            use_short = self._short_dispatch_ok()
        if any(self.active):
            if self._speculate_now():
                # the dispatch builds its window from host state, so a
                # pipelined group still in flight is applied first
                self._drain_pending()
                emitted, n_emit, decode_seq = self._spec_device()
                with self.lock:
                    self._apply_speculative(emitted, n_emit, decode_seq)
                    self.scheduler.step_finished(self.eos_token_id)
            elif (self.serve_cfg.pipelined_decode and not static
                    and not use_short and not admitted and not pending
                    and not self._partial_prefills
                    and 2 * int(self.active.sum())
                    >= self.serve_cfg.max_batch_size):
                # keep one group in flight: enqueue the next group chained
                # on the previous one's device-resident carry, THEN fetch
                # and apply the previous one. Any prefill breaks the chain
                # (a re-armed slot's chained inputs would be stale); a
                # finish does not (its row decodes into freed pages, which
                # the device overwrites in order, and apply() masks it).
                prev = self._pending
                self._pending = self._submit_group(
                    self._decode_units, chain_from=prev)
                if prev is not None:
                    sampled = self._fetch_group(prev)
                    with self.lock:
                        self._apply_decode(sampled, snapshot=prev)
                        self.scheduler.step_finished(self.eos_token_id)
            else:
                self._drain_pending()
                if any(self.active):
                    sampled = self._decode_device(use_short)
                    with self.lock:
                        self._apply_decode(sampled)
                        self.scheduler.step_finished(self.eos_token_id)
        with self.lock:
            return self.scheduler.active_count

    def fail_all(self, error: str) -> None:
        """Fail every queued and resident request (engine-thread crash
        path), so their waiters fire."""
        with self.lock:
            failed = self.scheduler.fail_all(error)
            self._pending = None
            # every slot was released: a chunk advanced now would write
            # into freed pages
            self._partial_prefills.clear()
        if self.on_finish is not None:
            for r in failed:
                self.on_finish(r)

    def recover(self) -> bool:
        """Probe the device after a failed step. Pages are updated in place
        (nothing is donated), so no buffer needs reallocating; a flushed
        prefix cache guards against pages a failed step half wrote. A
        tensor-parallel engine does not recover: its ranks may have parted
        mid-protocol."""
        if self._link is not None:
            logger.error("tensor-parallel engine failed a step: the ranks "
                         "cannot be resynchronised")
            return False
        try:
            self.kv.flush_prefix_cache()
            probe = torch.ones(8, device=self.device).sum()
            return float(probe) == 8.0
        except RuntimeError:
            logger.exception("engine recovery probe failed")
            return False

    def measure_device_times(self, buckets: Sequence[int] = (),
                             iters: int = 8) -> dict:
        """On-device phase times, as the JAX engine's calibration: the
        dense prefill of each bucket (default: the buckets served so far)
        and a decode dispatch of ``decode_steps`` steps over every slot, in
        ms, ``iters`` runs queued behind one synchronisation after a warm
        run. Every write goes to scratch page 0 (all-zero table entries),
        so live KV is untouched. Returns {"prefill_ms": {bucket: ms},
        "decode_ms_per_token": ms, "iters": iters}."""
        out: dict = {"prefill_ms": {}, "iters": iters}
        PS = self.kv.page_size

        def timed(run) -> float:
            run()
            self._sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                last = run()
            last.cpu()
            return (time.perf_counter() - t0) / iters * 1e3

        for bucket in buckets or sorted(self._dense_buckets):
            tokens = np.ones((1, bucket), np.int64)
            entries = np.zeros(bucket // PS, np.int64)
            out["prefill_ms"][bucket] = timed(
                lambda: self._prefill_dense(tokens, bucket, entries))
        K = self._decode_unit_len
        with torch.inference_mode():
            out["decode_ms_per_token"] = timed(
                lambda: self._probe_decode(K)) / K
        return out

    @on_every_rank()
    def _probe_decode(self, K: int) -> torch.Tensor:
        """``measure_device_times``' decode probe: K steps over every slot
        from position 0, every write to scratch page 0."""
        S = self.serve_cfg.max_batch_size
        zeros = torch.zeros(S, dtype=torch.int64, device=self.device)
        tables = torch.zeros_like(to_device(self.kv.block_tables,
                                            self.device))
        _, sampled, _ = decode_scan(
            self.params, zeros, zeros, self.kv.k_pages, self.kv.v_pages,
            tables, zeros + self.serve_cfg.max_seq_len, zeros,
            np.ones(S, np.float32), np.zeros(S, np.int64),
            np.ones(S, np.float32), self.cfg, K,
            w8_kernel_ok=self._w8_kernel_ok)
        self._digest(sampled)
        self.total_paged_passes += K
        return sampled

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self.scheduler.queue_depth == 0:
                return
        raise RuntimeError("run_until_idle: did not drain")

    # -- convenience ---------------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None) -> list[Request]:
        """Offline batch generation (tests and smoke runs)."""
        reqs = []
        for i, p in enumerate(prompts):
            r = Request(request_id=f"gen-{i}-{time.monotonic_ns()}",
                        prompt_tokens=list(p),
                        sampling=sampling or SamplingParams())
            if not self.scheduler.add_request(r):
                raise RuntimeError(f"queue full / invalid request: {r.error}")
            reqs.append(r)
        self.run_until_idle()
        return reqs

    def stats(self) -> dict:
        steps = max(self.total_decode_steps, 1)
        return {
            "weight_bytes": self.params.weight_bytes(),
            "quantization": self.quantization,
            **self.scheduler.stats(),
            "kv": self.kv.stats(),
            "admission": self.serve_cfg.admission,
            "preemptions": self.total_preemptions,
            "preemption_mode": self.serve_cfg.preemption,
            "swap_ins": self.total_swap_ins,
            "swapped_host_bytes": self._swap_bytes_in_queue(),
            "swap_outs": self.total_swap_outs,
            "swap_out_bytes": self.total_swap_out_bytes,
            "swap_fallbacks": self.total_swap_fallbacks,
            "decode_steps": self.total_decode_steps,
            "short_dispatches": self.total_short_dispatches,
            "prefill_tokens": self.total_prefill_tokens,
            "prefix_cached_tokens": self.total_prefix_cached_tokens,
            "requeue_cached_tokens": self.total_requeue_cached_tokens,
            "prefix_fetched_tokens": self.total_prefix_fetched_tokens,
            "salvage_tail_fetched_tokens":
                self.total_salvage_tail_fetched_tokens,
            "unexpected_prefills": self.total_unexpected_prefills,
            "partial_restores": self.total_partial_restores,
            "padded_slot_steps": self.total_padded_slot_steps,
            "dispatched_steps": self.total_dispatched_steps,
            "extend_prefills": self.total_extend_prefills,
            "paged_passes": self.total_paged_passes,
            "chunked_prefills": self.total_chunked_prefills,
            "prefill_chunks": self.total_prefill_chunks,
            "nonfinite_logits": int(self._nonfinite),
            "decode_slot_utilization": round(
                1.0 - self.total_padded_slot_steps
                / (steps * self.serve_cfg.max_batch_size), 4),
            "spec_dispatches": self.total_spec_dispatches,
            "spec_drafts": self.total_spec_drafts,
            "spec_accepted": self.total_spec_accepted,
            "spec_resumes": self.total_spec_resumes,
            "spec_acceptance": round(
                self.total_spec_accepted / max(self.total_spec_drafts, 1), 4),
            "device": str(self.device),
        }
