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
- **Quantization**: ``quantization`` int8 | int4 quantizes the block
  kernels at construction (W8A16 / group-wise W4A16; embedding, LM head
  and norms keep full precision), and ``kv_quantization`` int8 | int4
  stores the KV pages quantized, each token quantized as it is written.
  Decode sends W4 weights, and W8 weights with ``int8_pallas_matmul``, to
  the in-kernel-dequant matmuls; prefill dequantizes one layer at a time.
- **Admission**: on demand by default (pages for one dispatch of lookahead;
  chains grow as decode advances, and the newest resident request is
  preempted, recompute-style, when the pool runs dry).

Non-default features that the port does not carry yet raise
``NotImplementedError`` at construction, naming their ROADMAP item.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..models import gpt
from ..ops.paged_attention import (Int4Pages, QuantPages, quantize_kv_token,
                                   quantize_kv_token_int4)
from ..ops.quantization import (QuantTensor, Quant4Tensor, int4_group_for,
                                pack_int4_rows, quantize_int4_groupwise,
                                quantize_int8)
from .decode import decode_scan, extend_step_forward
from .kv_cache import PagedKVCache, prefix_page_hashes
from .sampling import gumbel_noise, sample_tokens
from .scheduler import (ContinuousBatchingScheduler, Request, RequestState,
                        SamplingParams)

logger = logging.getLogger("llmctl.serve.engine")

# feature -> (is it requested?, ROADMAP item that ports it)
_NOT_PORTED = (
    (lambda c: c.speculative != "off", "speculative",
     "queue 1 item 6 (serve/speculative.py)"),
    (lambda c: c.chunked_prefill_tokens > 0, "chunked_prefill_tokens > 0",
     "queue 1 item 6 (chunked prefill)"),
    (lambda c: c.quantization == "int4-awq", "quantization='int4-awq'",
     "queue 1 item 5 (AWQ calibration, ops/quantization.py)"),
    (lambda c: c.tensor_parallel > 1, "tensor_parallel > 1",
     "queue 1 item 7 (multi-GPU)"),
    (lambda c: c.preemption == "swap", "preemption='swap'",
     "queue 1 item 6 (swap preemption)"),
    (lambda c: bool(c.artifact), "artifact loading",
     "queue 1 item 5 (artifact loading, io/export.py)"),
)


QUANT_MIN_SIZE = 4096    # elements of the stacked [L, in, out] kernel


@torch.no_grad()
def quantize_blocks(model: gpt.GPT, kind: str, free_source: bool = False
                    ) -> gpt.GPT:
    """A model over ``model``'s embedding, norms and head with its block
    kernels quantized: the per-layer result of the JAX engine's
    ``quantize_tree_int8(blocks, min_ndim=3)`` (``kind`` "int8") or
    ``quantize_tree_int4`` ("int4") over the stacked tree. A kernel
    [in, out] quantizes when the stacked leaf would (L * in * out >=
    ``QUANT_MIN_SIZE``); int4 takes the largest group up to 128 that
    divides ``in`` and falls back to int8 where none does. Biases and norm
    scales stay as they are. Leaf by leaf, on the model's device; with
    ``free_source`` each full-precision kernel is dropped from ``model`` as
    soon as it is quantized, so the two copies never coexist."""
    L = len(model.blocks)
    blocks = []
    for blk in model.blocks:
        leaves = {}
        for name, p in blk.leaves().items():
            if (isinstance(p, (QuantTensor, Quant4Tensor)) or p.dim() != 2
                    or L * p.numel() < QUANT_MIN_SIZE):
                leaves[name] = p
                continue
            group = int4_group_for(p.shape[0]) if kind == "int4" else 0
            if group:
                leaves[name] = Quant4Tensor(
                    *quantize_int4_groupwise(p.detach(), group=group),
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
        for requested, name, item in _NOT_PORTED:
            if requested(serve_cfg):
                raise NotImplementedError(
                    f"{name} is not ported to the PyTorch engine yet "
                    f"(ROADMAP {item})")
        self.device = resolve_device(device)
        self.serve_cfg = serve_cfg
        self.eos_token_id = eos_token_id
        self.cfg = model_cfg
        # the effective quantization: what the weights are, which a
        # pre-quantized ``params`` decides whatever the config asks for
        self.quantization = serve_cfg.quantization
        dtype = getattr(torch, serve_cfg.dtype)
        own_params = params is None
        if own_params:
            # random init from the seed (no artifact: random weights keep
            # smoke and benchmark paths self-contained)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = gpt.init(model_cfg, gen, device=self.device, dtype=dtype)
        elif not isinstance(params, gpt.GPT):
            raise TypeError(
                "params must be a models.gpt.GPT (a JAX params tree goes "
                "through weights.params_from_jax first)")
        elif params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        kinds = {type(leaf) for blk in params.blocks
                 for leaf in blk.leaves().values()}
        if Quant4Tensor in kinds or QuantTensor in kinds:
            self.quantization = "int4" if Quant4Tensor in kinds else "int8"
            logger.info("serving pre-quantized weights (%s)",
                        self.quantization)
        elif serve_cfg.quantization in ("int8", "int4"):
            # the caller's model is left as it is; a model this engine made
            # gives up each full-precision kernel as it is quantized
            params = quantize_blocks(params, serve_cfg.quantization,
                                     free_source=own_params)
            logger.info("serving with %s block weights",
                        serve_cfg.quantization)
        self.params = params
        # the int8 kernels are opt-in, as in the JAX engine (the int4
        # kernel is always on: nothing here shards a weight)
        self._w8_kernel_ok = bool(serve_cfg.int8_pallas_matmul)

        S = serve_cfg.max_batch_size
        self.kv = PagedKVCache(
            model_cfg, num_slots=S, max_seq_len=serve_cfg.max_seq_len,
            page_size=serve_cfg.kv_block_size,
            num_pages=serve_cfg.kv_num_blocks,
            hbm_budget_gb=serve_cfg.kv_hbm_budget_gb, dtype=dtype,
            device=self.device, quantized=serve_cfg.kv_quantization)

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

        # the one un-fetched in-flight dispatch group (see step())
        self._pending = None
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
        self.total_padded_slot_steps = 0
        # decode steps enqueued (a pipelined group still in flight is
        # counted here, not in total_decode_steps) and suffix prefills:
        # together they say how many paged-attention passes ran per layer
        self.total_dispatched_steps = 0
        self.total_extend_prefills = 0
        # device count of logits tensors with a NaN/inf (read in stats())
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)

    # -- admission -----------------------------------------------------------

    @property
    def _decode_lookahead(self) -> int:
        """Tokens one dispatch group may write per slot."""
        return self._decode_units * self._decode_unit_len

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
        zeros = gpt.init_kv_cache(cfg, 1, bucket, dtype=self.kv.dtype,
                                  device=dev)
        logits, (kd, vd) = gpt.forward(
            self.params, to_device(tokens, dev, torch.int64), cfg,
            kv_cache=zeros,
            cache_offset=torch.zeros(1, dtype=torch.int64, device=dev),
            unembed_positions=to_device(np.array([n - 1]), dev))
        idx = to_device(entries, dev, torch.int64)

        def scatter(pages, dense):
            # [L, 1, bucket, Nkv, D] -> [L, nP, Nkv, PS, D], quantized per
            # (token, kv head) for quantized pages (int4: then packed along
            # the page-slot axis), written at the bucket's table entries
            dense = dense[:, 0].reshape(
                cfg.num_layers, n_pages, PS, cfg.num_kv_heads,
                cfg.head_dim).transpose(2, 3)
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

    @torch.inference_mode()
    def _prefill_extend(self, tokens: np.ndarray, cached: int, m: int,
                        table_row: np.ndarray) -> torch.Tensor:
        """Suffix prefill over a cached paged prefix: the ``m`` un-cached
        tokens (padded to the suffix bucket) run through
        ``extend_step_forward``, writing through the slot's block table.
        Returns the last real token's logits [1, V]."""
        dev = self.device
        bucket = tokens.shape[1]
        write_ok = torch.arange(bucket, device=dev)[None] < m
        logits, _, _ = extend_step_forward(
            self.params, to_device(tokens, dev, torch.int64),
            to_device(np.array([cached]), dev), self.kv.k_pages,
            self.kv.v_pages, to_device(table_row[None], dev), self.cfg,
            write_ok=write_ok, w8_kernel_ok=self._w8_kernel_ok)
        return logits[:, m - 1]

    def _prefill(self, req: Request):
        """Dispatch one prompt's prefill; returns (req, device token). The
        first-token fetch is deferred to ``_finish_prefill`` so a burst of
        admitted prompts pays one host round trip."""
        slot = req.slot
        ctx = req.context_tokens   # prompt, + generated after a preemption
        n = len(ctx)
        rid = req.request_id
        PS = self.kv.page_size
        with self.lock:   # page bookkeeping is shared with cancel/release
            pins = self._prefix_pins.get(rid, [])
            self.kv.allocate(slot, n + self._admission_tail(req),
                             prefix_pages=pins)
            self._reserved_pages -= self._reserved_by.pop(rid, 0)
            self._req_slot[rid] = slot
            cached = len(pins) * PS       # context tokens served from cache
            if cached == 0:
                # table entries for the bucket: beyond-length -> scratch 0
                bucket = self._bucket(n)
                entries = np.zeros(bucket // PS, np.int64)
                used = self.kv.pages_needed(n)
                entries[:used] = self.kv.block_tables[slot, :used]
            table_row = self.kv.block_tables[slot].copy()

        s = req.sampling
        if req.assigned_seed is None:
            req.assigned_seed = s.seed if s.seed is not None else (
                self._base_seed + self._admitted_counter)
        self._admitted_counter += 1
        self._slot_seq[slot] = self._admitted_counter  # preemption priority
        self._slot_seeds[slot] = req.assigned_seed
        if req.prefill_dispatch_time is None:
            req.prefill_dispatch_time = time.monotonic()

        if cached == 0:
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n] = ctx
            logits = self._prefill_dense(tokens, n, entries)
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

        # publish this prompt's freshly written full pages for future hits
        if self.serve_cfg.prefix_caching and req.prefix_hashes:
            with self.lock:
                table = self.kv.block_tables[slot]
                self.kv.register_pages(
                    [(req.prefix_hashes[i], int(table[i]))
                     for i in range(len(pins), n // PS)])

        self.total_prefill_tokens += computed
        return req, token

    def _arm_slot(self, req: Request, last_token: int, n_written: int) -> None:
        """Make a slot live for decode: the one place the per-slot decode
        state is set. ``n_written`` is the number of KV entries present."""
        slot = req.slot
        s = req.sampling
        req.state = RequestState.RUNNING
        self.last_tokens[slot] = last_token
        self.positions[slot] = n_written
        # first position this slot may NOT write (prompt + max_tokens)
        self.stop_positions[slot] = req.num_prompt_tokens + s.max_tokens
        self.active[slot] = True
        self.temperature[slot] = s.temperature
        self.top_k[slot] = s.top_k
        self.top_p[slot] = s.top_p

    def _finish_prefill(self, req: Request, token) -> None:
        """Resolve a dispatched prefill: fetch its first token and make the
        slot live for decode."""
        n = len(req.context_tokens)    # BEFORE recording the new token
        tok = int(token)
        req.record_token(tok)
        if self.on_token is not None:
            self.on_token(req, [tok])
        self._arm_slot(req, tok, n)

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
        self.total_dispatched_steps += self._decode_unit_len
        return {
            "sampled": sampled, "next_tokens": next_toks,
            "next_positions": next_pos,
            "req_ids": [r.request_id if r is not None else None
                        for r in self.scheduler.slots],
            "active": self.active.copy(),
        }

    def _submit_group(self, n_units: int, chain_from=None) -> dict:
        """Chain ``n_units`` unit dispatches; return a group record with
        the same keys as a unit (last unit's carry, first unit's slot
        snapshot), so groups chain onto groups."""
        units = []
        pend = chain_from
        shared = self._shared_decode_args()
        for _ in range(n_units):
            pend = self._submit_decode(chain_from=pend, shared=shared)
            units.append(pend)
        return {
            "units": units,
            "next_tokens": units[-1]["next_tokens"],
            "next_positions": units[-1]["next_positions"],
            "req_ids": units[0]["req_ids"],
            "active": units[0]["active"],
        }

    def _fetch_group(self, group: dict) -> np.ndarray:
        """One device->host fetch of a group's sampled tokens [K, B]."""
        out = torch.cat([u["sampled"] for u in group["units"]]).cpu().numpy()
        self.total_decode_steps += out.shape[0]
        self.total_padded_slot_steps += out.shape[0] * int(
            self.serve_cfg.max_batch_size - group["active"].sum())
        return out

    def _drain_pending(self) -> None:
        """Fetch and apply the in-flight pipelined group, if any."""
        prev, self._pending = self._pending, None
        if prev is None:
            return
        sampled = self._fetch_group(prev)
        with self.lock:
            self._apply_decode(sampled, snapshot=prev)
            self.scheduler.step_finished(self.eos_token_id)

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
            if accepted and self.on_token is not None:
                self.on_token(req, accepted)

    # -- lifecycle -----------------------------------------------------------

    def release(self) -> None:
        """Drop this engine's device memory (weights, KV pool). The engine
        is unusable afterwards."""
        self.params = None
        self.kv = None
        self._pending = None

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request (newest-first victim policy) so an older
        stream can grow. Recompute-style: the request re-enters the queue
        head and re-prefills prompt+generated, from prefix-cached pages
        where caching holds them (its full pages are published here).
        Caller holds self.lock."""
        req = self.scheduler.slots[slot]
        rid = req.request_id
        written = int(self.positions[slot])   # KV entries actually present
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
        self.scheduler.preempt_slot(slot)
        self.total_preemptions += 1
        logger.info("preempted %s (slot %d, %d tokens generated) to free "
                    "KV pages", rid, slot, len(req.generated_tokens))

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
        if self.on_finish is not None:
            self.on_finish(req)

    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: admit + prefill, then one decode dispatch
        for all running slots. Returns the number of requests in slots.
        Device work runs outside the lock; only bookkeeping is locked."""
        static = self.serve_cfg.scheduler == "static"
        with self.lock:
            if static:
                admitted = ([] if self.scheduler.active_count > 0
                            else self.scheduler.admit())
            else:
                admitted = self.scheduler.admit(
                    self.serve_cfg.prefill_budget_tokens)
        pending = [self._prefill(req) for req in admitted]
        for req, token in pending:
            self._finish_prefill(req, token)
        if pending:
            with self.lock:
                # prompt-is-whole-request edge: finished on the first token
                self.scheduler.step_finished(self.eos_token_id)
        with self.lock:
            # grow chains for one dispatch of writes, preempting if needed,
            # BEFORE the dispatch reads the block tables
            self._ensure_decode_capacity()
            use_short = self._short_dispatch_ok()
        if any(self.active):
            if (self.serve_cfg.pipelined_decode and not static
                    and not use_short and not admitted
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
        if self.on_finish is not None:
            for r in failed:
                self.on_finish(r)

    def recover(self) -> bool:
        """Probe the device after a failed step. Pages are updated in place
        (nothing is donated), so no buffer needs reallocating; a flushed
        prefix cache guards against pages a failed step half wrote."""
        try:
            self.kv.flush_prefix_cache()
            probe = torch.ones(8, device=self.device).sum()
            return float(probe) == 8.0
        except RuntimeError:
            logger.exception("engine recovery probe failed")
            return False

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
            "decode_steps": self.total_decode_steps,
            "short_dispatches": self.total_short_dispatches,
            "prefill_tokens": self.total_prefill_tokens,
            "prefix_cached_tokens": self.total_prefix_cached_tokens,
            "padded_slot_steps": self.total_padded_slot_steps,
            "dispatched_steps": self.total_dispatched_steps,
            "extend_prefills": self.total_extend_prefills,
            "nonfinite_logits": int(self._nonfinite),
            "decode_slot_utilization": round(
                1.0 - self.total_padded_slot_steps
                / (steps * self.serve_cfg.max_batch_size), 4),
            "device": str(self.device),
        }
