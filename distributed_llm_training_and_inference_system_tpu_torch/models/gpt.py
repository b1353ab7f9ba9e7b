"""Decoder-only GPT/Llama model as ``nn.Module``s.

Counterpart of the JAX package's ``models/gpt.py``. The JAX model is one
pytree whose layer leaves are stacked on a leading ``[L, ...]`` axis; here
each layer is a ``Block`` module in ``GPT.blocks`` (``weights.params_from_
jax`` unstacks the JAX tree). Parameter conventions are the JAX ones:
projection weights are ``[in, out]`` (``x @ w``) and a norm scale ``s`` is
applied as ``1 + s``.

Parameters are trainable fp32 masters (or bf16 for a serving model).
``forward`` casts every block leaf to the compute dtype once, outside the
layer loop (``precast_params``), so autograd returns fp32 gradients to the
masters; ``remat`` wraps each block in ``torch.utils.checkpoint``. Serving
calls ``forward`` under ``torch.inference_mode()``.

An MoE config's blocks hold a router and stacked experts in place of the
dense FFN (``moe_block``); ``forward(return_aux=True)`` also returns the
load-balancing aux loss summed over the layers, which training adds to the
loss.

A serving model's block kernels may be quantized: ``with_block_leaves``
builds a model whose blocks hold ``ops.quantization`` ``QuantTensor`` /
``Quant4Tensor`` leaves in place of parameters. ``forward`` dequantizes
those one layer at a time, so only one layer's full-precision weights
exist at once.
"""

from __future__ import annotations

import copy
import functools
import math
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..ops.quantization import QuantTensor, Quant4Tensor
from .layers import _activate, attention_block, cast, mlp_block, \
    moe_block, rms_norm, rope_frequencies

_QUANT = (QuantTensor, Quant4Tensor)


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))


class Block(nn.Module):
    """One pre-norm transformer block's parameters (a dense FFN, or for an
    MoE config the router [H, E] and the stacked experts); the block itself
    is ``_block_fn`` over these or their precast copies."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim
        Nq, Nkv, Fs = cfg.num_heads, cfg.num_kv_heads, cfg.ffn_size
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = _param(H, **kw)
        self.q = _param(H, Nq * D, **kw)
        self.k = _param(H, Nkv * D, **kw)
        self.v = _param(H, Nkv * D, **kw)
        self.o = _param(Nq * D, H, **kw)
        if cfg.attention_bias:
            self.q_bias = _param(Nq * D, **kw)
            self.k_bias = _param(Nkv * D, **kw)
            self.v_bias = _param(Nkv * D, **kw)
        self.mlp_norm = _param(H, **kw)
        if cfg.is_moe:
            E = cfg.moe.num_experts
            self.moe_router = _param(H, E, **kw)
            self.moe_gate = _param(E, H, Fs, **kw)
            self.moe_up = _param(E, H, Fs, **kw)
            self.moe_down = _param(E, Fs, H, **kw)
        else:
            self.gate = _param(H, Fs, **kw)
            self.up = _param(H, Fs, **kw)
            self.down = _param(Fs, H, **kw)

    # the JAX tree's blocks/mlp/{gate,up,down} and blocks/moe/{router,gate,
    # up,down}: a block holds one FFN or the other
    LEAF_NAMES = ("attn_norm", "q", "k", "v", "o", "q_bias", "k_bias",
                  "v_bias", "mlp_norm", "gate", "up", "down", "moe_router",
                  "moe_gate", "moe_up", "moe_down")

    def leaves(self) -> dict:
        """name -> leaf: a parameter, or a quantized weight."""
        return {n: getattr(self, n) for n in self.LEAF_NAMES
                if hasattr(self, n)}

    @classmethod
    def from_leaves(cls, leaves: dict) -> "Block":
        """A block over existing leaves, allocating nothing: parameters
        are shared with their owner, quantized weights are plain
        attributes."""
        blk = cls.__new__(cls)
        nn.Module.__init__(blk)
        for name, leaf in leaves.items():
            setattr(blk, name, leaf)
        return blk


def _block_fn(layer, x, cfg, positions, segment_ids, inv_freq,
              kv_cache=None, cache_offset=None, attn_impl="xla",
              norm_impl="xla", reduce=None):
    """One pre-norm block over ``layer`` (a ``Block`` or its precast
    leaves). Returns (x, updated kv_cache or None, the MoE aux loss or
    None for a dense block). ``reduce`` (a tensor-parallel serving rank's
    ``TPSums``) completes the row-parallel partial sums of o and down."""
    h = rms_norm(x, cast(layer.attn_norm, x.dtype), cfg.norm_eps,
                 impl=norm_impl)
    attn_out, new_cache = attention_block(
        h, layer, cfg, positions, segment_ids, inv_freq,
        kv_cache=kv_cache, cache_offset=cache_offset, attn_impl=attn_impl)
    if reduce is not None:
        attn_out = reduce.attn(attn_out)
    x = x + attn_out
    h = rms_norm(x, cast(layer.mlp_norm, x.dtype), cfg.norm_eps,
                 impl=norm_impl)
    if cfg.is_moe:
        ffn, aux = moe_block(h, layer, cfg)
    else:
        ffn, aux = mlp_block(h, layer, cfg), None
        if reduce is not None:
            ffn = reduce.ffn(ffn)
    return x + ffn, new_cache, aux


class GPT(nn.Module):
    """Embedding, ``num_layers`` blocks, final norm and LM head."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        H, V = cfg.hidden_size, cfg.vocab_size
        kw = dict(device=device, dtype=dtype)
        self.embed = _param(V, H, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _param(H, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else _param(H, V, **kw))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def with_block_leaves(self, blocks: list) -> "GPT":
        """A model over this one's embedding, final norm and LM head (the
        same parameters, not copies) and ``blocks``: one ``{name: leaf}``
        dict per layer, whose kernels may be quantized."""
        model = GPT.__new__(GPT)
        nn.Module.__init__(model)
        model.cfg = self.cfg
        model.embed = self.embed
        model.blocks = nn.ModuleList(Block.from_leaves(b) for b in blocks)
        model.final_norm = self.final_norm
        model.lm_head = self.lm_head
        return model

    def weight_bytes(self) -> int:
        """Device bytes of the weights (a quantized leaf counts its stored
        values and scales). A tensor-parallel serving rank's model reports
        the whole model's, as the JAX engine's global arrays do."""
        whole = getattr(self, "whole_weight_bytes", None)
        if whole is not None:
            return whole
        tensors = list(self.parameters())
        for blk in self.blocks:
            for leaf in blk.leaves().values():
                if isinstance(leaf, _QUANT):
                    tensors += leaf.tensors()
        return sum(t.numel() * t.element_size() for t in tensors)


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

@torch.no_grad()
def init(cfg, generator: Optional[torch.Generator] = None, device=None,
         dtype=torch.float32) -> GPT:
    """A randomly initialised model with the JAX ``init`` distributions:
    truncated normal (+-3 sigma) with std 0.02, output projections scaled
    to 0.02 / sqrt(2L), norm scales 0 (applied as 1 + 0). Draws are made
    in fp32 on ``device`` and cast to ``dtype``. The numbers differ from
    JAX's for the same seed (another generator); tests that compare the
    two packages bridge the JAX params with ``weights.params_from_jax``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    std = 0.02
    resid_std = std / math.sqrt(2.0 * cfg.num_layers)

    def fill(p: nn.Parameter, scale: float = std) -> None:
        t = torch.empty(p.shape, dtype=torch.float32, device=dev)
        nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
        p.copy_(t.mul_(scale))

    model = GPT(cfg, device=dev, dtype=dtype)
    for blk in model.blocks:
        fill(blk.q)
        fill(blk.k)
        fill(blk.v)
        fill(blk.o, resid_std)
        if cfg.is_moe:
            fill(blk.moe_router)
            fill(blk.moe_gate)
            fill(blk.moe_up)
            fill(blk.moe_down, resid_std)
        else:
            fill(blk.gate)
            fill(blk.up)
            fill(blk.down, resid_std)
    fill(model.embed)
    if model.lm_head is not None:
        fill(model.lm_head)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` with an fp32 result accumulated in fp32 from
    operands of one dtype. On a card, bf16 operands go to the tensor cores
    with an fp32 output (``torch.mm(out_dtype=float32)``); on the CPU the
    operands are widened first (products of bf16 values are exact in fp32,
    so this is the same sum up to its order)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` -> fp32, as the JAX einsum with
    ``preferred_element_type=float32``. The backward products take the
    fp32 cotangent rounded to the operands' dtype, with fp32
    accumulation, and return gradients in the operands' dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g.to(w.dtype), w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x.t(), g.to(x.dtype)).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] @ [K, N] -> [..., N] fp32 with an fp32 accumulator
    (differentiable)."""
    lead = x.shape[:-1]
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def head_weight(model: GPT, dtype: torch.dtype) -> torch.Tensor:
    """The LM head as [H, V] in ``dtype`` (the embedding transposed when
    tied)."""
    if model.cfg.tie_word_embeddings:
        return cast(model.embed, dtype).t()
    return cast(model.lm_head, dtype)


def unembed(model: GPT, x: torch.Tensor, cfg,
            norm_impl: str = "xla") -> torch.Tensor:
    """Final RMSNorm + LM head (tied or untied); fp32 logits from the fp32
    accumulator of the head product, as the JAX ``unembed``. On a
    tensor-parallel serving rank every rank ends with the whole logits:
    an untied head's vocab columns are all-gathered, a tied head's partial
    products over this rank's hidden slice are all-reduced."""
    x = rms_norm(x, cast(model.final_norm, x.dtype), cfg.norm_eps,
                 impl=norm_impl)
    mesh = tp_mesh_of(model)
    if mesh is None:
        return matmul_f32(x, head_weight(model, x.dtype))
    from ..comms.collectives import all_gather, allreduce_sum
    if not cfg.tie_word_embeddings:
        out = matmul_f32(x, cast(model.lm_head, x.dtype))
        if out.shape[-1] == cfg.vocab_size:       # vocab not cut
            return out
        return all_gather(out, "tp", gather_dim=-1, mesh=mesh)
    n = model.embed.shape[1]
    if n == cfg.hidden_size:                      # hidden not cut
        return matmul_f32(x, cast(model.embed, x.dtype).t())
    i = mesh.axis_index("tp")
    part = matmul_f32(x[..., i * n:(i + 1) * n].contiguous(),
                      cast(model.embed, x.dtype).t())
    return allreduce_sum(part, "tp", mesh)


# ---------------------------------------------------------------------------
# Tensor-parallel serving (one rank of a tp mesh, no autograd)
# ---------------------------------------------------------------------------

def tp_mesh_of(model) -> Optional[object]:
    """The tp mesh of a tensor-parallel serving rank's model
    (``weights.rank_model``), else None."""
    return getattr(model, "tp_mesh", None)


def embed_tokens(model: GPT, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The embedding lookup in ``dtype``; a tensor-parallel rank holds the
    table's hidden slice (JAX's ``PARAM_RULES``: hidden on tp) and
    all-gathers the rows over hidden."""
    x = cast(model.embed[tokens], dtype)
    mesh = tp_mesh_of(model)
    if mesh is None or x.shape[-1] == model.cfg.hidden_size:
        return x
    from ..comms.collectives import all_gather
    return all_gather(x, "tp", gather_dim=-1, mesh=mesh)


class TPSums:
    """The all-reduces of a tensor-parallel serving rank's block: after
    the row-parallel o, and after down where the FFN is cut (a width tp
    does not divide is replicated, as JAX's ``_shrink_to_fit`` leaves
    it, and needs none)."""

    def __init__(self, mesh, ffn_cut: bool):
        self.mesh, self.ffn_cut = mesh, ffn_cut

    def attn(self, y: torch.Tensor) -> torch.Tensor:
        from ..comms.collectives import allreduce_sum
        return allreduce_sum(y, "tp", self.mesh)

    def ffn(self, y: torch.Tensor) -> torch.Tensor:
        return self.attn(y) if self.ffn_cut else y


def tp_blocks(model: GPT, cfg) -> tuple:
    """``(local config, TPSums)`` of a tensor-parallel serving rank's
    model; ``(cfg, None)`` for a whole model."""
    mesh = tp_mesh_of(model)
    if mesh is None:
        return cfg, None
    local = tp_local_config(cfg, mesh.axis_size("tp"), ffn_must_divide=False)
    return local, TPSums(mesh, local.ffn_size != cfg.ffn_size)


def _dequantized(layer: SimpleNamespace, dtype) -> SimpleNamespace:
    """``layer`` with its quantized leaves dequantized to ``dtype`` (the
    same object when it has none)."""
    if not any(isinstance(v, _QUANT) for v in vars(layer).values()):
        return layer
    return SimpleNamespace(**{
        n: v.dequant(dtype) if isinstance(v, _QUANT) else v
        for n, v in vars(layer).items()})


def precast_params(model: GPT, dtype: torch.dtype) -> list[SimpleNamespace]:
    """Every block's plain leaves in ``dtype``, cast once (a no-op for
    leaves already in it); quantized leaves stay quantized. Casting inside
    the layer loop would read the fp32 masters again at every recompute."""
    return [SimpleNamespace(**{
        n: leaf if isinstance(leaf, _QUANT) else cast(leaf, dtype)
        for n, leaf in blk.leaves().items()}) for blk in model.blocks]


# matmul outputs: what "selective" keeps resident (the JAX policy
# dots_with_no_batch_dims_saveable); everything else is recomputed
_SAVED_OPS = frozenset({torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default})


def _selective_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, policy: str):
    """Wrap the block per the activation-checkpoint policy: "none",
    "full" (recompute everything in backward), "selective" (keep the
    matmul outputs, recompute the rest, the flash forward included) or
    "selective_attn".

    The JAX "selective_attn" adds the block's named ``attn_out`` to the
    dots policy. That name is the attention block's output after the o
    projection, a dot the dots policy keeps already: JAX's saved residuals
    are the same under both policies (``jax.ad_checkpoint``'s listing for
    gpt-test: the q, k, v, o and FFN products), and neither keeps the flash
    kernel's output, so its forward re-runs in the backward under both.
    The port copies that: "selective_attn" keeps what "selective" keeps."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy in ("selective", "selective_attn"):
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _selective_policy))
    raise ValueError(f"unknown remat policy {policy!r} "
                     "(none|selective|selective_attn|full)")


def forward(
    model: GPT,
    tokens: torch.Tensor,
    cfg=None,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    cache_offset: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    norm_impl: str = "xla",
    remat: str = "none",
    return_aux: bool = False,
    unembed_positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
):
    """Logits [B, S, V] (fp32), or with ``return_hidden`` the final-normed
    hidden states [B, S, H] in the compute dtype (for the chunked loss).

    - ``segment_ids`` [B, S] packs several documents per row (0 = pad).
    - ``attn_impl`` "xla" (plain masked attention) or "flash"
      (``ops.attention.flash_attention``: the kernels on a card).
    - ``norm_impl`` "xla" (plain RMSNorm) or "cuda" (``ops.rmsnorm``: the
      kernel on a card; forward only, so not for training).
    - ``remat`` "none" | "selective" | "selective_attn" | "full"
      (training only).
    - ``kv_cache`` ([L, B, Smax, Nkv, D], [L, B, Smax, Nkv, D]) with
      ``cache_offset`` [B] runs incremental attention; the cache is
      updated in place and returned as ``(logits, kv_cache)``.
    - ``unembed_positions`` [B] keeps one position per row for the LM
      head, returning [B, 1, V].
    - ``return_aux`` appends the MoE aux loss summed over the layers (an
      fp32 scalar; 0 for a dense model), as the JAX forward does:
      ``(out, [kv_cache,] aux)``."""
    cfg = cfg or model.cfg
    dt = compute_dtype(cfg)
    B, S = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
        positions = positions.expand(B, S)
        if cache_offset is not None:
            positions = positions + cache_offset[:, None]

    x = embed_tokens(model, tokens, dt)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope.base,
                                cfg.rope.scaling, cfg.rope.scaling_factor,
                                device=dev)
    layers = precast_params(model, dt)
    block_cfg, sums = tp_blocks(model, cfg)
    if sums is not None and kv_cache is None:
        raise ValueError("a tensor-parallel serving rank runs the cached "
                         "(serving) forward only")
    new_cache = None
    aux_total = None                     # summed over MoE layers only
    if kv_cache is None:
        block = _remat_wrap(_block_fn, remat)
        for layer in layers:
            layer = _dequantized(layer, dt)      # this layer only
            x, _, aux = block(layer, x, cfg, positions, segment_ids,
                              inv_freq, None, None, attn_impl, norm_impl)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
    else:
        k_cache, v_cache = kv_cache
        for i, layer in enumerate(layers):
            layer = _dequantized(layer, dt)      # this layer only
            x, _, aux = _block_fn(layer, x, block_cfg, positions,
                                  segment_ids, inv_freq,
                                  (k_cache[i], v_cache[i]), cache_offset,
                                  norm_impl=norm_impl, reduce=sums)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        new_cache = (k_cache, v_cache)

    if unembed_positions is not None:
        idx = unembed_positions.long()[:, None, None].expand(-1, 1,
                                                             x.shape[-1])
        x = torch.gather(x, 1, idx)
    if return_hidden:
        out = rms_norm(x, cast(model.final_norm, x.dtype), cfg.norm_eps,
                       impl=norm_impl)
    else:
        out = unembed(model, x, cfg, norm_impl=norm_impl)
    result = [out]
    if kv_cache is not None:
        result.append(new_cache)
    if return_aux:
        result.append(aux_total if aux_total is not None else torch.zeros(
            (), dtype=torch.float32, device=dev))
    return tuple(result) if len(result) > 1 else result[0]


# ---------------------------------------------------------------------------
# Sharded forward (one rank of a mesh)
# ---------------------------------------------------------------------------

def gather_leaf(t: torch.Tensor, spec: tuple, mesh,
                keep: tuple = ()) -> torch.Tensor:
    """A rank's shard ``t`` of a leaf cut by ``spec``, all-gathered over
    every axis of it but ``keep`` (differentiable). A gather over a data
    axis (the FSDP parameter gather) reduce-scatters its gradient: the
    members fed different rows. A gather over ``tp`` slices it: every tp
    rank computes the whole gradient of what it gathered alike."""
    from ..comms.collectives import gather
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for a in reversed(axes):        # the minor axis first
            if a in keep:
                continue
            t = gather(t, a, d, "slice" if a == "tp" else "reduce_scatter",
                       mesh)
    return t


def tp_local_config(cfg, tp: int, ffn_must_divide: bool = True):
    """``cfg`` as one tensor-parallel rank sees its blocks: 1/tp of the
    query and kv heads and of the FFN width (head-aligned column and row
    splits). Serving (``ffn_must_divide=False``) follows JAX's serving
    check, which asks nothing of the FFN: a width tp does not divide stays
    whole on every rank."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or (
            ffn_must_divide and cfg.ffn_size % tp):
        raise ValueError(
            f"tensor_parallel={tp} must divide num_heads={cfg.num_heads}, "
            f"num_kv_heads={cfg.num_kv_heads} and ffn_size={cfg.ffn_size}")
    local = copy.copy(cfg)
    local.num_heads = cfg.num_heads // tp
    local.num_kv_heads = cfg.num_kv_heads // tp
    if cfg.ffn_size % tp == 0:
        local.ffn_size = cfg.ffn_size // tp
    return local


def _sharded_block_fn(stacked: dict, layer_idx: int, x, cfg_local, mesh,
                      positions, segment_ids, inv_freq, attn_impl: str):
    """One pre-norm block on one rank: (x, the MoE aux loss or None). The
    layer's leaves are taken from the stacked shards, all-gathered over
    fsdp and cast to the compute dtype; q/k/v and gate/up are
    column-parallel (this rank's heads and FFN columns) behind
    ``copy_to``, o and down row-parallel with their partial sums
    all-reduced over tp by ``reduce_from``. An MoE layer keeps its
    experts cut over ep and tp (``layers.moe_block`` on the mesh)."""
    from ..comms.collectives import copy_to, reduce_from
    from ..parallel.sharding import spec_axes
    layer = SimpleNamespace(**{
        name: cast(gather_leaf(t[layer_idx], spec, mesh, keep=("tp", "ep")),
                   x.dtype)
        for name, (t, spec) in stacked.items()})
    h = rms_norm(x, layer.attn_norm, cfg_local.norm_eps)
    attn, _ = attention_block(copy_to(h, "tp", mesh), layer, cfg_local,
                              positions, segment_ids, inv_freq,
                              attn_impl=attn_impl, mesh=mesh)
    x = x + reduce_from(attn, "tp", mesh)
    h = rms_norm(x, layer.mlp_norm, cfg_local.norm_eps)
    if cfg_local.is_moe:
        cut = tuple(a for a in ("ep", "tp")
                    if a in spec_axes(stacked["moe_gate"][1]))
        ffn, aux = moe_block(h, layer, cfg_local, mesh=mesh, cut=cut)
        return x + ffn, aux
    return x + reduce_from(mlp_block(copy_to(h, "tp", mesh), layer,
                                     cfg_local), "tp", mesh), None


def forward_sharded(stacked: dict, top: dict, tokens: torch.Tensor, cfg,
                    mesh, *, positions: torch.Tensor,
                    segment_ids: Optional[torch.Tensor] = None,
                    attn_impl: str = "xla", remat: str = "none",
                    x: Optional[torch.Tensor] = None, first: bool = True,
                    last: bool = True):
    """The forward of one rank of a mesh: (out, head, aux). ``out`` is the
    final-normed hidden states [B_local, S_local, H] in the compute dtype
    and ``head`` the LM head whole (weight [V, H] when tied else [H, V],
    fp32); ``aux`` the MoE aux loss summed over this rank's layers (None
    for a dense model).

    ``stacked``: {block leaf name: (this rank's shard of the [L, ...]
    stacked leaf, its spec without the layer axis)}; ``top``: the same
    for "embed", "final_norm" and (untied) "lm_head". ``tokens`` [B_local,
    S_local] are this rank's rows (its data index) and sequence chunk (its
    sp index), ``positions`` their global positions.

    A pipeline stage (``parallel/pipeline.py``) holds the stacked leaves'
    layers of its pp index: the first stage (``first``) embeds ``tokens``,
    a later one takes its input activations ``x``; a stage that is not
    the ``last`` returns its blocks' output as ``out`` and None for
    ``head`` (the final norm and the head are the last stage's).

    Where the JAX forward anchors GSPMD with ``constrain(x,
    "activations")`` (batch over dp+fsdp, sequence over sp), the
    activations here are this rank's rows and chunk by construction: that
    constraint implies no collective. What GSPMD derives from the
    parameter specs is placed by hand: the embedding and LM head gathered
    whole (FSDP and tp), each block's leaves gathered over fsdp, the tp
    all-reduces of ``_sharded_block_fn``, the MoE dispatch over the global
    tokens, and the sequence's attention across sp ranks (``attn_impl``
    ring or ulysses)."""
    dt = compute_dtype(cfg)
    cfg_local = tp_local_config(cfg, mesh.axis_size("tp"))
    embed = None
    if first:
        embed = gather_leaf(*top["embed"], mesh)
        x = cast(embed[tokens], dt)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope.base,
                                cfg.rope.scaling, cfg.rope.scaling_factor,
                                device=tokens.device)
    block = _remat_wrap(_sharded_block_fn, remat)
    aux_total = None
    for i in range(next(iter(stacked.values()))[0].shape[0]):
        x, aux = block(stacked, i, x, cfg_local, mesh, positions,
                       segment_ids, inv_freq, attn_impl)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    if not last:
        return x, None, aux_total
    h = rms_norm(x, cast(gather_leaf(*top["final_norm"], mesh), x.dtype),
                 cfg.norm_eps)
    if cfg.tie_word_embeddings:
        head = embed if embed is not None else gather_leaf(*top["embed"],
                                                           mesh)
    else:
        head = gather_leaf(*top["lm_head"], mesh)
    return h, head, aux_total


def entry(device=None, norm_impl: str = "xla"):
    """(fn, example_args): a gpt-1b forward of one [1, 1024] row in bf16
    with flash attention, the port's counterpart of the JAX package's
    ``__graft_entry__.entry``. Weights are random (seed 0), made on
    ``device`` (the card unless the caller asks for the CPU);
    ``norm_impl="cuda"`` sends every RMSNorm through the kernel."""
    from ..config import get_model_config
    cfg = get_model_config("gpt-1b")
    dev = resolve_device(device)
    model = init(cfg, torch.Generator(device=dev).manual_seed(0),
                 device=dev, dtype=torch.bfloat16)

    def fn(model, tokens):
        with torch.inference_mode():
            return forward(model, tokens, cfg, attn_impl="flash",
                           norm_impl=norm_impl)

    tokens = torch.ones((1, 1024), dtype=torch.int64, device=dev)
    return fn, (model, tokens)


@torch.no_grad()
def activation_channel_scales(model: GPT, model_cfg, calib_tokens: torch.Tensor
                              ) -> dict[str, torch.Tensor]:
    """Per-input-channel activation RMS of the projection kernels from one
    calibration forward (the "activation-aware" statistic AWQ scales by):
    {stacked JAX param path: [L, in] fp32} for the q/k/v and dense mlp
    gate/up/down kernels (o and the MoE experts keep plain absmax: o's
    input never leaves the attention block, and experts are token-routed).
    ``model`` is a ``GPT`` with plain leaves; ``calib_tokens``
    [B, S] integer tokens on its device. The forward is the JAX one's:
    every layer's leaves cast to the compute dtype, plain attention, the
    MoE block for an MoE config."""
    dt = compute_dtype(model_cfg)
    dev = model.device
    tokens = calib_tokens.to(dev, torch.int64)
    x = cast(model.embed[tokens], dt)
    inv_freq = rope_frequencies(model_cfg.head_dim, model_cfg.rope.base,
                                model_cfg.rope.scaling,
                                model_cfg.rope.scaling_factor, device=dev)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    positions = positions.repeat(B, 1)
    per_layer: dict[str, list] = {}

    def record(key, h):
        rms = torch.sqrt((h.float() ** 2).mean(
            dim=tuple(range(h.dim() - 1)))) + 1e-6
        per_layer.setdefault(key, []).append(rms)

    for layer in precast_params(model, dt):
        h_attn = rms_norm(x, layer.attn_norm, model_cfg.norm_eps)
        for name in ("q", "k", "v"):
            record(f"blocks.{name}.kernel", h_attn)
        attn_out, _ = attention_block(h_attn, layer, model_cfg, positions,
                                      None, inv_freq)
        x = x + attn_out
        h_mlp = rms_norm(x, layer.mlp_norm, model_cfg.norm_eps)
        if model_cfg.is_moe:
            ffn, _ = moe_block(h_mlp, layer, model_cfg)
            x = x + ffn.to(x.dtype)
            continue
        for name in ("gate", "up"):
            record(f"blocks.mlp.{name}.kernel", h_mlp)
        a = _activate(h_mlp @ layer.gate, model_cfg.activation)
        a = a * (h_mlp @ layer.up)
        record("blocks.mlp.down.kernel", a)
        x = x + (a @ layer.down).to(x.dtype)
    return {k: torch.stack(v) for k, v in per_layer.items()}    # [L, in]


# ---------------------------------------------------------------------------
# Dense KV cache helper and FLOP accounting
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def flops_per_token(cfg, seq_len: int) -> float:
    """Training FLOPs per token: 6 * matmul params + the attention term."""
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    D, Nq, Nkv, F = (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                     cfg.ffn_size)
    attn_proj = H * Nq * D + 2 * H * Nkv * D + Nq * D * H
    if cfg.is_moe:
        ffn = 3 * H * F * cfg.moe.experts_per_token
    else:
        ffn = 3 * H * F if cfg.activation in ("silu", "gelu") else 2 * H * F
    head = H * V
    matmul_params = L * (attn_proj + ffn) + head
    dense_flops = 6.0 * matmul_params
    attn_flops = 12.0 * L * Nq * D * seq_len
    return dense_flops + attn_flops
