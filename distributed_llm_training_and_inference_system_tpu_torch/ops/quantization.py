"""Quantization ops: absmax int8 and group-wise int4 (pack/unpack).

Counterpart of the JAX package's ``ops/quantization.py``, function for
function and bit for bit: every quantizer divides in fp32, rounds half to
even (``torch.round``), floors the scale at 1e-12, and packs two 4-bit
two's-complement nibbles per byte with element 2i in the low nibble. The
dequantizers multiply in the dtype the JAX ones multiply in (int8 in fp32,
group-wise int4 in the target dtype), so both packages serve the same
numbers from the same bytes.

``QuantTensor`` / ``Quant4Tensor`` are the runtime form of a quantized
weight (small classes over plain tensors; ``models.gpt.Block`` holds them in
place of a parameter). The tree helpers walk plain nested dicts of tensors,
the layout of the JAX parameter tree. The AWQ statistic (per-input-channel
activation RMS from one calibration forward, ``models.gpt.
activation_channel_scales``) feeds ``quantize_tree_int4``'s channel scales
and the int8-awq interchange format (``quantize_int8_awq``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


# The np-jnp-parity lint pass (analysis/passes_parity.py) reads these two
# markers off the AST by name, as on the JAX package's twins. This module
# imports nothing of the package, so it keeps its own no-op copies.
def np_twin_of(torch_name: str):
    """This ``*_np`` function is the numpy twin of ``torch_name``."""
    return lambda fn: fn


def np_host_only(reason: str):
    """This ``*_np`` function has no torch counterpart by design."""
    return lambda fn: fn


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over the LAST axis, scale without keepdims:
    (values int8 [..., D], scale fp32 [...])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = (absmax / 127.0).clamp(min=1e-12)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_int8_rows: values [..., D] * scale [...]."""
    return (q.float() * scale[..., None]).to(dtype)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 along ``axis``: (values int8, scales fp32 with
    the axis kept as size 1), x ~= values * scales."""
    if axis in (-1, x.dim() - 1):
        q, scale = quantize_int8_rows(x)
        return q, scale[..., None]
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = (absmax / 127.0).clamp(min=1e-12)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _pack_pairs(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] -> one byte: ``lo`` in the low nibble."""
    lo = (lo.to(torch.int16) & 0xF)
    hi = (hi.to(torch.int16) & 0xF)
    return (lo | (hi << 4)).to(torch.uint8)


def quantize_int4_blockwise(x: torch.Tensor, block: int = 32
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int4 over the last axis, packed two nibbles per
    uint8 (low nibble = even index): (packed uint8 [..., n/2], scales fp32
    [..., n/block])."""
    n = x.shape[-1]
    if n % block != 0:
        raise ValueError(f"last dim {n} not divisible by block {block}")
    xb = x.float().reshape(*x.shape[:-1], n // block, block)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = (absmax / 7.0).clamp(min=1e-12)
    q = torch.round(xb / scale).clamp(-7, 7).to(torch.int8)
    q = q.reshape(*x.shape[:-1], n)
    return _pack_pairs(q[..., 0::2], q[..., 1::2]), scale[..., 0]


def _unnibble(v: torch.Tensor) -> torch.Tensor:
    """Sign-extend a 4-bit two's-complement nibble (values 0..15) to
    int8."""
    v = v.to(torch.int8)
    return torch.where(v >= 8, v - 16, v)


def dequantize_int4_blockwise(packed: torch.Tensor, scale: torch.Tensor,
                              block: int = 32, dtype=torch.bfloat16
                              ) -> torch.Tensor:
    lo = _unnibble(packed & 0xF)
    hi = _unnibble(packed >> 4)
    n = packed.shape[-1] * 2
    q = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], n)
    qb = q.reshape(*q.shape[:-1], n // block, block).float()
    out = qb * scale[..., None]
    return out.reshape(*q.shape[:-1], n).to(dtype)


# -- int4 KV rows (Int4Pages, ops/paged_attention.py) -------------------------
#
# Per-(token, kv-head) absmax over head_dim, the int8 rows' granularity,
# with nibbles packed pairwise along the PAGE-SLOT axis: two consecutive
# tokens share one byte and head_dim stays the minor axis.

def quantize_int4_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int4 over the LAST axis: (values int8 in [-7, 7]
    [..., D], scale fp32 [...]). Values stay unpacked; ``pack_int4_rows``
    pairs them along a chosen axis."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = (absmax / 7.0).clamp(min=1e-12)
    q = torch.round(xf / scale[..., None]).clamp(-7, 7).to(torch.int8)
    return q, scale


def pack_int4_rows(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int4-valued int8 rows pairwise along ``axis``: element 2i ->
    low nibble, 2i+1 -> high nibble of byte i. An odd count pads one zero
    row."""
    axis = axis % q.dim()
    n = q.shape[axis]
    if n % 2:
        pad = list(q.shape)
        pad[axis] = 1
        q = torch.cat([q, q.new_zeros(pad)], dim=axis)
        n += 1
    idx = torch.arange(0, n, 2, device=q.device)
    return _pack_pairs(q.index_select(axis, idx),
                       q.index_select(axis, idx + 1))


def unpack_int4_rows(packed: torch.Tensor, axis: int = -2,
                     n: Optional[int] = None) -> torch.Tensor:
    """Inverse of pack_int4_rows: uint8 bytes -> sign-extended int8 rows
    interleaved along ``axis`` (the count doubles; ``n`` trims a padded odd
    tail)."""
    axis = axis % packed.dim()
    lo = _unnibble(packed & 0xF)
    hi = _unnibble(packed >> 4)
    q = torch.stack([lo, hi], dim=axis + 1)
    shape = (*packed.shape[:axis], packed.shape[axis] * 2,
             *packed.shape[axis + 1:])
    q = q.reshape(shape)
    if n is not None and n < shape[axis]:
        q = q.narrow(axis, 0, n)
    return q


def dequantize_int4_rows(packed: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_int4_rows + pack_int4_rows for the KV layout:
    packed [..., PS/2, D] uint8 * row scales [..., PS] -> [..., PS, D]."""
    q = unpack_int4_rows(packed, axis=-2, n=scale.shape[-1])
    return (q.float() * scale[..., :, None]).to(dtype)


# -- numpy twins of the nibble helpers and the page-plane delta filters -------
#
# Host-side (a wire codec's) forms of the same byte layout: element 2i =
# low nibble, 2i+1 = high nibble, packed along the page-slot axis. All four
# delta transforms are size-preserving bijections in modular arithmetic.

@np_host_only("token-axis delta filter exists only in the courier wire "
              "codec (host-side); the device never sees delta-coded "
              "planes")
def delta_encode_planes_np(a: np.ndarray, axis: int = -2) -> np.ndarray:
    """Mod-256 first difference along ``axis``: row i becomes row_i -
    row_{i-1}, row 0 is kept."""
    u = np.ascontiguousarray(a).view(np.uint8)
    out = u.copy()
    axis = axis % u.ndim
    hi = [slice(None)] * u.ndim
    lo = [slice(None)] * u.ndim
    hi[axis] = slice(1, None)
    lo[axis] = slice(None, -1)
    out[tuple(hi)] = u[tuple(hi)] - u[tuple(lo)]     # wraps mod 256
    return out.view(a.dtype)


@np_host_only("inverse of the host-side courier delta filter")
def delta_decode_planes_np(a: np.ndarray, axis: int = -2) -> np.ndarray:
    """Inverse of delta_encode_planes_np: mod-256 prefix sum."""
    u = np.ascontiguousarray(a).view(np.uint8)
    out = np.add.accumulate(u, axis=axis % u.ndim, dtype=np.uint8)
    return out.view(a.dtype)


@np_twin_of("unpack_int4_rows")
def unpack_nibbles_np(packed: np.ndarray, axis: int = -2) -> np.ndarray:
    """uint8 bytes -> RAW nibbles (0..15, no sign extension) interleaved
    along ``axis``, in the layout of ``unpack_int4_rows``."""
    axis = axis % packed.ndim
    lo = (packed & 0xF).astype(np.uint8)
    hi = (packed >> 4).astype(np.uint8)
    q = np.stack([lo, hi], axis=axis + 1)
    shape = (*packed.shape[:axis], packed.shape[axis] * 2,
             *packed.shape[axis + 1:])
    return q.reshape(shape)


@np_twin_of("pack_int4_rows")
def pack_nibbles_np(q: np.ndarray, axis: int = -2) -> np.ndarray:
    """Inverse of unpack_nibbles_np (the ``pack_int4_rows`` layout)."""
    axis = axis % q.ndim
    even = [slice(None)] * q.ndim
    odd = [slice(None)] * q.ndim
    even[axis] = slice(0, None, 2)
    odd[axis] = slice(1, None, 2)
    lo = (q[tuple(even)] & 0xF).astype(np.uint8)
    hi = (q[tuple(odd)] & 0xF).astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


@np_host_only("mod-16 nibble delta filter exists only in the courier "
              "wire codec (host-side)")
def nibble_delta_encode_np(packed: np.ndarray, axis: int = -2) -> np.ndarray:
    """Mod-16 first difference over the unpacked nibble stream of a
    packed-int4 plane, repacked."""
    axis = axis % packed.ndim
    q = unpack_nibbles_np(packed, axis)
    out = q.copy()
    hi = [slice(None)] * q.ndim
    lo = [slice(None)] * q.ndim
    hi[axis] = slice(1, None)
    lo[axis] = slice(None, -1)
    out[tuple(hi)] = (q[tuple(hi)] - q[tuple(lo)]) & 0xF
    return pack_nibbles_np(out, axis)


@np_host_only("inverse of the host-side mod-16 nibble delta filter")
def nibble_delta_decode_np(packed: np.ndarray, axis: int = -2) -> np.ndarray:
    """Inverse of nibble_delta_encode_np: mod-16 prefix sum, repacked."""
    axis = axis % packed.ndim
    q = unpack_nibbles_np(packed, axis)
    out = np.add.accumulate(q, axis=axis, dtype=np.uint8) & 0xF
    return pack_nibbles_np(out, axis)


# -- group-wise int4 weights (W4A16) ------------------------------------------

def quantize_int4_groupwise(
    w: torch.Tensor,                          # [..., in, out] kernel(s)
    group: int = 128,
    act_scale: Optional[torch.Tensor] = None,  # [..., in] channel statistic
    alpha: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 along the INPUT axis (the reduction dim):
    each ``group`` of input channels shares one scale per output column.

    Storage is matmul-oriented: packed uint8 [..., in/2, out] (input
    channels 2i and 2i+1 in the low and high nibble of row i), scales fp32
    [..., in/group, out], chan fp32 [..., in]. With ``act_scale`` the
    channel statistic scales salient input channels up before quantization
    (its inverse folds into dequant); without it ``chan`` is all ones.
    W ~= unpack(packed) * scales / chan[:, None]."""
    if act_scale is not None:
        chan = awq_channel_scale(act_scale, alpha)
    else:
        chan = torch.ones(w.shape[:-1], dtype=torch.float32, device=w.device)
    w_scaled = w.float() * chan[..., :, None]
    wt = w_scaled.transpose(-1, -2)                  # [..., out, in]
    packed, scale = quantize_int4_blockwise(wt, block=group)
    return (packed.transpose(-1, -2).contiguous(),   # [..., in/2, out]
            scale.transpose(-1, -2).contiguous(),    # [..., in/group, out]
            chan)


def dequantize_int4_groupwise(packed: torch.Tensor, scale: torch.Tensor,
                              chan: torch.Tensor, group: int = 128,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_int4_groupwise -> [..., in, out]. The unpack *
    scale * (1/chan) chain runs elementwise in ``dtype`` (each product
    rounded to it), as the JAX package's does."""
    lo = _unnibble(packed & 0xF)                   # input channels 2i
    hi = _unnibble(packed >> 4)                    # input channels 2i+1
    n = packed.shape[-2] * 2
    out = packed.shape[-1]
    q = torch.stack([lo, hi], dim=-2).reshape(*packed.shape[:-2], n, out)
    qg = q.reshape(*q.shape[:-2], n // group, group, out).to(dtype)
    w = (qg * scale[..., :, None, :].to(dtype)).reshape(q.shape)
    inv_chan = (1.0 / chan).to(dtype)
    return w * inv_chan[..., :, None]


class Quant4Tensor:
    """Runtime form of a W4A16 weight: packed nibbles [..., in/2, out],
    group scales [..., in/group, out] and channel scales [..., in].
    ``shape`` is the LOGICAL [..., in, out] of the original kernel."""

    def __init__(self, packed, scale, chan, group: int = 128):
        self.packed = packed
        self.scale = scale
        self.chan = chan
        self.group = group

    @property
    def shape(self):
        s = self.packed.shape            # [..., in/2, out]
        return (*s[:-2], s[-2] * 2, s[-1])

    @property
    def ndim(self):
        return self.packed.dim()

    def tensors(self):
        return (self.packed, self.scale, self.chan)

    def dequant(self, dtype=torch.bfloat16):
        return dequantize_int4_groupwise(self.packed, self.scale, self.chan,
                                         self.group, dtype)


class QuantTensor:
    """Runtime form of an int8 weight: values int8 and scale fp32 with the
    quantized axis kept as size 1; W ~= values * scale."""

    def __init__(self, values, scale):
        self.values = values
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def ndim(self):
        return self.values.dim()

    def tensors(self):
        return (self.values, self.scale)

    def dequant(self, dtype=torch.bfloat16):
        return dequantize_int8(self.values, self.scale, dtype)


def _is_quant_marker(x: Any) -> bool:
    return isinstance(x, dict) and "__quant__" in x


def _is_runtime_quant(x: Any) -> bool:
    return isinstance(x, (QuantTensor, Quant4Tensor))


def _tree_map(fn, tree: Any, is_leaf=None) -> Any:
    """``fn`` over the leaves of a nested dict (the parameter-tree layout);
    ``is_leaf`` stops the descent at a node, as in jax.tree_util."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree: Any) -> list:
    if _is_runtime_quant(tree):
        return list(tree.tensors())
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def to_runtime_quant(tree: Any) -> Any:
    """Export-form ``{"__quant__": kind, ...}`` dicts -> QuantTensor /
    Quant4Tensor leaves. ``int8-awq`` markers are refused: dropping the
    channel scaling the exporter divided out would serve wrong weights
    without an error."""
    def conv(x):
        if not _is_quant_marker(x):
            return x
        kind = x["__quant__"]
        if kind == "int4":
            return Quant4Tensor(x["values"], x["scale"], x["chan"],
                                group=int(x.get("group", 128)))
        if kind == "int8":
            return QuantTensor(x["values"], x["scale"])
        raise ValueError(
            f"quant marker {kind!r} has no runtime form (int8-awq "
            "artifacts are interchange-only; re-export as int8 or int4)")
    return _tree_map(conv, tree, is_leaf=_is_quant_marker)


def cast_params(tree: Any, dtype, keep_w4: bool = False,
                keep_w8: bool = False) -> Any:
    """Cast a (possibly mixed plain/quantized) tree for compute: plain
    leaves are cast, quantized leaves DEQUANTIZED. Called per layer, so
    only one layer's full-precision weights exist at a time. ``keep_w4`` /
    ``keep_w8`` pass the quantized leaves through for the consumers that
    route them into the in-kernel-dequant matmuls."""
    def one(x):
        if isinstance(x, Quant4Tensor) and keep_w4:
            return x
        if isinstance(x, QuantTensor) and keep_w8:
            return x
        if _is_runtime_quant(x):
            return x.dequant(dtype)
        return x if x.dtype == dtype else x.to(dtype)
    return _tree_map(one, tree, is_leaf=_is_runtime_quant)


def precast_params(tree: Any, dtype) -> Any:
    """Cast PLAIN leaves to the compute dtype once, outside the layer
    loop, leaving quantized leaves quantized."""
    def one(x):
        if _is_runtime_quant(x):
            return x
        return x if x.dtype == dtype else x.to(dtype)
    return _tree_map(one, tree, is_leaf=_is_runtime_quant)


def tree_weight_bytes(tree: Any) -> int:
    """Device bytes of a param tree (a quantized leaf counts its stored
    values and scales)."""
    return int(sum(t.numel() * t.element_size() for t in _tree_leaves(tree)))


def _is_float(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def quantize_tree_int8(params: Any, min_size: int = 4096,
                       min_ndim: int = 2) -> Any:
    """Quantize every large float leaf of a param tree to an export-form
    ``{"__quant__": "int8", values, scale}`` dict. Small leaves (norm
    scales, biases) stay as they are; for STACKED-layer trees (kernels
    [L, in, out]) pass ``min_ndim=3`` so the [L, H] norm scales and biases
    stay in full precision."""
    def q(x):
        if _is_float(x) and x.numel() >= min_size and x.dim() >= min_ndim:
            values, scale = quantize_int8(x)
            return {"__quant__": "int8", "values": values, "scale": scale}
        return x
    return _tree_map(q, params)


def int4_group_for(n_in: int, group: int = 128) -> int:
    """The group size ``quantize_tree_int4`` uses for an input dim: the
    largest halving of ``group`` that divides it, or 0 where none of at
    least 2 does (that kernel falls back to int8)."""
    g = group
    while n_in % g and g > 2:
        g //= 2
    return 0 if (n_in % g or g < 2) else g


def _tree_map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(dotted path, leaf)`` over a nested dict's leaves."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(".".join(path), tree)


def quantize_tree_int4(params: Any, act: Optional[dict] = None,
                       group: int = 128, alpha: float = 0.5,
                       min_size: int = 4096) -> Any:
    """Group-wise int4 (W4A16) over a full param tree: only the stacked
    [L, in, out] block kernels quantize (embedding, LM head and norms keep
    full precision). The group is clamped to the input dim; an input dim
    no group divides falls back to int8. ``act`` ({stacked path: [L, in]},
    the AWQ statistic of ``models.gpt.activation_channel_scales``) scales
    the kernels it covers; the JAX function takes the model config and
    calibration tokens and runs that forward itself (this module imports
    nothing of the package, so ``weights.calibration_scales`` runs it)."""
    act = act or {}

    def q(path, x):
        if not (_is_float(x) and x.numel() >= min_size and x.dim() == 3):
            return (quantize_tree_int8(x, min_size=min_size, min_ndim=3)
                    if isinstance(x, torch.Tensor) else x)
        g = int4_group_for(x.shape[-2], group)
        if g == 0:
            return quantize_tree_int8(x, min_size=min_size, min_ndim=3)
        packed, scale, chan = quantize_int4_groupwise(
            x, group=g, act_scale=act.get(path), alpha=alpha)
        return {"__quant__": "int4", "values": packed, "scale": scale,
                "chan": chan, "group": g}
    return _tree_map_with_path(q, params)


def awq_channel_scale(act_scale: torch.Tensor, alpha: float = 0.5
                      ) -> torch.Tensor:
    """AWQ's channel scale ``s = act^alpha`` normalised to a geometric
    mean of 1 over the input channels (the last axis)."""
    chan = act_scale.float() ** alpha
    return chan / torch.exp(torch.log(chan).mean(dim=-1, keepdim=True))


def quantize_int8_awq(w: torch.Tensor, act_scale: torch.Tensor,
                      alpha: float = 0.5
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Activation-aware int8: salient input channels scaled up before
    per-output-channel absmax quantization. Returns (q int8, scales fp32
    [..., 1, out], chan fp32 [..., in]); W ~= (q * scales) / chan[:, None]."""
    s = awq_channel_scale(act_scale, alpha)
    q, scales = quantize_int8(w.float() * s[..., :, None], axis=-2)
    return q, scales, s


def dequantize_int8_awq(q: torch.Tensor, scales: torch.Tensor,
                        chan: torch.Tensor, dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """Inverse of quantize_int8_awq."""
    return ((q.float() * scales) / chan[..., :, None]).to(dtype)


def quantize_tree_int8_awq(params: Any, act: dict, alpha: float = 0.5,
                           min_size: int = 4096) -> Any:
    """AWQ-style int8 over a param tree: kernels with a calibrated
    statistic in ``act`` get channel-scaled ``{"__quant__": "int8-awq",
    values, scale, chan}``; every other large float leaf plain absmax int8
    (an interchange format: the serving engine refuses it)."""

    def q(path, x):
        if (path in act and _is_float(x) and x.numel() >= min_size
                and x.dim() == 3):
            qv, scales, chan = quantize_int8_awq(x, act[path], alpha=alpha)
            return {"__quant__": "int8-awq", "values": qv, "scale": scales,
                    "chan": chan}
        return (quantize_tree_int8(x, min_size=min_size)
                if isinstance(x, torch.Tensor) else x)
    return _tree_map_with_path(q, params)


def dequantize_tree(params: Any, dtype=torch.bfloat16) -> Any:
    """Export-form marker dicts back to full-precision tensors."""
    def dq(x):
        if not _is_quant_marker(x):
            return x
        if x["__quant__"] == "int4":
            return dequantize_int4_groupwise(
                x["values"], x["scale"], x["chan"],
                group=int(x.get("group", 128)), dtype=dtype)
        if x["__quant__"] == "int8-awq":
            return dequantize_int8_awq(x["values"], x["scale"], x["chan"],
                                       dtype)
        if x["__quant__"] == "int8":
            return dequantize_int8(x["values"], x["scale"], dtype)
        raise ValueError(f"unknown quant marker {x['__quant__']!r}")
    return _tree_map(dq, params, is_leaf=_is_quant_marker)
