"""Bridge from the JAX package's parameter pytree to the port's modules.

The JAX ``models.gpt.init`` tree (any array type that ``numpy.asarray``
accepts — numpy arrays, or JAX arrays handed over by a caller) is
``{"embed": {"embedding"}, "blocks": {...}, "final_norm": {"scale"},
["lm_head": {"kernel"}]}`` with every block leaf stacked on a leading
``[L, ...]`` axis. ``params_from_jax`` unstacks that axis into the
per-layer ``Block`` modules, so both packages compute on the same weights.
A block kernel may be quantized in the JAX tree, as a runtime leaf (an
object with ``values``/``scale``, or ``packed``/``scale``/``chan``/
``group``) or as an export-form ``{"__quant__": kind, ...}`` dict; its
bytes and scales are carried over as they are, read as numpy.
``train_state_from_jax`` carries a whole JAX ``TrainState`` across (params,
AdamW moments and count, step), so both trainers start from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.gpt import GPT
from .ops.quantization import QuantTensor, Quant4Tensor

# JAX block path -> Block attribute
_BLOCK_LEAVES = {
    ("attn_norm", "scale"): "attn_norm",
    ("q", "kernel"): "q",
    ("k", "kernel"): "k",
    ("v", "kernel"): "v",
    ("o", "kernel"): "o",
    ("mlp_norm", "scale"): "mlp_norm",
}
_MLP_LEAVES = {
    ("mlp", "gate", "kernel"): "gate",
    ("mlp", "up", "kernel"): "up",
    ("mlp", "down", "kernel"): "down",
}
# an MoE block's FFN: router [L, H, E], experts [L, E, H, F] / [L, E, F, H]
_MOE_LEAVES = {
    ("moe", "router", "kernel"): "moe_router",
    ("moe", "gate", "kernel"): "moe_gate",
    ("moe", "up", "kernel"): "moe_up",
    ("moe", "down", "kernel"): "moe_down",
}
_BIAS_LEAVES = {
    ("q", "bias"): "q_bias",
    ("k", "bias"): "k_bias",
    ("v", "bias"): "v_bias",
}


def _block_leaves(cfg, bias: bool = False) -> dict:
    """JAX block path -> Block attribute for ``cfg``'s blocks: the shared
    leaves, then the dense FFN's or the MoE's (and q/k/v biases with
    ``bias`` where the config has them)."""
    leaves = dict(_BLOCK_LEAVES)
    leaves.update(_MOE_LEAVES if cfg.is_moe else _MLP_LEAVES)
    if bias and cfg.attention_bias:
        leaves.update(_BIAS_LEAVES)
    return leaves


def _leaf(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return np.array(node, dtype=np.float32)     # a writable host copy


def _quant_parts(node):
    """None for a plain leaf; for a quantized one (kind, stacked numpy
    parts in the port's constructor order, group)."""
    if isinstance(node, dict) and "__quant__" in node:
        kind = node["__quant__"]
        if kind == "int4":
            return ("int4", [node["values"], node["scale"], node["chan"]],
                    int(node.get("group", 128)))
        if kind == "int8":
            return "int8", [node["values"], node["scale"]], 0
        raise ValueError(f"quant marker {kind!r} has no runtime form")
    if hasattr(node, "packed"):
        return ("int4", [node.packed, node.scale, node.chan],
                int(node.group))
    if hasattr(node, "values") and hasattr(node, "scale"):
        return "int8", [node.values, node.scale], 0
    return None


def _quant_leaves(tree, cfg, device) -> dict[str, object]:
    """``blocks.<i>.<leaf>`` -> QuantTensor | Quant4Tensor for every
    quantized block kernel of the JAX tree, split per layer."""
    out = {}
    for path, name in _block_leaves(cfg).items():
        node = tree["blocks"]
        for p in path:
            node = node[p]
        found = _quant_parts(node)
        if found is None:
            continue
        kind, parts, group = found
        parts = [np.array(a) for a in parts]        # writable host copies
        for i in range(cfg.num_layers):
            per = [torch.from_numpy(a[i]).to(device) for a in parts]
            out[f"blocks.{i}.{name}"] = (
                Quant4Tensor(*per, group=group) if kind == "int4"
                else QuantTensor(*per))
    return out


def _named_arrays(tree, cfg, skip=()) -> dict[str, np.ndarray]:
    """The JAX tree's plain leaves keyed by the port's parameter names
    (``blocks.<i>.<leaf>``, ``embed``, ``final_norm``, ``lm_head``), the
    stacked block leaves split per layer; names in ``skip`` (quantized
    kernels) are left out."""
    leaves = _block_leaves(cfg, bias=True)
    out = {"embed": _leaf(tree, ("embed", "embedding")),
           "final_norm": _leaf(tree, ("final_norm", "scale"))}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = _leaf(tree, ("lm_head", "kernel"))
    for path, name in leaves.items():
        if f"blocks.0.{name}" in skip:
            continue
        stacked = _leaf(tree["blocks"], path)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(
                f"blocks/{'/'.join(path)} has {stacked.shape[0]} layers, "
                f"config says {cfg.num_layers}")
        for i in range(cfg.num_layers):
            out[f"blocks.{i}.{name}"] = stacked[i]
    return out


def _load_named(model: GPT, arrays: dict[str, np.ndarray],
                skip=()) -> None:
    for name, p in model.named_parameters():
        if name in skip:
            continue                # replaced by a quantized leaf
        a = arrays[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(a))


@torch.no_grad()
def params_from_jax(tree, cfg, device=None, dtype=torch.float32) -> GPT:
    """Build a ``GPT`` holding the JAX tree's weights (plain leaves cast
    to ``dtype``, quantized kernels as they are)."""
    dev = resolve_device(device)
    model = GPT(cfg, device=dev, dtype=dtype)
    quant = _quant_leaves(tree, cfg, dev)
    _load_named(model, _named_arrays(tree, cfg, skip=quant), skip=quant)
    if not quant:
        return model
    return model.with_block_leaves(
        [{n: quant.get(f"blocks.{i}.{n}", leaf)
          for n, leaf in blk.leaves().items()}
         for i, blk in enumerate(model.blocks)])


@torch.no_grad()
def train_state_from_jax(state, cfg, device=None):
    """A port ``exec.train_step.TrainState`` equal to the JAX
    ``TrainState`` ``state``: fp32 master params, the AdamW mu/nu (optax
    ``ScaleByAdamState``, the head of the optimizer chain; their dtypes
    kept) and count, and the step."""
    from .exec.optimizer import AdamState
    from .exec.train_step import TrainState
    dev = resolve_device(device)
    model = params_from_jax(state.params, cfg, device=dev)
    adam = state.opt_state[0]
    moments = []
    for tree in (adam.mu, adam.nu):
        dtype = getattr(torch, str(np.asarray(
            tree["embed"]["embedding"]).dtype))
        named = _named_arrays(tree, cfg)
        moments.append([torch.from_numpy(named[n]).to(dev, dtype)
                        for n, _ in model.named_parameters()])
    count = torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                         device=dev)
    return TrainState(step=int(np.asarray(state.step)), model=model,
                      opt_state=AdamState(mu=moments[0], nu=moments[1],
                                          count=count))
