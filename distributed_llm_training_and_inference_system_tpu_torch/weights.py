"""Bridge from the JAX package's parameter pytree to the port's modules.

The JAX ``models.gpt.init`` tree (any array type that ``numpy.asarray``
accepts — numpy arrays, or JAX arrays handed over by a caller) is
``{"embed": {"embedding"}, "blocks": {...}, "final_norm": {"scale"},
["lm_head": {"kernel"}]}`` with every block leaf stacked on a leading
``[L, ...]`` axis. ``params_from_jax`` unstacks that axis into the
per-layer ``Block`` modules, so both packages compute on the same weights.
``train_state_from_jax`` carries a whole JAX ``TrainState`` across (params,
AdamW moments and count, step), so both trainers start from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.gpt import GPT

# JAX block path -> Block attribute
_BLOCK_LEAVES = {
    ("attn_norm", "scale"): "attn_norm",
    ("q", "kernel"): "q",
    ("k", "kernel"): "k",
    ("v", "kernel"): "v",
    ("o", "kernel"): "o",
    ("mlp_norm", "scale"): "mlp_norm",
    ("mlp", "gate", "kernel"): "gate",
    ("mlp", "up", "kernel"): "up",
    ("mlp", "down", "kernel"): "down",
}
_BIAS_LEAVES = {
    ("q", "bias"): "q_bias",
    ("k", "bias"): "k_bias",
    ("v", "bias"): "v_bias",
}


def _leaf(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return np.array(node, dtype=np.float32)     # a writable host copy


def _named_arrays(tree, cfg) -> dict[str, np.ndarray]:
    """The JAX tree's leaves keyed by the port's parameter names
    (``blocks.<i>.<leaf>``, ``embed``, ``final_norm``, ``lm_head``), the
    stacked block leaves split per layer."""
    leaves = dict(_BLOCK_LEAVES)
    if cfg.attention_bias:
        leaves.update(_BIAS_LEAVES)
    out = {"embed": _leaf(tree, ("embed", "embedding")),
           "final_norm": _leaf(tree, ("final_norm", "scale"))}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = _leaf(tree, ("lm_head", "kernel"))
    for path, name in leaves.items():
        stacked = _leaf(tree["blocks"], path)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(
                f"blocks/{'/'.join(path)} has {stacked.shape[0]} layers, "
                f"config says {cfg.num_layers}")
        for i in range(cfg.num_layers):
            out[f"blocks.{i}.{name}"] = stacked[i]
    return out


def _load_named(model: GPT, arrays: dict[str, np.ndarray]) -> None:
    for name, p in model.named_parameters():
        a = arrays[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(a))


@torch.no_grad()
def params_from_jax(tree, cfg, device=None, dtype=torch.float32) -> GPT:
    """Build a ``GPT`` holding the JAX tree's weights (cast to ``dtype``)."""
    model = GPT(cfg, device=resolve_device(device), dtype=dtype)
    _load_named(model, _named_arrays(tree, cfg))
    return model


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
