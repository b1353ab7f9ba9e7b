"""Bridge between the JAX package's parameter pytree and the port's modules.

The JAX ``models.gpt.init`` tree (any array type that ``numpy.asarray``
accepts — numpy arrays, or JAX arrays handed over by a caller — or host
torch tensors, as ``io.export`` and ``io.checkpoint`` read them) is
``{"embed": {"embedding"}, "blocks": {...}, "final_norm": {"scale"},
["lm_head": {"kernel"}]}`` with every block leaf stacked on a leading
``[L, ...]`` axis. ``params_from_jax`` unstacks that axis into the
per-layer ``Block`` modules, so both packages compute on the same weights;
``params_to_tree`` is its inverse. A block kernel may be quantized in the
JAX tree, as a runtime leaf (an object with ``values``/``scale``, or
``packed``/``scale``/``chan``/``group``) or as an export-form
``{"__quant__": kind, ...}`` dict; its bytes and scales are carried over as
they are and moved to the device quantized, so no full-precision copy of a
quantized kernel is ever made.

``train_state_from_jax`` carries a whole JAX ``TrainState`` across (params,
the optimizer state of any of the four optimizers, step), and
``state_dict_from_flat`` turns the flat, dotted-path form a JAX checkpoint
is saved in into the port's checkpoint state dict.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .device import resolve_device
from .io.checkpoint import CheckpointManager, params_from_flat, subtree
from .models.gpt import GPT, Block, activation_channel_scales
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
# the top-level leaves: port parameter name -> JAX path
_TOP_LEAVES = {"embed": ("embed", "embedding"),
               "final_norm": ("final_norm", "scale"),
               "lm_head": ("lm_head", "kernel")}
_ALL_BLOCK_LEAVES = {**_BLOCK_LEAVES, **_MLP_LEAVES, **_MOE_LEAVES,
                     **_BIAS_LEAVES}
_ATTR_PATH = {name: path for path, name in _ALL_BLOCK_LEAVES.items()}


def jax_path(name: str) -> str:
    """The dotted JAX tree path of a port parameter name, with the layer
    index dropped (``blocks.3.gate`` -> ``blocks.mlp.gate.kernel``)."""
    if name in _TOP_LEAVES:
        return ".".join(_TOP_LEAVES[name])
    attr = name.rsplit(".", 1)[-1]
    return ".".join(("blocks",) + _ATTR_PATH[attr])


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _has(tree, path) -> bool:
    try:
        _get(tree, path)
    except (KeyError, TypeError):
        return False
    return True


def _host(a) -> torch.Tensor:
    """A host tensor of a leaf: a torch tensor as it is, any other array
    through numpy (JAX's bfloat16, a numpy type torch cannot read, through
    fp32, exactly; a ``BF16_HOST`` uint16 array as the bf16 it holds)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if (a.dtype.metadata or {}).get("dtype") == "bfloat16":
        # kv_cache.BF16_HOST: bf16 bits held as uint16 (no ml_dtypes)
        return torch.from_numpy(np.array(a, np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _quant_parts(node):
    """None for a plain leaf; for a quantized one (kind, stacked parts in
    the port's constructor order, group)."""
    if isinstance(node, dict) and "__quant__" in node:
        kind = node["__quant__"]
        if kind == "int4":
            return ("int4", [node["values"], node["scale"], node["chan"]],
                    int(np.asarray(node.get("group", 128))))
        if kind == "int8":
            return "int8", [node["values"], node["scale"]], 0
        raise ValueError(f"quant marker {kind!r} has no runtime form")
    if hasattr(node, "packed"):
        return ("int4", [node.packed, node.scale, node.chan],
                int(node.group))
    if hasattr(node, "values") and hasattr(node, "scale"):
        return "int8", [node.values, node.scale], 0
    return None


def named_from_tree(tree) -> dict:
    """The JAX tree's leaves keyed by the port's parameter names
    (``blocks.<i>.<leaf>``, ``embed``, ``final_norm``, ``lm_head``): host
    tensors, the stacked block leaves split per layer, quantized kernels
    as ``QuantTensor`` / ``Quant4Tensor`` of host tensors."""
    out = {}
    for name, path in _TOP_LEAVES.items():
        if _has(tree, path):
            out[name] = _host(_get(tree, path))
    for path, attr in _ALL_BLOCK_LEAVES.items():
        if not _has(tree["blocks"], path):
            continue
        node = _get(tree["blocks"], path)
        found = _quant_parts(node)
        if found is None:
            stacked = _host(node)
            for i in range(stacked.shape[0]):
                out[f"blocks.{i}.{attr}"] = stacked[i]
            continue
        kind, parts, group = found
        parts = [_host(a) for a in parts]
        for i in range(parts[0].shape[0]):
            per = [a[i] for a in parts]
            out[f"blocks.{i}.{attr}"] = (
                Quant4Tensor(*per, group=group) if kind == "int4"
                else QuantTensor(*per))
    return out


def _to_device(leaf, device, dtype):
    """A parameter in ``dtype`` on ``device``, or a quantized leaf with its
    parts moved there as they are."""
    if isinstance(leaf, Quant4Tensor):
        return Quant4Tensor(*(t.to(device).contiguous()
                              for t in leaf.tensors()), group=leaf.group)
    if isinstance(leaf, QuantTensor):
        return QuantTensor(*(t.to(device).contiguous()
                             for t in leaf.tensors()))
    return nn.Parameter(leaf.to(device, dtype).contiguous(),
                        requires_grad=dtype.is_floating_point)


@torch.no_grad()
def model_from_named(named: dict, cfg, device=None,
                     dtype=torch.float32) -> GPT:
    """A ``GPT`` over ``named`` (port parameter name -> host tensor or
    quantized leaf), each leaf moved to ``device`` once (plain leaves cast
    to ``dtype``); nothing else is allocated. Shapes are checked against
    the config's."""
    dev = resolve_device(device)
    ref = GPT.__new__(GPT)
    want = {"embed": (cfg.vocab_size, cfg.hidden_size),
            "final_norm": (cfg.hidden_size,),
            "lm_head": (cfg.hidden_size, cfg.vocab_size)}
    meta_block = Block(cfg, device="meta")
    for n, p in meta_block.leaves().items():
        want[n] = tuple(p.shape)
    expected = ["embed", "final_norm"] + (
        [] if cfg.tie_word_embeddings else ["lm_head"])
    expected += [f"blocks.{i}.{n}" for i in range(cfg.num_layers)
                 for n in meta_block.leaves()]
    missing = [n for n in expected if n not in named]
    if missing:
        raise ValueError(f"parameters missing for {cfg.name}: "
                         f"{missing[:4]}{'...' if len(missing) > 4 else ''}")
    extra = sorted(set(named) - set(expected))
    if extra:
        raise ValueError(f"parameters {extra[:4]} do not belong to "
                         f"{cfg.name}")
    for n in expected:
        shape = tuple(named[n].shape)
        if shape != want[n.rsplit(".", 1)[-1]]:
            raise ValueError(f"{n}: shape {shape} != "
                             f"{want[n.rsplit('.', 1)[-1]]}")
    nn.Module.__init__(ref)
    ref.cfg = cfg
    ref.embed = _to_device(named["embed"], dev, dtype)
    ref.blocks = nn.ModuleList(
        Block.from_leaves({n: _to_device(named[f"blocks.{i}.{n}"], dev,
                                         dtype)
                           for n in meta_block.leaves()})
        for i in range(cfg.num_layers))
    ref.final_norm = _to_device(named["final_norm"], dev, dtype)
    ref.lm_head = (None if cfg.tie_word_embeddings
                   else _to_device(named["lm_head"], dev, dtype))
    return ref


def params_from_jax(tree, cfg, device=None, dtype=torch.float32) -> GPT:
    """A ``GPT`` holding the JAX tree's weights (plain leaves cast to
    ``dtype``, quantized kernels as they are)."""
    return model_from_named(named_from_tree(tree), cfg, device, dtype)


@torch.no_grad()
def rank_model(model: GPT, mesh, free_source: bool = False) -> GPT:
    """This rank's serving model of a whole ``model`` (plain or quantized
    block kernels) on a tp ``mesh``: every leaf cut to its shard of JAX's
    spec (``parallel.sharding.shard_leaf``), on the model's device. The
    forwards read its ``tp_mesh``; ``weight_bytes`` reports the whole
    model's, as the JAX engine's global arrays do. With ``free_source``
    each whole block leaf is dropped from ``model`` once it is cut."""
    from .parallel.sharding import shard_leaf
    whole_bytes = 0

    def cut(name: str, leaf):
        nonlocal whole_bytes
        quant = isinstance(leaf, (QuantTensor, Quant4Tensor))
        whole_bytes += sum(t.numel() * t.element_size()
                           for t in (leaf.tensors() if quant else (leaf,)))
        part = shard_leaf(leaf if quant else leaf.detach(), jax_path(name),
                          model.cfg.num_layers, mesh)
        return part if quant else nn.Parameter(part, requires_grad=False)
    blocks = []
    for i, blk in enumerate(model.blocks):
        leaves = {}
        for name, leaf in blk.leaves().items():
            leaves[name] = cut(f"blocks.{i}.{name}", leaf)
            if free_source:
                delattr(blk, name)
        blocks.append(leaves)
    out = GPT.__new__(GPT)
    nn.Module.__init__(out)
    out.cfg = model.cfg
    out.embed = cut("embed", model.embed)
    out.blocks = nn.ModuleList(Block.from_leaves(b) for b in blocks)
    out.final_norm = cut("final_norm", model.final_norm)
    out.lm_head = (None if model.lm_head is None
                   else cut("lm_head", model.lm_head))
    out.tp_mesh = mesh
    out.whole_weight_bytes = whole_bytes
    return out


def rank_params_from_jax(tree, cfg, mesh, quantization: str = "none",
                         device=None, dtype=torch.float32) -> GPT:
    """One tensor-parallel rank's serving model from a JAX params tree:
    the whole model bridged (``params_from_jax``), its block kernels
    quantized whole as the JAX engine quantizes them (``quantization``
    none | int8 | int4), then cut to this rank's shard (``rank_model``)."""
    model = params_from_jax(tree, cfg, device=device, dtype=dtype)
    if quantization not in ("", "none"):
        from .serve.engine import quantize_blocks
        model = quantize_blocks(model, quantization, free_source=True)
    return rank_model(model, mesh, free_source=True)


def calibration_scales(tree, cfg, calib_tokens) -> dict:
    """``models.gpt.activation_channel_scales`` over a JAX-layout tree (a
    model built on the tree's device, in its embedding's dtype):
    {stacked path: [L, in] fp32}, the ``act`` of
    ``ops.quantization.quantize_tree_int4``."""
    emb = tree["embed"]["embedding"]
    model = params_from_jax(tree, cfg, device=emb.device, dtype=emb.dtype)
    return activation_channel_scales(model, cfg, calib_tokens)


def params_to_tree(model: GPT) -> dict:
    """The JAX-layout tree of ``model`` (block leaves stacked on [L, ...],
    quantized kernels as export-form ``{"__quant__": ...}`` dicts), on the
    model's device; the inverse of ``params_from_jax``."""
    tree = {"embed": {"embedding": model.embed.detach()},
            "final_norm": {"scale": model.final_norm.detach()},
            "blocks": {}}
    if model.lm_head is not None:
        tree["lm_head"] = {"kernel": model.lm_head.detach()}
    for attr in model.blocks[0].leaves():
        leaves = [blk.leaves()[attr] for blk in model.blocks]
        if isinstance(leaves[0], Quant4Tensor):
            packed, scale, chan = (torch.stack(t) for t in zip(
                *(q.tensors() for q in leaves)))
            value = {"__quant__": "int4", "values": packed, "scale": scale,
                     "chan": chan, "group": leaves[0].group}
        elif isinstance(leaves[0], QuantTensor):
            values, scale = (torch.stack(t) for t in zip(
                *(q.tensors() for q in leaves)))
            value = {"__quant__": "int8", "values": values, "scale": scale}
        else:
            value = torch.stack([p.detach() for p in leaves])
        node = tree["blocks"]
        path = _ATTR_PATH[attr]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def tree_from_named(named: dict) -> dict:
    """The JAX-layout tree of a full-precision {port name: tensor} dict
    (block leaves stacked on [L, ...]); the inverse of
    ``named_from_tree``."""
    tree: dict = {"blocks": {}}
    for name, path in _TOP_LEAVES.items():
        if name in named:
            tree.setdefault(path[0], {})[path[1]] = named[name]
    layers = sorted({int(m.group(1)) for n in named
                     if (m := _LAYER.match(n))})
    attrs = {n.split(".", 2)[2] for n in named if _LAYER.match(n)}
    for attr in sorted(attrs):
        node = tree["blocks"]
        path = _ATTR_PATH[attr]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.stack(
            [named[f"blocks.{i}.{attr}"] for i in layers])
    return tree


def checkpoint_tree(directory, step=None) -> tuple[dict, dict]:
    """(JAX-layout param tree of host tensors, extra metadata) of a
    committed checkpoint, the port's or the JAX package's."""
    ckpt = CheckpointManager(directory)
    jax_written = ckpt.is_jax(step)
    state, extra = ckpt.restore(step=step)
    if jax_written:
        return params_from_flat(state), extra
    return tree_from_named(state["params"]), extra


# -- optimizer state ---------------------------------------------------------

_LAYER = re.compile(r"^blocks\.(\d+)\.")


def _opt_leaves(tree, names: list[str]) -> dict:
    """{port name: host tensor} of an optimizer moment tree laid out like
    the params (stacked block leaves split per layer; a (1,)-shaped
    placeholder leaf, as optax's adafactor keeps for unused statistics,
    goes to every layer as it is)."""
    out = {}
    for name in names:
        m = _LAYER.match(name)
        a = _host(_get(tree, jax_path(name).split(".")))
        if m and a.dim() > 0 and a.shape != (1,):
            a = a[int(m.group(1))]
        out[name] = a
    return out


# the optax state's fields, by the chain position of the transformation
# that holds them, per optimizer
_OPT_FIELDS = {
    "adamw": {"mu": "0.mu", "nu": "0.nu", "count": "0.count"},
    "lion": {"mu": "0.mu", "count": "0.count"},
    "adafactor": {"v_row": "0.v_row", "v_col": "0.v_col", "v": "0.v",
                  "count": "0.count"},
    "sgd": {"trace": "0.trace", "count": "1.count"},
}
_OPT_FIELDS["adam"] = _OPT_FIELDS["adamw"]


def opt_state_from_jax(opt_state, names: list[str], kind: str) -> dict:
    """{field: {port name: host tensor} or a count} of an optax state
    (the tuple of the chain's states) of the port optimizer ``kind``."""
    out = {}
    for field, where in _OPT_FIELDS[kind].items():
        pos, attr = where.split(".")
        node = getattr(opt_state[int(pos)], attr)
        out[field] = (_host(node).to(torch.int32) if field == "count"
                      else _opt_leaves(node, names))
    return out


def state_dict_from_flat(flat: dict, names: list[str], kind: str) -> dict:
    """The port's checkpoint state dict (``io.checkpoint.state_to_dict``)
    of a JAX checkpoint restored without a target: ``flat`` maps dotted
    paths (``params.blocks.q.kernel``, ``opt_state.0.mu.embed.embedding``,
    ``step``) to host tensors; ``names`` are the model's parameter names
    in order, ``kind`` the optimizer."""
    params = named_from_tree(subtree(flat, "params"))
    opt = {}
    for field, where in _OPT_FIELDS[kind].items():
        key = f"opt_state.{where}"
        if field == "count":
            if key not in flat:
                raise ValueError(f"checkpoint has no {key}: not a {kind} "
                                 "optimizer state")
            opt[field] = _host(flat[key]).to(torch.int32)
        else:
            opt[field] = _opt_leaves(subtree(flat, key), names)
    return {"step": int(_host(flat["step"])), "params": params,
            "opt_state": opt}


@torch.no_grad()
def train_state_from_jax(state, cfg, device=None, optimizer: str = "adamw"):
    """A port ``exec.train_step.TrainState`` equal to the JAX
    ``TrainState`` ``state``: fp32 master params, the optimizer state of
    ``optimizer`` (its moments' dtypes kept) and the step."""
    from .exec.optimizer import state_from_fields
    from .exec.train_step import TrainState
    dev = resolve_device(device)
    model = params_from_jax(state.params, cfg, device=dev)
    names = [n for n, _ in model.named_parameters()]
    fields = opt_state_from_jax(state.opt_state, names, optimizer)
    return TrainState(step=int(np.asarray(state.step)), model=model,
                      opt_state=state_from_fields(optimizer, fields, names,
                                                  dev))
