"""Sharding rules: parameter path -> partition spec, and the per-rank shard.

The port's counterpart of the JAX package's ``parallel/sharding.py``, with
its rules, entry for entry. A spec is a tuple with one entry per leading
dim of a leaf: ``None`` (replicated), an axis name, or a tuple of axis
names (the dim cut over their row-major product, the first axis major),
as a JAX ``PartitionSpec``. Paths are JAX's dotted tree paths
(``blocks.q.kernel``, ``embed.embedding``), and block leaves are stacked
on a leading ``[L, ...]`` axis that the specs put on ``pp``.

Megatron tensor parallelism as data layout:

- column-parallel kernels (q/k/v, mlp gate/up, lm_head): output dim on tp
- row-parallel kernels (o, mlp down): input dim on tp
- embedding: vocab on fsdp, hidden on tp
- every 2D kernel additionally shards its other dim on fsdp (ZeRO-3)

Where XLA derives the collectives from these specs, the port places them
by hand (``models/gpt.py`` ``forward_sharded``). ``shard_of`` cuts a full
leaf into this rank's shard and ``unshard`` gathers it back (a collective:
every rank calls it).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

Spec = tuple

# (path regex, spec WITHOUT the stacked-layer axis). First match wins.
PARAM_RULES: list[tuple[str, Spec]] = [
    (r"embed\.embedding$",        ("fsdp", "tp")),
    (r"lm_head\.kernel$",         ("fsdp", "tp")),
    (r"final_norm\.scale$",       (None,)),
    (r"blocks\.(q|k|v)\.kernel$", ("fsdp", "tp")),
    (r"blocks\.(q|k|v)\.bias$",   ("tp",)),
    (r"blocks\.o\.kernel$",       ("tp", "fsdp")),
    (r"blocks\.mlp\.(gate|up)\.kernel$", ("fsdp", "tp")),
    (r"blocks\.mlp\.down\.kernel$",      ("tp", "fsdp")),
    (r"blocks\.moe\.router\.kernel$",    ("fsdp", None)),
    (r"blocks\.moe\.(gate|up)\.kernel$", ("ep", "fsdp", "tp")),
    (r"blocks\.moe\.down\.kernel$",      ("ep", "tp", "fsdp")),
    (r"blocks\..*norm\.scale$",   (None,)),
    (r".*", (None,)),  # fallback: replicate
]

# activation specs (JAX's logical names): the batch over dp+fsdp, the
# sequence over sp, the logits' vocab over tp
ACTIVATION_RULES: dict[str, Spec] = {
    "activations": (("dp", "fsdp"), "sp", None),
    "logits": (("dp", "fsdp"), "sp", "tp"),
    "tokens": (("dp", "fsdp"), "sp"),
}


def spec_for_path(path: str, stacked: bool = False) -> Spec:
    """The spec of a dotted param path; ``stacked`` prepends the layer axis
    (on pp) to a block leaf's."""
    for pattern, spec in PARAM_RULES:
        if re.search(pattern, path):
            if stacked and path.startswith("blocks."):
                return ("pp", *spec)
            return spec
    raise AssertionError("unreachable: catch-all rule")


def entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _shrink_to_fit(spec: Spec, shape: tuple, mesh_shape: dict) -> Spec:
    """Drop axis assignments that don't divide the dim (e.g. tp=4 on a
    3-dim) so tiny test models still shard cleanly."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        size = 1
        keep = []
        for a in entry_axes(entry):
            asize = mesh_shape[a]
            if shape[i] % (size * asize) == 0:
                keep.append(a)
                size *= asize
        out.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return tuple(out)


def param_specs(shapes: dict[str, tuple], mesh_shape: dict) -> dict:
    """{path: spec} for {path: shape} of the stacked-layer layout."""
    return {path: _shrink_to_fit(spec_for_path(path, stacked=True),
                                 tuple(shape), mesh_shape)
            for path, shape in shapes.items()}


def batch_specs(batch: dict, mesh_shape: dict) -> dict:
    """Batch arrays: [B, S, ...] over (dp,fsdp) x sp; rank-1 [B] arrays
    over (dp,fsdp) only; scalars replicated."""
    def spec(x):
        nd = np.ndim(x)
        if nd == 0:
            return ()
        if nd == 1:
            return _shrink_to_fit((("dp", "fsdp"),), np.shape(x), mesh_shape)
        s = ACTIVATION_RULES["tokens"]
        return _shrink_to_fit((*s, *(None,) * (nd - 2)), np.shape(x),
                              mesh_shape)
    return {k: spec(v) for k, v in batch.items()}


def sharded_dims(spec: Spec) -> dict[int, tuple[str, ...]]:
    """{dim: axes} of the dims a spec cuts."""
    return {d: entry_axes(e) for d, e in enumerate(spec) if entry_axes(e)}


def spec_axes(spec: Spec) -> set[str]:
    return {a for e in spec for a in entry_axes(e)}


def local_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    out = list(shape)
    for d, axes in sharded_dims(spec).items():
        out[d] //= mesh.axis_size(axes)
    return tuple(out)


def shard_of(full: torch.Tensor, spec: Spec, mesh,
             rank: Optional[int] = None) -> torch.Tensor:
    """The shard of ``full`` that ``rank`` (default this one) holds under
    ``spec``: a contiguous copy."""
    rank = mesh.rank if rank is None else rank
    out = full
    for d, axes in sharded_dims(spec).items():
        n = mesh.axis_size(axes)
        size = full.shape[d] // n
        out = out.narrow(d, mesh.index_of(rank, axes) * size, size)
    return out.contiguous().clone()


def unshard(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's shard (a collective)."""
    from ..comms.collectives import all_gather
    out = local
    for d, axes in sharded_dims(spec).items():
        out = all_gather(out, axes, gather_dim=d, mesh=mesh)
    return out


# -- the serving leaves: one tensor-parallel rank's shard --------------------

def leaf_specs(leaf, path: str, layers: int, mesh_shape: dict) -> tuple:
    """The per-layer specs of a serving leaf of the stacked JAX ``path``
    (``blocks.q.kernel``; ``layers`` is the stack's depth), as JAX's
    ``param_specs`` gives them, the layer axis dropped: one spec for a
    tensor; for an int8 ``QuantTensor`` (values, scale): the values take
    the kernel's spec and the per-(L, in) scale its leading axes; for a
    ``Quant4Tensor`` (packed, scale, chan): the packed nibbles [in/2, out]
    and the group scale [in/group, out] take the kernel's (layer, in, out)
    spec and ``chan`` its (layer, in). A dim the axes do not divide is
    replicated (``_shrink_to_fit``)."""
    from ..ops.quantization import QuantTensor, Quant4Tensor
    stacked = path.startswith("blocks.")
    spec = spec_for_path(path, stacked=stacked)

    def fit(s, shape):
        shape = ((layers,) if stacked else ()) + tuple(shape)
        out = _shrink_to_fit(s, shape, mesh_shape)
        return out[1:] if stacked else out

    if isinstance(leaf, Quant4Tensor):
        lay, in_ax, out_ax = (tuple(spec) + (None, None, None))[:3]
        return (fit((lay, in_ax, out_ax), leaf.packed.shape),
                fit((lay, in_ax, out_ax), leaf.scale.shape),
                fit((lay, in_ax), leaf.chan.shape))
    if isinstance(leaf, QuantTensor):
        full = _shrink_to_fit(spec, ((layers,) if stacked else ())
                              + tuple(leaf.values.shape), mesh_shape)
        return (full[1:] if stacked else full,
                fit((*full[:-1], None), leaf.scale.shape))
    return fit(spec, leaf.shape)


def shard_leaf(leaf, path: str, layers: int, mesh):
    """This rank's shard of a whole serving leaf (a tensor, ``QuantTensor``
    or ``Quant4Tensor``) under ``leaf_specs``: each part holds the bytes
    of JAX's shard of it. A quantized leaf is quantized whole first (as
    the JAX engine quantizes before it shards), so a column shard keeps
    the scales of whole input rows.

    Where a W4 leaf's input rows are cut but its group scale, whose
    in/group rows tp does not divide, is replicated, the rows of a rank
    lie in one group only when in/group is 1: that shard computes with a
    group of its in/tp rows. Any other such split raises."""
    from ..ops.quantization import QuantTensor, Quant4Tensor
    specs = leaf_specs(leaf, path, layers, mesh.shape)
    if isinstance(leaf, Quant4Tensor):
        packed, scale, chan = (shard_of(t, s, mesh)
                               for t, s in zip(leaf.tensors(), specs))
        n_in, group = 2 * packed.shape[0], leaf.group
        if scale.shape[0] * group != n_in:
            if scale.shape[0] != 1:
                raise ValueError(
                    f"{path}: the int4 group scales {tuple(leaf.scale.shape)}"
                    f" (group {group}) do not split with the rows over "
                    f"tp={mesh.axis_size('tp')}")
            group = n_in
        if chan.shape[0] != n_in:
            raise ValueError(f"{path}: chan {tuple(chan.shape)} against "
                             f"{n_in} input rows")
        return Quant4Tensor(packed, scale, chan, group=group)
    if isinstance(leaf, QuantTensor):
        return QuantTensor(*(shard_of(t, s, mesh)
                             for t, s in zip(leaf.tensors(), specs)))
    return shard_of(leaf, specs, mesh)
