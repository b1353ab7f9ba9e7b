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
