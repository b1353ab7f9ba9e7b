"""ZeRO-style optimizer-state sharding (the JAX package's
``parallel/zero.py``).

- stage 0: the optimizer state sharded exactly like its params
- stage 1/2: the AdamW moments additionally sharded over the data axes
  (dp, fsdp) even where their param is replicated: ZeRO-1. Each rank
  updates only its slice of the param and the slices are all-gathered
  back (``exec/train_step.py``); stage 2's gradient sharding adds nothing
  over that here, the gradient being reduced whole before the update
- stage 3: fully-sharded *params*: the fsdp mesh axis in
  ``sharding.PARAM_RULES``, orthogonal to this module

A moment leaf is matched to its param by path, as the JAX package matches
an optax state leaf by the param path its own path ends with.
"""

from __future__ import annotations

from .sharding import Spec, entry_axes, spec_axes


def _zero_shard(spec: Spec, shape: tuple, mesh_shape: dict) -> Spec:
    """Additionally shard an opt-state leaf over unused data axes
    (fsdp, dp), on the first dim that divides evenly."""
    used = spec_axes(spec)
    extra = [a for a in ("fsdp", "dp") if a not in used
             and mesh_shape[a] > 1]
    if not extra:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, dim in enumerate(shape):
        cur_axes = entry_axes(entries[i])
        cur_size = 1
        for a in cur_axes:
            cur_size *= mesh_shape[a]
        extra_size = 1
        for a in extra:
            extra_size *= mesh_shape[a]
        if dim % (cur_size * extra_size) == 0:
            entries[i] = (tuple(list(cur_axes) + extra)
                          if (cur_axes or len(extra) > 1) else extra[0])
            return tuple(entries)
    return spec


def opt_state_specs(shapes: dict[str, tuple], p_specs: dict,
                    mesh_shape: dict, zero_stage: int) -> dict:
    """{path: spec} of a param-shaped optimizer moment (AdamW's mu and nu):
    the param's spec, plus ZeRO sharding at stage >= 1. The step count is
    a scalar, replicated."""
    out = {}
    for path, shape in shapes.items():
        spec = p_specs[path]
        if len(shape) and zero_stage >= 1:
            spec = _zero_shard(spec, tuple(shape), mesh_shape)
        out[path] = spec
    return out


def zero_slice(p_spec: Spec, o_spec: Spec) -> tuple:
    """Where a moment's spec cuts finer than its param's: (dim, the extra
    axes in order) or None when they cut alike. The rank's slice of its
    param shard along ``dim`` is its index over those axes."""
    p = list(p_spec) + [None] * (len(o_spec) - len(p_spec))
    for d, (pe, oe) in enumerate(zip(p, o_spec)):
        pa, oa = entry_axes(pe), entry_axes(oe)
        if pa != oa:
            assert oa[:len(pa)] == pa, (p_spec, o_spec)
            return d, oa[len(pa):]
    return None
