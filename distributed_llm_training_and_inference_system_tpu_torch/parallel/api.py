"""Sharded training on a mesh of ranks: ``ShardedTrainer``.

The port's counterpart of the JAX package's ``parallel/api.py``. There,
one controller builds the mesh, places the params and optimizer state by
their specs and jits the step, and XLA inserts every collective. Here
each rank (one process a card, ``parallel/mesh.py``) builds the same
mesh, holds exactly the shard of each leaf that the JAX
``PartitionSpec`` gives its mesh position (``sharding.param_specs``; the
AdamW moments by ``zero.opt_state_specs``), and runs
``exec/train_step.make_sharded_train_step``, whose collectives are placed
by hand:

- FSDP: a stacked leaf's layer is all-gathered over fsdp before use and
  its gradient reduce-scattered (``models/gpt.forward_sharded``);
- TP: q/k/v/gate/up column-parallel, o/down row-parallel with an
  all-reduce; the embedding and LM head gathered whole as their
  ``("fsdp", "tp")`` specs cut them;
- SP: ring or Ulysses attention over the sequence chunks;
- EP: each rank computes its E/ep experts for the global dispatch JAX
  computes over the call's tokens (``models/layers.moe_block``);
- PP: one rank a stage, GPipe or 1F1B as JAX chooses them (1F1B for a
  dense model when ``pipeline_schedule`` says so, GPipe for MoE;
  ``parallel/pipeline.py``);
- data (dp, fsdp, sp): the loss is the global token-weighted mean and
  every gradient is summed over the data and sequence ranks (and the
  stages) its leaf is not cut over; ZeRO-1 updates each rank's slice of a
  param and gathers the slices back.

The state is kept in the JAX package's layout: leaves by dotted path,
block leaves stacked on [L, ...]. ``init_state(seed)`` builds the port's
init (or takes a JAX-layout param tree: ``params=``) whole and keeps this
rank's shards. ``full_state_dict``/``load_full_state_dict`` speak the
single-device checkpoint format (``io.checkpoint.state_to_dict``): every
rank gathers (over pp and ep too), rank 0 writes; a restore slices.

Optimizers other than AdamW on a mesh wait for ROADMAP queue 1 item 7b,
step 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..exec.fused_update import kernel_eligible
from ..exec.train_step import (ShardedTrainState, grad_sum_axes,
                               make_sharded_eval_step,
                               make_sharded_train_step)
from ..exec.optimizer import _NO_DECAY
from .mesh import batch_axes, build_mesh
from .sharding import local_shape, param_specs, shard_of, unshard
from .zero import opt_state_specs

ITEM_7B = "ROADMAP queue 1 item 7b"


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict, in sorted key order (JAX's
    flattening order of a dict)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, path + "."))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split(".")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


@dataclass
class StateLayout:
    """Every leaf of the model by JAX path: its global (stacked) shape, the
    param's and the moments' specs, the port's name of it, whether weight
    decay applies and whether the fused AdamW kernel takes it."""
    shapes: dict
    p_specs: dict
    o_specs: dict
    names: dict          # path -> port parameter attr ("q", "embed", ...)
    decay: dict
    kernel: dict

    @property
    def paths(self) -> list[str]:
        return list(self.shapes)

    @staticmethod
    def stacked(path: str) -> bool:
        return path.startswith("blocks.")


def state_layout(model_cfg, mesh_shape: dict, zero_stage: int) -> StateLayout:
    """The layout of ``model_cfg``'s leaves on a mesh of ``mesh_shape``
    (from shapes alone: nothing is allocated)."""
    from ..weights import _ALL_BLOCK_LEAVES, _TOP_LEAVES
    from ..models.gpt import GPT
    meta = GPT(model_cfg, device="meta")
    shapes, names = {}, {}
    for name, path in _TOP_LEAVES.items():
        p = getattr(meta, name)
        if p is not None:
            shapes[".".join(path)] = tuple(p.shape)
            names[".".join(path)] = name
    blk = meta.blocks[0].leaves()
    for path, attr in _ALL_BLOCK_LEAVES.items():
        if attr in blk:
            key = ".".join(("blocks",) + path)
            shapes[key] = (model_cfg.num_layers, *blk[attr].shape)
            names[key] = attr
    shapes = dict(sorted(shapes.items()))
    p_specs = param_specs(shapes, mesh_shape)
    o_specs = opt_state_specs(shapes, p_specs, mesh_shape, zero_stage)
    # the port's decay mask (exec.optimizer._decay_mask) on each layer's
    # leaf; the kernel's size rule on the GLOBAL stacked leaf (JAX's)
    decay = {}
    for path, shape in shapes.items():
        layer_ndim = len(shape) - (1 if StateLayout.stacked(path) else 0)
        decay[path] = (layer_ndim >= 2 and not any(
            k in names[path] for k in _NO_DECAY))
    kernel = {path: kernel_eligible(shape) for path, shape in shapes.items()}
    return StateLayout(shapes, p_specs, o_specs, names, decay, kernel)


class ShardedTrainer:
    """Owns the mesh, this rank's shard of the train state, and the step."""

    def __init__(self, model_cfg, opt_cfg, par_cfg, device,
                 attn_impl: str = "xla"):
        if opt_cfg.type not in ("adamw", "adam"):
            raise NotImplementedError(
                f"sharded training with the {opt_cfg.type} optimizer is not "
                f"ported to the PyTorch package yet ({ITEM_7B}, step 7); "
                f"AdamW is")
        par_cfg.require_supported(model_cfg)
        if par_cfg.sequence_parallel > 1 and attn_impl not in ("ring",
                                                               "ulysses"):
            raise ValueError(
                f"sequence_parallel={par_cfg.sequence_parallel} needs "
                f"attn_impl ring, ulysses or auto (got {attn_impl!r})")
        self.model_cfg, self.opt_cfg, self.par_cfg = (model_cfg, opt_cfg,
                                                      par_cfg)
        self.device = device
        self.attn_impl = attn_impl
        self.mesh = build_mesh(par_cfg, device)
        self.layout = state_layout(model_cfg, self.mesh.shape,
                                   par_cfg.zero_stage)
        # the gradient sums' groups, made by every rank in one order
        for axes in grad_sum_axes(self.layout, self.mesh):
            self.mesh.group(axes)
        self.mesh.group(("pp", "dp", "fsdp", "sp"))     # a pipeline's loss
        grad_fn = None
        self.schedule = None
        if par_cfg.pipeline_parallel > 1:
            from . import pipeline
            self.schedule = ("1f1b" if par_cfg.pipeline_schedule == "1f1b"
                             and not model_cfg.is_moe else "gpipe")
            make = (pipeline.make_pipeline_grad_fn if self.schedule == "1f1b"
                    else pipeline.make_pipeline_loss_fn)
            grad_fn = make(model_cfg, par_cfg, self.mesh, self.layout,
                           attn_impl)
            self.eval_step = pipeline.make_pipeline_eval_fn(
                model_cfg, par_cfg, self.mesh, self.layout, attn_impl)
        else:
            self.eval_step = make_sharded_eval_step(model_cfg, self.mesh,
                                                    self.layout, attn_impl)
        self.train_step, _, self._gradients = make_sharded_train_step(
            model_cfg, opt_cfg, par_cfg, self.mesh, self.layout, attn_impl,
            grad_fn=grad_fn)
        self.state: Optional[ShardedTrainState] = None

    def describe(self) -> str:
        """The mesh, and the pipeline's schedule where there is one."""
        text = self.mesh.describe()
        if self.schedule is not None:
            text += (f"; pipeline {self.schedule}, "
                     f"{self.par_cfg.num_microbatches} microbatches")
        return text

    # -- state ---------------------------------------------------------------

    def _shard(self, flat: dict, specs: dict, dtype=None) -> dict:
        out = {}
        for path, spec in specs.items():
            t = torch.as_tensor(np.asarray(flat[path])) if not isinstance(
                flat[path], torch.Tensor) else flat[path]
            t = shard_of(t.to(self.device), spec, self.mesh)
            out[path] = t.to(dtype) if dtype is not None else t
        return out

    def init_state(self, seed: int = 0, params: Optional[dict] = None
                   ) -> ShardedTrainState:
        """This rank's shards of fresh state: fp32 master params from the
        port's init with ``seed`` (drawn whole on this rank's device, so
        every mesh starts from the single-device run's params) or from
        ``params``, a JAX-layout tree (nested dict or dotted paths, arrays
        or tensors); zero moments, count 0."""
        if params is None:
            from ..models import gpt
            from ..weights import params_to_tree
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model = gpt.init(self.model_cfg, gen, device=self.device)
            params = params_to_tree(model)
            del model
        flat = params if all(isinstance(k, str) and "." in k
                             for k in params) else flatten_tree(params)
        shards = self._shard({p: _fp32(flat[p]) for p in self.layout.paths},
                             self.layout.p_specs, torch.float32)
        del params, flat
        if torch.device(self.device).type == "cuda":
            # the whole model goes back to the card, not this rank's cache:
            # ranks that share a card would each keep a copy reserved
            torch.cuda.empty_cache()
        self.state = self._state_from(shards, step=0)
        return self.state

    def _state_from(self, params: dict, step: int) -> ShardedTrainState:
        mdt = getattr(torch, self.opt_cfg.moment_dtype)
        ndt = getattr(torch, self.opt_cfg.nu_dtype)
        lay = self.layout

        def zeros(dtype):
            return {p: torch.zeros(local_shape(lay.shapes[p], lay.o_specs[p],
                                               self.mesh),
                                   dtype=dtype, device=self.device)
                    for p in lay.paths}
        for t in params.values():
            t.requires_grad_(True)
        return ShardedTrainState(
            step=step, params=params, mu=zeros(mdt), nu=zeros(ndt),
            count=torch.zeros((), dtype=torch.int32, device=self.device))

    def full_state_dict(self) -> dict:
        """The whole state in the single-device checkpoint format
        (``io.checkpoint.state_to_dict``) on every rank (a collective)."""
        from ..weights import named_from_tree
        st, lay = self.state, self.layout
        # gloo moves host memory anyway: gather there, not back to the card
        host = self.mesh.backend == "gloo"

        def whole(d, specs):
            return named_from_tree(unflatten_tree({
                p: unshard(d[p].detach().cpu() if host else d[p].detach(),
                           specs[p], self.mesh).cpu()
                for p in lay.paths}))
        return {"step": int(st.step),
                "params": whole(st.params, lay.p_specs),
                "opt_state": {"mu": whole(st.mu, lay.o_specs),
                              "nu": whole(st.nu, lay.o_specs),
                              "count": st.count.detach().cpu()}}

    @torch.no_grad()
    def load_full_state_dict(self, d: dict) -> None:
        """Restore from a single-device state dict by slicing this rank's
        shards (moments too, by their ZeRO specs)."""
        from ..weights import tree_from_named
        lay = self.layout

        def flat(named):
            return flatten_tree(tree_from_named(named))
        params = self._shard(flat(d["params"]), lay.p_specs, torch.float32)
        self.state = self._state_from(params, step=int(d["step"]))
        if "opt_state" in d:
            opt = d["opt_state"]
            for field in ("mu", "nu"):
                src = self._shard(flat(opt[field]), lay.o_specs)
                dst = getattr(self.state, field)
                for p in lay.paths:
                    dst[p].copy_(src[p])
            self.state.count.copy_(torch.as_tensor(opt["count"]))

    # -- batches and steps ---------------------------------------------------

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def world(self) -> int:
        return self.mesh.world

    @property
    def shape(self) -> dict:
        """{axis: degree} of the mesh."""
        return dict(self.mesh.shape)

    @property
    def data_index(self) -> int:
        return self.mesh.axis_index(batch_axes())

    @property
    def data_size(self) -> int:
        return self.mesh.axis_size(batch_axes())

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch ([B, ...] arrays cut over
        dp x fsdp, as JAX's ``batch_specs``); the sequence stays whole
        (the step cuts its sp chunk). Under a pipeline the batch is
        [M, B/M, ...] first (``reshape_batch_for_pipeline``) and each
        microbatch's rows are cut, as JAX's ``pipeline_batch_specs``."""
        n, i = self.data_size, self.data_index
        dim = 0
        if self.schedule is not None and batch["tokens"].ndim == 2:
            from .pipeline import reshape_batch_for_pipeline
            batch = reshape_batch_for_pipeline(
                batch, self.par_cfg.num_microbatches)
            dim = 1
        out = {}
        for k, v in batch.items():
            rows = v.shape[dim] // n
            out[k] = v.narrow(dim, i * rows, rows)
        return out

    def step(self, batch: dict) -> dict:
        """One step on this rank's rows (device tensors, whole sequence)."""
        assert self.state is not None, "call init_state() first"
        self.state, metrics = self.train_step(self.state, batch)
        return metrics

    def evaluate(self, batch: dict) -> dict:
        assert self.state is not None, "call init_state() first"
        return self.eval_step(self.state, batch)

    def gradients(self, batch: dict) -> dict:
        """The step's gradient on this rank's rows without an update:
        {"loss", "aux" (the MoE aux, 0 dense), "grads" (this rank's shard
        of each leaf's gradient, summed over the ranks it is not cut over,
        before the clip)}."""
        assert self.state is not None, "call init_state() first"
        loss, aux, grads = self._gradients(self.state, batch)
        return {"loss": loss, "aux": aux, "grads": grads}

    def local_shapes(self) -> dict:
        """{path: (param shard shape, moment shard shape)} of this rank."""
        return {p: (tuple(self.state.params[p].shape),
                    tuple(self.state.mu[p].shape))
                for p in self.layout.paths}


def _fp32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().float()
    a = np.asarray(a)
    return torch.from_numpy(np.asarray(a, dtype=np.float32))
