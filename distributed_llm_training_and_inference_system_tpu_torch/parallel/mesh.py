"""The device mesh over ``torch.distributed`` ranks: one process a card.

The JAX package's ``parallel/mesh.py`` builds one ``jax.sharding.Mesh``
that a single controller drives and XLA inserts the collectives into. The
port runs one process per device (a *rank*) and places its collectives by
hand, so a mesh here is a grid of global ranks over JAX's axes, in JAX's
order, plus one process group per axis:

    axis   meaning                              collective traffic
    ----   -----------------------------------  -------------------
    pp     pipeline stage                       p2p (parallel/pipeline.py)
    dp     pure data parallel                   all-reduce of gradients
    fsdp   data parallel + param/opt sharding   all-gather / reduce-scatter
    ep     expert parallel (MoE experts)        all-reduce of expert outputs
    sp     sequence/context parallel            ring p2p, all-to-all
    tp     tensor (Megatron) parallel           all-reduce per block

A global rank's coordinates are row-major over ``AXES`` (tp innermost), as
JAX lays devices out. ``Mesh.group(axes)`` is the group of this rank's
coset over ``axes`` (None when the axes have size 1, so a size-1 axis
costs no call); every group of an axis set is created by every rank in
the same order (``torch.distributed.new_group`` needs all ranks).

**Backend rule** (``choose_backend``): NCCL when every rank on this host
has a card of its own, gloo otherwise. A gloo collective on a CUDA tensor
passes through host memory (``comms/collectives.py`` stages it). The
choice is made once, at ``init_distributed``, and printed by the trainer;
nothing switches backend after a failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# a hung peer fails the run after this long rather than after gloo's
# default 30 minutes
DEFAULT_TIMEOUT_S = 600.0


def mesh_shape_from_config(par) -> dict[str, int]:
    return {
        "pp": par.pipeline_parallel,
        "dp": par.data_parallel,
        "fsdp": par.fsdp,
        "ep": par.expert_parallel,
        "sp": par.sequence_parallel,
        "tp": par.tensor_parallel,
    }


def infer_data_parallel(par, num_devices: int):
    """Fill in data_parallel so the mesh covers all devices (ranks)."""
    other = (par.fsdp * par.tensor_parallel * par.pipeline_parallel *
             par.sequence_parallel * par.expert_parallel)
    if num_devices % other != 0:
        raise ValueError(
            f"device count {num_devices} not divisible by "
            f"fsdp*tp*pp*sp*ep = {other}")
    return dataclasses.replace(par, data_parallel=num_devices // other)


def batch_axes() -> tuple[str, ...]:
    """Mesh axes the global batch dimension is sharded over."""
    return ("dp", "fsdp")


def choose_backend(device: torch.device,
                   local_world_size: Optional[int] = None) -> str:
    """NCCL when every rank on this host has its own card, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if torch.cuda.device_count() >= local and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, world: int,
                rank: Optional[int] = None) -> torch.device:
    """The device of ``rank`` (default ``RANK``) of a ``world`` of ranks
    on this host: ``cuda:{rank}`` where every rank has a card of its own,
    else ``cuda:0``, which the ranks share (and move their collectives
    over gloo); the CPU stays the CPU."""
    if device.type != "cuda" or world <= 1:
        return device
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    return torch.device("cuda", rank if torch.cuda.device_count() >= world
                        else 0)


def init_distributed(device: torch.device,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group the launcher described in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``: a TCP rendezvous), once. Returns the
    backend. Under NCCL each rank takes card ``LOCAL_RANK``."""
    if dist.is_initialized():
        return dist.get_backend()
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    backend = choose_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return backend


class Mesh:
    """This rank's place in the rank grid, and the groups over its axes."""

    def __init__(self, shape: dict[str, int], rank: int, world: int,
                 backend: str, device: torch.device):
        self.shape = {a: int(shape[a]) for a in AXES}
        self.size = int(np.prod(list(self.shape.values())))
        if self.size != world:
            raise ValueError(
                f"parallel config needs {self.size} devices ({self.shape}), "
                f"but {world} are available")
        self.rank, self.world = rank, world
        self.backend = backend
        self.device = device
        self.grid = np.arange(world).reshape(tuple(self.shape[a]
                                                   for a in AXES))
        where = np.argwhere(self.grid == rank)[0]
        self.coords = {a: int(i) for a, i in zip(AXES, where)}
        self._groups: dict[frozenset, object] = {}
        # every group the trainer uses, created here by every rank in the
        # same order: each axis, the data axes together, the axes an MoE
        # layer's experts are cut over, all of them
        for axes in [(a,) for a in AXES] + [("dp", "fsdp"), ("ep", "tp"),
                                            AXES]:
            self._make_group(axes)

    # -- sizes and indices ---------------------------------------------------

    def axis_size(self, axes) -> int:
        axes = _as_axes(axes)
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in the order given:
        the first axis is the major one, as in a JAX PartitionSpec entry
        ``("fsdp", "dp")``)."""
        return self.index_of(self.rank, axes)

    def index_of(self, rank: int, axes) -> int:
        where = np.argwhere(self.grid == rank)[0]
        coords = dict(zip(AXES, where))
        idx = 0
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + int(coords[a])
        return idx

    def members(self, axes) -> list[int]:
        """Global ranks of this rank's coset over ``axes``, ascending (a
        group's rank order)."""
        axes = _as_axes(axes)
        sl = tuple(slice(None) if a in axes else self.coords[a]
                   for a in AXES)
        return sorted(int(r) for r in np.ravel(self.grid[sl]))

    def group(self, axes):
        """The process group over ``axes`` holding this rank; None when
        their size is 1."""
        axes = _as_axes(axes)
        if self.axis_size(axes) == 1:
            return None
        key = frozenset(axes)
        if key not in self._groups:
            self._make_group(axes)
        return self._groups[key]

    def _make_group(self, axes) -> None:
        axes = _as_axes(axes)
        key = frozenset(axes)
        if key in self._groups or self.axis_size(axes) == 1:
            return
        if self.axis_size(axes) == self.world:
            self._groups[key] = dist.group.WORLD
            return
        others = [a for a in AXES if a not in axes]
        mine = None
        for combo in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            fixed = dict(zip(others, combo))
            sl = tuple(slice(None) if a in axes else fixed[a] for a in AXES)
            ranks = sorted(int(r) for r in np.ravel(self.grid[sl]))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        self._groups[key] = mine

    def describe(self) -> str:
        used = {a: n for a, n in self.shape.items() if n > 1}
        return (f"mesh {used or {'dp': 1}} over {self.world} rank(s), "
                f"backend {self.backend}, device {self.device}")


def _as_axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def build_mesh(par, device: torch.device) -> Mesh:
    """The mesh of ``par`` over the initialised process group (a world of
    one without it). The product of the degrees must equal the world."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, "none"
    return Mesh(mesh_shape_from_config(par), rank, world, backend, device)

