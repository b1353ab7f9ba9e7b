"""Parallelism on ``torch.distributed`` (the JAX package's ``parallel/``):
the mesh of ranks, the sharding rules, ZeRO, the pipeline (GPipe and
1F1B, one rank a stage), the planner and ``ShardedTrainer``."""

from .mesh import (AXES, Mesh, build_mesh, choose_backend,  # noqa: F401
                   infer_data_parallel, init_distributed)
from .sharding import param_specs, shard_of, unshard  # noqa: F401
from .zero import opt_state_specs  # noqa: F401
