"""Parallelism on ``torch.distributed``: the mesh of ranks, the sharding
rules, ZeRO, the sp-scheme planner and ``ShardedTrainer`` (the JAX
package's ``parallel/``; its pipeline and the rest of its planner wait for
ROADMAP queue 1 item 7b)."""

from .mesh import (AXES, Mesh, build_mesh, choose_backend,  # noqa: F401
                   infer_data_parallel, init_distributed)
from .sharding import param_specs, shard_of, unshard  # noqa: F401
from .zero import opt_state_specs  # noqa: F401
