"""Communication layer: named collectives over the mesh's process groups
(the JAX package's ``comms/``; its collective benchmark waits for ROADMAP
queue 1 item 7b)."""

from .collectives import (  # noqa: F401
    all_gather, all_to_all, allreduce_mean, allreduce_sum, axis_index,
    axis_size, barrier, copy_to, gather, reduce_from, reduce_scatter,
    ring_shift)
