"""Communication layer (the JAX package's ``comms/``): named collectives
and the pipeline's point-to-point hops over the mesh's process groups,
and their benchmark (``comms/bench.py``)."""

from .collectives import (  # noqa: F401
    all_gather, all_to_all, allreduce_mean, allreduce_sum, axis_index,
    axis_size, barrier, copy_to, gather, gather_tokens, reduce_from,
    reduce_scatter, ring_shift, send_recv)
