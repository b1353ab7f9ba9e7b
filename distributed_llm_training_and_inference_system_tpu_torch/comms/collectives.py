"""Named collectives over mesh axes, on ``torch.distributed``.

The port's counterpart of the JAX package's ``comms/collectives.py``.
There, each primitive wraps a ``jax.lax`` collective used inside
``shard_map`` bodies; here each runs over the process group of the named
axes of the mesh it is given (``parallel.mesh.Mesh``; there is no ambient
mesh, so a call that lacks one fails rather than running over the wrong
ranks), and ring and Ulysses attention and the sharded step read like
the pattern they run:

    allreduce_sum/mean  <- all_reduce           (gradient sync, tp blocks)
    all_gather          <- all_gather           (FSDP parameter gather)
    reduce_scatter      <- reduce_scatter       (FSDP gradient shard)
    ring_shift          <- batched isend/irecv  (ring attention hop)
    send_recv           <- batched isend/irecv  (pipeline stage hop)
    all_to_all          <- all_to_all_single    (Ulysses head scatter)

``axes`` may name several mesh axes; a tiled result is ordered by the
row-major index over them in the order given (JAX's ``("fsdp", "dp")``
entry), not by the group's rank order. Over axes of size 1 every call is
the identity and makes no call.

**Backend.** ``parallel.mesh.choose_backend`` takes NCCL when every rank
has its own card and gloo otherwise. Under gloo a CUDA tensor passes
through host memory: it is copied to the host, reduced or moved there and
copied back; 16-bit floats reduce in fp32 and travel as their bits.
Gloo's reduce-scatter is an all-reduce and a slice. Nothing here retries
or switches backend.

The autograd pairs a sharded model needs are ``torch.autograd.Function``
s: ``copy_to`` (identity; all-reduce of the gradient) before a
column-parallel matmul, ``reduce_from`` (all-reduce; identity gradient)
after a row-parallel one, ``gather`` (all-gather; the gradient
reduce-scattered for an FSDP gather over data ranks, or sliced for a
gather of a tensor every rank then uses alike), and ``all_to_all``
(differentiable: its gradient is the inverse all-to-all).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

# 16-bit floats cross gloo as their bytes (it moves no 16-bit type)
_WIRE_BITS = {torch.bfloat16: torch.uint8, torch.float16: torch.uint8}


def _staged(mesh) -> bool:
    """Gloo moves CUDA tensors through host memory."""
    return mesh.backend == "gloo"


def _send_form(x: torch.Tensor, mesh) -> torch.Tensor:
    """The tensor a move (gather, p2p, all-to-all) puts on the wire."""
    x = x.contiguous()
    if _staged(mesh):
        x = x.cpu()
        if x.dtype in _WIRE_BITS:
            x = x.reshape(-1).view(_WIRE_BITS[x.dtype])
    return x


def _recv_form(t: torch.Tensor, like: torch.Tensor, mesh,
               shape=None) -> torch.Tensor:
    """A received wire tensor as ``like``'s dtype and device, in ``shape``
    (default ``like``'s)."""
    if _staged(mesh):
        if like.dtype in _WIRE_BITS:
            t = t.view(like.dtype).reshape(
                like.shape if shape is None else shape)
        t = t.to(like.device)
    return t


def axis_size(axis, mesh) -> int:
    return mesh.axis_size(axis)


def axis_index(axis, mesh) -> int:
    return mesh.axis_index(axis)


def allreduce_sum(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """The sum over ``axis`` (a new tensor; ``x`` is left as it was)."""
    g = mesh.group(axis)
    if g is None:
        return x.clone()
    if _staged(mesh):
        t = x.detach().to("cpu", torch.float32 if x.dtype in _WIRE_BITS
                          else x.dtype, copy=True)
    else:
        t = x.detach().clone()
    dist.all_reduce(t, group=g)
    return t.to(x.device, x.dtype)


def allreduce_mean(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    return allreduce_sum(x, axis, mesh) / mesh.axis_size(axis)


def _gather_list(x: torch.Tensor, axis, mesh) -> list[torch.Tensor]:
    """Every member's ``x``, ordered by its index over ``axis``."""
    g = mesh.group(axis)
    if g is None:
        return [x]
    members = mesh.members(axis)
    xs = _send_form(x.detach(), mesh)
    out = [torch.empty_like(xs) for _ in members]
    dist.all_gather(out, xs, group=g)
    ordered: list = [None] * len(members)
    for m, t in zip(members, out):
        ordered[mesh.index_of(m, axis)] = _recv_form(t, x, mesh)
    return ordered


def all_gather(x: torch.Tensor, axis, *, gather_dim: int = 0,
               mesh) -> torch.Tensor:
    """The members' ``x`` concatenated along ``gather_dim`` (tiled)."""
    return torch.cat(_gather_list(x, axis, mesh), gather_dim)


def reduce_scatter(x: torch.Tensor, axis, *, scatter_dim: int = 0,
                   mesh) -> torch.Tensor:
    """The sum over ``axis``, cut into as many chunks along
    ``scatter_dim``; this rank keeps the chunk of its index."""
    g = mesh.group(axis)
    if g is None:
        return x.clone()
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[scatter_dim] % n:
        raise ValueError(f"dim {scatter_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    if _staged(mesh):
        return allreduce_sum(x, axis, mesh).chunk(n, scatter_dim)[i] \
            .contiguous()
    chunks = x.detach().chunk(n, scatter_dim)
    inputs = [chunks[mesh.index_of(m, axis)].contiguous()
              for m in mesh.members(axis)]
    out = torch.empty_like(inputs[0])
    dist.reduce_scatter(out, inputs, group=g)
    return out


def ring_shift(x: torch.Tensor, axis, *, shift: int = 1,
               mesh) -> torch.Tensor:
    """Send to index (i + shift) mod n, receive from (i - shift) mod n:
    the ring-attention hop."""
    if mesh.group(axis) is None:
        return x
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    by_index = {mesh.index_of(m, axis): m for m in mesh.members(axis)}
    dst, src = by_index[(i + shift) % n], by_index[(i - shift) % n]
    send = _send_form(x.detach(), mesh)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst),
           dist.P2POp(dist.irecv, recv, src)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _recv_form(recv, x, mesh)


def _member(axis, index: int, mesh) -> int:
    """The global rank of the member of ``index`` over ``axis``."""
    for m in mesh.members(axis):
        if mesh.index_of(m, axis) == index:
            return m
    raise ValueError(f"no member of index {index} over {axis}")


def send_recv(x, axis, *, to=None, frm=None, shape=None, dtype=None,
              mesh, device=None):
    """Send ``x`` (or nothing, None) to the member of index ``to`` over
    ``axis`` and receive a tensor of ``shape`` and ``dtype`` (or nothing,
    ``shape`` None) from the member of index ``frm``, on ``device``; the
    two are posted together as one ``batch_isend_irecv`` and both are done
    when it returns. Returns the received tensor or None.

    Paired so: under NCCL a rank's p2p calls run in order on one stream
    and a large send ends only once its receiver has posted the receive,
    so a send posted alone before a receive can wait on a peer that waits
    on that receive (a pipeline's activations one way, its cotangents the
    other). Two ranks whose hops are posted as pairs, and whose k-th
    message between them is the same on both sides, never block each
    other (``parallel.pipeline``'s orders, held by a test)."""
    group = mesh.group(axis)
    ops, wire = [], None
    if x is not None:
        ops.append(dist.P2POp(dist.isend, _send_form(x.detach(), mesh),
                              _member(axis, to, mesh), group=group))
    if shape is not None:
        if not _staged(mesh):
            wire = torch.empty(shape, dtype=dtype, device=device)
        elif dtype in _WIRE_BITS:
            wire = torch.empty(math.prod(shape) * dtype.itemsize,
                               dtype=torch.uint8)
        else:
            wire = torch.empty(shape, dtype=dtype)
        ops.append(dist.P2POp(dist.irecv, wire, _member(axis, frm, mesh),
                              group=group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if wire is not None and _staged(mesh):
        if dtype in _WIRE_BITS:
            wire = wire.view(dtype).reshape(shape)
        wire = wire.to(device)
    return wire


def _all_to_all(x: torch.Tensor, axis, split_dim: int, concat_dim: int,
                mesh) -> torch.Tensor:
    n = mesh.axis_size(axis)
    members = mesh.members(axis)
    chunks = x.detach().chunk(n, split_dim)
    # chunk j goes to the member of index j (group rank order on the wire)
    stacked = torch.stack([chunks[mesh.index_of(m, axis)] for m in members])
    send = _send_form(stacked, mesh)
    if _staged(mesh) and x.dtype in _WIRE_BITS:
        send = send.reshape(n, -1)      # a row a member
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    recv = _recv_form(recv, x, mesh, stacked.shape)
    got = {mesh.index_of(m, axis): recv[r] for r, m in enumerate(members)}
    return torch.cat([got[j] for j in range(n)], concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim, mesh):
        ctx.args = (axis, split_dim, concat_dim, mesh)
        return _all_to_all(x, axis, split_dim, concat_dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim, mesh = ctx.args
        return (_all_to_all(g, axis, concat_dim, split_dim, mesh),
                None, None, None, None)


def all_to_all(x: torch.Tensor, axis, *, split_dim: int, concat_dim: int,
               mesh) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into n chunks along ``split_dim``,
    chunk j sent to index j, the received chunks concatenated along
    ``concat_dim`` in their senders' index order. Differentiable."""
    if mesh.group(axis) is None:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim, mesh)


def barrier(axis, mesh) -> None:
    """Wait for every member over ``axis`` (``parallel.mesh.AXES``: all ranks)."""
    g = mesh.group(axis)
    if g is not None:
        dist.barrier(group=g)


# -- the autograd pairs ----------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.args
        return allreduce_sum(g, axis, mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return allreduce_sum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, grad, mesh):
        ctx.args = (axis, dim, grad, mesh)
        return all_gather(x, axis, gather_dim=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        axis, dim, grad, mesh = ctx.args
        if grad == "reduce_scatter":
            out = reduce_scatter(g.contiguous(), axis, scatter_dim=dim,
                                 mesh=mesh)
        else:
            n, i = mesh.axis_size(axis), mesh.axis_index(axis)
            out = g.chunk(n, dim)[i].contiguous()
        return out, None, None, None, None


def gather_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data and sequence rank's tokens ``x`` [B_local, S_local, ...]
    as the call's global [B, S, ...]: rows over (dp, fsdp), the sequence
    over sp, in JAX's batch and sequence order. Differentiable: each rank
    gets its own tokens' gradient, summed over the ranks that used them
    (the router's probabilities of the MoE dispatch over the global
    tokens)."""
    x = gather(x, "sp", 1, "reduce_scatter", mesh)
    return gather(x, ("dp", "fsdp"), 0, "reduce_scatter", mesh)


def copy_to(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``axis``: the
    input of a column-parallel matmul."""
    return x if mesh.group(axis) is None else _CopyTo.apply(x, axis, mesh)


def reduce_from(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """All-reduce forward, identity gradient: the output of a row-parallel
    matmul."""
    return x if mesh.group(axis) is None else _ReduceFrom.apply(x, axis,
                                                               mesh)


def gather(x: torch.Tensor, axis, dim: int, grad: str,
           mesh) -> torch.Tensor:
    """Differentiable tiled all-gather along ``dim``. ``grad`` says what
    its gradient is: "reduce_scatter" (the members fed different data: an
    FSDP parameter gather) or "slice" (every member computes the same
    gradient of the whole: this rank's chunk of it)."""
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"grad must be reduce_scatter|slice, got {grad!r}")
    if mesh.group(axis) is None:
        return x
    return _Gather.apply(x, axis, dim, grad, mesh)
