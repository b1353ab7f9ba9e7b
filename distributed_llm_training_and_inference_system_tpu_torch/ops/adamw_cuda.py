"""Wrapper of the hand-written Hopper fused AdamW kernel.

The kernel (``csrc/adamw.cu``) replaces the TPU kernel ``_adamw_kernel``
of the JAX package's ``exec/fused_update.py``: one in-place pass over each
parameter leaf's (p, g, mu, nu). ``adamw_multi_kernel`` updates a list of
leaves in as few launches as ``adamw_plan`` gives (one per (mu, nu) dtype
pair, split at the table's capacity); ``adamw_kernel`` is the same for
one leaf. Both launch on the current stream; ``adamw_kernel.launches``
counts launches and ``adamw_kernel.leaves`` the leaves they updated
(plain integers callers may reset). A launch that is refused raises;
nothing falls back. The plain PyTorch version is
``exec.fused_update._leaf_math``, to which the kernel is bitwise equal.

``adamw_plan`` is pure Python (CPU-tested): the grouping and the tiles
of each launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

_MOMENT_DTYPES = (torch.float32, torch.bfloat16)

# the kernel's layout (csrc/adamw.cu; checked against the library when it
# is loaded): leaves a launch, elements a tile, threads a block
CAPACITY = 256
TILE = 4096
BLOCKS_PER_SM = 2
_LEAF = np.dtype([("p", "<u8"), ("g", "<u8"), ("mu", "<u8"), ("nu", "<u8"),
                  ("n", "<i8"), ("wd", "<f4"), ("vec", "<i4")])
TABLE_BYTES = _LEAF.itemsize * CAPACITY + 4 * (CAPACITY + 2)


def vector_aligned(ptrs, moment_itemsizes) -> bool:
    """Whether a leaf's pointers (p, g, mu, nu) allow the kernel's vectors
    of 4 elements: 16 bytes for fp32, 8 for a bf16 moment."""
    p, g, mu, nu = ptrs
    m_item, n_item = moment_itemsizes
    return (p % 16 == 0 and g % 16 == 0 and mu % (4 * m_item) == 0
            and nu % (4 * n_item) == 0)


def adamw_plan(leaves, sm_count: int = 132) -> list[dict]:
    """Launches for ``leaves``, a sequence of (n elements, mu dtype, nu
    dtype). Leaves of one (mu, nu) dtype pair share launches, in their
    order, CAPACITY leaves at most a launch; leaves with no element are
    left out. Each launch: ``dtypes``, ``leaves`` (indices into
    ``leaves``), ``tile_start`` (leaf i of the launch owns tiles
    [tile_start[i], tile_start[i + 1]) of TILE elements), ``tiles`` and
    ``grid`` (persistent blocks)."""
    groups: dict = {}
    for i, (n, mdt, ndt) in enumerate(leaves):
        if n > 0:
            groups.setdefault((mdt, ndt), []).append(i)
    launches = []
    for dtypes, idx in groups.items():
        for c in range(0, len(idx), CAPACITY):
            part = idx[c:c + CAPACITY]
            start = [0]
            for i in part:
                start.append(start[-1] + -(-leaves[i][0] // TILE))
            if start[-1] >= 2 ** 31:
                raise ValueError("adamw plan: more than 2^31 tiles in a "
                                 "launch")
            launches.append({"dtypes": dtypes, "leaves": part,
                             "tile_start": start, "tiles": start[-1],
                             "grid": min(start[-1], sm_count * BLOCKS_PER_SM)})
    return launches


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn():
    lib = build.load("adamw")
    f = lib.adamw_update_multi
    if f.argtypes is None:      # first use: pointers must not pass as int32
        layout = (lib.adamw_capacity(), lib.adamw_table_bytes(),
                  lib.adamw_tile())
        if layout != (CAPACITY, TABLE_BYTES, TILE):
            raise RuntimeError(f"adamw kernel layout {layout} != "
                               f"{(CAPACITY, TABLE_BYTES, TILE)}")
        f.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_float] * 5
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"adamw_kernel: {msg}")


def _table(launch: dict, leaves, wds) -> np.ndarray:
    """The bytes of the kernel's Table for one launch."""
    buf = np.zeros(TABLE_BYTES, dtype=np.uint8)
    rows = buf[:_LEAF.itemsize * CAPACITY].view(_LEAF)
    for k, i in enumerate(launch["leaves"]):
        p, g, m, v = leaves[i]
        ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        rows[k] = (*ptrs, p.numel(), wds[i],
                   int(vector_aligned(ptrs, (m.element_size(),
                                             v.element_size()))))
    tail = buf[_LEAF.itemsize * CAPACITY:].view(np.int32)
    tail[:len(launch["tile_start"])] = launch["tile_start"]
    tail[CAPACITY + 1] = len(launch["leaves"])
    return buf


def adamw_multi_kernel(params, grads, mus, nus, scalars: torch.Tensor, *,
                       b1: float, b2: float, eps: float, wds) -> int:
    """Update every (p, mu, nu) in place from its g. p, g fp32; mu, nu
    fp32 or bf16, each of its p's shape and contiguous; ``scalars`` a
    device fp32[4] holding (lr, 1 - b1^t, 1 - b2^t, clip scale); ``wds``
    the weight decay of each leaf. Returns the number of launches."""
    leaves = list(zip(params, grads, mus, nus, strict=True))
    wds = list(wds)
    _check(len(wds) == len(leaves), f"{len(wds)} decays for {len(leaves)} "
           f"leaves")
    if not leaves:
        return 0
    dev = scalars.device
    _check(scalars.is_cuda and scalars.dtype == torch.float32
           and scalars.numel() == 4 and scalars.is_contiguous(),
           "scalars must be a contiguous CUDA fp32[4]")
    for p, g, m, v in leaves:
        _check(all(t.is_cuda and t.device == dev for t in (p, g, m, v)),
               "every tensor must be on the scalars' CUDA device")
        _check(p.dtype == torch.float32 and g.dtype == torch.float32,
               "p and g must be fp32")
        _check(m.dtype in _MOMENT_DTYPES and v.dtype in _MOMENT_DTYPES,
               "mu/nu must be fp32 or bf16")
        _check(g.shape == p.shape and m.shape == p.shape
               and v.shape == p.shape, "p, g, mu, nu differ in shape")
        _check(all(t.is_contiguous() for t in (p, g, m, v)),
               "contiguous tensors")
    plan = adamw_plan([(p.numel(), m.dtype, v.dtype)
                       for p, _, m, v in leaves], _sm_count(dev.index))
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for launch in plan:
            mdt, ndt = launch["dtypes"]
            # b1 * mu multiplies by b1 rounded to mu's dtype (optax's
            # weak-typed scalar); the value is exact in fp32
            b1_mu = float(torch.tensor(b1, dtype=mdt))
            table = _table(launch, leaves, wds)
            rc = fn(table.ctypes.data, scalars.data_ptr(), b1_mu, 1.0 - b1,
                    b2, 1.0 - b2, eps, int(mdt == torch.bfloat16),
                    int(ndt == torch.bfloat16), launch["grid"], stream)
            if rc != 0:
                raise RuntimeError(f"adamw kernel launch failed: CUDA error "
                                   f"{rc}")
            build.count_launch(adamw_kernel, leaves=len(launch["leaves"]))
    return len(plan)


def adamw_kernel(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, scalars: torch.Tensor, *, b1: float,
                 b2: float, eps: float, wd: float) -> None:
    """Update one leaf's p, mu and nu in place: ``adamw_multi_kernel``
    with one leaf."""
    adamw_multi_kernel([p], [g], [mu], [nu], scalars, b1=b1, b2=b2, eps=eps,
                       wds=[wd])


adamw_kernel.launches = 0
adamw_kernel.leaves = 0
