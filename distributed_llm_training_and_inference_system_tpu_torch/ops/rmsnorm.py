"""Fused RMSNorm forward: wrapper of the hand-written kernel.

Counterpart of the JAX package's ``ops/rmsnorm.py``. ``rms_norm_fused``
normalises the last axis of ``x`` ([..., H]) with fp32 statistics, applies
``1 + scale`` and casts back to x's dtype. On a CUDA tensor it launches the
kernel of ``csrc/rmsnorm.cu`` once, with the scale read in its own dtype,
counts the launch in ``rmsnorm_kernel.launches`` and raises if it is
refused; nothing falls back. On a CPU tensor it is the plain version,
``models.layers.rms_norm``. Like the TPU kernel it has no backward: an
input that requires grad is refused while gradients are being recorded.

``launch_plan`` (pure, CPU-tested) gives the kernel's launch shape from
(rows, H, x's element size) and the card's SM count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's limits (csrc/rmsnorm.cu): a warp holds a row of at most
# MAX_LANE_VECS 16-byte vectors a lane; a block holds at most
# MAX_WARPS_PER_BLOCK warps
MAX_LANE_VECS = 16
MAX_WARPS_PER_BLOCK = 8
WARPS_PER_BLOCK = 4
# warps the plan aims to keep on each SM: enough rows in flight to cover
# the memory latency (8 ran faster than 2 or 4 and as fast as 16 on an
# H100 under profile_norm_adamw.py); past 132 x 8 rows a warp walks
# several and reads the scale once for them
WARPS_PER_SM = 8


def launch_plan(rows: int, H: int, itemsize: int,
                sm_count: int = 132) -> dict:
    """The launch shape of one call over ``rows`` rows of ``H`` elements
    of ``itemsize`` bytes. A warp a row where the row fits in
    ``MAX_LANE_VECS`` 16-byte vectors a lane ("warp": ``vpl`` vectors a
    lane, a power of two; ``warps`` warps walk rows w, w + warps, ...,
    ``rows_per_warp`` at most each, ``warps_per_block`` a block, ``grid``
    blocks); else a block of 256 threads a row ("block", ``grid`` =
    rows)."""
    if rows < 0 or H <= 0 or (H * itemsize) % 16:
        raise ValueError(f"rmsnorm plan: rows={rows}, H={H}, "
                         f"itemsize={itemsize}")
    vec = 16 // itemsize
    lane_vecs = -(-(H // vec) // 32)
    if lane_vecs > MAX_LANE_VECS:
        return {"mode": "block", "vpl": 0, "warps": 0, "rows_per_warp": 1,
                "warps_per_block": 0, "grid": rows}
    vpl = 1 << (lane_vecs - 1).bit_length()
    warps = max(1, min(rows, sm_count * WARPS_PER_SM))
    rows_per_warp = -(-rows // warps) if rows else 0
    warps = -(-rows // rows_per_warp) if rows else 0
    wpb = max(1, min(WARPS_PER_BLOCK, warps))
    return {"mode": "warp", "vpl": vpl, "warps": warps,
            "rows_per_warp": rows_per_warp, "warps_per_block": wpb,
            "grid": -(-warps // wpb)}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn():
    f = build.load("rmsnorm").rmsnorm_fwd
    if f.argtypes is None:      # first use: pointers must not pass as int32
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                      + [ctypes.c_float] + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm_kernel: {msg}")


def rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [..., H] (fp32 | bf16, contiguous), scale [H] (fp32 | bf16) ->
    x's shape and dtype, through the kernel: one launch."""
    _check(x.is_cuda and scale.is_cuda and x.device == scale.device,
           "x and scale must be on one CUDA device")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} (float32|bfloat16)")
    _check(scale.dtype in _DTYPES,
           f"scale dtype {scale.dtype} (float32|bfloat16)")
    _check(x.dim() >= 1 and scale.dim() == 1
           and scale.shape[0] == x.shape[-1],
           f"x {tuple(x.shape)} against scale {tuple(scale.shape)}")
    H = x.shape[-1]
    _check(H % 8 == 0, f"H={H} (multiple of 8)")
    _check(x.is_contiguous() and x.data_ptr() % 16 == 0,
           "x must be contiguous and 16-byte aligned")
    scale = scale.contiguous()
    _check(scale.data_ptr() % 16 == 0, "scale must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // H
    if rows == 0:
        return out
    plan = launch_plan(rows, H, x.element_size(), _sm_count(x.device.index))
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, H,
                   float(eps), _DTYPES[x.dtype], _DTYPES[scale.dtype],
                   plan["vpl"], plan["warps"], plan["warps_per_block"],
                   plan["grid"],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    build.count_launch(rmsnorm_kernel)
    return out


rmsnorm_kernel.launches = 0


def rms_norm_fused(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm through the kernel on a CUDA tensor, through the plain
    version on a CPU tensor. Forward only."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError(
            "rms_norm_fused has no backward (the kernel is forward-only): "
            "use models.layers.rms_norm(impl='xla') where a gradient is "
            "needed")
    if not x.is_cuda:
        from ..models.layers import rms_norm
        return rms_norm(x, scale, eps)
    return rmsnorm_kernel(x.contiguous(), scale, eps)
