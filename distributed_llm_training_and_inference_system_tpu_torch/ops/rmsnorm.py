"""Fused RMSNorm forward: wrapper of the hand-written kernel.

Counterpart of the JAX package's ``ops/rmsnorm.py``. ``rms_norm_fused``
normalises the last axis of ``x`` ([..., H]) with fp32 statistics, applies
``1 + scale`` and casts back to x's dtype. On a CUDA tensor it launches the
kernel of ``csrc/rmsnorm.cu``, counts the launch in
``rmsnorm_kernel.launches`` and raises if it is refused; nothing falls
back. On a CPU tensor it is the plain version, ``models.layers.rms_norm``.
Like the TPU kernel it has no backward: an input that requires grad is
refused while gradients are being recorded.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    f = build.load("rmsnorm").rmsnorm_fwd
    if f.argtypes is None:      # first use: pointers must not pass as int32
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm_kernel: {msg}")


def rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """x [..., H] (fp32 | bf16, contiguous), scale [H] -> x's shape and
    dtype, through the kernel."""
    _check(x.is_cuda and scale.is_cuda and x.device == scale.device,
           "x and scale must be on one CUDA device")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} (float32|bfloat16)")
    _check(x.dim() >= 1 and scale.dim() == 1
           and scale.shape[0] == x.shape[-1],
           f"x {tuple(x.shape)} against scale {tuple(scale.shape)}")
    H = x.shape[-1]
    _check(H % 8 == 0, f"H={H} (multiple of 8)")
    _check(x.is_contiguous() and x.data_ptr() % 16 == 0,
           "x must be contiguous and 16-byte aligned")
    scale32 = scale.float().contiguous()
    _check(scale32.data_ptr() % 16 == 0, "scale must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // H
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), scale32.data_ptr(), out.data_ptr(), rows, H,
                   float(eps), _DTYPES[x.dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm_kernel.launches += 1
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
