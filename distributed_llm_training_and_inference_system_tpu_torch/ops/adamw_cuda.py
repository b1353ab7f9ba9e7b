"""Wrapper of the hand-written Hopper fused AdamW kernel.

The kernel (``csrc/adamw.cu``) replaces the TPU kernel ``_adamw_kernel``
of the JAX package's ``exec/fused_update.py``: one in-place pass over a
parameter leaf's (p, g, mu, nu). The wrapper checks what it is given and
launches on the current stream; ``adamw_kernel.launches`` counts its
launches (a plain integer callers may reset). A launch that is refused
raises; nothing falls back. The plain PyTorch version is
``exec.fused_update._leaf_math``, to which the kernel is bitwise equal.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_MOMENT_DTYPES = (torch.float32, torch.bfloat16)


def _fn():
    f = build.load("adamw").adamw_update
    if f.argtypes is None:      # first use: pointers must not pass as int32
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                      + [ctypes.c_float] * 6 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"adamw_kernel: {msg}")


def adamw_kernel(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, scalars: torch.Tensor, *, b1: float,
                 b2: float, eps: float, wd: float) -> None:
    """Update p, mu and nu in place. p, g fp32; mu, nu fp32 or bf16, all
    of p's shape and contiguous; ``scalars`` a device fp32[4] holding
    (lr, 1 - b1^t, 1 - b2^t, clip scale)."""
    tensors = (p, g, mu, nu, scalars)
    _check(all(t.is_cuda for t in tensors), "every tensor must be on CUDA")
    _check(len({t.device for t in tensors}) == 1, "tensors on two devices")
    _check(p.dtype == torch.float32 and g.dtype == torch.float32,
           "p and g must be fp32")
    _check(mu.dtype in _MOMENT_DTYPES and nu.dtype in _MOMENT_DTYPES,
           "mu/nu must be fp32 or bf16")
    _check(g.shape == p.shape and mu.shape == p.shape and nu.shape == p.shape,
           "p, g, mu, nu differ in shape")
    _check(scalars.dtype == torch.float32 and scalars.numel() == 4,
           "scalars must be fp32[4]")
    _check(all(t.is_contiguous() for t in tensors), "contiguous tensors")
    n = p.numel()
    if n == 0:
        return
    # b1 * mu multiplies by b1 rounded to mu's dtype (optax's weak-typed
    # scalar); the value is exact in fp32
    b1_mu = float(torch.tensor(b1, dtype=mu.dtype))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = _fn()(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                   scalars.data_ptr(), n, b1_mu, 1.0 - b1, b2, 1.0 - b2, eps,
                   wd, int(mu.dtype == torch.bfloat16),
                   int(nu.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"adamw kernel launch failed: CUDA error {rc}")
    adamw_kernel.launches += 1


adamw_kernel.launches = 0
