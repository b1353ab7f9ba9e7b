"""Wrappers of the hand-written Hopper flash-attention kernels.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernels
``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` of the JAX
package's ``ops/attention.py``. Each wrapper checks what it is given,
allocates its outputs, launches on the current stream and counts its
launches in ``<wrapper>.launches`` (a plain integer callers may reset), so
a run can show that the training path went through the kernels. A launch
that is refused raises; nothing falls back. The plain PyTorch versions are
``_fwd_plain``, ``_bwd_dq_plain`` and ``_bwd_dkv_plain`` in
``ops.attention``.

Layout: q [BH, Sq, D], k/v [BH, Skv, D] (bf16 or fp32, contiguous), segment
ids and positions [BH, 1, S] int32, lse/delta [BH, Sq, 1] fp32.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(name: str, n_ptr: int):
    f = getattr(build.load("flash_attention"), name)
    if f.argtypes is None:      # first use: pointers must not pass as int32
        f.argtypes = [_P] * n_ptr + [_I] * 5 + [_F, _I, _P]
        f.restype = ctypes.c_int
    return f


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check_inputs(q, k, v, q_segments, kv_segments, q_positions,
                  kv_positions, extra=()):
    tensors = (q, k, v, q_segments, kv_segments, q_positions, kv_positions,
               *extra)
    _check(all(t.is_cuda for t in tensors), "every tensor must be on CUDA")
    _check(len({t.device for t in tensors}) == 1, "tensors on two devices")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32|bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype, "q, k, v dtypes differ")
    _check(q.dim() == 3 and k.dim() == 3 and v.shape == k.shape,
           "q [BH,Sq,D], k/v [BH,Skv,D]")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    _check(k.shape[0] == BH and k.shape[2] == D, "k/v shape against q")
    _check(D in HEAD_DIMS, f"head dim {D} (one of {HEAD_DIMS})")
    for t, n in ((q_segments, Sq), (q_positions, Sq), (kv_segments, Skv),
                 (kv_positions, Skv)):
        _check(t.dtype == torch.int32 and tuple(t.shape) == (BH, 1, n),
               "segments/positions int32 [BH, 1, S]")
    _check(all(t.is_contiguous() for t in tensors), "contiguous tensors")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, *extra[:1])),
           "q, k, v and dO must be 16-byte aligned")
    _check(-(-max(Sq, Skv) // 64) <= 65535, "sequence too long for the grid")
    return BH, Sq, Skv, D


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, q_segments, kv_segments, q_positions, kv_positions,
              causal: bool, scale: float):
    """(out [BH, Sq, D] in q's dtype, lse [BH, Sq, 1] fp32)."""
    BH, Sq, Skv, D = _check_inputs(q, k, v, q_segments, kv_segments,
                                   q_positions, kv_positions)
    out = torch.empty_like(q)
    lse = torch.empty(BH, Sq, 1, dtype=torch.float32, device=q.device)
    if BH == 0 or Sq == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = _fn("flash_fwd", 9)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segments.data_ptr(),
            kv_segments.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, Sq,
            Skv, D, int(causal), float(scale), _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, q_segments, kv_segments, q_positions,
                 kv_positions, do, lse, delta, causal: bool, scale: float):
    """dq [BH, Sq, D] in q's dtype."""
    BH, Sq, Skv, D = _check_inputs(q, k, v, q_segments, kv_segments,
                                   q_positions, kv_positions,
                                   (do, lse, delta))
    _check(do.shape == q.shape and do.dtype == q.dtype, "dO like q")
    _check(lse.dtype == torch.float32 and delta.dtype == torch.float32
           and tuple(lse.shape) == (BH, Sq, 1) == tuple(delta.shape),
           "lse/delta fp32 [BH, Sq, 1]")
    dq = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return dq
    with torch.cuda.device(q.device):
        rc = _fn("flash_bwd_dq", 11)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segments.data_ptr(),
            kv_segments.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), BH, Sq, Skv, D, int(causal),
            float(scale), _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd_dq kernel launch failed: CUDA error {rc}")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, q_segments, kv_segments, q_positions,
                  kv_positions, do, lse, delta, causal: bool, scale: float):
    """(dk, dv) [BH, Skv, D] in k's dtype."""
    BH, Sq, Skv, D = _check_inputs(q, k, v, q_segments, kv_segments,
                                   q_positions, kv_positions,
                                   (do, lse, delta))
    _check(do.shape == q.shape and do.dtype == q.dtype, "dO like q")
    _check(lse.dtype == torch.float32 and delta.dtype == torch.float32
           and tuple(lse.shape) == (BH, Sq, 1) == tuple(delta.shape),
           "lse/delta fp32 [BH, Sq, 1]")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if BH == 0 or Skv == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        rc = _fn("flash_bwd_dkv", 12)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segments.data_ptr(),
            kv_segments.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Sq, Skv, D,
            int(causal), float(scale), _DTYPES[q.dtype], _stream(q))
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd_dkv kernel launch failed: CUDA error {rc}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
