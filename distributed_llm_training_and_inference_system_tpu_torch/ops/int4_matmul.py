"""W4A16 matmul with in-kernel dequantization: wrapper and plain version.

Counterpart of the JAX package's ``ops/int4_matmul_pallas.py``.
``matmul_w4`` computes ``y = x @ dequant(packed, scale, chan)`` for ``x``
[B <= 64, in], ``packed`` uint8 [in/2, out] (input channels 2i and 2i+1 in
the low and high nibble of row i), ``scale`` fp32 [in/group, out] and
``chan`` fp32 [in] (``ops.quantization.quantize_int4_groupwise``). The
channel scales fold into the activations (x / chan in fp32, rounded to
bf16: the kernel does it as it builds its B fragments); a weight is
``float(nibble) * scale`` rounded to bf16; the products accumulate in fp32.
On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/int4_matmul.cu`` (bf16 ``mma.sync`` tensor-core products, the
weights as the A operand, dequantized in registers), counts the launch in
``int4_matmul_kernel.launches`` and raises if it is refused; nothing falls
back. On a CPU tensor ``matmul_w4`` is ``matmul_w4_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .quantization import _unnibble

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 64
TILE_COLS = 64          # out must be a multiple of this


def fold_chan(x: torch.Tensor, chan: torch.Tensor) -> torch.Tensor:
    """bf16(x / chan): the channel scales folded into the activations, in
    fp32, rounded once."""
    return (x.float() / chan.float()).to(torch.bfloat16)


def matmul_w4_plain(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, chan: torch.Tensor, group: int = 128,
                    weight_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: ``x_even . W_lo + x_odd .
    W_hi`` in fp32, each weight plane ``float(nibble) * scale`` rounded to
    ``weight_dtype``. ``bfloat16`` is what the kernel (and the TPU kernel)
    computes; ``float32`` skips the weight rounding, as the JAX kernel's
    interpret mode does."""
    n_in = x.shape[-1]
    if packed.shape[-2] * 2 != n_in:
        raise ValueError(f"packed rows {packed.shape[-2]} != in/2")
    if n_in % group:
        raise ValueError(f"in={n_in} not divisible by group={group}")
    xf = fold_chan(x, chan).float()
    srow = scale.float().repeat_interleave(group // 2, dim=0)  # [in/2, out]
    wlo = (_unnibble(packed & 0xF).float() * srow).to(weight_dtype).float()
    whi = (_unnibble(packed >> 4).float() * srow).to(weight_dtype).float()
    y = xf[:, 0::2] @ wlo + xf[:, 1::2] @ whi
    return y.to(x.dtype)


def _fn():
    f = build.load("int4_matmul").int4_matmul
    if f.argtypes is None:      # first use: pointers must not pass as int32
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"matmul_w4: {msg}")


def int4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor, chan: torch.Tensor,
                       group: int = 128) -> torch.Tensor:
    """[B, out] in x's dtype through the kernel."""
    tensors = (x, packed, scale, chan)
    _check(all(t.is_cuda for t in tensors), "every tensor must be on CUDA")
    _check(len({t.device for t in tensors}) == 1, "tensors on two devices")
    _check(x.dtype in _OUT_DTYPES, f"x dtype {x.dtype} (float32|bfloat16)")
    _check(packed.dtype == torch.uint8 and packed.dim() == 2,
           "packed must be uint8 [in/2, out]")
    _check(x.dim() == 2 and x.shape[1] == 2 * packed.shape[0],
           f"x {tuple(x.shape)} against packed {tuple(packed.shape)}")
    B, n_in = x.shape
    n_out = packed.shape[1]
    _check(group > 0 and group % 2 == 0 and n_in % group == 0,
           f"in={n_in} not divisible by an even group={group}")
    _check(scale.dtype == torch.float32
           and tuple(scale.shape) == (n_in // group, n_out),
           f"scale must be fp32 {(n_in // group, n_out)}")
    _check(chan.dtype == torch.float32 and chan.numel() == n_in
           and chan.is_contiguous(),
           f"chan must be fp32, contiguous, {n_in} long")
    _check(0 < B <= MAX_ROWS, f"{B} rows (1..{MAX_ROWS})")
    _check(n_out % TILE_COLS == 0, f"out={n_out} (multiple of {TILE_COLS})")
    # rows of `out` bytes / floats read as 4-byte and 16-byte vectors
    _check(packed.is_contiguous() and scale.is_contiguous()
           and packed.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0,
           "packed and scale must be contiguous and 16-byte aligned")
    xs = x.contiguous()
    y = torch.empty((B, n_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn()(xs.data_ptr(), chan.data_ptr(), packed.data_ptr(),
                   scale.data_ptr(), y.data_ptr(), B, n_in, n_out, group, _OUT_DTYPES[x.dtype],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    int4_matmul_kernel.launches += 1
    return y


int4_matmul_kernel.launches = 0


def matmul_w4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              chan: torch.Tensor, group: int = 128) -> torch.Tensor:
    """y = x @ dequant(packed, scale, chan), [B, out] in x's dtype: the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not x.is_cuda:
        return matmul_w4_plain(x, packed, scale, chan, group)
    return int4_matmul_kernel(x, packed, scale, chan, group)
