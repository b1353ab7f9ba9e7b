"""W8A16 matmul with in-kernel dequantization: wrappers and plain version.

Counterpart of the JAX package's ``ops/int8_matmul_pallas.py``. ``matmul_w8``
computes ``y = bf16(x * scale) . bf16(values)`` with fp32 accumulation for
``x`` [B <= 64, in], ``values`` int8 [in, out] and one fp32 ``scale`` per
input row ([in, 1] or [in]). On a CUDA tensor it launches the hand-written
tensor-core kernel of ``csrc/int8_matmul.cu`` (which folds the scale into
the activations itself) through one of its two entry points, chosen from
the shapes by the JAX package's predicate (``w8_route``): the
whole-reduction route, or the k-split route for wide reductions. Both run
one body: the reduction split over the blocks of a thread block cluster by
``split_plan`` and combined in split order on the chip, one launch a call,
so repeated calls give identical bits. Each wrapper counts its launches in
``.launches`` and raises when a launch is refused; nothing falls back. On a
CPU tensor ``matmul_w8`` is ``matmul_w8_plain``, which repeats the kernel's
arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 64
OUT_MULTIPLE = 64       # out must be a multiple of this (half a block's tile)
BLOCK_COLS = 128        # kBlockCols: output columns a block owns
K_STEP = 16             # kStepK: a split is whole k-steps of this many rows
MAX_SPLITS = 8          # kMaxSplits: a column tile's splits form one cluster
MIN_SPLIT_STEPS = 4     # a split walks at least this many k-steps
BLOCKS_PER_SM = 4       # the split aims at this many blocks an SM
H100_SMS = 132
_VMEM_BUDGET = 2 * 2 ** 20     # the JAX package's whole-K tile budget


def w8_route(n_in: int, n_out: int) -> str:
    """"whole_k" or "ksplit" for a [n_in, n_out] weight: the JAX package's
    choice between its two kernels (auto tile). Its third route, a dequant
    product for a wide reduction no k tile divides, does not exist here:
    the kernel takes any reduction length, so those shapes are
    "ksplit" too."""
    bo = next((b for b in (512, 256, 128)
               if n_out % b == 0 and n_in * b <= _VMEM_BUDGET),
              128 if n_out % 128 == 0 else n_out)
    bo = min(bo, n_out)
    bk = next((k for k in (2048, 1024, 512, 256)
               if n_in % k == 0 and k < n_in), 0)
    bo_k = next((b for b in (512, 256, 128) if n_out % b == 0), 0)
    if n_in * bo > _VMEM_BUDGET and not (bk and bo_k > bo):
        return "ksplit"
    if bo < 512 and n_in * 512 > _VMEM_BUDGET and bk and bo_k > bo:
        return "ksplit"
    return "whole_k"


def split_plan(n_in: int, n_out: int, sms: int = H100_SMS) -> dict:
    """How a call splits the reduction over blocks, from the shapes alone.

    The output's ``col_tiles`` tiles of BLOCK_COLS columns each take
    ``splits`` blocks (one cluster), split ``s`` over input rows
    ``[s * k_per_split, (s + 1) * k_per_split)`` clamped to ``n_in``: whole
    k-steps, as many splits as bring the grid to about BLOCKS_PER_SM blocks
    an SM, at most MAX_SPLITS, each at least MIN_SPLIT_STEPS k-steps long
    where the reduction allows, and none empty."""
    steps = -(-n_in // K_STEP)
    col_tiles = -(-n_out // BLOCK_COLS)
    splits = max(1, min(MAX_SPLITS, BLOCKS_PER_SM * sms // col_tiles,
                        steps // MIN_SPLIT_STEPS))
    per = -(-steps // splits)
    splits = -(-steps // per)
    return {"k_per_split": per * K_STEP, "splits": splits,
            "col_tiles": col_tiles, "grid": col_tiles * splits}


def split_ranges(plan: dict, n_in: int) -> list:
    """The input-row range [begin, end) of each split, as the kernel
    computes them."""
    kps = plan["k_per_split"]
    return [(s * kps, min((s + 1) * kps, n_in))
            for s in range(plan["splits"])]


def fold_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """bf16(x * scale): the per-input-row scale folded into the
    activations, in fp32, rounded once."""
    return (x.float() * scale.reshape(-1).float()).to(torch.bfloat16)


def matmul_w8_plain(x: torch.Tensor, values: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: the folded bf16
    activations times the int8 values, both widened to fp32 (exact), summed
    in fp32, cast to x's dtype."""
    y = fold_scale(x, scale).float() @ values.float()
    return y.to(x.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"matmul_w8: {msg}")


def _prepare(x, values, scale):
    _check(x.is_cuda and values.is_cuda and scale.is_cuda,
           "every tensor must be on CUDA")
    _check(len({x.device, values.device, scale.device}) == 1,
           "tensors on two devices")
    _check(x.dtype in _OUT_DTYPES, f"x dtype {x.dtype} (float32|bfloat16)")
    _check(values.dtype == torch.int8 and values.dim() == 2,
           "values must be int8 [in, out]")
    _check(x.dim() == 2 and x.shape[1] == values.shape[0],
           f"x {tuple(x.shape)} against values {tuple(values.shape)}")
    B, n_in = x.shape
    n_out = values.shape[1]
    _check(scale.numel() == n_in, f"scale {tuple(scale.shape)} for in={n_in}")
    _check(0 < B <= MAX_ROWS, f"{B} rows (1..{MAX_ROWS})")
    _check(n_out % OUT_MULTIPLE == 0,
           f"out={n_out} (multiple of {OUT_MULTIPLE})")
    _check(values.is_contiguous() and values.data_ptr() % 16 == 0,
           "values must be contiguous and 16-byte aligned")
    _check(scale.dtype == torch.float32 and scale.is_contiguous(),
           "scale must be fp32 and contiguous")
    y = torch.empty((B, n_out), dtype=x.dtype, device=x.device)
    return x.contiguous(), y, B, n_in, n_out


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(name: str, x, values, scale) -> torch.Tensor:
    xs, y, B, n_in, n_out = _prepare(x, values, scale)
    plan = split_plan(n_in, n_out, _sms(x.device.index))
    f = getattr(build.load("int8_matmul"), name)
    if f.argtypes is None:      # first use: pointers must not pass as int32
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = f(xs.data_ptr(), scale.data_ptr(), values.data_ptr(),
               y.data_ptr(), B, n_in, n_out, plan["k_per_split"],
               plan["splits"], _OUT_DTYPES[x.dtype],
               torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return y


def int8_matmul_kernel(x: torch.Tensor, values: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The whole-reduction route: [B, out] in x's dtype."""
    y = _launch("int8_matmul_whole_k", x, values, scale)
    build.count_launch(int8_matmul_kernel)
    return y


def int8_matmul_ksplit_kernel(x: torch.Tensor, values: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """The k-split route: [B, out] in x's dtype."""
    y = _launch("int8_matmul_ksplit", x, values, scale)
    build.count_launch(int8_matmul_ksplit_kernel)
    return y


int8_matmul_kernel.launches = 0
int8_matmul_ksplit_kernel.launches = 0


def matmul_w8(x: torch.Tensor, values: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """y = x @ (values * scale), [B, out] in x's dtype: a kernel on a CUDA
    tensor (which one: ``w8_route``), the plain version on a CPU tensor."""
    if not x.is_cuda:
        return matmul_w8_plain(x, values, scale)
    if w8_route(values.shape[0], values.shape[1]) == "ksplit":
        return int8_matmul_ksplit_kernel(x, values, scale)
    return int8_matmul_kernel(x, values, scale)
