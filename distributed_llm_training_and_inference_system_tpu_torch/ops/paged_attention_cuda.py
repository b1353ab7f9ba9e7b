"""Wrappers of the hand-written Hopper paged-attention kernel.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``_extend_kernel`` of the JAX package's ``ops/paged_attention_pallas.py``
for its three page kinds: pages in q's dtype, int8 pages (``QuantPages``)
and packed-int4 pages (``Int4Pages``), the quantized ones dequantized in
the kernel. One wrapper per kind checks what it is given, allocates the
output, and launches on the current stream; each counts its launches in
``.launches`` (a plain integer that callers may reset), so a run can show
which kernel the serving path went through. None falls back: a launch that
is refused raises. The plain PyTorch version of the same function is
``ops.paged_attention.paged_attention_multi(impl="gather")``.

A call splits each slot's keys over several blocks; where a row tile has
more than one live split, its blocks (one thread block cluster) combine
their partials in split order through distributed shared memory, in the
same launch. ``split_plan`` fixes the split on the host from the table's
width, and the launcher follows it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KIND_FP, _KIND_INT8, _KIND_INT4 = 0, 1, 2
KEYS_PER_TILE = 64     # kKeys of csrc/paged_attention.cu
ROWS_PER_TILE = 8      # kRows: query rows (token, q head) of a block
MAX_SPLITS = 8         # kMaxSplits: a row tile's splits form one cluster
BLOCKS_PER_SM = 4      # the split aims at this many blocks an SM
H100_SMS = 132


def split_plan(B: int, T: int, Nq: int, Nkv: int, maxP: int, PS: int,
               sms: int = H100_SMS) -> dict:
    """How a call splits each slot's keys over blocks, from shapes alone
    (the table's width maxP*PS, never the lengths, so no sync).

    Without a split the grid has ``row_tiles * Nkv * B`` blocks. The keys
    of a full table, in tiles of KEYS_PER_TILE, are cut into splits of
    whole tiles, as few tiles a split as still give about BLOCKS_PER_SM
    blocks an SM over a full table, and at most MAX_SPLITS splits: a
    decode batch (T = 1) gets many splits, a long window (whose rows fill
    the card by themselves) one."""
    row_tiles = -(-T * (Nq // Nkv) // ROWS_PER_TILE)
    blocks = row_tiles * Nkv * B
    tiles = max(1, -(-maxP * PS // KEYS_PER_TILE))
    per_split = min(tiles, max(-(-tiles // MAX_SPLITS),
                               -(-tiles * blocks // (BLOCKS_PER_SM * sms))))
    n_splits = -(-tiles // per_split)
    return {"keys_per_split": per_split * KEYS_PER_TILE,
            "n_splits": n_splits, "row_tiles": row_tiles,
            "grid": (row_tiles * n_splits, Nkv, B)}


def split_ranges(plan: dict, start: int, T: int, G: int, maxP: int,
                 PS: int) -> list:
    """The key range [begin, end) of each live split of each row tile of a
    slot whose window starts at ``start``, as the kernel computes them:
    a row tile's keys end at min(start + its last token + 1, maxP*PS);
    a split is live if it starts before that end (split 0 always)."""
    kps = plan["keys_per_split"]
    out = []
    for rt in range(plan["row_tiles"]):
        last_row = min((rt + 1) * ROWS_PER_TILE, T * G) - 1
        n_keys = min(start + last_row // G + 1, maxP * PS)
        n_live = max(1, -(-n_keys // kps))
        out.append([(s * kps, max(0, min((s + 1) * kps, n_keys)))
                    for s in range(n_live)])
    return out


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn():
    f = build.load("paged_attention").paged_attention_fwd
    if f.argtypes is None:      # first use: pointers must not pass as int32
        f.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                      + [ctypes.c_float] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_kernel: {msg}")


def _launch(wrapper, kind, q, k_vals, v_vals, k_scale, v_scale, PS,
            block_tables, start_positions) -> torch.Tensor:
    """Checks shared by the three kinds, then the launch, counted on
    ``wrapper``. ``k_vals`` / ``v_vals`` are the stored value tensors;
    ``PS`` the logical page size."""
    quant = kind != _KIND_FP
    tensors = [q, k_vals, v_vals, block_tables, start_positions]
    if quant:
        tensors += [k_scale, v_scale]
    _check(all(t.is_cuda for t in tensors), "every tensor must be on CUDA")
    _check(len({t.device for t in tensors}) == 1, "tensors on two devices")
    _check(q.dtype in _DTYPES, f"q dtype {q.dtype} (float32|bfloat16)")
    _check(block_tables.dtype == torch.int32
           and start_positions.dtype == torch.int32, "int32 tables/starts")
    _check(q.dim() == 4 and k_vals.dim() == 4, "q [B,T,Nq,D], pages "
           "[NP,Nkv,PS,D]")
    B, T, Nq, D = q.shape
    NP, Nkv, rows, Dk = k_vals.shape
    _check(v_vals.shape == k_vals.shape, "k/v pages differ in shape")
    _check(rows * (2 if kind == _KIND_INT4 else 1) == PS,
           f"{rows} stored rows per page for a page size of {PS}")
    _check(Dk == D, f"head dim {D} vs pages {Dk}")
    _check(D % 8 == 0 and 0 < D <= 256, f"head dim {D} (multiple of 8, "
           "at most 256)")
    _check(Nq % Nkv == 0, f"Nq {Nq} not a multiple of Nkv {Nkv}")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B
           and start_positions.shape == (B,), "tables [B,maxP], starts [B]")
    if quant:
        _check(D % 16 == 0, f"head dim {D} of quantized pages (multiple "
               "of 16)")
        _check(k_scale.dtype == torch.float32
               and v_scale.dtype == torch.float32, "fp32 page scales")
        _check(tuple(k_scale.shape) == (NP, Nkv, PS)
               and tuple(v_scale.shape) == (NP, Nkv, PS),
               f"scales must be [NP,Nkv,PS] = {(NP, Nkv, PS)}")
        _check(all(t.data_ptr() % 4 == 0 for t in (k_scale, v_scale)),
               "scales must be 4-byte aligned")
    _check(all(t.is_contiguous() for t in tensors), "contiguous tensors")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_vals, v_vals)),
           "q and pages must be 16-byte aligned")
    maxP = block_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out
    plan = split_plan(B, T, Nq, Nkv, maxP, PS, _sms(q.device.index))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn()(q.data_ptr(), k_vals.data_ptr(), v_vals.data_ptr(),
                   k_scale.data_ptr() if quant else None,
                   v_scale.data_ptr() if quant else None,
                   block_tables.data_ptr(), start_positions.data_ptr(),
                   out.data_ptr(), B, T, Nq, Nkv, D, PS, maxP,
                   1.0 / float(D) ** 0.5, _DTYPES[q.dtype], kind,
                   plan["keys_per_split"], plan["n_splits"], stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def paged_attention_kernel(
    q: torch.Tensor,              # [B, T, Nq, D] bf16 | f32, contiguous
    k_pages: torch.Tensor,        # [NP, Nkv, PS, D], q's dtype, contiguous
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # [B, maxP] int32, contiguous
    start_positions: torch.Tensor,  # [B] int32 — position of q[:, 0]
) -> torch.Tensor:
    """[B, T, Nq, D] in q's dtype: query j of slot b attends causally over
    positions [0, start_b + j] through the slot's pages."""
    _check(isinstance(k_pages, torch.Tensor)
           and isinstance(v_pages, torch.Tensor)
           and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
           "pages must be tensors of q's dtype (quantized pages go through "
           "paged_attention_int8_kernel / paged_attention_int4_kernel)")
    return _launch(paged_attention_kernel, _KIND_FP, q, k_pages, v_pages,
                   None, None, k_pages.shape[2] if k_pages.dim() == 4 else 0,
                   block_tables, start_positions)


def paged_attention_int8_kernel(q, k_pages, v_pages, block_tables,
                                start_positions) -> torch.Tensor:
    """The same function over ``QuantPages``: values int8 [NP, Nkv, PS, D],
    scale fp32 [NP, Nkv, PS]."""
    from .paged_attention import Int4Pages, QuantPages
    _check(all(isinstance(p, QuantPages) and not isinstance(p, Int4Pages)
               for p in (k_pages, v_pages)), "k/v pages must be QuantPages")
    _check(k_pages.values.dtype == torch.int8
           and v_pages.values.dtype == torch.int8, "int8 page values")
    return _launch(paged_attention_int8_kernel, _KIND_INT8, q,
                   k_pages.values, v_pages.values, k_pages.scale,
                   v_pages.scale, k_pages.shape[2], block_tables,
                   start_positions)


def paged_attention_int4_kernel(q, k_pages, v_pages, block_tables,
                                start_positions) -> torch.Tensor:
    """The same function over ``Int4Pages``: values uint8 [NP, Nkv, PS/2,
    D] (two page slots per byte), scale fp32 [NP, Nkv, PS]."""
    from .paged_attention import Int4Pages
    _check(all(isinstance(p, Int4Pages) for p in (k_pages, v_pages)),
           "k/v pages must be Int4Pages")
    _check(k_pages.values.dtype == torch.uint8
           and v_pages.values.dtype == torch.uint8, "uint8 page values")
    return _launch(paged_attention_int4_kernel, _KIND_INT4, q,
                   k_pages.values, v_pages.values, k_pages.scale,
                   v_pages.scale, k_pages.shape[2], block_tables,
                   start_positions)


paged_attention_kernel.launches = 0
paged_attention_int8_kernel.launches = 0
paged_attention_int4_kernel.launches = 0


def paged_attention_launch(q, k_pages, v_pages, block_tables,
                           start_positions) -> torch.Tensor:
    """The wrapper for the kind of pages given (Int4Pages tested first)."""
    from .paged_attention import Int4Pages, QuantPages
    if isinstance(k_pages, Int4Pages):
        fn = paged_attention_int4_kernel
    elif isinstance(k_pages, QuantPages):
        fn = paged_attention_int8_kernel
    else:
        fn = paged_attention_kernel
    return fn(q, k_pages, v_pages, block_tables, start_positions)
