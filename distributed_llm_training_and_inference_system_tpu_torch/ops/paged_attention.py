"""Paged attention over a block-table-indexed KV cache.

Counterpart of the JAX package's ``ops/paged_attention.py``. KV lives in
fixed-size pages, per layer ``[num_pages, Nkv, page_size, D]``; each slot
owns a row of the block table ``[B, maxP]``; unused entries point at the
reserved scratch page 0. Pages are a plain tensor in the compute dtype, or
quantized: ``QuantPages`` (int8 values and one fp32 scale per token and kv
head) or ``Int4Pages`` (two page slots per byte, the same scale tile).
Every ``isinstance`` chain tests ``Int4Pages`` first (it subclasses
``QuantPages``). Writes quantize on the way in and update both tensors in
place.

``impl``: ``"auto"`` sends a CUDA tensor to the hand-written kernel
(``ops/paged_attention_cuda.py``) and a CPU tensor to the plain PyTorch
gather version below; ``"cuda"`` and ``"gather"`` force one of them. There
is no fallback from the kernel to the gather path: a CUDA tensor that the
kernel refuses raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.layers import NEG_INF
from .quantization import (QuantTensor, dequantize_int4_rows,
                           dequantize_int8_rows, pack_int4_rows,
                           quantize_int4_rows, quantize_int8_rows,
                           unpack_int4_rows)


class QuantPages(QuantTensor):
    """int8 KV pages and per-token absmax scales: values [..., NP, Nkv,
    PS, D] int8, scale [..., NP, Nkv, PS] fp32 (no trailing singleton: the
    row scale broadcasts over D explicitly). Indexing a layer
    (``pages[i]``) gives views of both tensors, so in-place writes reach
    the pool."""

    def __getitem__(self, i):
        return type(self)(self.values[i], self.scale[i])

    def dequant(self, dtype=torch.float32):
        return dequantize_int8_rows(self.values, self.scale, dtype)


class Int4Pages(QuantPages):
    """Packed-int4 KV pages: values uint8 [..., NP, Nkv, PS/2, D] (two
    consecutive page slots per byte, low nibble = even slot), scale fp32
    [..., NP, Nkv, PS]. ``shape`` reports the LOGICAL [..., NP, Nkv, PS, D]
    geometry."""

    @property
    def shape(self):
        s = self.values.shape
        return (*s[:-2], s[-2] * 2, s[-1])

    def dequant(self, dtype=torch.float32):
        return dequantize_int4_rows(self.values, self.scale, dtype)


def quantize_kv_token(new_kv: torch.Tensor):
    """Per-(row, head) absmax int8 of a token's K or V [..., Nkv, D] ->
    (int8 values, fp32 scale [..., Nkv])."""
    return quantize_int8_rows(new_kv)


def quantize_kv_token_int4(new_kv: torch.Tensor):
    """int4 sibling of quantize_kv_token: (UNPACKED int8 values in [-7, 7],
    fp32 scale [..., Nkv]); packing happens where the page is written."""
    return quantize_int4_rows(new_kv)


def _impl(impl: str, t: torch.Tensor) -> str:
    if impl == "auto":
        return "cuda" if t.is_cuda else "gather"
    if impl not in ("cuda", "gather"):
        raise ValueError(f"unknown paged-attention impl {impl!r} "
                         "(auto|cuda|gather)")
    return impl


def _gather_pages(pages, block_tables: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[NP, Nkv, PS, D] through tables [B, maxP] -> [B, Nkv, maxP*PS, D].
    Quantized pages dequantize right after the gather (fp32 product,
    cast to ``dtype``)."""
    B, maxP = block_tables.shape
    _NP, Nkv, PS, D = pages.shape
    idx = block_tables.long()
    if isinstance(pages, Int4Pages):
        vals = unpack_int4_rows(pages.values[idx], axis=-2)
        g = (vals.float() * pages.scale[idx][..., None]).to(dtype)
    elif isinstance(pages, QuantPages):
        g = (pages.values[idx].float()
             * pages.scale[idx][..., None]).to(dtype)
    else:
        g = pages[idx]                               # [B, maxP, Nkv, PS, D]
    return g.permute(0, 2, 1, 3, 4).reshape(B, Nkv, maxP * PS, D)


def paged_attention_multi(
    q: torch.Tensor,                 # [B, T, Nq, D] — T consecutive tokens
    k_pages: torch.Tensor,           # [NP, Nkv, PS, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,      # [B, maxP]
    start_positions: torch.Tensor,   # [B] — position of q[:, 0]
    impl: str = "auto",
) -> torch.Tensor:
    """Query j of slot b attends causally over [0, start_b + j] through the
    pages (the window's own K/V must already be written). Returns
    [B, T, Nq, D] in q's dtype.

    The gather version is the JAX package's fallback: each of the B*T
    flattened rows (b, j) attends over slot b's gathered prefix masked to
    length start_b + j + 1, softmax in fp32. The gather is done once per
    slot and shared by its T rows, which computes the same row-wise
    products as gathering per flattened row."""
    if _impl(impl, q) == "cuda":
        from .paged_attention_cuda import paged_attention_launch
        return paged_attention_launch(
            q.contiguous(), k_pages, v_pages,
            block_tables.to(torch.int32).contiguous(),
            start_positions.to(torch.int32).contiguous())
    B, T, Nq, D = q.shape
    Nkv = k_pages.shape[1]
    groups = Nq // Nkv
    k = _gather_pages(k_pages, block_tables, q.dtype)
    v = _gather_pages(v_pages, block_tables, q.dtype)
    L = k.shape[2]
    qg = q.reshape(B, T, Nkv, groups, D)
    # products of the operands widened to fp32 (exact for bf16 inputs):
    # the fp32-accumulated einsum of the JAX version
    scores = torch.einsum("btngd,bnkd->btngk", qg.float(), k.float())
    scores = scores / math.sqrt(D)
    lengths = (start_positions.long()[:, None]
               + torch.arange(T, device=q.device) + 1)          # [B, T]
    valid = torch.arange(L, device=q.device) < lengths[:, :, None]
    scores = scores.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("btngk,bnkd->btngd", probs, v)
    return out.reshape(B, T, Nq, D).to(q.dtype)


def paged_attention(
    q: torch.Tensor,              # [B, Nq, D] — one query token per slot
    k_pages: torch.Tensor,        # [NP, Nkv, PS, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,   # [B, maxP]
    lengths: torch.Tensor,        # [B] — attend over [0, lengths)
    impl: str = "auto",
) -> torch.Tensor:
    """Decode attention, the T = 1 case of ``paged_attention_multi`` (one
    implementation, so decode and extend can never diverge). Returns
    [B, Nq, D] in q's dtype."""
    out = paged_attention_multi(q[:, None], k_pages, v_pages, block_tables,
                                lengths - 1, impl=impl)
    return out[:, 0]


def _write_window_int4(pages: Int4Pages, new_kv, block_tables,
                       start_positions, write_ok) -> Int4Pages:
    """The window write for packed-int4 pages of T >= 2 tokens. Two tokens
    share a byte, so the slot's two staging pages are unpacked, the
    window's freshly quantized rows selected in, and the whole pages
    repacked and written back: both nibbles of a byte come from one merge.
    A staging page that is the scratch page 0 takes no row and is written
    back as it was."""
    B, T, Nkv, D = new_kv.shape
    _NP, _, PS, _ = pages.shape
    maxP = block_tables.shape[1]
    dev = new_kv.device
    n_stage = 2
    start = start_positions.long()
    tables = block_tables.long()
    p0 = (start // PS).clamp(0, maxP - 1)                       # [B]
    lp = torch.stack([p0, (p0 + 1).clamp(0, maxP - 1)], 1)      # [B, 2]
    phys = torch.gather(tables, 1, lp)
    # window entirely in the last logical page: the second half would
    # rewrite the same page with stale content; send it to scratch
    phys[:, 1] = torch.where(lp[:, 1] == lp[:, 0],
                             torch.zeros_like(phys[:, 1]), phys[:, 1])
    off0 = start - p0 * PS                                      # [B]
    off = off0[:, None] + torch.arange(T, device=dev)           # [B, T]
    ok = (torch.ones(B, T, dtype=torch.bool, device=dev)
          if write_ok is None else write_ok.to(dev))
    tok_half = (off // PS).clamp(0, n_stage - 1)
    ok = ok & (torch.gather(phys, 1, tok_half) != 0)
    # staging position s takes window token s - off0 where that token is ok
    t_of_s = torch.arange(n_stage * PS, device=dev)[None] - off0[:, None]
    in_win = (t_of_s >= 0) & (t_of_s < T)
    t_idx = t_of_s.clamp(0, T - 1)                              # [B, nPS]
    hit = in_win & torch.gather(ok, 1, t_idx)

    def merge(staging, rows):
        """staging [B, n, Nkv, PS, X] <- rows [B, T, Nkv, X] at ``hit``;
        returns [B*n, Nkv, PS, X]."""
        X = rows.shape[-1]
        stag = staging.transpose(2, 3).reshape(B, n_stage * PS, Nkv, X)
        upd = torch.gather(
            rows, 1, t_idx[:, :, None, None].expand(-1, -1, Nkv, X))
        merged = torch.where(hit[:, :, None, None], upd, stag)
        return merged.reshape(B, n_stage, PS, Nkv, X).transpose(
            2, 3).reshape(B * n_stage, Nkv, PS, X)

    qv, qs = quantize_kv_token_int4(new_kv)     # [B,T,Nkv,D] i8, [B,T,Nkv]
    staging = unpack_int4_rows(pages.values[phys], axis=-2)
    packed = pack_int4_rows(merge(staging, qv), axis=-2)
    scales = merge(pages.scale[phys][..., None], qs[..., None])[..., 0]
    flat = phys.reshape(-1)
    pages.values[flat] = packed
    pages.scale[flat] = scales
    return pages


def write_window_to_pages(
    pages,                        # [NP, Nkv, PS, D] — updated IN PLACE
    new_kv: torch.Tensor,         # [B, T, Nkv, D] — T consecutive tokens
    block_tables: torch.Tensor,   # [B, maxP]
    start_positions: torch.Tensor,  # [B] — position of new_kv[:, 0]
    write_ok: Optional[torch.Tensor] = None,  # [B, T] bool
):
    """Write a window of T <= PS tokens per slot into its pages, in place
    (``index_put_``), and return ``pages``.

    Same result, page for page, as the JAX whole-page merge: a token is
    written only where ``write_ok`` holds, its logical page lies inside the
    table, and its table entry is not the scratch page 0; every other row
    re-writes page 0 with page 0's own content, so page 0 is left as it
    was. No host synchronisation: masked rows are redirected, not
    filtered. ``QuantPages`` quantize the window's rows once and scatter
    values and scales the same way. ``Int4Pages`` splice a single token's
    nibble into its byte (T = 1) or merge whole pages (T >= 2,
    ``_write_window_int4``)."""
    B, T, Nkv, D = new_kv.shape
    _NP, _, PS, _ = pages.shape
    maxP = block_tables.shape[1]
    if T > PS:
        raise ValueError(f"window {T} exceeds page size {PS}")
    if isinstance(pages, Int4Pages) and T > 1:
        return _write_window_int4(pages, new_kv, block_tables,
                                  start_positions, write_ok)
    dev = new_kv.device
    pos = start_positions.long()[:, None] + torch.arange(T, device=dev)
    logical = pos // PS
    ok = (logical >= 0) & (logical < maxP)
    if write_ok is not None:
        ok = ok & write_ok.to(dev)
    phys = torch.gather(block_tables.long(), 1, logical.clamp(0, maxP - 1))
    ok = ok & (phys != 0)
    phys = torch.where(ok, phys, torch.zeros_like(phys))
    off = pos % PS
    if isinstance(pages, Int4Pages):
        # T = 1 (decode): one nibble per slot, spliced into the byte it
        # shares with its neighbour; no two live rows share a byte, and a
        # masked row writes page 0's byte back as it was
        qv, qs = quantize_kv_token_int4(new_kv)
        nib = (qv.to(torch.int16) & 0xF).to(torch.uint8)
        byte = off // 2
        cur = pages.values[phys, :, byte]                     # [B,1,Nkv,D]
        spliced = torch.where((off % 2 == 0)[:, :, None, None],
                              (cur & 0xF0) | nib, (cur & 0x0F) | (nib << 4))
        pages.values[phys, :, byte] = torch.where(ok[:, :, None, None],
                                                  spliced, cur)
        pages.scale[phys, :, off] = torch.where(
            ok[:, :, None], qs, pages.scale[phys, :, off])
        return pages
    if isinstance(pages, QuantPages):
        qv, qs = quantize_kv_token(new_kv)      # [B,T,Nkv,D] i8, [B,T,Nkv]
        pages.values[phys, :, off] = torch.where(
            ok[:, :, None, None], qv, pages.values[phys, :, off])
        pages.scale[phys, :, off] = torch.where(
            ok[:, :, None], qs, pages.scale[phys, :, off])
        return pages
    old = pages[phys, :, off]                                 # [B, T, Nkv, D]
    pages[phys, :, off] = torch.where(ok[:, :, None, None],
                                      new_kv.to(pages.dtype), old)
    return pages


def write_token_to_pages(
    pages,                        # [NP, Nkv, PS, D] — updated IN PLACE
    new_kv: torch.Tensor,         # [B, Nkv, D]
    block_tables: torch.Tensor,   # [B, maxP]
    positions: torch.Tensor,      # [B] — slot-local position to write
    active: Optional[torch.Tensor] = None,  # [B] bool
):
    """Scatter one token per row into its page, in place (``index_put_``),
    and return ``pages``. Rows whose table entry is the scratch page 0, or
    whose ``active`` flag is False, write into page 0 instead of a page
    beyond the block table. Quantized pages get the token quantized per
    (row, head) on the way in.

    ``Int4Pages``: a token's nibble is spliced into the byte it shares
    with its neighbour. Rows 2i and 2i+1 of one slot (a suffix prefill
    flattens B*T rows into one call) share a byte, and a single scatter
    would build both from the old byte and keep one; so the even slots
    are written first and the odd slots second, each over what the other
    left (the rows of the other parity go to scratch meanwhile)."""
    PS = pages.shape[2]
    maxP = block_tables.shape[1]
    positions = positions.long()
    logical = (positions // PS).clamp(0, maxP - 1)
    offset = positions % PS
    phys = torch.gather(block_tables.long(), 1, logical[:, None])[:, 0]
    if active is not None:
        phys = torch.where(active.to(phys.device), phys,
                           torch.zeros_like(phys))
    if isinstance(pages, Int4Pages):
        qv, scale = quantize_kv_token_int4(new_kv)        # [B,Nkv,D] i8
        nib = (qv.to(torch.int16) & 0xF).to(torch.uint8)
        byte = offset // 2
        for parity in (0, 1):
            mine = (offset % 2) == parity
            ph = torch.where(mine, phys, torch.zeros_like(phys))
            cur = pages.values[ph, :, byte]               # [B,Nkv,D] u8
            pages.values[ph, :, byte] = (
                (cur & 0xF0) | nib if parity == 0
                else (cur & 0x0F) | (nib << 4))
        pages.scale[phys, :, offset] = scale
        return pages
    # rows sent to one (page, offset), the scratch page's above all, all
    # write the last such row's values: the JAX scatter's last-wins result,
    # and the same bits every run on a card, where an index_put_ with
    # duplicate indices keeps an arbitrary one (idle rows of an MoE batch
    # read scratch page 0, and their routing takes capacity)
    new_kv = new_kv[_last_writer(phys * PS + offset, pages.shape[0] * PS)]
    if isinstance(pages, QuantPages):
        qv, scale = quantize_kv_token(new_kv)
        pages.values[phys, :, offset] = qv
        pages.scale[phys, :, offset] = scale
        return pages
    pages[phys, :, offset] = new_kv.to(pages.dtype)
    return pages


def _last_writer(key: torch.Tensor, n_keys: int) -> torch.Tensor:
    """For rows writing at ``key`` [R] (in [0, n_keys)), the index of the
    last row that writes the same key (an integer scatter-max: exact, no
    host synchronisation)."""
    rows = torch.arange(key.numel(), device=key.device)
    last = torch.full((n_keys,), -1, dtype=torch.int64, device=key.device)
    last.scatter_reduce_(0, key, rows, reduce="amax")
    return last[key]
