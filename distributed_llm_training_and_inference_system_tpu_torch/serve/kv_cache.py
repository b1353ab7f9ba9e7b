"""Paged KV cache: device-resident pages + host-side page allocator.

Counterpart of the JAX package's ``serve/kv_cache.py``:

- All layers' pages live in two buffers [L, num_pages, Nkv, page_size, D]
  on the device, allocated once: plain tensors in the compute dtype, or
  with ``quantized="int8"`` / ``"int4"`` the ``QuantPages`` / ``Int4Pages``
  of ``ops.paged_attention`` (values and per-token scales).
- Page 0 is reserved scratch: every unused block-table entry points at it,
  so a decode step can run over ALL slots; inactive slots read garbage
  that their length mask hides and write nowhere that matters.
- Allocation and free are host-side integer bookkeeping; the device only
  sees the dense ``block_tables`` array.
- Prefix cache: full pages are published under a chain hash of the prefix
  they complete; a page is in exactly one of free, referenced (ref > 0),
  or evictable (ref == 0, content kept, LRU order).

- Swap payloads: ``extract_slot`` / ``extract_slot_pages`` /
  ``extract_pages`` copy pages to the host, ``restore_slot`` /
  ``write_slot_pages`` write them back in place. A payload is
  ``{"k", "v", "num_pages"}``; each of k and v is one tensor [L, n, Nkv,
  PS, D] in the pool's dtype, or for a quantized pool a ``{"values",
  "scale"}`` dict (int8 values [L, n, Nkv, PS, D], or int4 packed uint8
  [L, n, Nkv, PS/2, D]; fp32 scale [L, n, Nkv, PS]).

Host form of a payload: CPU torch tensors. On a card they are pinned and
filled by one asynchronous device-to-host copy per tensor on the current
stream, so a swap-out does not wait for the decode work queued before it;
a restore, queued on the same stream, needs no synchronisation, and a host
reader goes through ``payload_numpy``, which synchronises first. The JAX
package's payload holds numpy arrays of the same shapes and bytes:
``payload_numpy`` gives them, with a bf16 tensor as its ``uint16`` view
(numpy has no bf16 without ``ml_dtypes``; JAX's bf16 array viewed as
``uint16`` holds the same bytes). A restore takes either form, a
``uint16`` numpy array standing for bf16 pages.

The fleet-only helpers of the JAX module (prefix-page insert, inventory,
demotion) are not ported yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..ops.paged_attention import Int4Pages, QuantPages


def _host_tensor(data, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A payload array as a CPU or device tensor: a tensor as it is, a
    numpy array through ``torch.from_numpy`` (a ``uint16`` array taken as
    the bits of bf16 when ``dtype`` is bf16)."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.array(data, copy=True)     # a tensor may not alias read-only
    if arr.dtype == np.uint16 and dtype == torch.bfloat16:
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(arr)


def payload_bytes(content: dict) -> int:
    """Host bytes of a payload's page tensors."""
    return sum(t.nbytes for part in (content["k"], content["v"])
               for t in (part.values() if isinstance(part, dict)
                         else (part,)))


def payload_numpy(content: dict) -> dict:
    """A payload with every tensor copied into a numpy array (bf16 as its
    ``uint16`` view): the JAX package's payload form. Synchronises the card
    first, since an extract fills its tensors asynchronously; the copies
    leave the pinned buffers free to return to PyTorch's cache."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if node.dtype == torch.bfloat16:
            node = node.view(torch.uint16)
        return node.cpu().numpy().copy()
    return {"k": conv(content["k"]), "v": conv(content["v"]),
            "num_pages": int(content["num_pages"])}


def prefix_page_hashes(tokens, page_size: int) -> list[bytes]:
    """Chain hashes for every FULL page of a token prefix: ``h_i`` digests
    tokens[0 : (i+1)*page_size] through the chain, because a page's K/V
    depend on the entire prefix. Bit-identical to the JAX package's."""
    arr = np.asarray(tokens, np.int32)
    out, h = [], b""
    for i in range(len(arr) // page_size):
        h = hashlib.blake2b(
            h + arr[i * page_size:(i + 1) * page_size].tobytes(),
            digest_size=16).digest()
        out.append(h)
    return out


class PagedKVCache:
    def __init__(
        self,
        cfg,
        num_slots: int,
        max_seq_len: int,
        page_size: int = 16,
        num_pages: int = 0,
        hbm_budget_gb: float = 4.0,
        dtype=torch.bfloat16,
        device=None,
        quantized=False,        # False|"none" | True|"int8" | "int4"
    ):
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.page_size = page_size
        self.max_pages_per_slot = math.ceil(max_seq_len / page_size)
        # normalise the quantization kind: a bare True means int8
        if quantized is True:
            kind = "int8"
        elif not quantized or quantized == "none":
            kind = "none"
        else:
            kind = str(quantized)
        if kind not in ("none", "int8", "int4"):
            raise ValueError(f"unknown KV quantization {quantized!r} "
                             "(none|int8|int4)")
        if kind == "int4" and page_size % 2:
            raise ValueError(
                f"int4 KV pages pack two page slots per byte; page_size "
                f"{page_size} must be even")
        self.quant_kind = kind
        self.quantized = kind != "none"
        if num_pages <= 0:
            # auto-size from the device-memory budget (K and V, all
            # layers); a quantized row is its values (D or D/2 bytes) plus
            # one fp32 scale per (token, kv head)
            if kind == "int4":
                row_bytes = cfg.head_dim // 2 + 4
            elif kind == "int8":
                row_bytes = cfg.head_dim + 4
            else:
                row_bytes = (cfg.head_dim
                             * torch.empty((), dtype=dtype).element_size())
            bytes_per_page = (2 * cfg.num_layers * page_size
                              * cfg.num_kv_heads * row_bytes)
            num_pages = max(int(hbm_budget_gb * 1e9 // bytes_per_page), 2)
        # never more than every slot fully resident (+1 scratch)
        num_pages = min(num_pages, num_slots * self.max_pages_per_slot + 1)
        self.num_pages = num_pages
        self.dtype = dtype
        self.device = device

        shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size,
                 cfg.head_dim)
        self.k_pages = self._new_pages(shape)
        self.v_pages = self._new_pages(shape)

        # host-side state; page 0 is scratch and never allocated
        self._free: list[int] = list(range(1, num_pages))
        self._owned: dict[int, list[int]] = {}            # slot -> pages
        self._chain_len: dict[int, int] = {}   # slot -> table entries used
        self.block_tables = np.zeros((num_slots, self.max_pages_per_slot),
                                     np.int32)

        # prefix cache: refcounted shared pages + LRU of evictable ones
        self._ref = np.zeros(num_pages, np.int32)
        self._hash_to_page: dict[bytes, int] = {}
        self._page_to_hash: dict[int, bytes] = {}
        self._evictable: OrderedDict[int, None] = OrderedDict()
        self.prefix_hits = 0          # pages served from cache
        self.prefix_queries = 0       # full pages looked up

    def _new_pages(self, shape):
        """A zeroed page buffer of the cache's kind. ``shape`` is the
        LOGICAL [L, NP, Nkv, PS, D]; the int4 buffer stores PS/2 bytes along
        the page-slot axis and the full per-slot scale tile."""
        dev = self.device
        if self.quant_kind == "int4":
            return Int4Pages(
                torch.zeros((*shape[:-2], shape[-2] // 2, shape[-1]),
                            dtype=torch.uint8, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        if self.quant_kind == "int8":
            return QuantPages(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        return torch.zeros(shape, dtype=self.dtype, device=dev)

    # -- accounting ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._evictable)

    def pages_needed(self, num_tokens: int) -> int:
        return math.ceil(max(num_tokens, 1) / self.page_size)

    def can_ever_allocate(self, num_tokens: int) -> bool:
        """Whether an EMPTY cache could hold this many tokens (page 0 is
        reserved scratch)."""
        return self.pages_needed(num_tokens) <= self.num_pages - 1

    def hbm_bytes(self) -> int:
        def one(buf):
            parts = buf.tensors() if self.quantized else (buf,)
            return sum(t.numel() * t.element_size() for t in parts)
        return one(self.k_pages) + one(self.v_pages)

    # -- alloc / grow / free -------------------------------------------------

    def _take_free_page(self) -> int:
        """Pop a free page, evicting the LRU cached page if needed."""
        if self._free:
            return self._free.pop()
        if self._evictable:
            page, _ = self._evictable.popitem(last=False)   # oldest first
            h = self._page_to_hash.pop(page, None)
            if h is not None:
                self._hash_to_page.pop(h, None)
            return page
        raise RuntimeError("KV cache OOM: no free or evictable pages")

    def _drop_ref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] <= 0:
            self._ref[page] = 0
            if page in self._page_to_hash:
                self._evictable[page] = None    # keep content, reclaimable
            else:
                self._free.append(page)

    def allocate(self, slot: int, num_tokens: int,
                 prefix_pages: Optional[list[int]] = None) -> None:
        """Give ``slot`` enough pages for ``num_tokens`` tokens.
        ``prefix_pages`` (already pinned via ``pin_pages``) become the head
        of the slot's block table; only the remainder is freshly
        allocated."""
        prefix_pages = prefix_pages or []
        need = self.pages_needed(num_tokens)
        fresh = need - len(prefix_pages)
        if fresh > self.free_pages:
            raise RuntimeError(
                f"KV cache OOM: need {fresh} pages, {self.free_pages} free")
        pages = [self._take_free_page() for _ in range(fresh)]
        for p in pages:
            self._ref[p] = 1
        # the slot owns refs on fresh pages only; prefix pins are tracked
        # by the engine per request and dropped via unpin_pages
        self._owned[slot] = pages
        table = list(prefix_pages) + pages
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :len(table)] = table
        self._chain_len[slot] = len(table)

    def extend_slot(self, slot: int, num_tokens: int) -> bool:
        """Grow ``slot``'s chain to cover ``num_tokens``. All or nothing:
        returns False, allocating nothing, if the pool cannot supply every
        page needed (the engine then preempts a victim and retries)."""
        need = self.pages_needed(num_tokens) - self._chain_len.get(slot, 0)
        if need <= 0:
            return True
        if need > self.free_pages:
            return False
        start = self._chain_len.get(slot, 0)
        pages = [self._take_free_page() for _ in range(need)]
        for p in pages:
            self._ref[p] = 1
        self._owned.setdefault(slot, []).extend(pages)
        self.block_tables[slot, start:start + need] = pages
        self._chain_len[slot] = start + need
        return True

    def release(self, slot: int) -> None:
        for page in self._owned.pop(slot, []):
            self._drop_ref(page)
        self.block_tables[slot, :] = 0
        self._chain_len.pop(slot, None)

    # -- swap (preemption to host memory) ------------------------------------

    def extract_slot(self, slot: int) -> dict:
        """Copy ``slot``'s pages to host memory (the swap-out half of
        preemption=swap): one device gather and one device-to-host copy a
        tensor."""
        return self.extract_slot_pages(slot, 0, self._chain_len.get(slot, 0))

    def extract_slot_pages(self, slot: int, lo: int, hi: int) -> dict:
        """Copy chain entries [lo, hi) of ``slot`` to host memory. Bounds
        are checked first: an out-of-range request would otherwise gather
        scratch page 0 and present it as real K/V."""
        chain = self._chain_len.get(slot, 0)
        if not 0 <= lo <= hi <= chain:
            raise ValueError(
                f"extract_slot_pages: range [{lo}, {hi}) outside slot "
                f"{slot}'s chain of {chain} page(s)")
        return self._extract_pages_idx(self.block_tables[slot, lo:hi].copy())

    def extract_pages(self, pages: list[int]) -> dict:
        """Copy arbitrary page ids to host memory (same payload schema).
        Scratch page 0 and ids outside the pool are refused."""
        bad = [int(p) for p in pages if not 0 < int(p) < self.num_pages]
        if bad:
            raise ValueError(
                f"extract_pages: page id(s) {bad} outside (0, "
                f"{self.num_pages})")
        return self._extract_pages_idx(np.asarray(pages, np.int64))

    def _extract_pages_idx(self, pages: np.ndarray) -> dict:
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=self.device)
        on_card = torch.device(self.device).type == "cuda"

        def grab(t: torch.Tensor) -> torch.Tensor:
            picked = t.index_select(1, idx)          # one gather, on device
            if not on_card:
                return picked
            host = torch.empty(picked.shape, dtype=picked.dtype,
                               pin_memory=True)
            return host.copy_(picked, non_blocking=True)

        def part(buf):
            if isinstance(buf, QuantPages):
                return {"values": grab(buf.values), "scale": grab(buf.scale)}
            return grab(buf)
        return {"k": part(self.k_pages), "v": part(self.v_pages),
                "num_pages": int(len(pages))}

    def restore_slot(self, slot: int, content: dict) -> bool:
        """Swap-in: allocate fresh pages for the slot and write the saved
        K/V back. Returns False, allocating nothing, when the pool cannot
        supply the pages (the caller falls back to recompute). The payload
        is validated before anything is allocated, so a malformed one
        raises with no page taken."""
        n = self._validate_pages_content(content)
        if n > self.free_pages:
            return False
        self.allocate(slot, n * self.page_size)
        self.write_slot_pages(slot, content)
        return True

    def _validate_payload(self, slot: int, content: dict, lo: int) -> int:
        """Schema and bounds check of a restore payload; returns its page
        count. Bounds before shapes, so a wrong page count names the
        slot's chain rather than a derived shape mismatch."""
        n = self._parse_num_pages(content)
        chain = self._chain_len.get(slot, 0)
        if lo < 0 or lo + n > chain:
            raise ValueError(
                f"restore payload covers chain entries [{lo}, {lo + n}) "
                f"but slot {slot} owns only {chain} page(s)")
        self._validate_pages_shapes(content, n)
        return n

    def _validate_pages_content(self, content: dict) -> int:
        """Schema and shape check with no slot bounds; the page count."""
        n = self._parse_num_pages(content)
        self._validate_pages_shapes(content, n)
        return n

    @staticmethod
    def _parse_num_pages(content) -> int:
        if not isinstance(content, dict) or "num_pages" not in content \
                or "k" not in content or "v" not in content:
            got = (sorted(content) if isinstance(content, dict)
                   else type(content).__name__)
            raise ValueError(
                "restore payload must be a dict with 'k', 'v' and "
                f"'num_pages'; got keys {got}")
        try:
            n = int(content["num_pages"])
        except (TypeError, ValueError):
            raise ValueError(
                f"restore payload num_pages must be an int, got "
                f"{content['num_pages']!r}") from None
        if n < 0:
            raise ValueError(f"restore payload num_pages {n} < 0")
        return n

    def _validate_pages_shapes(self, content: dict, n: int) -> None:
        cfg = self.cfg
        expect = (cfg.num_layers, n, cfg.num_kv_heads, self.page_size,
                  cfg.head_dim)
        for name, buf in (("k", self.k_pages), ("v", self.v_pages)):
            data = content[name]
            if isinstance(buf, QuantPages):
                if not isinstance(data, dict) or "values" not in data \
                        or "scale" not in data:
                    raise ValueError(
                        f"restore payload '{name}' must be a quantized "
                        "{values, scale} dict for a "
                        f"{self.quant_kind}-KV pool; got "
                        f"{type(data).__name__}")
                vexpect = expect
                if isinstance(buf, Int4Pages):
                    # packed layout: PS/2 bytes along the page-slot axis
                    vexpect = (*expect[:-2], expect[-2] // 2, expect[-1])
                shapes = {"values": vexpect, "scale": expect[:-1]}
                for part, want in shapes.items():
                    got = tuple(data[part].shape)
                    if got != want:
                        raise ValueError(
                            f"restore payload '{name}.{part}' shape "
                            f"{got} != expected {want}")
                # the dtype guards the int8/int4 seam the shapes cannot
                # always see (garbage K/V scattered, no error)
                got_dtype = _host_tensor(data["values"]).dtype
                if got_dtype != buf.values.dtype:
                    raise ValueError(
                        f"restore payload '{name}.values' dtype "
                        f"{got_dtype} != pool dtype {buf.values.dtype} "
                        f"({self.quant_kind}-KV pool)")
            else:
                if isinstance(data, dict):
                    raise ValueError(
                        f"restore payload '{name}' is quantized but the "
                        "pool holds plain pages; quantized-KV payloads "
                        "only restore into same-kind quantized engines")
                got = tuple(data.shape)
                if got != expect:
                    raise ValueError(
                        f"restore payload '{name}' shape {got} != "
                        f"expected {expect}")

    def write_slot_pages(self, slot: int, content: dict,
                         lo: int = 0) -> None:
        """Write a host payload's pages into chain entries [lo,
        lo + num_pages) of an already-allocated slot. Schema and bounds
        are validated first: a malformed payload raises ValueError and
        writes nothing."""
        n = self._validate_payload(slot, content, lo)
        if n <= 0:
            return
        self._write_pages_idx(self.block_tables[slot, lo:lo + n],
                              content["k"], content["v"])

    def _write_pages_idx(self, pages: np.ndarray, kd, vd) -> None:
        """Write n pages of host K/V content into the given page ids, in
        place: one host-to-device copy a tensor, then ``index_copy_`` along
        the page axis of the pool (no second pool, no buckets)."""
        if len(pages) == 0:
            return
        dev = self.device
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=dev)

        def put(t: torch.Tensor, data) -> None:
            src = _host_tensor(data, t.dtype).to(dev, non_blocking=True)
            t.index_copy_(1, idx, src.to(t.dtype))

        for buf, data in ((self.k_pages, kd), (self.v_pages, vd)):
            if isinstance(buf, QuantPages):
                put(buf.values, data["values"])
                put(buf.scale, data["scale"])
            else:
                put(buf, data)

    # -- prefix cache --------------------------------------------------------

    def lookup_prefix(self, hashes: list[bytes]) -> list[int]:
        """Longest cached page chain for these full-page hashes (NOT
        pinned: call ``pin_pages`` under the same lock)."""
        pages = []
        for h in hashes:
            page = self._hash_to_page.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def pin_pages(self, pages: list[int]) -> None:
        for p in pages:
            if self._ref[p] == 0:
                self._evictable.pop(p, None)
            self._ref[p] += 1

    def unpin_pages(self, pages: list[int]) -> None:
        for p in pages:
            self._drop_ref(p)

    def flush_prefix_cache(self) -> None:
        """Drop every hash->page mapping and free the evictable pages
        (required whenever the page tensors are reallocated)."""
        self._hash_to_page.clear()
        self._page_to_hash.clear()
        while self._evictable:
            page, _ = self._evictable.popitem(last=False)
            self._free.append(page)

    def register_pages(self, pairs: list[tuple[bytes, int]]) -> None:
        """Publish (hash, page) pairs. First writer wins: a hash already
        mapped keeps its page (the new page stays private to its slot)."""
        for h, page in pairs:
            if h not in self._hash_to_page and page not in self._page_to_hash:
                self._hash_to_page[h] = page
                self._page_to_hash[page] = h

    def stats(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "free_pages": self.free_pages,
            "page_size": self.page_size,
            "kv_quantization": self.quant_kind,
            "hbm_bytes": self.hbm_bytes(),
            "slots_resident": len(self._owned),
            "prefix_cached_pages": len(self._hash_to_page),
            "prefix_hits": self.prefix_hits,
            "prefix_queries": self.prefix_queries,
            "prefix_hit_rate": round(
                self.prefix_hits / max(self.prefix_queries, 1), 4),
        }
