"""Batched token sampling.

Counterpart of the JAX package's ``serve/sampling.py``. Every row carries
its own (temperature, top_k, top_p); temperature 0 is greedy. The batch
takes the cheapest path that serves it, chosen on the host from the host
copies of the knobs (no device synchronisation):

  all rows greedy     -> argmax only
  no row filters      -> categorical draw from the scaled logits
  any row filters     -> top-k then top-p from ONE sort of the row
                         (``_filtered_single_sort``), then the
                         categorical draw

A categorical draw is ``argmax(logits + gumbel)``, the Gumbel-max form of
``jax.random.categorical``. The noise is an argument, so a test can feed
both packages the same draws. The engine's noise is ``gumbel_noise``: the
bits of JAX's threefry2x32 generator, computed with integer tensor
arithmetic. A request seeded ``s`` keys its token at position ``p`` with
``fold_in(PRNGKey(s), p)`` and draws one uniform in [tiny, 1) per vocab
entry from ``random_bits`` (the partitionable counter layout, the JAX
default), so a seeded request gets the JAX engine's tokens, whatever slot
or batch it shares.

The JAX package filters through a 256-candidate tier first
(``_filtered_fast_or_exact``: a top-257 selection, the single sort where
the kept set could reach past the candidates), chosen per batch by
``lax.cond`` on a device value. It is ported here with the same kept set
and tie order, but the sampler does not take it: the host would have to
read the device's "needs the exact path" flag every filtered step, and on
the H100 the single sort alone is the faster call (``chip_smoke.py``
phase 17a times both; PERF.md).

``randint`` is ``jax.random.randint`` for int32 bit for bit (the int4-awq
calibration tokens of the serving engine).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..device import to_device
from ..models.layers import NEG_INF

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) on int64
    tensors holding uint32 values; keys and counters broadcast."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key_data(PRNGKey(seed))`` per seed: (0, seed mod 2^32)
    (JAX without x64 keeps the low 32 bits of a Python int seed)."""
    seeds = seeds.long()
    return torch.zeros_like(seeds), seeds & _M32


def fold_in(key: tuple[torch.Tensor, torch.Tensor], data: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in``: threefry of the counter pair (0, data)."""
    data = data.long() & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: tuple[torch.Tensor, torch.Tensor], n: int
                ) -> torch.Tensor:
    """[B, n] uint32 values (in int64) of ``jax.random.bits`` for a [n]
    draw from each of B keys: the partitionable layout hashes the counter
    pair (hi, lo) of each flat index and xors the two words."""
    idx = torch.arange(n, dtype=torch.int64, device=key[0].device)[None, :]
    b0, b1 = threefry2x32(key[0][:, None], key[1][:, None], idx >> 32,
                          idx & _M32)
    return b0 ^ b1


def split(key: tuple[torch.Tensor, torch.Tensor], num: int = 2
          ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``jax.random.split`` (threefry, partitionable): key i is the hash
    of the counter pair (0, i)."""
    i = torch.arange(num, dtype=torch.int64, device=key[0].device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return [(b0[j], b1[j]) for j in range(num)]


def randint(key: tuple[torch.Tensor, torch.Tensor], shape: tuple,
            minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 (JAX
    without x64): the key split in two, 32 bits drawn from each, folded
    into [minval, maxval) as ``(hi % span) * m + lo % span`` modulo span
    with ``m = (2^16 % span)^2 % span``, every product wrapping in uint32
    as JAX's does. Returns int64 values."""
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) outside int32")
    k1, k2 = split(key)
    n = math.prod(shape)
    hi = random_bits((k1[0][None], k1[1][None]), n)[0]
    lo = random_bits((k2[0][None], k2[1][None]), n)[0]
    span = max(maxval - minval, 1)
    mult = ((((1 << 16) % span) ** 2) & _M32) % span
    off = (((hi % span) * mult & _M32) + lo % span) & _M32
    return (minval + off % span).reshape(shape)


def uniform(key: tuple[torch.Tensor, torch.Tensor], n: int,
            minval: float = 0.0) -> torch.Tensor:
    """[B, n] fp32 ``jax.random.uniform(key, (n,), minval=minval)``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled to
    [minval, 1)."""
    bits = random_bits(key, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = (floats - 1.0) * (1.0 - minval) + minval
    return torch.clamp(floats, min=minval)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """[B, V] fp32 standard Gumbel noise of JAX's ``categorical`` for the
    keys ``fold_in(PRNGKey(seed), position)``: ``-log(-log(u))`` with u
    uniform in [tiny, 1). ``seeds`` and ``positions`` are [B] integer
    tensors on the device the noise is made on."""
    key = fold_in(prng_key(seeds), positions)
    u = uniform(key, vocab_size, minval=_TINY)
    return -torch.log(-torch.log(u))


def _filtered_single_sort(scaled: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """top-k then top-p filtering from ONE sort of the scaled logits.

    The order is that of ``jnp.argsort(x)[:, ::-1]``: a stable ascending
    sort, reversed, i.e. descending value and, among equal values,
    descending token id. top-k keeps every value >= the k-th (ties
    included); top-p keeps the sorted prefix whose preceding mass is
    below p (the top token always)."""
    B, V = scaled.shape
    sort_idx = torch.sort(scaled, dim=-1, stable=True).indices.flip(-1)
    sorted_desc = torch.gather(scaled, 1, sort_idx)

    k = top_k.clamp(1, V)
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    keep_k = (sorted_desc >= kth) | (top_k[:, None] <= 0)

    masked_sorted = sorted_desc.masked_fill(~keep_k, NEG_INF)
    probs = torch.softmax(masked_sorted, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[:, None]
    keep_p[:, 0] = True
    keep_p = keep_p | (top_p[:, None] >= 1.0)

    keep = torch.zeros((B, V), dtype=torch.bool, device=scaled.device)
    keep.scatter_(1, sort_idx, keep_k & keep_p)
    return scaled.masked_fill(~keep, NEG_INF)


FILTER_FAST_CAP = 256
"""Candidate width of the fast filter tier: a top-(CAP + 1) selection in
place of a full-vocab sort (the JAX package's ``FILTER_FAST_CAP``)."""


def _filtered_fast(scaled: torch.Tensor, top_k: torch.Tensor,
                   top_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(filtered logits over the CAP largest values of each row, a 0-dim
    bool: does some filtered row need the exact path?). The JAX
    ``_filtered_fast_or_exact`` before its ``lax.cond``: the candidates
    are put in the single sort's order (descending value, ties by
    descending token id) before the cuts, and a row is "dirty" when its
    top-k cut lies past or ties the largest excluded value, when top-p's
    mass is not reached within the candidates, or when its kept set
    touches a value the excluded tail ties with."""
    B, V = scaled.shape
    cap = FILTER_FAST_CAP
    vals, idx = torch.topk(scaled, cap + 1, dim=-1)
    sentinel = vals[:, cap]                     # largest EXCLUDED value
    cvals, cidx = vals[:, :cap], idx[:, :cap]
    # torch.topk orders ties arbitrarily on a card: sort the candidates by
    # descending token id, then stably by descending value (ties keep
    # descending id), the argsort path's order
    i1, perm = torch.sort(cidx, dim=-1, descending=True)
    v1 = torch.gather(cvals, 1, perm)
    svals, order = torch.sort(v1, dim=-1, descending=True, stable=True)
    sidx = torch.gather(i1, 1, order)                       # [B, cap]

    k_active = top_k > 0
    p_active = top_p < 1.0
    k = top_k.clamp(1, V)
    kth = torch.gather(svals, 1, ((k - 1).clamp(max=cap - 1))[:, None])
    keep_k = (svals >= kth) | ~k_active[:, None]

    # the exact path's masked softmax: over the kept candidates when top-k
    # masks the tail, over the whole row when it does not
    m = svals[:, :1]
    exps = torch.where(keep_k, torch.exp(svals - m),
                       torch.zeros((), dtype=svals.dtype,
                                   device=svals.device))
    z_kept = exps.sum(dim=1, keepdim=True)
    z_full = torch.exp(scaled - m).sum(dim=1, keepdim=True)
    probs = exps / torch.where(k_active[:, None], z_kept, z_full)
    cum = torch.cumsum(probs, dim=1)
    keep_p = (cum - probs) < top_p[:, None]
    keep_p[:, 0] = True
    keep_p = keep_p | (top_p[:, None] >= 1.0)
    keep_c = keep_k & keep_p

    filtered_row = k_active | p_active
    dirty = ((k_active & ((k > cap) | (kth[:, 0] <= sentinel)))
             | (~k_active & p_active & ((cum[:, -1] - probs[:, -1]) < top_p))
             | (filtered_row
                & (keep_c & (svals <= sentinel[:, None])).any(dim=1)))
    need_exact = (dirty & filtered_row).any()

    keep = torch.zeros((B, V), dtype=torch.bool, device=scaled.device)
    keep.scatter_(1, sidx, keep_c)
    fast = scaled.masked_fill(~(keep | ~filtered_row[:, None]), NEG_INF)
    return fast, need_exact


def _filtered_fast_or_exact(scaled: torch.Tensor, top_k: torch.Tensor,
                            top_p: torch.Tensor, host_top_k: np.ndarray
                            ) -> torch.Tensor:
    """Filtered logits with ``_filtered_single_sort``'s kept set: the
    candidate tier where it is exact, else the single sort. The host
    picks: small vocabularies and a top_k past the candidates sort
    straight away (``host_top_k`` is the knobs' host copy); otherwise the
    tier's flag is read back from the device."""
    V = scaled.shape[1]
    if V <= FILTER_FAST_CAP + 1 or (host_top_k > FILTER_FAST_CAP).any():
        return _filtered_single_sort(scaled, top_k, top_p)
    fast, need_exact = _filtered_fast(scaled, top_k, top_p)
    if bool(need_exact):                 # the one device-to-host read
        return _filtered_single_sort(scaled, top_k, top_p)
    return fast


Noise = Union[torch.Tensor, Callable[[], torch.Tensor]]


def sample_tokens(
    logits: torch.Tensor,            # [B, V] fp32
    temperature,                     # [B] host array; <= 0 = greedy
    top_k,                           # [B] host array; <= 0 = disabled
    top_p,                           # [B] host array; >= 1 = disabled
    noise: Optional[Noise] = None,   # [B, V] Gumbel noise, or a maker
) -> torch.Tensor:
    """Sampled token ids [B] (int64) on logits' device. ``noise`` is only
    read (or made, when it is a callable) if some row samples."""
    temperature = np.asarray(temperature, np.float32)
    top_k = np.asarray(top_k, np.int64)
    top_p = np.asarray(top_p, np.float32)
    greedy = logits.argmax(dim=-1)
    is_sampled = temperature > 0.0
    if not is_sampled.any():
        return greedy
    dev = logits.device
    temp = to_device(np.maximum(temperature, 1e-6), dev)
    scaled = logits / temp[:, None]
    if (is_sampled & ((top_k > 0) | (top_p < 1.0))).any():
        scaled = _filtered_single_sort(
            scaled, to_device(top_k, dev), to_device(top_p, dev))
    if noise is None:
        raise ValueError("sampled rows need Gumbel noise")
    if callable(noise):
        noise = noise()
    toks = (scaled + noise).argmax(dim=-1)
    return torch.where(to_device(is_sampled, dev), toks, greedy)
