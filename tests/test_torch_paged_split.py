"""The split of each slot's keys over blocks in the paged-attention kernel,
on the CPU.

``split_plan`` (``ops/paged_attention_cuda.py``) fixes the split on the
host and the kernel follows it; ``split_ranges`` gives the key range of
each live split as the kernel computes it. These tests hold the plan to
its shapes and the ranges to exact coverage, then emulate in torch what
the kernel computes: each split's online softmax over its 64-key tiles
(fp32, the NEG_INF guards), its partial (m, l, unnormalised acc), and the
fixed-order combine. The emulation is held against the port's plain
version ``paged_attention_multi(impl="gather")`` and against the JAX
package's paged attention (the TPU kernel in interpret mode, and its
gather path) on the same inputs from a numpy seed: 1e-5 against the
port's plain version and 2e-5 against JAX (fp32 sums in another order).
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.ops import (
    paged_attention as jpa)
from distributed_llm_training_and_inference_system_tpu_torch.models.layers \
    import NEG_INF
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    paged_attention as tpa, quantization as tq)
from distributed_llm_training_and_inference_system_tpu_torch.ops.\
    paged_attention_cuda import (KEYS_PER_TILE, MAX_SPLITS, ROWS_PER_TILE,
                                 split_plan, split_ranges)


# -- the plan ------------------------------------------------------------------

def test_plan_at_the_decode_shape_of_serving():
    """llama-8b-gqa decode (B = 8, T = 1, 32 q heads over 8 kv heads) over
    serving's 32-page table of 64 (max_seq_len 2048), which is also
    chip_smoke's phase 4: 64 blocks without a split, so 4 tiles (256 keys)
    a split and 8 splits (a full cluster) give 512 blocks on 132 SMs."""
    p = split_plan(8, 1, 32, 8, 32, 64)
    assert p["keys_per_split"] == 256 and p["n_splits"] == 8
    assert p["row_tiles"] == 1 and p["grid"] == (8, 8, 8)
    # phase 4's lengths: 30 live splits, 240 live blocks of 512
    lengths = [2048, 1, 64, 65, 777, 1500, 130, 2000]
    live = [len(split_ranges(p, n - 1, 1, 4, 32, 64)[0]) for n in lengths]
    assert live == [8, 1, 1, 1, 4, 6, 1, 8]


@pytest.mark.parametrize("T,splits", [(4, 4), (44, 1), (128, 1)])
def test_windows_take_few_or_no_splits(T, splits):
    """A window of T tokens fills T * G / 8 row tiles itself: phase 3's T =
    4 keeps 4 splits, the 44-token suffix prefill of serving and phase 3's
    T = 128 one."""
    p = split_plan(8, T, 32, 8, 32, 64)
    assert p["n_splits"] == splits
    assert p["row_tiles"] == -(-T * 4 // ROWS_PER_TILE)


@pytest.mark.parametrize("maxP,B", [(32, 1), (512, 8), (4096, 1)])
def test_a_row_tile_never_takes_more_splits_than_a_cluster(maxP, B):
    """A row tile's splits combine within one thread block cluster, so a
    long table takes longer splits, never more than MAX_SPLITS."""
    p = split_plan(B, 1, 32, 8, maxP, 64)
    assert p["n_splits"] <= MAX_SPLITS
    assert p["keys_per_split"] * p["n_splits"] >= maxP * 64


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("maxP,PS", [(1, 8), (3, 16), (32, 64), (7, 64),
                                     (40, 50)])
def test_plan_covers_the_table_in_whole_tiles(maxP, PS, sms):
    p = split_plan(4, 1, 8, 2, maxP, PS, sms)
    kps, n = p["keys_per_split"], p["n_splits"]
    assert kps % KEYS_PER_TILE == 0 and kps > 0
    assert kps * n >= maxP * PS > kps * (n - 1)   # no split past the table
    assert p["grid"] == (p["row_tiles"] * n, 2, 4)


def _covers_once(plan, start, T, G, maxP, PS):
    """Each row tile's live splits cover its keys [0, min(start + j_last +
    1, maxP*PS)) exactly once, in order, in whole tiles but the last."""
    ranges = split_ranges(plan, start, T, G, maxP, PS)
    assert len(ranges) == plan["row_tiles"]
    kps = plan["keys_per_split"]
    for rt, splits in enumerate(ranges):
        last = min((rt + 1) * ROWS_PER_TILE, T * G) - 1
        n_keys = min(start + last // G + 1, maxP * PS)
        assert 1 <= len(splits) <= plan["n_splits"]
        at = 0
        for s, (b, e) in enumerate(splits):
            assert b == at == s * kps and b % KEYS_PER_TILE == 0
            assert b < e <= n_keys or (s == 0 and n_keys <= 0)
            assert e - b == kps or e == n_keys
            at = e
        assert at == max(n_keys, 0)
        # no key a row can see lies outside the tile's live splits
        for r in range(rt * ROWS_PER_TILE, last + 1):
            assert min(start + r // G + 1, maxP * PS) <= at


@pytest.mark.parametrize("T,G", [(1, 4), (4, 4), (44, 4), (3, 1), (20, 8)])
def test_ranges_cover_every_key_once_never_past_the_clamp(T, G):
    maxP, PS = 9, 16
    plan = split_plan(2, T, 2 * G, 2, maxP, PS, sms=1)
    for start in (0, 1, 15, 16, 63, 64, 65, maxP * PS - T,
                  maxP * PS - 1, maxP * PS + 5):
        _covers_once(plan, start, T, G, maxP, PS)


@pytest.mark.parametrize("kps", [64, 128, 192])
def test_ranges_on_and_one_past_a_split_boundary(kps):
    plan = dict(split_plan(1, 1, 4, 1, 16, 16), keys_per_split=kps,
                n_splits=-(-256 // kps))
    for n in (kps - 1, kps, kps + 1, 2 * kps, 2 * kps + 1):
        if n > 256:
            continue
        splits = split_ranges(plan, n - 1, 1, 4, 16, 16)[0]
        assert len(splits) == -(-n // kps) and splits[-1][1] == n
        _covers_once(plan, n - 1, 1, 4, 16, 16)


# -- the emulation -------------------------------------------------------------

def _dense(pages):
    """[NP, Nkv, PS, D] fp32 values of fp, int8 or int4 pages: float(value)
    * scale, as the kernel dequantizes a row."""
    if isinstance(pages, tpa.QuantPages):
        return pages.dequant(torch.float32)
    return pages.float()


def emulate(q, k_pages, v_pages, tables, starts, plan, stats=None):
    """What the kernel computes, split by split: [B, T, Nq, D] fp32."""
    B, T, Nq, D = q.shape
    k, v = _dense(k_pages), _dense(v_pages)
    _NP, Nkv, PS, _ = k.shape
    G, maxP = Nq // Nkv, tables.shape[1]
    scale = 1.0 / math.sqrt(D)
    out = torch.zeros(B, T, Nq, D)
    pos = torch.arange(maxP * PS)
    for b, kvh in itertools.product(range(B), range(Nkv)):
        start = int(starts[b])
        phys = tables[b].long()[pos // PS]
        kb, vb = k[phys, kvh, pos % PS], v[phys, kvh, pos % PS]
        for rt, splits in enumerate(split_ranges(plan, start, T, G, maxP,
                                                 PS)):
            rows = range(rt * ROWS_PER_TILE,
                         min((rt + 1) * ROWS_PER_TILE, T * G))
            j = torch.tensor([r // G for r in rows])
            h = torch.tensor([kvh * G + r % G for r in rows])
            qr = q[b, j, h].float()                        # [R, D]
            parts = []
            for k0, k1 in splits:
                m = torch.full((len(rows),), NEG_INF)
                l_ = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), D)
                for t0 in range(k0, k1, KEYS_PER_TILE):
                    keys = torch.arange(t0, min(t0 + KEYS_PER_TILE, k1))
                    s = (qr @ kb[keys].T) * scale
                    s = torch.where(keys[None] <= start + j[:, None], s,
                                    torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.max(1).values)
                    live = m_new > NEG_INF / 2
                    p = torch.where(live[:, None],
                                    torch.exp(s - m_new[:, None]),
                                    torch.zeros(()))
                    alpha = torch.where(live, torch.exp(m - m_new),
                                        torch.ones(()))
                    l_ = alpha * l_ + p.sum(1)
                    acc = alpha[:, None] * acc + p @ vb[keys]
                    m = m_new
                parts.append((m, l_, acc))
            if stats is not None:
                stats["tiles"] += 1
                stats["split_tiles"] += len(parts) > 1
                stats["dead_partials"] += sum(
                    int((m <= NEG_INF / 2).sum()) for m, _, _ in parts)
            if len(parts) == 1:
                m, l_, acc = parts[0]
            else:                     # fixed order: split 0, 1, ...
                m_max = torch.stack([m for m, _, _ in parts]).max(0).values
                l_ = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), D)
                for m, ls, a in parts:
                    w = torch.where(m > NEG_INF / 2, torch.exp(m - m_max),
                                    torch.zeros(()))
                    l_ = l_ + w * ls
                    acc = acc + w[:, None] * a
            out[b, j, h] = acc / torch.where(l_ > 0, l_, torch.ones(()))[:,
                                                                         None]
    return out


B, NQ, NKV, D, PS, MAXP = 4, 8, 2, 16, 16, 12
NP = B * MAXP + 1


def _case(T, seed, lengths=(1, MAXP * PS, 65, 0), scratch_start=70):
    """Slot 0 holds one key beside slot 1's full table (most of slot 0's
    splits are empty), slot 2 ends one past a 64-key boundary, slot 3's
    table is all scratch (length 0 means: page 0 everywhere, the window at
    ``scratch_start``)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, NQ, D).astype(np.float32)
    kp = rs.randn(NP, NKV, PS, D).astype(np.float32)
    vp = rs.randn(NP, NKV, PS, D).astype(np.float32)
    perm = rs.permutation(NP - 1) + 1
    bt = np.zeros((B, MAXP), np.int32)
    starts = np.zeros(B, np.int32)
    for b, n in enumerate(lengths):
        n = max(n, T) if n else 0
        used = -(-n // PS)
        bt[b, :used] = perm[b * MAXP:b * MAXP + used]
        starts[b] = n - T if n else scratch_start
    return q, kp, vp, bt, starts


def _t(a):
    return torch.from_numpy(np.array(a))


def _pages(kind, dense):
    t = _t(dense)
    if kind == "fp":
        return t, jnp.asarray(dense)
    if kind == "int8":
        v, s = tq.quantize_int8_rows(t)
        return (tpa.QuantPages(v, s),
                jpa.QuantPages(jnp.asarray(v.numpy()),
                               jnp.asarray(s.numpy())))
    v, s = tq.quantize_int4_rows(t)
    packed = tq.pack_int4_rows(v, axis=-2)
    return (tpa.Int4Pages(packed, s),
            jpa.Int4Pages(jnp.asarray(packed.numpy()),
                          jnp.asarray(s.numpy())))


@pytest.mark.parametrize("kps", [64, 128])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_split_emulation_matches_plain_and_jax(kind, T, kps):
    # slot 3's first token ends one key short of split 1, its second one
    # reaches into it: at T > 1 a row of that tile sees no key of split 1
    q, kp, vp, bt, starts = _case(T, seed=T + kps, scratch_start=kps - 1)
    tk, jk = _pages(kind, kp)
    tv, jv = _pages(kind, vp)
    plan = dict(split_plan(B, T, NQ, NKV, MAXP, PS), keys_per_split=kps,
                n_splits=-(-MAXP * PS // kps))
    stats = dict.fromkeys(("tiles", "split_tiles", "dead_partials"), 0)
    got = emulate(_t(q), tk, tv, _t(bt), _t(starts), plan, stats)
    # the case reaches what the kernel must get right: tiles with several
    # live splits, and partials of rows that see none of their split's keys
    assert stats["split_tiles"] >= 2
    assert stats["dead_partials"] > 0 or T == 1
    plain = tpa.paged_attention_multi(_t(q), tk, tv, _t(bt), _t(starts),
                                      impl="gather")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    for impl in ("pallas", "gather"):
        ref = np.asarray(jpa.paged_attention_multi(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(starts),
            impl=impl))
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


def test_combine_is_in_a_fixed_order():
    """The same inputs give the same bits, and a split plan that cuts the
    keys differently agrees to fp32 summation order only."""
    q, kp, vp, bt, starts = _case(1, seed=5)
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(starts))
    plan = dict(split_plan(B, 1, NQ, NKV, MAXP, PS), keys_per_split=64,
                n_splits=3)
    a, b = emulate(*args, plan), emulate(*args, plan)
    assert torch.equal(a, b)
    one = dict(plan, keys_per_split=192, n_splits=1)
    np.testing.assert_allclose(a.numpy(), emulate(*args, one).numpy(),
                               atol=1e-5, rtol=0)


def test_all_scratch_table_reads_page_zero_like_the_plain_version():
    q, kp, vp, bt, starts = _case(3, seed=9, lengths=(0, 0, 0, 0))
    plan = dict(split_plan(B, 3, NQ, NKV, MAXP, PS), keys_per_split=64,
                n_splits=3)
    got = emulate(_t(q), _t(kp), _t(vp), _t(bt), _t(starts), plan)
    plain = tpa.paged_attention_multi(_t(q), _t(kp), _t(vp), _t(bt),
                                      _t(starts), impl="gather")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
