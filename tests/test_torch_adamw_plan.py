"""The multi-leaf AdamW kernel's plan on the CPU: which leaves share a
launch, the tiles each launch walks, the leaf table it packs, and a torch
emulation of the kernel's tile walk against the per-leaf update.

- every element of every leaf is covered exactly once by the kernel's
  indexing (vectors of 4, the tail, the scalar path of an unaligned leaf);
- leaves group by (mu dtype, nu dtype), gpt-1b's 170 eligible leaves take
  one launch, and a launch holds at most the table's capacity;
- the emulation, ``_leaf_math`` over each tile in the kernel's order, is
  bitwise equal to ``_leaf_math`` over each whole leaf, and within rtol
  1e-6 of JAX ``fused_adamw_apply(use_pallas=False)`` (XLA's CPU fusion
  rounds p one ulp apart from op-by-op arithmetic; the tolerances of
  tests/test_torch_train.py's per-leaf comparison).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.exec import (
    fused_update as jfu)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config)
from distributed_llm_training_and_inference_system_tpu_torch.exec import (
    fused_update as tfu)
from distributed_llm_training_and_inference_system_tpu_torch.models import gpt
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    adamw_cuda as ac)

F32, BF16 = torch.float32, torch.bfloat16
THREADS = 256                 # csrc/adamw.cu: threads a block
VECS = ac.TILE // (4 * THREADS)


def _gpt1b_eligible():
    meta = gpt.GPT(get_model_config("gpt-1b"), device="meta")
    return [p.numel() for p in meta.parameters()
            if p.dim() >= 2 and p.numel() >= tfu.KERNEL_MIN_ELEMENTS]


def _tile_elements(n: int, tile: int, vec: bool) -> np.ndarray:
    """The elements the kernel updates for one tile of a leaf of ``n``,
    index by index as csrc/adamw.cu computes them."""
    base = tile * ac.TILE
    t = np.arange(THREADS)
    if not vec:
        i = (base + np.arange(ac.TILE // THREADS)[:, None] * THREADS
             + t).ravel()
        return i[i < n]
    n4 = n // 4
    v = (base // 4 + np.arange(VECS)[:, None] * THREADS + t).ravel()
    v = v[v < n4]
    out = [(4 * v[:, None] + np.arange(4)).ravel()]
    if base + ac.TILE >= n:
        i = 4 * n4 + t
        out.append(i[i < n])
    return np.concatenate(out)


def _leaf_of_tile(tile_start, tile: int) -> int:
    """The kernel's binary search: the last leaf whose first tile is <=
    tile."""
    lo, hi = 0, len(tile_start) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if tile_start[mid] <= tile:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _walk(launch: dict):
    """(leaf position in the launch, tile of that leaf) in the order the
    persistent grid takes them: block b, tiles b, b + grid, ..."""
    for b in range(launch["grid"]):
        for tile in range(b, launch["tiles"], launch["grid"]):
            k = _leaf_of_tile(launch["tile_start"], tile)
            yield k, tile - launch["tile_start"][k]


@pytest.mark.parametrize("sizes", [
    [65536, 70001 * 5, 4096, 4097, 1, 3, 8191],
    [ac.TILE * 3, ac.TILE * 3 + 1, ac.TILE * 3 - 1, 2, 7, 350005],
    [1 << 20],
])
@pytest.mark.parametrize("vec", [True, False])
def test_the_walk_covers_every_element_once(sizes, vec):
    leaves = [(n, F32, F32) for n in sizes]
    (launch,) = ac.adamw_plan(leaves, sm_count=3)
    hits = [np.zeros(n, dtype=np.int64) for n in sizes]
    for k, tile in _walk(launch):
        i = launch["leaves"][k]
        np.add.at(hits[i], _tile_elements(sizes[i], tile, vec), 1)
    for h in hits:
        assert (h == 1).all()


@pytest.mark.parametrize("tile_start", [[0, 1], [0, 3, 4, 9], [0, 1, 2, 3],
                                        [0, 5, 5, 5, 8]])
def test_leaf_search_finds_the_owner_of_every_tile(tile_start):
    for tile in range(tile_start[-1]):
        k = _leaf_of_tile(tile_start, tile)
        assert tile_start[k] <= tile < tile_start[k + 1]


@pytest.mark.parametrize("mu_dtype,nu_dtype,launches", [
    (F32, F32, 1), (BF16, F32, 1), (BF16, BF16, 1)])
def test_gpt1b_takes_one_launch_per_dtype_pair(mu_dtype, nu_dtype, launches):
    sizes = _gpt1b_eligible()
    assert len(sizes) == 170
    plan = ac.adamw_plan([(n, mu_dtype, nu_dtype) for n in sizes])
    assert len(plan) == launches
    (launch,) = plan
    assert launch["leaves"] == list(range(170))
    assert launch["tiles"] == sum(-(-n // ac.TILE) for n in sizes)
    assert launch["grid"] == 132 * ac.BLOCKS_PER_SM


def test_leaves_group_by_dtype_pair_in_order():
    pairs = [(F32, F32), (BF16, F32), (F32, F32), (BF16, BF16), (BF16, F32)]
    plan = ac.adamw_plan([(70000, m, n) for m, n in pairs])
    assert [(lp["dtypes"], lp["leaves"]) for lp in plan] == [
        ((F32, F32), [0, 2]), ((BF16, F32), [1, 4]), ((BF16, BF16), [3])]


@pytest.mark.parametrize("count,want", [
    (ac.CAPACITY, 1), (ac.CAPACITY + 1, 2), (600, 3), (3 * ac.CAPACITY, 3),
    (0, 0)])
def test_a_launch_holds_at_most_the_capacity(count, want):
    plan = ac.adamw_plan([(100, F32, F32)] * count)
    assert len(plan) == want
    assert sorted(i for lp in plan for i in lp["leaves"]) == list(
        range(count))
    assert all(len(lp["leaves"]) <= ac.CAPACITY for lp in plan)


def test_empty_leaves_take_no_tile_and_small_calls_a_small_grid():
    plan = ac.adamw_plan([(0, F32, F32), (5, F32, F32), (0, BF16, F32)])
    assert len(plan) == 1
    assert plan[0]["leaves"] == [1] and plan[0]["grid"] == 1


@pytest.mark.parametrize("ptrs,items,want", [
    ((0, 16, 32, 48), (4, 4), True),
    ((4, 16, 32, 48), (4, 4), False),        # p one element in
    ((0, 16, 8, 48), (2, 4), True),          # a bf16 mu needs 8 bytes
    ((0, 16, 8, 48), (4, 4), False),
    ((0, 16, 32, 6), (4, 2), False),
    ((0, 16, 32, 24), (4, 2), True)])
def test_vector_alignment_of_a_leaf(ptrs, items, want):
    assert ac.vector_aligned(ptrs, items) is want


def test_the_table_holds_pointers_sizes_decays_and_tiles():
    """The packed bytes, read back in the kernel's layout."""
    base = torch.zeros(70001 * 5 + 1)
    leaves = [(torch.zeros(s), torch.zeros(s), torch.zeros(s, dtype=BF16),
               torch.zeros(s)) for s in ((300, 256), (5, 70001))]
    view = base[1:].view(5, 70001)           # 4 bytes into its storage
    leaves.append((view, view, torch.zeros(5, 70001, dtype=BF16),
                   torch.zeros(5, 70001)))
    wds = [0.1, 0.0, 0.25]
    (launch,) = ac.adamw_plan([(p.numel(), m.dtype, v.dtype)
                               for p, _, m, v in leaves])
    buf = ac._table(launch, leaves, wds)
    assert buf.nbytes == ac.TABLE_BYTES
    rows = buf[:ac._LEAF.itemsize * ac.CAPACITY].view(ac._LEAF)
    tail = buf[ac._LEAF.itemsize * ac.CAPACITY:].view(np.int32)
    for k, (p, g, m, v) in enumerate(leaves):
        r = rows[k]
        assert (int(r["p"]), int(r["g"]), int(r["mu"]), int(r["nu"])) == (
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
        assert int(r["n"]) == p.numel()
        assert float(r["wd"]) == np.float32(wds[k])
    assert [int(r["vec"]) for r in rows[:3]] == [1, 1, 0]
    assert (rows[3:]["n"] == 0).all()
    assert list(tail[:4]) == launch["tile_start"]
    assert tail[ac.CAPACITY + 1] == 3


def _leaves(sizes, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for shape in sizes:
        out.append((rs.randn(*shape).astype(np.float32),
                    (1e-2 * rs.randn(*shape)).astype(np.float32),
                    (1e-3 * rs.randn(*shape)).astype(np.float32),
                    (1e-5 * rs.rand(*shape)).astype(np.float32)))
    return out


def _t(a, dtype=F32):
    return torch.from_numpy(np.array(a)).to(dtype)


SIZES = [(300, 256), (5, 70001), (64, 48), (300,), (257, 1031), (16,)]
DECAY = [True, False, True, False, True, True]


@pytest.mark.parametrize("mu_dtype,nu_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_tile_walk_emulation_is_bitwise_equal_to_the_leaf_update(mu_dtype,
                                                                 nu_dtype):
    """The leaves past the 65536-element threshold, mixed with small ones,
    go through an emulation of the kernel (``_leaf_math`` over each tile,
    in the grid's order); the small ones through ``_leaf_math``, as
    ``fused_adamw_apply`` sends them."""
    mdt, ndt = getattr(torch, mu_dtype), getattr(torch, nu_dtype)
    data = _leaves(SIZES)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    count, lr, clip = torch.tensor(4, dtype=torch.int32), torch.tensor(
        2e-3), torch.tensor(0.5)
    scalars = tfu.adam_scalars(count, lr, 0.9, 0.95, clip)
    s = scalars.unbind()

    def state():
        return ([_t(p) for p, *_ in data], [_t(g) for _, g, *_ in data],
                [_t(m, mdt) for *_, m, _ in data],
                [_t(v, ndt) for *_, v in data])

    # the reference: _leaf_math over each whole leaf
    rp, rg, rm, rv = state()
    for i in range(len(SIZES)):
        wd = 0.1 if DECAY[i] else 0.0
        np_, nm, nv = tfu._leaf_math(rp[i], rg[i], rm[i], rv[i], *s, wd=wd,
                                     mu_dtype=mdt, nu_dtype=ndt, **kw)
        rp[i], rm[i], rv[i] = np_, nm, nv

    # the emulation: eligible leaves by tiles, in the kernel's walk
    ep, eg, em, ev = state()
    eligible = [i for i, sh in enumerate(SIZES) if len(sh) >= 2
                and int(np.prod(sh)) >= tfu.KERNEL_MIN_ELEMENTS]
    assert len(eligible) == 3
    (launch,) = ac.adamw_plan([(ep[i].numel(), mdt, ndt) for i in eligible],
                              sm_count=2)
    touched = {i: torch.zeros(ep[i].numel(), dtype=torch.int64)
               for i in eligible}
    for k, tile in _walk(launch):
        i = eligible[launch["leaves"][k]]
        lo = tile * ac.TILE
        hi = min(lo + ac.TILE, ep[i].numel())
        flat = [t.view(-1)[lo:hi] for t in (ep[i], eg[i], em[i], ev[i])]
        np_, nm, nv = tfu._leaf_math(*flat, *s,
                                     wd=0.1 if DECAY[i] else 0.0,
                                     mu_dtype=mdt, nu_dtype=ndt, **kw)
        flat[0].copy_(np_)
        flat[2].copy_(nm)
        flat[3].copy_(nv)
        touched[i][lo:hi] += 1
    assert all((t == 1).all() for t in touched.values())
    for i in set(range(len(SIZES))) - set(eligible):
        wd = 0.1 if DECAY[i] else 0.0
        np_, nm, nv = tfu._leaf_math(ep[i], eg[i], em[i], ev[i], *s, wd=wd,
                                     mu_dtype=mdt, nu_dtype=ndt, **kw)
        ep[i].copy_(np_)
        em[i].copy_(nm)
        ev[i].copy_(nv)
    for a, b in zip(ep + em + ev, rp + rm + rv):
        assert torch.equal(a, b)

    # fused_adamw_apply on the CPU (every leaf through _leaf_math) agrees
    fp, fg, fm, fv = state()
    tfu.fused_adamw_apply(fp, fg, fm, fv, count, lr=lr, weight_decay=0.1,
                          decay_mask=DECAY, clip_scale=clip, **kw)
    for a, b in zip(fp + fm + fv, ep + em + ev):
        assert torch.equal(a, b)

    # and JAX's plain path, within one ulp's tolerance
    jp, jm, jv = jfu.fused_adamw_apply(
        [jnp.asarray(p) for p, *_ in data], [jnp.asarray(g)
                                             for _, g, *_ in data],
        [jnp.asarray(_t(m, mdt).float().numpy()).astype(mu_dtype)
         for *_, m, _ in data],
        [jnp.asarray(_t(v, ndt).float().numpy()).astype(nu_dtype)
         for *_, v in data],
        jnp.int32(4), lr=jnp.float32(2e-3), weight_decay=0.1,
        decay_mask=DECAY, clip_scale=jnp.float32(0.5), use_pallas=False,
        **kw)
    for a, b in zip(jp, ep):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-9)
    for a, b in zip(jm + jv, em + ev):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-10)
