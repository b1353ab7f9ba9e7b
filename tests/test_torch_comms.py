"""The port's collectives (comms/collectives.py) on gloo ranks, held to the
JAX package's.

Each collective over 2 ranks (one sp axis) and 4 ranks (one tp axis of 4;
dp 2 x fsdp 2 over each axis and over both): the sum, mean, tiled gathers
along both dims, reduce-scatter, the ring hop and the all-to-all equal the
JAX package's ``comms`` functions in ``shard_map`` over the same mesh
layout on the fake CPU devices (as ``tests/test_comms.py``); bf16 sums and
gathers through gloo; the autograd pairs' gradients (copy_to, reduce_from,
the gather's reduce-scatter and slice gradients, the all-to-all's
inverse). One spawn a world size; every mesh of it in that spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from distributed_llm_training_and_inference_system_tpu.comms import (
    all_gather, all_to_all, allreduce_mean, allreduce_sum, reduce_scatter,
    ring_shift)
from distributed_llm_training_and_inference_system_tpu.utils.compat import (
    shard_map)

import torch_dist_ranks as R

WORLDS = {2: [{"sp": 2}], 4: [{"tp": 4}, {"dp": 2, "fsdp": 2}]}


@pytest.fixture(scope="module")
def ranks():
    return {w: R.spawn(R.collectives_rank, w, shapes)
            for w, shapes in WORLDS.items()}


def _x(r):
    return np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * r


def _jax(shape: dict, body, xs: list) -> list:
    """``body`` in shard_map over a mesh of ``shape`` (axis order as
    given: the port's row-major rank layout); device r holds xs[r]."""
    names, dims = tuple(shape), tuple(shape.values())
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(dims))]).reshape(
        dims), names)
    spec = P(names if len(names) > 1 else names[0])
    fn = shard_map(lambda v: body(v)[None], mesh=mesh, in_specs=(spec,),
                   out_specs=spec, check_vma=False)
    return list(np.asarray(jax.jit(fn)(jnp.concatenate(xs))))


CASES = [(w, i, key) for w, shapes in WORLDS.items()
         for i, shape in enumerate(shapes)
         for key in list(shape) + (["dp+fsdp"] if len(shape) > 1 else [])]


@pytest.mark.parametrize("world,mesh_i,axis_key", CASES,
                         ids=[f"{w}ranks-{k}" for w, _, k in CASES])
def test_collectives_equal_jax(ranks, world, mesh_i, axis_key):
    shape = WORLDS[world][mesh_i]
    axis = tuple(axis_key.split("+")) if "+" in axis_key else axis_key
    got = [ranks[world][r][mesh_i][axis_key] for r in range(world)]
    xs = [_x(r) for r in range(world)]
    n = got[0]["size"]
    ys = [np.arange(4 * n, dtype=np.float32).reshape(n, 4) + 100 * r
          for r in range(world)]
    if isinstance(axis, str):
        for r in range(world):
            assert got[r]["index"] == ranks[world][r][mesh_i]["coords"][axis]
    want = {
        "sum": _jax(shape, lambda v: allreduce_sum(v, axis), xs),
        "mean": _jax(shape, lambda v: allreduce_mean(v, axis), xs),
        "gather0": _jax(shape, lambda v: all_gather(v, axis), xs),
        "gather1": _jax(shape, lambda v: all_gather(v, axis, gather_dim=1),
                        xs),
        "rs0": _jax(shape, lambda v: reduce_scatter(
            jnp.tile(v, (n, 1)), axis), xs),
        "shift": _jax(shape, lambda v: ring_shift(v, axis), xs),
        "a2a": _jax(shape, lambda v: all_to_all(v, axis, split_dim=0,
                                                concat_dim=1), ys),
    }
    for key, per_rank in want.items():
        for r in range(world):
            np.testing.assert_array_equal(got[r][key], per_rank[r],
                                          err_msg=f"{key} rank {r}")
    xb = [np.arange(8, dtype=np.float32).reshape(4, 2) + r
          for r in range(world)]
    bf_sum = _jax(shape, lambda v: allreduce_sum(v, axis), xb)
    bf_gather = _jax(shape, lambda v: all_gather(v, axis), xb)
    for r in range(world):
        np.testing.assert_array_equal(got[r]["bf16_sum"], bf_sum[r])
        np.testing.assert_array_equal(got[r]["bf16_gather"], bf_gather[r])


@pytest.mark.parametrize("world,mesh_i,axis_key", CASES,
                         ids=[f"{w}ranks-{k}" for w, _, k in CASES])
def test_autograd_pairs(ranks, world, mesh_i, axis_key):
    """copy_to sums the gradient over the axis; reduce_from sums forward
    and passes the gradient; the gather's gradient is reduce-scattered or
    sliced; the all-to-all's is the inverse all-to-all."""
    for r in range(world):
        got = ranks[world][r][mesh_i][axis_key]
        members = got["members"]
        ones = np.ones((4, 2), np.float32)
        factor = sum(m + 1 for m in members)
        np.testing.assert_array_equal(got["copy_to_grad"], ones * factor)
        np.testing.assert_array_equal(
            got["reduce_from"], sum(_x(m) for m in members))
        np.testing.assert_array_equal(got["reduce_from_grad"], ones * (r + 1))
        np.testing.assert_array_equal(got["gather_reduce_scatter_grad"],
                                      ones * factor)
        np.testing.assert_array_equal(got["gather_slice_grad"],
                                      ones * (r + 1))
        # an all-to-all sends chunk j to index j: the gradient of this
        # rank's chunk j is the (r_j + 1) of the member that received it
        by_index = sorted(members,
                          key=lambda m: ranks[world][m][mesh_i][axis_key]
                          ["index"])
        want = np.concatenate([np.full((1, 4), m + 1, np.float32)
                               for m in by_index])
        np.testing.assert_array_equal(got["a2a_grad"], want)
