"""The port's mesh, sharding rules, ZeRO and ShardedTrainer on gloo ranks,
held to the JAX package's ``parallel/`` (as ``tests/test_parallel.py``).

- The mesh: every rank's coordinates are the JAX mesh's device layout
  (row-major over pp, dp, fsdp, ep, sp, tp); a world of the wrong size is
  refused.
- Specs: each leaf's param spec and AdamW moment spec equal JAX's
  ``state_specs`` on the same config, and each rank holds exactly the
  slice of the leaf that JAX's ``NamedSharding`` gives the device at its
  mesh position (params at init, moments after the steps).
- A 3-step gpt-test trajectory for dp2, tp2, fsdp2 x tp2 and fsdp2 +
  ZeRO-1 equals JAX's single-device ``make_train_step`` from the same
  params at JAX's own tolerance (rtol 2e-4, atol 2e-5), and so do the
  final params.
- ZeRO-1: the moments are cut where their param is replicated.
- ``batch_specs`` and the planner's ring-or-Ulysses rule equal JAX's
  (no ranks needed).

One spawn a config (every check of it in that spawn); the JAX side runs
in this process on the fake CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributed_llm_training_and_inference_system_tpu.config import (
    schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.exec import (
    train_step as jts)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt)
from distributed_llm_training_and_inference_system_tpu.parallel import (
    build_mesh as jbuild_mesh)
from distributed_llm_training_and_inference_system_tpu.parallel.api import (
    state_specs)
from distributed_llm_training_and_inference_system_tpu.utils.tree import (
    flatten_with_paths, path_str)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ParallelConfig)
from distributed_llm_training_and_inference_system_tpu_torch.parallel import (
    mesh as tmesh)

import torch_dist_ranks as R

CONFIGS = {
    "dp2": (dict(data_parallel=2), 2),
    "tp2": (dict(tensor_parallel=2), 2),
    "fsdp2tp2": (dict(fsdp=2, tensor_parallel=2), 4),
    "fsdp2zero1": (dict(fsdp=2, zero_stage=1), 2),
}
OPT = {"lr": 1e-2}
STEPS = 3


@pytest.fixture(scope="module")
def reference():
    """JAX's params, batches, single-device losses and final state."""
    cfg = jax_cfg("gpt-test")
    params = jgpt.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (8, 32)).astype(
        np.int32)} for _ in range(STEPS)]
    step, tx, _ = jts.make_train_step(
        cfg, jax_schema.OptimizerConfig.from_dict(OPT))
    state = jts.TrainState.create(params, tx)
    jstep = jax.jit(step)
    losses = []
    for b in batches:
        state, m = jstep(state, {"tokens": jnp.asarray(b["tokens"])})
        losses.append(float(m["loss"]))
    flat = {p: np.asarray(v) for p, v in flatten_with_paths(params)}
    return {"cfg": cfg, "tx": tx, "flat": flat, "batches": batches,
            "losses": losses, "state": state}


@pytest.fixture(scope="module")
def runs(reference):
    return {name: R.spawn(R.train_rank, world, "gpt-test", par,
                          reference["flat"], reference["batches"], "xla",
                          OPT)
            for name, (par, world) in CONFIGS.items()}


def _jax_specs(reference, par: dict, world: int):
    jpar = jax_schema.ParallelConfig(**par)
    mesh = jbuild_mesh(jpar, jax.devices()[:world])
    specs, abstract = state_specs(reference["cfg"], reference["tx"], mesh,
                                  jpar.zero_stage)

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))
        return {path_str(p): s for p, s in leaves}
    mu = flat(specs.opt_state[0].mu)
    return mesh, flat(specs.params), mu, abstract


def _index_map(mesh, spec, shape, rank):
    """The slices of a leaf that JAX gives the device at mesh position
    ``rank`` (row-major)."""
    dev = mesh.devices.flat[rank]
    return NamedSharding(mesh, spec).devices_indices_map(shape)[dev]


def test_mesh_axes_and_layout(runs):
    """Ranks sit row-major over JAX's axes, as the JAX mesh's devices;
    a mesh whose degrees miss the world is refused."""
    for name, (par, world) in CONFIGS.items():
        shape = tmesh.mesh_shape_from_config(ParallelConfig(**par))
        assert tuple(shape) == tmesh.AXES == ("pp", "dp", "fsdp", "ep",
                                              "sp", "tp")
        for res in runs[name]:
            want = np.unravel_index(res["rank"], [shape[a] for a in
                                                  tmesh.AXES])
            assert [res["coords"][a] for a in tmesh.AXES] == list(want)
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.build_mesh(ParallelConfig(tensor_parallel=2),
                         torch.device("cpu"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shards_are_jax_specs_shards(reference, runs, name):
    par, world = CONFIGS[name]
    mesh, p_specs, mu_specs, abstract = _jax_specs(reference, par, world)
    final_mu = {p: np.asarray(v) for p, v in flatten_with_paths(
        reference["state"].opt_state[0].mu)}
    for res in runs[name]:
        r = res["rank"]
        for path, full in reference["flat"].items():
            assert res["p_specs"][path] == tuple(p_specs[path]), path
            assert res["o_specs"][path] == tuple(mu_specs[path]), path
            idx = _index_map(mesh, p_specs[path], full.shape, r)
            np.testing.assert_array_equal(res["init_shards"][path],
                                          full[idx], err_msg=path)
            idx = _index_map(mesh, mu_specs[path], full.shape, r)
            assert res["mu_shards"][path].shape == final_mu[path][idx].shape
            np.testing.assert_allclose(res["mu_shards"][path],
                                       final_mu[path][idx], rtol=2e-4,
                                       atol=2e-6, err_msg=path)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_trajectory_matches_jax_single_device(reference, runs,
                                                      name):
    for res in runs[name]:
        np.testing.assert_allclose(res["losses"], reference["losses"],
                                   rtol=2e-4, atol=2e-5)
    final = {p: np.asarray(v) for p, v in flatten_with_paths(
        reference["state"].params)}
    got = runs[name][0]["params"]
    for path, want in final.items():
        np.testing.assert_allclose(got[path], want, rtol=2e-4, atol=2e-5,
                                   err_msg=path)


def test_zero1_moments_cut_where_the_param_is_replicated(runs):
    """fsdp2 + ZeRO-1: the norm scales' params are whole on every rank,
    their AdamW moments halved; fsdp-cut kernels keep their param's cut."""
    for res in runs["fsdp2zero1"]:
        for path, (p_shape, m_shape) in res["shapes"].items():
            if "norm" in path:
                assert np.prod(m_shape) * 2 == np.prod(p_shape), path
                assert "fsdp" not in str(res["p_specs"][path])
            if path == "blocks.q.kernel":
                assert m_shape == p_shape == (2, 32, 64)


@pytest.mark.parametrize("par", [dict(data_parallel=2, sequence_parallel=2),
                                 dict(fsdp=4, tensor_parallel=2),
                                 dict(data_parallel=3)],
                         ids=["dp2sp2", "fsdp4tp2", "dp3"])
def test_batch_specs_equal_jax(par):
    """[B, S] arrays over (dp, fsdp) x sp, [B] over (dp, fsdp), scalars
    replicated, shrunk where a dim does not divide: JAX's specs."""
    from distributed_llm_training_and_inference_system_tpu.parallel.sharding \
        import batch_specs as jbatch_specs
    from distributed_llm_training_and_inference_system_tpu_torch.parallel \
        import sharding as tsharding
    world = int(np.prod(list(par.values())))
    jmesh = jbuild_mesh(jax_schema.ParallelConfig(**par),
                        jax.devices()[:world])
    batch = {"tokens": np.zeros((8, 32), np.int32),
             "offsets": np.zeros((8,), np.int32),
             "odd": np.zeros((6, 9), np.int32),
             "step": np.zeros((), np.int32)}
    want = jbatch_specs(batch, jmesh)
    got = tsharding.batch_specs(batch, tmesh.mesh_shape_from_config(
        ParallelConfig(**par)))
    assert {k: tuple(v) for k, v in want.items()} == got


@pytest.mark.parametrize("model,sp,seq", [("gpt-1b", 2, 2048),
                                          ("gpt-1b", 8, 32768),
                                          ("llama-8b-gqa", 16, 8192)])
def test_sp_scheme_choice_equals_jax(model, sp, seq):
    """The ring-or-Ulysses rule prices as JAX's does on the same hardware
    numbers (the port's H100 defaults; no calibration)."""
    import dataclasses

    from distributed_llm_training_and_inference_system_tpu.parallel import (
        planner as jplanner)
    from distributed_llm_training_and_inference_system_tpu_torch.config \
        import HardwareConfig, get_model_config
    from distributed_llm_training_and_inference_system_tpu_torch.parallel \
        import planner as tplanner
    hw = HardwareConfig()
    jhw = jax_schema.HardwareConfig(**dataclasses.asdict(hw))
    got = tplanner.choose_sp_scheme(get_model_config(model), sp, seq, 2, hw,
                                    calibration={})
    want = jplanner.choose_sp_scheme(jax_cfg(model), sp, seq, 2, jhw,
                                     calibration={})
    assert got == want
    # a calibration of another card is not used for this one
    tpu = {"chip_type": "v5e", "ring_efficiency": 0.9,
           "ulysses_efficiency": 0.01}
    assert tplanner.sp_scheme_costs(get_model_config(model), sp, seq, 2, hw,
                                    tpu) == got[1]
