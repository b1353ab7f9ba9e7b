"""Expert parallelism and MoE training on a mesh of gloo ranks, held to
the JAX package, as JAX's ``tests/test_parallel.py`` holds its own
(``test_moe_ep_sharding``, ``test_moe_ep_loss_matches_single_device``).

- The experts' leaves are cut on ``ep`` (JAX's specs), and each rank of
  ep2, tp2, dp2 x ep2 and fsdp2 x ep2 holds JAX's shard of every leaf.
- Every mesh's first loss is within JAX's 5e-4 of JAX's single device,
  and every leaf's gradient shard of the first step equals the same
  slice of JAX's single-device gradient (rtol 2e-4, atol 2e-6).
- A dp2 run and an sp2 (ring) run at a capacity factor where tokens are
  dropped (the share is asserted > 0) give JAX's loss, aux and gradient
  shards: the dispatch is over the call's global tokens in token-major
  order (every row, every sequence chunk), as GSPMD computes it, not over
  a rank's rows or chunk.
- MoE under pp2 x ep2 (GPipe: a microbatch's capacity is its own) gives
  the 2-step losses of JAX's ``ShardedTrainer`` at pp2 (rtol 2e-4, atol
  2e-5; ep adds no arithmetic to JAX's program).

One spawn a world size; the JAX side runs in this process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
    ShardedTrainer as JShardedTrainer, build_mesh as jbuild_mesh)
from distributed_llm_training_and_inference_system_tpu.parallel.api import (
    state_specs)
from distributed_llm_training_and_inference_system_tpu.utils.tree import (
    flatten_with_paths, path_str)

import torch_dist_ranks as R

MODEL = "gpt-test-moe"
DROP = {"name": MODEL, "moe": {"capacity_factor": 0.25}}
OPT = {"lr": 1e-2}
STEPS = 2
# name: (ParallelConfig fields, world, model)
CONFIGS = {
    "ep2": (dict(expert_parallel=2), 2, MODEL),
    "tp2": (dict(tensor_parallel=2), 2, MODEL),
    "dp2-drop": (dict(data_parallel=2), 2, DROP),
    "sp2-drop": (dict(sequence_parallel=2), 2, DROP),
    "dp2ep2": (dict(data_parallel=2, expert_parallel=2), 4, MODEL),
    "fsdp2ep2": (dict(fsdp=2, expert_parallel=2), 4, MODEL),
    "pp2ep2": (dict(pipeline_parallel=2, expert_parallel=2,
                    num_microbatches=2, pipeline_schedule="gpipe",
                    activation_checkpoint="none"), 4, MODEL),
}
GRADS = [n for n in CONFIGS if not n.startswith("pp")]
DROPS = [n for n in CONFIGS if n.endswith("-drop")]


def _attn(par):
    return "ring" if par.get("sequence_parallel", 1) > 1 else "xla"


def _jax_cfg(model):
    cfg = jax_cfg(MODEL)
    if model == DROP:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=DROP["moe"]["capacity_factor"]))
    return cfg


@pytest.fixture(scope="module")
def inputs():
    cfg = _jax_cfg(MODEL)
    params = jgpt.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 16)).astype(
        np.int32)} for _ in range(STEPS)]
    return {"cfg": cfg, "params": params, "batches": batches,
            "flat": {p: np.asarray(v) for p, v in flatten_with_paths(params)}}


@pytest.fixture(scope="module")
def started(inputs):
    """Both world sizes' ranks, started before the JAX side compiles."""
    out = {}
    for world in (2, 4):
        names = [n for n, (_, w, _) in CONFIGS.items() if w == world]
        jobs = [("train_rank", (CONFIGS[n][2], CONFIGS[n][0],
                                inputs["flat"], inputs["batches"],
                                _attn(CONFIGS[n][0]), OPT, None,
                                n in GRADS)) for n in names]
        out[world] = (names, R.Spawned(R.jobs_rank, world, *[jobs]))
    return out


@pytest.fixture(scope="module")
def reference(inputs, started):
    """JAX's single-device loss, aux and gradients of the first batch (at
    the default and the dropping capacity factor) and its
    ``ShardedTrainer``'s losses at pp2, computed while the ranks run."""
    out = dict(inputs)
    _, out["tx"], _ = jts.make_train_step(
        inputs["cfg"], jax_schema.OptimizerConfig.from_dict(OPT))
    tokens = {"tokens": jnp.asarray(inputs["batches"][0]["tokens"])}
    for model in (MODEL, DROP):
        c = _jax_cfg(model)
        (total, (loss, _)), grads = jax.jit(jax.value_and_grad(
            lambda p, b, c=c: jts._loss_fn(p, b, c, "xla", "none"),
            has_aux=True))(inputs["params"], tokens)
        out[str(model)] = {"loss": float(loss),
                           "aux": float(total) - float(loss),
                           "grads": {p: np.asarray(v) for p, v in
                                     flatten_with_paths(grads)}}
    # GPipe over MoE stages at pp2 (ep adds no arithmetic to JAX's
    # program): each microbatch dispatched over its own global tokens
    par = dict(CONFIGS["pp2ep2"][0], expert_parallel=1)
    tr = JShardedTrainer(inputs["cfg"], jax_schema.OptimizerConfig(**OPT),
                         jax_schema.ParallelConfig(**par),
                         devices=jax.devices()[:2])
    tr.init_state(seed=0)           # the reference's params: one seed
    out["pp2"] = [float(tr.step({"tokens": jnp.asarray(b["tokens"])})[
        "loss"]) for b in inputs["batches"]]
    return out


@pytest.fixture(scope="module")
def runs(started):
    out = {}
    for names, ranks in started.values():
        got = ranks.results()
        for i, n in enumerate(names):
            out[n] = [r[i] for r in got]
    return out


def _jax_layout(reference, par, world):
    jpar = jax_schema.ParallelConfig(**par)
    mesh = jbuild_mesh(jpar, jax.devices()[:world])
    specs, _ = state_specs(reference["cfg"], reference["tx"], mesh,
                           jpar.zero_stage)

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))
        return {path_str(p): s for p, s in leaves}
    return mesh, flat(specs.params), flat(specs.opt_state[0].mu)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_expert_shards_are_jax_specs_shards(reference, runs, name):
    par, world, _ = CONFIGS[name]
    mesh, p_specs, mu_specs = _jax_layout(reference, par, world)
    if "expert_parallel" in par:
        assert "ep" in str(p_specs["blocks.moe.gate.kernel"])
    for res in runs[name]:
        dev = mesh.devices.flat[res["rank"]]
        for path, full in reference["flat"].items():
            assert res["p_specs"][path] == tuple(p_specs[path]), path
            assert res["o_specs"][path] == tuple(mu_specs[path]), path
            idx = NamedSharding(mesh, p_specs[path]).devices_indices_map(
                full.shape)[dev]
            np.testing.assert_array_equal(res["init_shards"][path],
                                          full[idx], err_msg=path)


@pytest.mark.parametrize("name", [n for n in GRADS if n not in DROPS])
def test_moe_mesh_matches_jax_single_device(reference, runs, name):
    """JAX's ``test_moe_ep_loss_matches_single_device``: the first step's
    loss (the gradients it updates by are held leaf by leaf below)."""
    for res in runs[name]:
        assert abs(res["losses"][0] - reference[MODEL]["loss"]) < 5e-4
        assert np.isfinite(res["losses"]).all()


@pytest.mark.parametrize("name", GRADS)
def test_moe_gradient_shards_equal_jax(reference, runs, name):
    """Each rank's gradient of every leaf (the router's the sum of every
    expert's share and the aux's, counted once) is JAX's slice of it."""
    par, world, model = CONFIGS[name]
    want = reference[str(model)]
    mesh, p_specs, _ = _jax_layout(reference, par, world)
    for res in runs[name]:
        dev = mesh.devices.flat[res["rank"]]
        np.testing.assert_allclose(res["grad_loss"], want["loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["aux"], want["aux"], rtol=1e-5,
                                   atol=1e-7)
        for path, full in want["grads"].items():
            idx = NamedSharding(mesh, p_specs[path]).devices_indices_map(
                full.shape)[dev]
            np.testing.assert_allclose(res["grads"][path], full[idx],
                                       rtol=2e-4, atol=2e-6, err_msg=path)


def test_dp2_drop_case_drops_tokens(reference):
    """The dp2 case's capacity drops choices on the global batch (the port's
    single-device dispatch over JAX's params, counted in the test)."""
    import torch

    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import gpt as tgpt, layers
    from distributed_llm_training_and_inference_system_tpu_torch.weights \
        import params_from_jax
    cfg = R.model_config(DROP)
    model = params_from_jax(reference["params"], cfg, device="cpu")
    seen = []
    dispatch = layers.moe_dispatch

    def counted(probs, c, *share):
        d = dispatch(probs, c, *share)
        seen.append((int(torch.clamp(d.counts - d.capacity, min=0).sum()),
                     probs.shape[0] * c.moe.experts_per_token))
        return d
    layers.moe_dispatch = counted
    try:
        with torch.no_grad():
            tgpt.forward(model, torch.from_numpy(
                reference["batches"][0]["tokens"]).long(), cfg)
    finally:
        layers.moe_dispatch = dispatch
    dropped = sum(d for d, _ in seen) / sum(n for _, n in seen)
    assert len(seen) == cfg.num_layers and dropped > 0


def test_moe_pp2_matches_jax_sharded_trainer(reference, runs):
    """GPipe over MoE stages: JAX's ShardedTrainer at the same pp mesh."""
    for res in runs["pp2ep2"]:
        np.testing.assert_allclose(res["losses"], reference["pp2"],
                                   rtol=2e-4, atol=2e-5)
