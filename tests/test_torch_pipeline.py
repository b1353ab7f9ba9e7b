"""The port's pipeline (``parallel/pipeline.py``: one rank a stage, GPipe
and 1F1B) on gloo ranks, held to the JAX package, as JAX's
``tests/test_pipeline_ring.py`` holds its own pipeline.

- ``test_pipeline_matches_single_device`` and ``test_pipeline_with_tp``
  on the port: a 3-step gpt-test (4 layers) trajectory at pp2 (both
  schedules), pp2 x dp2 and pp2 x tp2 equals JAX's single-device
  ``make_train_step`` from the same params at JAX's rtol 2e-3 / atol
  1e-4, and so does the forward-only loss through the stages;
- ``test_1f1b_matches_gpipe_trajectory``: the port's 1F1B equals its
  GPipe within rtol 2e-4 / atol 2e-5;
- each rank holds JAX's shard of each leaf with the stacked axis on pp
  (the params at init, the moments' specs), and a pp2 run's checkpoint
  is the single-device file: it loads into a one-device train state and
  holds JAX's final params;
- ``test_1f1b_memory_constant_in_microbatches``: the bytes saved for
  backward at once on a rank grow < 1.3x from M = 4 to 16 under 1F1B and
  > 1.5x under GPipe (JAX's bounds);
- the batch layout (``reshape_batch_for_pipeline``,
  ``pipeline_batch_specs``) and the 1F1B order.

One spawn a world size; the JAX side runs in this process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from distributed_llm_training_and_inference_system_tpu.parallel import (
    pipeline as jpipeline)
from distributed_llm_training_and_inference_system_tpu.parallel.api import (
    state_specs)
from distributed_llm_training_and_inference_system_tpu.utils.tree import (
    flatten_with_paths, path_str)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    OptimizerConfig, ParallelConfig)
from distributed_llm_training_and_inference_system_tpu_torch.parallel import (
    pipeline as tpipeline)
from distributed_llm_training_and_inference_system_tpu_torch.parallel.mesh \
    import mesh_shape_from_config
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_ranks as R

MODEL = {"name": "gpt-test", "num_layers": 4}
OPT = {"lr": 1e-2}
STEPS = 3
BASE = dict(pipeline_parallel=2, activation_checkpoint="none")
# name: (ParallelConfig fields, world)
CONFIGS = {
    "pp2-gpipe": (dict(BASE, num_microbatches=4, pipeline_schedule="gpipe"),
                  2),
    "pp2-1f1b": (dict(BASE, num_microbatches=4, pipeline_schedule="1f1b"),
                 2),
    "pp2dp2": (dict(BASE, data_parallel=2, num_microbatches=2), 4),
    "pp2tp2": (dict(pipeline_parallel=2, tensor_parallel=2,
                    num_microbatches=2, activation_checkpoint="selective"),
               4),
}
MEMORY = {(sched, M): dict(BASE, num_microbatches=M, pipeline_schedule=sched)
          for sched in ("gpipe", "1f1b") for M in (4, 16)}


@pytest.fixture(scope="module")
def inputs():
    cfg = dataclasses.replace(jax_cfg("gpt-test"), num_layers=4)
    params = jgpt.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (8, 32)).astype(
        np.int32)} for _ in range(STEPS)]
    return {"cfg": cfg, "params": params, "batches": batches,
            "flat": {p: np.asarray(v) for p, v in flatten_with_paths(params)}}


@pytest.fixture(scope="module")
def started(inputs, tmp_path_factory):
    """Both world sizes' ranks, started before the JAX side compiles."""
    ck = tmp_path_factory.mktemp("pp2-ckpt")
    out = {"ckpt": ck}
    for world in (2, 4):
        names = [n for n, (_, w) in CONFIGS.items() if w == world]
        jobs = [("train_rank", (MODEL, CONFIGS[n][0], inputs["flat"],
                                inputs["batches"], "xla", OPT,
                                str(ck) if n == "pp2-gpipe" else None))
                for n in names]
        if world == 2:
            names += list(MEMORY)
            jobs += [("saved_bytes_rank", (MODEL, par, 32))
                     for par in MEMORY.values()]
        out[world] = (names, R.Spawned(R.jobs_rank, world, jobs))
    return out


@pytest.fixture(scope="module")
def reference(inputs, started):
    """JAX's single-device trajectory and final params, computed while the
    ranks run."""
    # no remat: the same math, compiled in half the time
    step, tx, _ = jts.make_train_step(
        inputs["cfg"], jax_schema.OptimizerConfig.from_dict(OPT),
        jax_schema.ParallelConfig(activation_checkpoint="none"))
    state = jts.TrainState.create(inputs["params"], tx)
    jstep = jax.jit(step)
    losses = []
    for b in inputs["batches"]:
        state, m = jstep(state, {"tokens": jnp.asarray(b["tokens"])})
        losses.append(float(m["loss"]))
    return dict(inputs, tx=tx, losses=losses, final={
        p: np.asarray(v) for p, v in flatten_with_paths(state.params)})


@pytest.fixture(scope="module")
def runs(started):
    out = {"ckpt": started["ckpt"]}
    for world in (2, 4):
        names, ranks = started[world]
        got = ranks.results()
        for i, n in enumerate(names):
            out[n] = [r[i] for r in got]
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pipeline_trajectory_matches_jax_single_device(reference, runs,
                                                       name):
    for res in runs[name]:
        np.testing.assert_allclose(res["losses"], reference["losses"],
                                   rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(res["eval_loss"], reference["losses"][0],
                                   rtol=2e-3, atol=1e-4)
    got = runs[name][0]["params"]
    for path, want in reference["final"].items():
        np.testing.assert_allclose(got[path], want, rtol=2e-3, atol=1e-4,
                                   err_msg=path)


def test_port_1f1b_matches_its_gpipe(runs):
    for a, b in zip(runs["pp2-1f1b"], runs["pp2-gpipe"]):
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(a["grad_norms"], b["grad_norms"],
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_shards_are_jax_specs_shards(reference, runs, name):
    """Every rank holds the slice of each leaf that JAX's NamedSharding
    gives its device, block leaves cut on pp by their stacked axis; the
    moments' specs are JAX's."""
    par, world = CONFIGS[name]
    jpar = jax_schema.ParallelConfig(**par)
    mesh = jbuild_mesh(jpar, jax.devices()[:world])
    specs, _ = state_specs(reference["cfg"], reference["tx"], mesh,
                           jpar.zero_stage)

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))
        return {path_str(p): s for p, s in leaves}
    p_specs, mu_specs = flat(specs.params), flat(specs.opt_state[0].mu)
    assert p_specs["blocks.q.kernel"][0] == "pp"
    for res in runs[name]:
        dev = mesh.devices.flat[res["rank"]]
        for path, full in reference["flat"].items():
            assert res["p_specs"][path] == tuple(p_specs[path]), path
            assert res["o_specs"][path] == tuple(mu_specs[path]), path
            idx = NamedSharding(mesh, p_specs[path]).devices_indices_map(
                full.shape)[dev]
            np.testing.assert_array_equal(res["init_shards"][path],
                                          full[idx], err_msg=path)


def test_pp2_checkpoint_is_the_single_device_file(reference, runs):
    from distributed_llm_training_and_inference_system_tpu_torch.exec \
        import train_step as tts
    from distributed_llm_training_and_inference_system_tpu_torch.io \
        .checkpoint import CheckpointManager, load_state_dict_into
    from distributed_llm_training_and_inference_system_tpu_torch.models \
        import gpt as tgpt
    from distributed_llm_training_and_inference_system_tpu_torch.weights \
        import params_to_tree
    state, _ = CheckpointManager(runs["ckpt"]).restore()
    assert state["step"] == STEPS
    cfg = R.model_config(MODEL)
    _, init, _ = tts.make_train_step(cfg, OptimizerConfig(**OPT))
    one = tts.TrainState.create(tgpt.GPT(cfg, device="cpu"), init)
    load_state_dict_into(one, state)
    got = dict(flatten_with_paths(params_to_tree(one.model)))
    for path, want in reference["final"].items():
        np.testing.assert_allclose(got[path].detach().numpy(), want,
                                   rtol=2e-3, atol=1e-4, err_msg=path)
    assert int(one.opt_state.count) == STEPS


def test_1f1b_saved_bytes_constant_in_microbatches(runs):
    for rank in range(2):
        grow_1f1b = (runs[("1f1b", 16)][rank] / runs[("1f1b", 4)][rank])
        grow_gpipe = (runs[("gpipe", 16)][rank]
                      / runs[("gpipe", 4)][rank])
        assert grow_1f1b < 1.3, (rank, grow_1f1b)
        assert grow_gpipe > 1.5, (rank, grow_gpipe)


def test_pipeline_batch_layout_equals_jax():
    batch = {"tokens": np.arange(8 * 6).reshape(8, 6),
             "offsets": np.arange(8), "seg": np.ones((8, 6, 2))}
    want = jpipeline.reshape_batch_for_pipeline(batch, 4)
    got = tpipeline.reshape_batch_for_pipeline(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 4)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for par, world in [(dict(pipeline_parallel=2, data_parallel=2), 4),
                       (dict(pipeline_parallel=2, fsdp=2, data_parallel=2),
                        8), (dict(pipeline_parallel=4), 4)]:
        jpar = jax_schema.ParallelConfig(num_microbatches=4, **par)
        mesh = jbuild_mesh(jpar, jax.devices()[:world])
        jspecs = jpipeline.pipeline_batch_specs(want, mesh)
        tspecs = tpipeline.pipeline_batch_specs(
            want, mesh_shape_from_config(ParallelConfig(num_microbatches=4,
                                                        **par)))
        assert {k: tuple(v) for k, v in jspecs.items()} == tspecs


ORDERS = {"gpipe": tpipeline.gpipe_order,
          "1f1b": tpipeline.one_f_one_b_order}


def _ops(stage: int, step) -> set:
    """A hop's messages as (from stage, to stage, what)."""
    _, send, recv = step
    up = {"act": 1, "cot": -1}
    out = set()
    if send:
        out.add((stage, stage + up[send[0]], send))
    if recv:
        out.add((stage - up[recv[0]], stage, recv))
    return out


def _stuck(orders: list) -> list:
    """Plays every stage's hops as NCCL runs a rank's p2p calls: one at a
    time in order, a pair's messages together, and a message done only
    once both ends have posted it (no buffering: a large send). Returns
    the stages left waiting, [] when every hop ended. A message whose
    other end names another one next (the k-th messages between two
    stages differ) never ends either."""
    hops = [[_ops(s, st) for st in o if st[0] == "X"]
            for s, o in enumerate(orders)]
    pos = [0] * len(hops)
    done = [set() for _ in hops]

    def posted(s):
        return hops[s][pos[s]] if pos[s] < len(hops[s]) else set()
    moved = True
    while moved:
        moved = False
        for s in range(len(hops)):
            for msg in posted(s):
                peer = msg[1] if msg[0] == s else msg[0]
                if msg in posted(peer):
                    done[s].add(msg)
        for s in range(len(hops)):
            if pos[s] < len(hops[s]) and posted(s) <= done[s]:
                pos[s], done[s], moved = pos[s] + 1, set(), True
    return [s for s in range(len(hops)) if pos[s] < len(hops[s])]


@pytest.mark.parametrize("schedule", list(ORDERS))
def test_stage_orders_end_under_in_order_p2p(schedule):
    """Every stage's hops end when each rank's p2p calls run in order and
    a send waits for its receiver (NCCL's worst case), for pp 2-4 and any
    M; each input and cotangent arrives before the step that uses it."""
    for pp in (2, 3, 4):
        for M in range(1, 10):
            orders = [ORDERS[schedule](s, pp, M) for s in range(pp)]
            assert _stuck(orders) == [], (pp, M)
            for s, order in enumerate(orders):
                have = set()
                for st in order:
                    if st[0] == "X":
                        have |= {st[2]} if st[2] else set()
                    elif st[0] == "F" and s > 0:
                        assert ("act", st[1]) in have, (pp, M, s, st)
                    elif st[0] == "B" and s < pp - 1:
                        assert ("cot", st[1]) in have, (pp, M, s, st)


def test_in_order_matcher_finds_unpaired_1f1b_deadlock():
    """The same 1F1B order with each pair posted as a send, then a
    receive: at pp 2, M 4, stage 0's second send waits for stage 1's
    second receive, which waits behind its first send, which waits for
    stage 0's first receive, behind that second send."""
    def unpaired(order):
        out = []
        for st in order:
            if st[0] == "X" and st[1] and st[2]:
                out += [("X", st[1], None), ("X", None, st[2])]
            else:
                out.append(st)
        return out
    orders = [unpaired(tpipeline.one_f_one_b_order(s, 2, 4))
              for s in range(2)]
    assert _stuck(orders) == [0, 1]


def test_1f1b_order_holds_at_most_pp_minus_stage_microbatches():
    for pp in (2, 3, 4):
        for M in (pp, 2 * pp + 1):
            for s in range(pp):
                order = [st for st in tpipeline.one_f_one_b_order(s, pp, M)
                         if st[0] != "X"]
                assert sorted(order) == sorted(
                    [("F", m) for m in range(M)]
                    + [("B", m) for m in range(M)])
                live = peak = 0
                for kind, m in order:
                    live += 1 if kind == "F" else -1
                    peak = max(peak, live)
                    # a backward follows its own forward
                    if kind == "B":
                        assert order.index(("F", m)) < order.index(("B", m))
                assert peak == min(pp - s, M)
