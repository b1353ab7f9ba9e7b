"""Checkpoints across the packages (gpt-test, fp32, CPU).

- A train state saved by the JAX package's ``CheckpointManager`` (adamw,
  adamw with bf16 moments, lion, adafactor, sgd; one leaf sharded over two
  devices, so its slices are assembled) is restored bit for bit and
  resumes in the port: the next step's loss and grad norm equal the JAX
  step's (rtol 1e-5, the adamw trajectory's tolerance in
  ``tests/test_torch_train.py``), and the parameters after it within 1e-5
  (fp32 moments).
- The port's ``TrainingEngine`` resumes from a JAX checkpoint directory.
- Each optimizer's state round-trips through the port's own checkpoints.
- An engine with ``artifact=`` a JAX checkpoint directory serves the JAX
  engine's tokens on the same directory; one on a port checkpoint
  directory serves what an engine given the model serves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.exec import (
    train_step as jts)
from distributed_llm_training_and_inference_system_tpu.io import (
    checkpoint as jckpt, data as jdata)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg, loader as tloader,
    schema as torch_schema)
from distributed_llm_training_and_inference_system_tpu_torch.exec import (
    train_step as tts)
from distributed_llm_training_and_inference_system_tpu_torch.io import (
    checkpoint as tckpt)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt)
from distributed_llm_training_and_inference_system_tpu_torch.runtime.engine \
    import TrainingEngine
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    named_from_tree, state_dict_from_flat, train_state_from_jax)

OPT = dict(lr=1e-2, scheduler=dict(warmup_steps=2, total_steps=10))
SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")
PROMPTS = [[5, 17, 99, 3, 42, 250, 23], [int(t) for t in
                                         np.random.default_rng(2).integers(
                                             1, 250, 30)]]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs():
    return (dataclasses.replace(jax_cfg("gpt-test"), dtype="float32"),
            dataclasses.replace(torch_cfg("gpt-test"), dtype="float32"))


def _jax_run(opt, steps, directory, shard=True):
    """JAX: ``steps`` steps, a checkpoint, then one more step; returns
    (the batches, the last step's metrics, the saved state, the final
    state)."""
    jc, _ = _cfgs()
    jstep, tx, _ = jts.make_train_step(
        jc, jax_schema.OptimizerConfig.from_dict(opt),
        jax_schema.ParallelConfig(activation_checkpoint="none"),
        loss_chunk=16)
    jstep = jax.jit(jstep)
    state = jts.TrainState.create(jgpt.init(jc, jax.random.PRNGKey(0)), tx)
    data = jdata.SyntheticDataset(4, 32, jc.vocab_size, seed=0)
    batches = [next(data) for _ in range(steps + 1)]
    for b in batches[:steps]:
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
    at_save = saved = state
    if shard:
        # the embedding in two row slices, one a device
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("d",))
        emb = jax.device_put(state.params["embed"]["embedding"],
                             NamedSharding(mesh, PartitionSpec("d", None)))
        saved = dataclasses.replace(state, params=dict(
            state.params, embed={"embedding": emb}))
    mgr = jckpt.CheckpointManager(directory, async_save=False)
    mgr.save(steps, saved, extra={"step": steps,
                                  "config": {"model": "gpt-test"}})
    state, m = jstep(state, {k: jnp.asarray(v)
                             for k, v in batches[steps].items()})
    return batches, m, at_save, state


@pytest.mark.parametrize("opt", [
    dict(OPT, type="adamw"),
    dict(OPT, type="adamw", moment_dtype="bfloat16"),
    dict(OPT, type="lion", lr=1e-3),
    dict(OPT, type="adafactor"),
    dict(OPT, type="sgd"),
], ids=["adamw", "adamw-bf16-mu", "lion", "adafactor", "sgd"])
def test_jax_checkpoint_resumes_with_the_same_next_step(tmp_path, opt):
    """The restored state equals the saved one bit for bit; the next step
    equals JAX's. With bf16 moments the parameters after it are not held:
    the two packages' AdamW steps differ there by up to 2.9e-5 with or
    without a checkpoint (ROADMAP queue 3 item 3)."""
    kind = opt["type"]
    batches, jm, at_save, jstate = _jax_run(opt, 2, tmp_path)
    _, tc = _cfgs()
    ocfg = torch_schema.OptimizerConfig.from_dict(opt)
    step, init, _ = tts.make_train_step(
        tc, ocfg, torch_schema.ParallelConfig(activation_checkpoint="none"),
        loss_chunk=16)
    state = tts.TrainState.create(tgpt.GPT(tc, device="cpu"), init)
    mgr = tckpt.CheckpointManager(tmp_path)
    assert mgr.is_jax()
    flat, extra = mgr.restore()
    assert extra["step"] == 2
    names = [n for n, _ in state.model.named_parameters()]
    tckpt.load_state_dict_into(state, state_dict_from_flat(flat, names,
                                                           kind))
    ref = train_state_from_jax(at_save, tc, device="cpu", optimizer=kind)
    assert state.step == ref.step == 2
    for f in dataclasses.fields(ref.opt_state):
        a, b = getattr(ref.opt_state, f.name), getattr(state.opt_state,
                                                       f.name)
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b], strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
    for x, y in zip(ref.model.parameters(), state.model.parameters()):
        assert torch.equal(x, y)
    state, tm = step(state, {k: _t(v) for k, v in batches[2].items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    if opt.get("moment_dtype") == "bfloat16":
        return
    want = named_from_tree(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params))
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-5, rtol=0, err_msg=n)


def test_training_engine_resumes_a_jax_checkpoint(tmp_path):
    """The port's TrainingEngine pointed at a JAX checkpoint directory
    restores params, optimizer state and step from it."""
    _jax_run(dict(OPT, type="adamw"), 2, tmp_path, shard=False)
    cfg = tloader.load_run_config(cli_overrides={
        "model": {"name": "gpt-test", "dtype": "float32"},
        "optimizer": OPT,
        "data": {"max_length": 32},
        "parallel": {"micro_batch_size": 4, "global_batch_size": 4,
                     "activation_checkpoint": "none"},
        "checkpoint": {"path": str(tmp_path), "async_save": False},
        "training": {"max_steps": 3}}, environ={})
    eng = TrainingEngine(cfg, device="cpu")
    assert eng.initialize() == 2
    assert eng.state.step == 2 and int(eng.state.opt_state.count) == 2
    mgr = tckpt.CheckpointManager(tmp_path)
    flat, _ = mgr.restore()
    emb = flat["params.embed.embedding"].numpy()
    np.testing.assert_array_equal(eng.state.model.embed.detach().numpy(),
                                  emb)


@pytest.mark.parametrize("kind", ["adamw", "lion", "adafactor", "sgd"])
def test_port_checkpoints_round_trip_every_optimizer(tmp_path, kind):
    _, tc = _cfgs()
    ocfg = torch_schema.OptimizerConfig.from_dict(dict(OPT, type=kind))
    step, init, _ = tts.make_train_step(
        tc, ocfg, torch_schema.ParallelConfig(activation_checkpoint="none"),
        loss_chunk=16)
    state = tts.TrainState.create(
        tgpt.init(tc, torch.Generator().manual_seed(0), device="cpu"), init)
    data = jdata.SyntheticDataset(4, 32, tc.vocab_size, seed=1)
    for _ in range(2):
        state, _ = step(state, {k: _t(v) for k, v in next(data).items()})
    mgr = tckpt.CheckpointManager(tmp_path, async_save=False)
    mgr.save(2, tckpt.state_to_dict(state))
    other = tts.TrainState.create(tgpt.GPT(tc, device="cpu"), init)
    saved, _ = mgr.restore()
    tckpt.load_state_dict_into(other, saved)
    assert other.step == 2
    for f in dataclasses.fields(state.opt_state):
        a, b = getattr(state.opt_state, f.name), getattr(other.opt_state,
                                                         f.name)
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b], strict=True):
            assert torch.equal(x, y), f.name
    # and a state of another optimizer is refused, naming the field
    if kind != "adamw":
        adam = tts.TrainState.create(tgpt.GPT(tc, device="cpu"),
                                     tts.make_train_step(
                                         tc, torch_schema.OptimizerConfig(),
                                         loss_chunk=16)[1])
        with pytest.raises(ValueError, match="optimizer field"):
            tckpt.load_state_dict_into(adam, saved)


def test_engine_serves_a_jax_checkpoint_directory(tmp_path):
    _jax_run(dict(OPT, type="adamw"), 2, tmp_path)
    je = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(
        **SERVE, artifact=str(tmp_path)), seed=0)
    te = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(
        **SERVE, artifact=str(tmp_path)), seed=0, device="cpu")
    sp = dict(temperature=0.0, max_tokens=10)
    want = [r.generated_tokens for r in je.generate(PROMPTS,
                                                    JaxSampling(**sp))]
    got = [r.generated_tokens for r in te.generate(PROMPTS,
                                                   SamplingParams(**sp))]
    assert got == want


def test_engine_serves_a_port_checkpoint_directory(tmp_path):
    _, tc = _cfgs()
    _, init, _ = tts.make_train_step(tc, torch_schema.OptimizerConfig())
    state = tts.TrainState.create(
        tgpt.init(tc, torch.Generator().manual_seed(3), device="cpu"), init)
    tckpt.CheckpointManager(tmp_path, async_save=False).save(
        1, tckpt.state_to_dict(state))
    from_dir = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(
        **SERVE, artifact=str(tmp_path)), seed=0, device="cpu")
    given = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(**SERVE),
                            params=state.model, seed=0, device="cpu")
    sp = SamplingParams(temperature=0.0, max_tokens=10)
    assert [r.generated_tokens for r in from_dir.generate(PROMPTS, sp)] == \
        [r.generated_tokens for r in given.generate(PROMPTS, sp)]
