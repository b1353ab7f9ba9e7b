"""The port's training path against the JAX package's, on the same numpy
inputs and bridged state (gpt-test, fp32, CPU).

- losses (value and gradient) 1e-5; schedules equal to 1e-6 relative
  (fp32 transcendentals of two libraries); the decay mask leaf by leaf;
- the fused AdamW update's plain path against JAX ``fused_adamw_apply``,
  rtol 1e-6;
- a 5-step trajectory of ``make_train_step`` from ``train_state_from_jax``
  (xla and flash attention, accumulation 1 and 2): loss and grad norm per
  step rtol 1e-5, parameters within 1e-5 after 5 steps;
- datasets byte-identical for the same seed; the training configs equal;
- the ``TrainingEngine`` trains, saves, resumes and continues the same
  trajectory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.exec import (
    fused_update as jfu, optimizer as jopt, schedules as jsched,
    train_step as jts)
from distributed_llm_training_and_inference_system_tpu.io import (
    data as jdata)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt, loss as jloss)
from distributed_llm_training_and_inference_system_tpu.utils import (
    tree as jtree)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg, loader as tloader, schema as torch_schema)
from distributed_llm_training_and_inference_system_tpu_torch.exec import (
    fused_update as tfu, optimizer as topt, schedules as tsched,
    train_step as tts)
from distributed_llm_training_and_inference_system_tpu_torch.io import (
    data as tdata)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt, loss as tloss)
from distributed_llm_training_and_inference_system_tpu_torch.runtime.engine \
    import TrainingEngine
from distributed_llm_training_and_inference_system_tpu_torch.utils import (
    tree as ttree)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax, train_state_from_jax)

CLASSES = ["SchedulerConfig", "OptimizerConfig", "ParallelConfig",
           "DataConfig", "CheckpointConfig", "TrainingConfig"]


def _t(a):
    return torch.from_numpy(np.array(a))


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", CLASSES)
def test_training_configs_equal_jax(name):
    jcls, tcls = getattr(jax_schema, name), getattr(torch_schema, name)
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
    d = {"scheduler": {"type": "linear", "warmup": 3}, "lr": 1e-3,
         "fused": "false", "max_steps": 7, "seq_len": 64, "dp": 1,
         "activation_checkpoint": "full", "save_interval": 9}
    assert dataclasses.asdict(tcls.from_dict(d)) == \
        dataclasses.asdict(jcls.from_dict(d))


def test_hardware_is_an_h100_and_run_config_loads():
    hw = torch_schema.HardwareConfig()
    assert hw.peak_bf16_tflops == 989.0 and hw.hbm_gb_per_chip == 80.0
    assert [f.name for f in dataclasses.fields(hw)] == \
        [f.name for f in dataclasses.fields(jax_schema.HardwareConfig)]
    cfg = tloader.load_run_config(
        cli_overrides={"model": {"name": "gpt-1b", "layers": 2},
                       "training": {"max_steps": 3}},
        environ={"LLMCTL_OPTIMIZER__LR": "0.001"})
    assert cfg.model.num_layers == 2 and cfg.model.hidden_size == 2048
    assert cfg.training.max_steps == 3 and cfg.optimizer.lr == 0.001


def test_parallel_degrees_above_one_are_refused():
    # dp, fsdp, tp, sp, pp, ep and ZeRO train on a mesh of ranks
    torch_schema.ParallelConfig(data_parallel=2, fsdp=2, tensor_parallel=2,
                                sequence_parallel=2,
                                zero_stage=1).require_supported()
    four = dataclasses.replace(torch_cfg("gpt-test"), num_layers=4)
    for degree in ("pipeline_parallel", "expert_parallel"):
        torch_schema.ParallelConfig(**{degree: 2}).require_supported(four)
    # JAX's checks: layers the stages divide, microbatches enough to fill
    # the pipeline, a known schedule; pp with sp waits for its item
    with pytest.raises(torch_schema.ConfigError, match="not divisible"):
        torch_schema.ParallelConfig(pipeline_parallel=3).require_supported(
            four)
    with pytest.raises(torch_schema.ConfigError, match="num_microbatches"):
        torch_schema.ParallelConfig(pipeline_parallel=2).validate()
    with pytest.raises(torch_schema.ConfigError, match="gpipe|1f1b"):
        torch_schema.ParallelConfig(pipeline_schedule="zb").validate()
    with pytest.raises(NotImplementedError, match="queue 1 item 7b, step 9"):
        torch_schema.ParallelConfig(
            pipeline_parallel=2, sequence_parallel=2).require_supported(four)
    # a mesh still trains with AdamW alone (item 7b, step 7)
    from distributed_llm_training_and_inference_system_tpu_torch.parallel \
        .api import ShardedTrainer
    with pytest.raises(NotImplementedError, match="item 7b, step 7"):
        ShardedTrainer(four, torch_schema.OptimizerConfig(type="lion"),
                       torch_schema.ParallelConfig(pipeline_parallel=2,
                                                   num_microbatches=2),
                       torch.device("cpu"))
    # every optimizer of the JAX package is ported (lion among them)
    init, _ = topt.make_optimizer(torch_schema.OptimizerConfig(type="lion"))
    model = tgpt.GPT(torch_cfg("gpt-test"), device="cpu")
    assert isinstance(init(model), topt.LionState)


# -- losses ------------------------------------------------------------------

def _loss_inputs(seed=0, B=2, S=12, H=16, V=40):
    rs = np.random.RandomState(seed)
    hidden = rs.randn(B, S, H).astype(np.float32)
    w = (0.3 * rs.randn(H, V)).astype(np.float32)
    tokens = rs.randint(0, V, (B, S)).astype(np.int32)
    segs = np.ones((B, S), np.int32)
    segs[0, 5:] = 2
    segs[1, 9:] = 0
    return hidden, w, tokens, segs


@pytest.mark.parametrize("packed", [False, True])
def test_losses_and_grads_match_jax(packed):
    hidden, w, tokens, segs = _loss_inputs()
    segs = segs if packed else None
    logits = np.einsum("bsh,hv->bsv", hidden, w)
    jce = jloss.cross_entropy(jnp.asarray(logits[:, :-1]),
                              jnp.asarray(tokens[:, 1:]), z_loss_weight=1e-3)
    tce = tloss.cross_entropy(_t(logits[:, :-1]), _t(tokens[:, 1:]),
                              z_loss_weight=1e-3)
    np.testing.assert_allclose(tce[0].item(), float(jce[0]), rtol=1e-5)
    jseg = None if segs is None else jnp.asarray(segs)
    tseg = None if segs is None else _t(segs)
    jl, jc = jloss.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                   jseg)
    tl_, tc = tloss.next_token_loss(_t(logits), _t(tokens), tseg)
    np.testing.assert_allclose(tl_.item(), float(jl), rtol=1e-5)
    assert tc.item() == float(jc)

    def jchunk(h, w_):
        return jloss.chunked_next_token_loss(h, w_, jnp.asarray(tokens), jseg,
                                             chunk=4, tied=False)[0]
    jv, (jgh, jgw) = jax.value_and_grad(jchunk, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w))
    th, tw = _t(hidden).requires_grad_(True), _t(w).requires_grad_(True)
    tv, _ = tloss.chunked_next_token_loss(th, tw, _t(tokens), tseg, chunk=4,
                                          tied=False)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=1e-5)
    # tied: the head is the [V, H] embedding
    jt = jloss.chunked_next_token_loss(jnp.asarray(hidden),
                                       jnp.asarray(w.T), jnp.asarray(tokens),
                                       jseg, chunk=5, tied=True)[0]
    tt = tloss.chunked_next_token_loss(_t(hidden), _t(w.T), _t(tokens), tseg,
                                       chunk=5, tied=True)[0]
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)


# -- schedules, decay mask, global norm ----------------------------------------

@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_equal_jax(kind):
    sc = dict(type=kind, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
    js = jsched.make_schedule(jax_schema.SchedulerConfig(**sc), 3e-4)
    tsf = tsched.make_schedule(torch_schema.SchedulerConfig(**sc), 3e-4)
    for step in range(0, 45):
        np.testing.assert_allclose(tsf(step).item(), float(js(step)),
                                   rtol=1e-6, atol=0)
    assert tsf(torch.tensor(7, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("tied,bias", [(False, False), (True, True)])
def test_decay_mask_equal_leaf_by_leaf(tied, bias):
    jc = dataclasses.replace(jax_cfg("gpt-test"), tie_word_embeddings=tied,
                             attention_bias=bias)
    tc = dataclasses.replace(torch_cfg("gpt-test"), tie_word_embeddings=tied,
                             attention_bias=bias)
    params = jgpt.init(jc, jax.random.PRNGKey(0))
    jmask = jopt._decay_mask(params)
    as_float = jax.tree_util.tree_map(lambda m: np.float32(m), jmask)
    ref = {n: bool(m) for n, m in
           _named(as_float, jc, np.ones_like).items()}
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc,
                            device="cpu")
    assert topt._decay_mask(model) == ref


def _named(tree, cfg, _):
    from distributed_llm_training_and_inference_system_tpu_torch.weights \
        import named_from_tree
    stacked = jax.tree_util.tree_map(
        lambda m: np.full((cfg.num_layers,), m, np.float32), tree["blocks"])
    full = dict(tree, blocks=stacked)
    return {k: float(np.asarray(v).reshape(-1)[0])
            for k, v in named_from_tree(full).items()}


def test_global_norm_and_param_count_match_jax():
    cfg = jax_cfg("gpt-test")
    params = jgpt.init(cfg, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            torch_cfg("gpt-test"), device="cpu")
    assert ttree.param_count(model) == jtree.param_count(params)
    np.testing.assert_allclose(ttree.global_norm(model).item(),
                               float(jtree.global_norm(params)), rtol=1e-6)


# -- fused AdamW ------------------------------------------------------------------

@pytest.mark.parametrize("mu_dtype,nu_dtype", [("float32", "float32"),
                                               ("bfloat16", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_fused_adamw_plain_path_matches_jax(mu_dtype, nu_dtype):
    rs = np.random.RandomState(0)
    shapes = [(64, 48), (300,), (256, 256)]      # the last: JAX's kernel
    p = [rs.randn(*s).astype(np.float32) for s in shapes]
    g = [(1e-2 * rs.randn(*s)).astype(np.float32) for s in shapes]
    mu = [(1e-3 * rs.randn(*s)).astype(np.float32) for s in shapes]
    nu = [(1e-5 * rs.rand(*s)).astype(np.float32) for s in shapes]
    decay = [True, False, True]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    mdt, ndt = getattr(torch, mu_dtype), getattr(torch, nu_dtype)
    # the port's copies first: JAX may alias (and its kernel update in
    # place) the numpy buffers it is handed
    tp = [_t(a) for a in p]
    tmu = [_t(a).to(mdt) for a in mu]
    tnu = [_t(a).to(ndt) for a in nu]
    jmu = [jnp.array(t.float().numpy()).astype(mu_dtype) for t in tmu]
    jnu = [jnp.array(t.float().numpy()).astype(nu_dtype) for t in tnu]
    # With a bf16 mu the reference is JAX's op-by-op _leaf_math: XLA's CPU
    # compilation of the interpreted Pallas kernel body drops the bf16
    # rounding of b1*mu that the source asks for (optax's order), and the
    # port keeps it
    jp, jm, jn = jfu.fused_adamw_apply(
        [jnp.array(a) for a in p], [jnp.array(a) for a in g], jmu, jnu,
        jnp.int32(4), lr=jnp.float32(2e-3), decay_mask=decay,
        clip_scale=jnp.float32(0.5), use_pallas=mu_dtype == "float32", **kw)
    tfu.fused_adamw_apply(tp, [_t(a) for a in g], tmu, tnu,
                          torch.tensor(4, dtype=torch.int32),
                          lr=torch.tensor(2e-3), decay_mask=decay,
                          clip_scale=torch.tensor(0.5), **kw)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-9)
    for a, b in zip(jm + jn, tmu + tnu):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-10)


# -- the training step ---------------------------------------------------------

def _cfgs():
    return (dataclasses.replace(jax_cfg("gpt-test"), dtype="float32"),
            dataclasses.replace(torch_cfg("gpt-test"), dtype="float32"))


OPT = dict(lr=1e-2, scheduler=dict(warmup_steps=2, total_steps=10))


@pytest.mark.parametrize("attn,accum", [("xla", 1), ("flash", 1),
                                        ("xla", 2), ("flash", 2)])
def test_five_step_trajectory_matches_jax(attn, accum):
    jc, tc = _cfgs()
    par = dict(activation_checkpoint="none",
               gradient_accumulation_steps=accum)
    jstep, tx, _ = jts.make_train_step(
        jc, jax_schema.OptimizerConfig.from_dict(OPT),
        jax_schema.ParallelConfig(**par), attn_impl=attn, loss_chunk=16)
    jstep = jax.jit(jstep)
    jstate = jts.TrainState.create(jgpt.init(jc, jax.random.PRNGKey(0)), tx)
    tstate = train_state_from_jax(jstate, tc, device="cpu")
    tstep, _, _ = tts.make_train_step(
        tc, torch_schema.OptimizerConfig.from_dict(OPT),
        torch_schema.ParallelConfig(**par), attn_impl=attn, loss_chunk=16)
    data = jdata.SyntheticDataset(4, 32, jc.vocab_size, seed=0)
    for _ in range(5):
        batch = next(data)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        assert tm["tokens"] == float(jm["tokens"])
    assert tstate.step == 5 and int(tstate.opt_state.count) == 5
    ref = train_state_from_jax(jstate, tc, device="cpu")
    for a, b in zip(ref.model.parameters(), tstate.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(),
                                   a.detach().numpy(), atol=1e-5, rtol=0)


def test_selective_remat_and_chunked_loss_change_nothing():
    """remat selective/full and the unchunked loss give the plain step's
    loss and gradient norm (same arithmetic, other memory)."""
    _, tc = _cfgs()
    batch = {k: _t(v) for k, v in next(tdata.SyntheticDataset(
        2, 32, tc.vocab_size, seed=3)).items()}
    out = []
    for remat, chunk in (("none", 0), ("selective", 16), ("full", 16)):
        model = tgpt.init(tc, torch.Generator().manual_seed(0), device="cpu")
        step, init, _ = tts.make_train_step(
            tc, torch_schema.OptimizerConfig(),
            torch_schema.ParallelConfig(activation_checkpoint=remat),
            attn_impl="flash", loss_chunk=chunk)
        _, m = step(tts.TrainState.create(model, init), batch)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    for other in out[1:]:
        np.testing.assert_allclose(other, out[0], rtol=1e-5)


def test_eval_step_matches_jax():
    jc, tc = _cfgs()
    params = jgpt.init(jc, jax.random.PRNGKey(1))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc,
                            device="cpu")
    batch = next(jdata.SyntheticDataset(2, 16, jc.vocab_size, seed=1))
    ref = jts.make_eval_step(jc)(params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    out = tts.make_eval_step(tc)(model, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]),
                               rtol=1e-5)


# -- data ------------------------------------------------------------------------

def test_synthetic_batches_byte_identical():
    j = jdata.SyntheticDataset(3, 20, 500, seed=4, host_id=1, num_hosts=2)
    t = tdata.SyntheticDataset(3, 20, 500, seed=4, host_id=1, num_hosts=2)
    for _ in range(3):
        a, b = next(j), next(t)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("pack", [True, False])
def test_memmap_batches_byte_identical(tmp_path, pack, monkeypatch):
    monkeypatch.setenv("LLMCTL_NO_NATIVE", "1")
    rs = np.random.RandomState(0)
    docs = [rs.randint(1, 1000, rs.randint(3, 40)) for _ in range(30)]
    tdata.write_token_shard(tmp_path / "a.bin", docs[:17])
    jdata.write_token_shard(tmp_path / "b.bin", docs[17:])
    j = jdata.make_dataset(str(tmp_path), 2, 24, 1000, seed=5, pack=pack)
    t = tdata.make_dataset(str(tmp_path), 2, 24, 1000, seed=5, pack=pack)
    for _ in range(6):                      # past one epoch
        a, b = next(j), next(t)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
    state = t.state_dict()
    assert state == j.state_dict()
    again = tdata.make_dataset(str(tmp_path), 2, 24, 1000, seed=5, pack=pack)
    again.load_state_dict(state)
    assert next(again)["tokens"].tobytes() == next(t)["tokens"].tobytes()
    # a remote scheme no store serves is refused as the JAX package
    # refuses it (remote shards themselves: tests/test_torch_remote_data.py)
    for pkg in (jdata, tdata):
        with pytest.raises(ValueError, match="no shard store registered"):
            pkg.make_dataset("nostore://bucket/x", 2, 24, 1000)


# -- the engine --------------------------------------------------------------------

def _run_cfg(tmp_path, max_steps):
    return tloader.load_run_config(cli_overrides={
        "model": {"name": "gpt-test"},
        "optimizer": {"lr": 1e-2, "scheduler": {"warmup_steps": 2}},
        "parallel": {"global_batch_size": 2},
        "data": {"max_length": 32},
        "checkpoint": {"path": str(tmp_path / "ck"), "interval_steps": 3},
        "training": {"max_steps": max_steps, "log_interval": 1,
                     "eval_interval": 100}}, environ={})


def test_engine_trains_saves_resumes_and_continues(tmp_path):
    full = TrainingEngine(_run_cfg(tmp_path / "a", 5), device="cpu")
    ref = full.train()
    first = TrainingEngine(_run_cfg(tmp_path / "b", 3), device="cpu")
    first.train()
    assert first.ckpt.latest_step() == 3
    second = TrainingEngine(_run_cfg(tmp_path / "b", 5), device="cpu")
    assert second.initialize(resume=True) == 3
    assert second.train_data.state_dict()["step"] == 3
    out = second.train()
    assert out["step"] == 5 and ref["mfu"] is None      # no CPU MFU
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-6)
    for a, b in zip(full.state.model.parameters(),
                    second.state.model.parameters()):
        assert torch.equal(a, b)
    assert (tmp_path / "b" / "ck" / "run_manifest.json").is_file()
    ev = second.evaluate(num_batches=2)
    assert np.isfinite(ev["loss"]) and ev["tokens"] > 0


def test_train_entry_trains_and_saves_on_the_cpu(tmp_path):
    from distributed_llm_training_and_inference_system_tpu_torch.io.\
        checkpoint import CheckpointManager
    from distributed_llm_training_and_inference_system_tpu_torch.runtime \
        import train_entry
    ck = tmp_path / "ck"
    assert train_entry.main([
        "--model", "gpt-test", "--max-steps", "2", "--device", "cpu",
        "--set", "data.max_length=32", "--set", "parallel.global_batch_size=2",
        "--set", f"checkpoint.path={ck}"]) == 0
    assert CheckpointManager(ck).latest_step() == 2
