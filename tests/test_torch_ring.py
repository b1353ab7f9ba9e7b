"""Context-parallel attention and sharded training end to end on gloo
ranks, held to the JAX package (as ``tests/test_pipeline_ring.py``).

- Ring attention over sp 4 and sp 2, and Ulysses over sp 2 (GQA: 4 query
  over 2 kv heads, two segments): output and q/k/v gradients equal JAX's
  dense ``dot_product_attention`` at the JAX tests' tolerances; the ring
  saves no score matrix (its autograd node holds q, k, v, segments,
  positions, out and lse only, all O(S/sp)); a checkpointed ring whose
  backward recomputes it on another thread (as autograd's CUDA device
  thread does) still finds the mesh.
- gpt-test on dp2 x sp2 with ring and on sp2 with Ulysses: the forward's
  loss equals JAX's plain ("xla") forward, and two training steps equal
  JAX's dense single-device step.
- ``llmctl-torch --device cpu train launch`` with dp2 spawns two gloo
  ranks, resumes a JAX checkpoint of step 0, and reaches JAX's losses on
  the two ranks' stripes of the synthetic data; the sharded checkpoint
  it writes (rank 0, the single-device format) restores into a
  single-device engine with JAX's params and moments.
"""

import contextlib
import io
import json
from pathlib import Path

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
from distributed_llm_training_and_inference_system_tpu.io import (
    checkpoint as jckpt, data as jdata)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt)
from distributed_llm_training_and_inference_system_tpu.models.layers import (
    attention_mask, dot_product_attention)
from distributed_llm_training_and_inference_system_tpu.utils.tree import (
    flatten_with_paths)
from distributed_llm_training_and_inference_system_tpu_torch.cli import (
    main as tmain)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    loader as tloader)
from distributed_llm_training_and_inference_system_tpu_torch.runtime.engine \
    import TrainingEngine
from distributed_llm_training_and_inference_system_tpu_torch.runtime.\
    train_entry import parse_overrides
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    named_from_tree)

import torch_dist_ranks as R

B, S, NQ, NKV, D = 2, 32, 4, 2, 16
JOBS = [("ring", {"sp": 4}), ("ring", {"dp": 2, "sp": 2}),
        ("ulysses", {"dp": 2, "sp": 2}),
        ("ring-remat-thread", {"dp": 2, "sp": 2})]


def _inputs():
    rng = np.random.default_rng(0)
    out = {n: rng.standard_normal((B, S, NQ if n in ("q", "dout") else NKV,
                                   D)).astype(np.float32)
           for n in ("q", "k", "v", "dout")}
    out["positions"] = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg = np.ones((B, S), np.int32)
    seg[:, 20:] = 2
    out["segment_ids"] = seg
    return out


@pytest.fixture(scope="module")
def attention():
    inp = _inputs()
    ranks = R.spawn(R.attention_rank, 4, JOBS, inp)
    pos, seg = inp["positions"], inp["segment_ids"]
    mask = attention_mask(pos, pos, seg, seg)

    def ref_loss(q, k, v):
        return jnp.sum(dot_product_attention(q, k, v, mask) * inp["dout"])
    q, k, v = (jnp.asarray(inp[n]) for n in "qkv")
    out = dot_product_attention(q, k, v, mask)
    grads = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    ref = {"out": np.asarray(out), **{f"d{n}": np.asarray(g)
                                      for n, g in zip("qkv", grads)}}
    return ranks, ref


@pytest.mark.parametrize("job", range(len(JOBS)),
                         ids=[f"{s}-{'x'.join(f'{a}{n}' for a, n in m.items())}"
                              for s, m in JOBS])
def test_context_parallel_attention_matches_dense(attention, job):
    ranks, ref = attention
    shape = JOBS[job][1]
    sp = shape["sp"]
    for d in range(shape.get("dp", 1)):
        # the chunks of data index d (ranks are dp-major), in sequence order
        parts = sorted((r[job] for r in ranks[d * sp:(d + 1) * sp]),
                       key=lambda p: p["sp_index"])
        for key, tol in (("out", (2e-4, 2e-4)), ("dq", (5e-4, 5e-5)),
                         ("dk", (5e-4, 5e-5)), ("dv", (5e-4, 5e-5))):
            got = np.concatenate([p[key] for p in parts], axis=1)
            np.testing.assert_allclose(got, ref[key], rtol=tol[0],
                                       atol=tol[1], err_msg=key)


def test_ring_saves_no_score_matrix():
    """The ring's autograd node keeps q, k, v, segments, positions, out and
    lse: nothing as large as a chunk's score matrix (the node is the same
    whatever sp; a one-chunk ring on the plain path here)."""
    from distributed_llm_training_and_inference_system_tpu_torch.ops import (
        ring_attention as tring)
    saved = []
    q = torch.randn(1, 64, 4, 16, requires_grad=True)
    k = torch.randn(1, 64, 2, 16, requires_grad=True)
    v = torch.randn(1, 64, 2, 16, requires_grad=True)
    seg = torch.ones(1, 64, dtype=torch.int32)
    pos = torch.arange(64, dtype=torch.int32)[None]
    qf, kf, vf, sq, pq, sk, pk, _ = tring.fold_gqa(q, k, v, seg, pos)
    one = type("OneChunk", (), {"axis_size": lambda self, a: 1,
                                "group": lambda self, a: None})()

    def pack(t):
        saved.append(t.numel())
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tring._Ring.apply(qf, kf, vf, sq, sk, pq, pk, "sp", 0.25, 512,
                                512, one)
    out.sum().backward()
    assert len(saved) == 9
    # a score matrix of the chunk would be [B*Nkv, G*S, S]: 4x q's size
    assert max(saved) <= qf.numel() < qf.shape[0] * qf.shape[1] * 64


def _jax_reference_losses(params, batches, steps, opt=None):
    cfg = jax_cfg("gpt-test")
    step, tx, _ = jts.make_train_step(
        cfg, jax_schema.OptimizerConfig.from_dict(opt or {"lr": 1e-2}))
    state = jts.TrainState.create(params, tx)
    jstep = jax.jit(step)
    losses = []
    for b in batches[:steps]:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("impl,par,world", [
    ("ring", dict(data_parallel=2, sequence_parallel=2), 4),
    ("ulysses", dict(sequence_parallel=2), 2)], ids=["ring-dp2sp2",
                                                     "ulysses-sp2"])
def test_context_parallel_training_matches_dense(impl, par, world):
    cfg = jax_cfg("gpt-test")
    params = jgpt.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (4, 64)).astype(
        np.int32)} for _ in range(2)]
    ref, _ = _jax_reference_losses(params, batches, 2)
    flat = {p: np.asarray(v) for p, v in flatten_with_paths(params)}
    runs = R.spawn(R.train_rank, world, "gpt-test", par, flat, batches, impl)
    jeval = jts.make_eval_step(cfg, "xla")(
        params, {"tokens": jnp.asarray(batches[0]["tokens"])})
    for res in runs:
        np.testing.assert_allclose(res["eval_loss"], float(jeval["loss"]),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(res["losses"], ref, rtol=2e-4, atol=2e-5)


def test_train_launch_dp2_reaches_jax_and_restores_on_one_device(tmp_path):
    ck = tmp_path / "ck"
    sets = ["data.max_length=32", "parallel.global_batch_size=4",
            "parallel.micro_batch_size=2", f"checkpoint.path={ck}",
            "checkpoint.async_save=false", "training.log_interval=1",
            "training.eval_interval=1000"]
    tcfg = tloader.load_run_config(cli_overrides=parse_overrides(sets),
                                   environ={})
    cfg = jax_cfg("gpt-test")
    opt = tcfg.to_dict()["optimizer"]
    params = jgpt.init(cfg, jax.random.PRNGKey(0))
    _, tx, _ = jts.make_train_step(cfg, jax_schema.OptimizerConfig.from_dict(
        opt))
    # a JAX checkpoint of step 0: the launched ranks resume from it
    jckpt.CheckpointManager(ck, async_save=False).save(
        0, jts.TrainState.create(params, tx), extra={"step": 0})
    # the two data ranks' stripes of the synthetic stream, step by step
    seed = tcfg.data.seed
    stripes = [jdata.SyntheticDataset(2, 32, cfg.vocab_size, seed=seed,
                                      host_id=h, num_hosts=2)
               for h in range(2)]
    batches = []
    for _ in range(3):
        parts = [next(s) for s in stripes]
        batches.append({k: np.concatenate([p[k] for p in parts])
                        for k in parts[0]})
    ref, jstate = _jax_reference_losses(params, batches, 3, opt)

    argv = ["--device", "cpu", "train", "launch", "--model", "gpt-test",
            "--max-steps", "3", "--set", "parallel.data_parallel=2"]
    for s in sets:
        argv += ["--set", s]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tmain.main(argv) == 0
    logged = [float(line.split("| loss ")[1].split()[0])
              for line in buf.getvalue().splitlines() if "| loss " in line]
    np.testing.assert_allclose(logged, ref, rtol=0, atol=1e-4)
    manifest = json.loads((Path(ck) / "run_manifest.json").read_text())
    assert manifest["num_devices"] == 2 and manifest["backend"] == "gloo"
    np.testing.assert_allclose(manifest["final_metrics"]["loss"], ref[-1],
                               rtol=2e-4, atol=2e-5)

    # the sharded run's checkpoint (rank 0, single-device format) restores
    # into a single-device engine: JAX's params and moments after 3 steps
    one = tloader.load_run_config(cli_overrides={
        "model": {"name": "gpt-test", "dtype": "float32"},
        "data": {"max_length": 32},
        "parallel": {"global_batch_size": 4, "micro_batch_size": 2},
        "checkpoint": {"path": str(ck), "async_save": False}}, environ={})
    eng = TrainingEngine(one, device="cpu")
    try:
        assert eng.initialize() == 3
        assert eng.state.step == 3 and int(eng.state.opt_state.count) == 3
        want = named_from_tree(jax.tree_util.tree_map(np.asarray,
                                                      jstate.params))
        mu = named_from_tree(jax.tree_util.tree_map(
            np.asarray, jstate.opt_state[0].mu))
        names = [n for n, _ in eng.state.model.named_parameters()]
        for n, p, m in zip(names, eng.state.model.parameters(),
                           eng.state.opt_state.mu):
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=n)
            np.testing.assert_allclose(m.numpy(), mu[n].numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=n)
    finally:
        eng.close()
