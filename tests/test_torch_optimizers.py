"""Lion, Adafactor and SGD, and the ``selective_attn`` remat policy: the
port's training step against the JAX package's on the same numpy inputs
and bridged state (fp32, CPU).

- 5-step trajectories of ``make_train_step`` from ``train_state_from_jax``
  for each optimizer, with the adamw trajectory's tolerances
  (``tests/test_torch_train.py``): loss, grad norm and lr per step rtol
  1e-5; parameters within 1e-5 after 5 steps; the optimizer state then
  within 1e-5 (Adafactor's second moments, which estimate g^2, within
  1e-5 relative and 1e-5 of their largest element). Adafactor
  runs at widths where optax factors the kernels (hidden 128, ffn 256)
  and at gpt-test's, where nothing factors.
- ``selective_attn``: JAX's saved residuals under it are those of
  ``selective`` (the named ``attn_out`` is the o projection's output, a
  dot the dots policy keeps), and the port's saved tensors are the same
  under both policies; the flash forward runs twice a layer a step under
  both (once under no remat); loss and gradients equal JAX's under
  ``selective_attn`` within the remat tolerance (1e-5).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.exec import (
    train_step as jts)
from distributed_llm_training_and_inference_system_tpu.io import (
    data as jdata)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt)
from distributed_llm_training_and_inference_system_tpu.models.layers import (
    rope_frequencies as jrope)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg, schema as torch_schema)
from distributed_llm_training_and_inference_system_tpu_torch.exec import (
    optimizer as topt, train_step as tts)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt)
from distributed_llm_training_and_inference_system_tpu_torch.models.layers \
    import rope_frequencies as trope
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    attention as tattn)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax, train_state_from_jax)

OPT = dict(lr=1e-2, scheduler=dict(warmup_steps=2, total_steps=10))
WIDE = dict(hidden_size=128, ffn_size=256, num_heads=4, num_kv_heads=2,
            head_dim=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**over):
    return (dataclasses.replace(jax_cfg("gpt-test"), dtype="float32", **over),
            dataclasses.replace(torch_cfg("gpt-test"), dtype="float32",
                                **over))


def _steps(kind, over, remat="none", attn="xla", steps=5, lr=1e-2):
    jc, tc = _cfgs(**over)
    opt = dict(OPT, type=kind, lr=lr)
    par = dict(activation_checkpoint=remat)
    jstep, tx, _ = jts.make_train_step(
        jc, jax_schema.OptimizerConfig.from_dict(opt),
        jax_schema.ParallelConfig(**par), attn_impl=attn, loss_chunk=16)
    jstep = jax.jit(jstep)
    jstate = jts.TrainState.create(jgpt.init(jc, jax.random.PRNGKey(0)), tx)
    tstate = train_state_from_jax(jstate, tc, device="cpu", optimizer=kind)
    tstep, _, _ = tts.make_train_step(
        tc, torch_schema.OptimizerConfig.from_dict(opt),
        torch_schema.ParallelConfig(**par), attn_impl=attn, loss_chunk=16)
    data = jdata.SyntheticDataset(4, 32, jc.vocab_size, seed=0)
    for _ in range(steps):
        batch = next(data)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    return jstate, tstate, tc


@pytest.mark.parametrize("kind,over,lr", [
    ("lion", {}, 1e-3),
    ("sgd", {}, 1e-2),
    ("adafactor", {}, 1e-2),
    ("adafactor", WIDE, 1e-2),
])
def test_five_step_trajectory_matches_jax(kind, over, lr):
    jstate, tstate, tc = _steps(kind, over, lr=lr)
    assert tstate.step == 5 and int(tstate.opt_state.count) == 5
    ref = train_state_from_jax(jstate, tc, device="cpu", optimizer=kind)
    for a, b in zip(ref.model.parameters(), tstate.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-5, rtol=0)
    for f in dataclasses.fields(ref.opt_state):
        want, got = (getattr(ref.opt_state, f.name),
                     getattr(tstate.opt_state, f.name))
        if f.name == "count":
            assert int(got) == int(want) == 5
            continue
        for a, b in zip(want, got, strict=True):
            assert a.shape == b.shape, f.name
            if kind == "adafactor":
                np.testing.assert_allclose(
                    b.numpy(), a.numpy(), rtol=1e-5,
                    atol=1e-5 * float(a.abs().max()), err_msg=f.name)
            else:
                np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                           rtol=0, err_msg=f.name)


def test_adafactor_factors_as_optax_does():
    """At the wide config the stacked q/gate/down kernels and the
    embedding factor (rows and columns), norm scales do not."""
    _, tc = _cfgs(**WIDE)
    init, _ = topt.make_optimizer(torch_schema.OptimizerConfig(
        type="adafactor"))
    model = tgpt.GPT(tc, device="cpu")
    st = init(model)
    shapes = {n: (tuple(r.shape), tuple(c.shape), tuple(v.shape))
              for (n, _), r, c, v in zip(model.named_parameters(), st.v_row,
                                         st.v_col, st.v)}
    assert shapes["embed"] == ((128,), (256,), (1,))
    assert shapes["blocks.0.q"] == ((128,), (128,), (1,))
    assert shapes["blocks.1.gate"] == ((128,), (256,), (1,))
    assert shapes["blocks.0.attn_norm"] == ((1,), (1,), (128,))


# -- selective_attn ----------------------------------------------------------

def test_jax_saves_the_same_residuals_under_both_policies():
    jc, _ = _cfgs(num_layers=1)
    params = jgpt.init(jc, jax.random.PRNGKey(0))
    layer = jax.tree_util.tree_map(lambda p: p[0], params["blocks"])
    x = jnp.ones((2, 32, jc.hidden_size), jnp.float32) * 0.1
    pos = jnp.arange(32)[None].repeat(2, 0)
    inv = jrope(jc.head_dim, jc.rope.base, jc.rope.scaling,
                jc.rope.scaling_factor)
    saved = {}
    for remat in ("selective", "selective_attn"):
        blk = jgpt._remat_wrap(functools.partial(
            jgpt._block_fn, jc, "flash", "xla"), remat)

        def f(x, layer):
            return blk(x, layer, pos, None, inv)[0].sum()
        res = saved_residuals(f, x, layer)
        saved[remat] = sorted(str(a.shape) for a, why in res
                              if "argument" not in why)
    assert saved["selective"] == saved["selective_attn"]


def _port_saved_shapes(remat):
    _, tc = _cfgs(num_layers=1)
    model = tgpt.init(tc, torch.Generator().manual_seed(0), device="cpu")
    layer = tgpt.precast_params(model, torch.float32)[0]
    x = torch.full((2, 32, tc.hidden_size), 0.1, requires_grad=True)
    pos = torch.arange(32)[None].expand(2, 32)
    inv = trope(tc.head_dim, tc.rope.base, tc.rope.scaling,
                tc.rope.scaling_factor)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _, _ = tgpt._remat_wrap(tgpt._block_fn, remat)(
            layer, x, tc, pos, None, inv, None, None, "flash", "xla")
    out.sum().backward()
    return sorted(shapes)


def test_port_saves_the_same_under_both_policies():
    assert _port_saved_shapes("selective_attn") == \
        _port_saved_shapes("selective")


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("selective", 2),
                                             ("selective_attn", 2),
                                             ("full", 2)])
def test_flash_forwards_a_step(monkeypatch, remat, per_layer):
    """The flash forward runs once a layer, and again in the backward
    under every remat policy (JAX's selective_attn keeps no flash output
    either)."""
    calls = []
    real = tattn._fwd

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tattn, "_fwd", counting)
    _, tc = _cfgs()
    model = tgpt.init(tc, torch.Generator().manual_seed(0), device="cpu")
    step, init, _ = tts.make_train_step(
        tc, torch_schema.OptimizerConfig(),
        torch_schema.ParallelConfig(activation_checkpoint=remat),
        attn_impl="flash", loss_chunk=16)
    batch = {"tokens": torch.randint(1, 200, (2, 32))}
    step(tts.TrainState.create(model, init), batch)
    assert len(calls) == per_layer * tc.num_layers


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_selective_attn_loss_and_grads_match_jax(attn):
    jc, tc = _cfgs()
    params = jgpt.init(jc, jax.random.PRNGKey(0))
    batch = next(jdata.SyntheticDataset(2, 32, jc.vocab_size, seed=3))
    jloss, jgrads = jax.value_and_grad(lambda p: jts._loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jc, attn,
        "selective_attn", 16)[0])(params)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc,
                            device="cpu")
    total, _ = tts._loss_fn(model, {k: _t(v) for k, v in batch.items()}, tc,
                            attn, "selective_attn", 16)
    grads = torch.autograd.grad(total, list(model.parameters()))
    np.testing.assert_allclose(total.item(), float(jloss), rtol=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), tc,
                          device="cpu")
    for g, r in zip(grads, ref.parameters()):
        np.testing.assert_allclose(g.numpy(), r.detach().numpy(), atol=1e-5,
                                   rtol=0)
