"""The port's mixture-of-experts block, model and training step against the
JAX package's, on the same numpy inputs and bridged params (CPU).

Tolerances: ``moe_block`` out and aux within 1e-5 in fp32, with the same
kept and dropped choices; bf16 out within 2e-2 of its largest element
(one rounding of x's dtype either way); whole-model logits 1e-4 and the
aux loss 1e-5; gradients of loss + aux 1e-4 of each leaf's largest; the
3-step trajectory's loss and gradient norm 1e-5 relative, its parameters
1e-5, as the dense trajectory test. Quantized MoE leaves equal JAX's
bytes exactly.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.exec import (
    train_step as jts)
from distributed_llm_training_and_inference_system_tpu.io import (
    data as jdata)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt, layers as jl)
from distributed_llm_training_and_inference_system_tpu.ops import (
    quantization as jq)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    get_model_config as torch_cfg, schema as torch_schema)
from distributed_llm_training_and_inference_system_tpu_torch.exec import (
    train_step as tts)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt, layers as tl)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    quantization as tq)
from distributed_llm_training_and_inference_system_tpu_torch.serve.engine \
    import quantize_blocks
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    named_from_tree, params_from_jax, train_state_from_jax)

NAME = "gpt-test-moe"
MOE = ("router", "gate", "up", "down")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(name=NAME, **moe):
    j, t = jax_cfg(name), torch_cfg(name)
    if moe:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe))
    return j, t


def _wide_cfgs():
    """gpt-test-moe with a router large enough to quantize (L * H * E =
    4096 elements, the quantizers' floor): 8 experts over H = 256."""
    over = dict(hidden_size=256, head_dim=64)
    j, t = _cfgs(num_experts=8)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _block_inputs(seed, B=3, S=9, H=64, F=128, E=4):
    """x [B, S, H] with two zero rows (uniform router probabilities: every
    expert ties) and a layer whose router favours expert 0 (a direction
    shared by every row), so that capacity drops choices below a factor
    of 2."""
    rs = np.random.RandomState(seed)
    u = rs.randn(H)
    x = (rs.randn(B, S, H) + 0.5 * u).astype(np.float32)
    x[0, 2] = 0.0
    x[2, 5] = 0.0
    router = 0.3 * rs.randn(H, E)
    router[:, 0] += 0.03 * u
    layer = {"router": router, "gate": 0.1 * rs.randn(E, H, F),
             "up": 0.1 * rs.randn(E, H, F), "down": 0.1 * rs.randn(E, F, H)}
    return x, {k: v.astype(np.float32) for k, v in layer.items()}


def _jax_layer(layer, dtype=jnp.float32):
    return {k: {"kernel": jnp.asarray(v).astype(dtype)}
            for k, v in layer.items()}


def _torch_layer(layer, dtype=torch.float32):
    return SimpleNamespace(**{f"moe_{k}": _t(v).to(dtype)
                              for k, v in layer.items()})


def _one_hot_kept(top_e, E, C):
    """The GShard one-hot rule, independently of any sort: choice (n, k)
    is kept while fewer than C earlier choices (token-major order) went to
    its expert."""
    N, K = top_e.shape
    seen = np.zeros(E, np.int64)
    kept = np.zeros((N, K), bool)
    for n in range(N):
        for k in range(K):
            e = top_e[n, k]
            kept[n, k] = seen[e] < C
            seen[e] += 1
    return kept


# -- moe_block ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0, 1.25, 2.0])
def test_moe_block_keeps_jax_choices_at_every_capacity(capacity_factor,
                                                       dtype):
    jc, tc = _cfgs(capacity_factor=capacity_factor)
    x, layer = _block_inputs(seed=int(capacity_factor * 4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    jout, jaux = jl.moe_block(jx, _jax_layer(layer, jdt), jc)
    tx = _t(x).to(tdt)
    with torch.no_grad():
        tout, taux = tl.moe_block(tx, _torch_layer(layer, tdt), tc)
        logits = tx.reshape(-1, 64).float() @ _torch_layer(
            layer, tdt).moe_router.float()
        d = tl.moe_dispatch(torch.softmax(logits, dim=-1), tc)

    # the same choices, top-K order and tie order included, as
    # jax.lax.top_k on JAX's own router probabilities
    jlog = jnp.einsum("nh,he->ne", jx.reshape(-1, 64).astype(jnp.float32),
                      jnp.asarray(layer["router"]).astype(jdt)
                      .astype(jnp.float32))
    _, jtop = jax.lax.top_k(jax.nn.softmax(jlog, axis=-1), 2)
    np.testing.assert_array_equal(d.top_e.numpy(), np.asarray(jtop))
    # the zero rows tie every expert: the two lowest ids, in order
    assert d.top_e[2].tolist() == [0, 1] and d.top_e[23].tolist() == [0, 1]
    N = x.shape[0] * x.shape[1]
    C = max(int(capacity_factor * 2 * N / 4), 1)
    assert d.capacity == C
    kept = _one_hot_kept(np.asarray(jtop), 4, C)
    np.testing.assert_array_equal(d.slot.numpy() >= 0, kept)
    if capacity_factor < 2.0:
        assert not kept.all(), "no choice was dropped"
    # every kept choice holds its own buffer slot, and the buffers hold
    # exactly the kept tokens
    s = d.slot.numpy()
    assert len(set(s[kept].tolist())) == kept.sum()
    tok, valid = d.tok.numpy().reshape(-1), d.valid.numpy().reshape(-1)
    np.testing.assert_array_equal(tok[s[kept]], np.nonzero(kept)[0])
    assert valid.sum() == kept.sum()

    np.testing.assert_allclose(taux.item(), float(jaux), rtol=0, atol=1e-5)
    got = tout.float().numpy()
    ref = np.asarray(jout.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_moe_combine_adds_in_buffer_order_and_repeats_bit_for_bit():
    """K = 3: a token's three rows are added to zero in ascending expert id
    (the JAX scatter-add's buffer order), and two calls give equal bits."""
    jc, tc = _cfgs(experts_per_token=3, capacity_factor=2.0)
    x, layer = _block_inputs(seed=5)
    with torch.no_grad():
        a, _ = tl.moe_block(_t(x), _torch_layer(layer), tc)
        b, _ = tl.moe_block(_t(x), _torch_layer(layer), tc)
    assert torch.equal(a, b)
    jout, _ = jl.moe_block(jnp.asarray(x), _jax_layer(layer), jc)
    np.testing.assert_allclose(a.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


# -- the model ----------------------------------------------------------------

def _np_params(cfg, seed=0):
    p = jgpt.init(cfg, jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rs.randn(*a.shape).astype(np.float32),
        p)


def test_moe_presets_construct_with_jax_parameter_counts():
    for name in ("gpt-moe-8x1b", "gpt-moe-1b", NAME):
        model = tgpt.GPT(torch_cfg(name), device="meta")
        n = sum(p.numel() for p in model.parameters())
        shapes = jax.eval_shape(lambda: jgpt.init(jax_cfg(name),
                                                  jax.random.PRNGKey(0)))
        assert n == sum(int(np.prod(s.shape))
                        for s in jax.tree_util.tree_leaves(shapes)), name
        blk = model.blocks[0]
        assert not hasattr(blk, "gate") and blk.moe_gate.dim() == 3


@pytest.mark.parametrize("remat", ["none", "selective", "full"])
def test_moe_forward_aux_and_grads_match_jax(remat):
    jc, tc = _cfgs()
    p = _np_params(jc, seed=1)
    model = params_from_jax(p, tc, device="cpu")
    rs = np.random.RandomState(2)
    batch = {"tokens": rs.randint(0, jc.vocab_size, (2, 24))}
    jlog, jaux = jgpt.forward(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(batch["tokens"]), jc,
                              return_aux=True)
    with torch.no_grad():
        tlog, taux = tgpt.forward(model, _t(batch["tokens"]).long(), tc,
                                  return_aux=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=0, atol=1e-5)
    assert taux.item() > 0

    def jloss(params):
        return jts._loss_fn(params, {"tokens": jnp.asarray(batch["tokens"])},
                            jc, "xla", "none", 16)
    (jtotal, (jl_, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p))
    total, (loss, _) = tts._loss_fn(model, {"tokens": _t(batch["tokens"])
                                            .long()}, tc, "xla", remat, 16)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl_), rtol=1e-5)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params)
    ref = named_from_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, g in zip(names, grads):
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * max(np.abs(r).max(), 1e-6),
                                   err_msg=name)


OPT = dict(lr=1e-2, scheduler=dict(warmup_steps=2, total_steps=10))


def test_moe_three_step_trajectory_matches_jax():
    jc, tc = _cfgs()
    par = dict(activation_checkpoint="none")
    jstep, tx, _ = jts.make_train_step(
        jc, jax_schema.OptimizerConfig.from_dict(OPT),
        jax_schema.ParallelConfig(**par), loss_chunk=16)
    jstep = jax.jit(jstep)
    jstate = jts.TrainState.create(jgpt.init(jc, jax.random.PRNGKey(0)), tx)
    tstate = train_state_from_jax(jstate, tc, device="cpu")
    tstep, _, _ = tts.make_train_step(
        tc, torch_schema.OptimizerConfig.from_dict(OPT),
        torch_schema.ParallelConfig(**par), loss_chunk=16)
    data = jdata.SyntheticDataset(4, 32, jc.vocab_size, seed=0)
    for _ in range(3):
        batch = next(data)
        _, jaux = jgpt.forward(jstate.params, jnp.asarray(batch["tokens"]),
                               jc, return_aux=True)
        with torch.no_grad():
            _, taux = tgpt.forward(tstate.model, _t(batch["tokens"]).long(),
                                   tc, return_aux=True)
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    ref = train_state_from_jax(jstate, tc, device="cpu")
    for (name, a), b in zip(ref.model.named_parameters(),
                            tstate.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
    for a, b in zip(ref.opt_state.mu + ref.opt_state.nu,
                    tstate.opt_state.mu + tstate.opt_state.nu):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)


def test_moe_trains_through_train_entry_and_refuses_expert_parallel(
        tmp_path):
    from distributed_llm_training_and_inference_system_tpu_torch.io.\
        checkpoint import CheckpointManager
    from distributed_llm_training_and_inference_system_tpu_torch.runtime \
        import train_entry
    ck = tmp_path / "ck"
    common = ["--model", NAME, "--device", "cpu", "--set",
              "data.max_length=32", "--set", "parallel.global_batch_size=2",
              "--set", f"checkpoint.path={ck}"]
    assert train_entry.main(common + ["--max-steps", "2"]) == 0
    assert CheckpointManager(ck).latest_step() == 2
    # expert parallelism trains on a mesh of ranks (tests/test_torch_ep.py);
    # one process alone refuses it and names the launcher that starts them
    with pytest.raises(ValueError, match="needs 2 ranks.*train launch"):
        train_entry.main(common + ["--max-steps", "1", "--set",
                                   "parallel.expert_parallel=2"])


# -- quantized MoE leaves -----------------------------------------------------

def _layer_bytes(leaf, i):
    """A per-layer port leaf and the JAX stacked leaf's layer i, as the
    list of numpy arrays that hold its bytes."""
    if isinstance(leaf, tq.Quant4Tensor):
        return [leaf.packed.numpy(), leaf.scale.numpy(), leaf.chan.numpy()]
    if isinstance(leaf, tq.QuantTensor):
        return [leaf.values.numpy(), leaf.scale.numpy()]
    return [leaf.detach().numpy()]


def _jax_bytes(node, i):
    if isinstance(node, dict) and "__quant__" in node:
        keys = (["values", "scale", "chan"] if node["__quant__"] == "int4"
                else ["values", "scale"])
        return [np.asarray(node[k])[i] for k in keys]
    return [np.asarray(node)[i]]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_moe_quantized_bytes_equal_jax(kind, wide):
    """Both routes to quantized MoE leaves give JAX's bytes: the port's
    quantize_blocks over the fp32 model, and the bridge of JAX's quantized
    tree. Experts take int8 under int4 too; the router quantizes once the
    stacked leaf reaches 4096 elements (the wide config), to int4 groups
    under int4."""
    jc, tc = _wide_cfgs() if wide else _cfgs()
    p = jax.tree_util.tree_map(np.asarray, jgpt.init(jc,
                                                     jax.random.PRNGKey(3)))
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    if kind == "int8":
        jtree = dict(p, blocks=jax.tree_util.tree_map(
            np.asarray, jq.quantize_tree_int8(jp["blocks"], min_ndim=3)))
    else:
        jtree = jax.tree_util.tree_map(np.asarray,
                                       jq.quantize_tree_int4(dict(jp)))
    moe = jtree["blocks"]["moe"]
    expect = {"router": ("int4" if kind == "int4" else "int8") if wide
              else None}
    router = moe["router"]["kernel"]
    assert (router.get("__quant__") if isinstance(router, dict)
            else None) == expect["router"]
    for e in ("gate", "up", "down"):
        assert moe[e]["kernel"]["__quant__"] == "int8"
    own = quantize_blocks(params_from_jax(p, tc, device="cpu"), kind)
    bridged = params_from_jax(jtree, tc, device="cpu")
    for model in (own, bridged):
        for i, blk in enumerate(model.blocks):
            leaves = blk.leaves()
            for name in MOE:
                got = _layer_bytes(leaves[f"moe_{name}"], i)
                ref = _jax_bytes(moe[name]["kernel"], i)
                assert len(got) == len(ref), name
                for a, b in zip(got, ref):
                    assert a.dtype == b.dtype and a.shape == b.shape, name
                    assert a.tobytes() == b.tobytes(), name
    # weight bytes count the experts in their stored form
    wb = own.weight_bytes()
    assert wb == bridged.weight_bytes()
    assert wb == jq.tree_weight_bytes(jq.to_runtime_quant(jtree))
