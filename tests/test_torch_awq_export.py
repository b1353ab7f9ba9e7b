"""AWQ calibration, int4-awq serving and export artifacts: the port against
the JAX package on the same params (gpt-test and gpt-test-moe, fp32, CPU).

- ``activation_channel_scales``: the same keys and values within rtol 1e-6
  (measured 2.2e-7: one or two ulps, the order of the fp32 mean over the
  calibration rows, which XLA's CPU reduction and torch's take apart).
  ``quantize_tree_int4`` and the ``int8_awq`` trio, from JAX's statistic
  or the port's own: the int8 values and int4 nibbles bitwise, the group
  and channel scales within rtol 1e-6 (the channel scale's geometric mean
  is a mean over the input channels, one or two ulps apart for the same
  reason); the dequantizers bitwise on the same bytes.
- The int4-awq engine (it draws JAX's calibration tokens and calibrates
  itself) is token-identical to the JAX engine, with fp and int8 KV.
- Export, for none/int8/int4/int4-awq: a port safetensors file is
  byte-identical to JAX's for the same tree and metadata; each package's
  artifact loads in the other with the same tensors and metadata; an
  engine on the artifact serves the JAX engine's tokens on the same file
  and reports the same quantization; every refusal is JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg, schema as jax_schema)
from distributed_llm_training_and_inference_system_tpu.io import (
    export as jexp)
from distributed_llm_training_and_inference_system_tpu.models import (
    init as jax_init)
from distributed_llm_training_and_inference_system_tpu.ops import (
    quantization as jq)
from distributed_llm_training_and_inference_system_tpu.serve import (
    InferenceEngine as JaxEngine, SamplingParams as JaxSampling)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg)
from distributed_llm_training_and_inference_system_tpu_torch.io import (
    export as texp)
from distributed_llm_training_and_inference_system_tpu_torch.models import (
    gpt as tgpt)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    quantization as tq)
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    calibration_scales, params_from_jax, params_to_tree)

SERVE = dict(model="gpt-test", max_batch_size=4, max_seq_len=128,
             prefill_chunk=32, kv_block_size=8, dtype="float32")
_RNG = np.random.default_rng(21)
PROMPTS = [[int(t) for t in _RNG.integers(1, 250, n)] for n in (6, 23, 41)]
GREEDY = dict(temperature=0.0, max_tokens=10)
QUANTS = [None, "int8", "int4", "int4-awq"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return jax_init(jax_cfg("gpt-test"), jax.random.PRNGKey(0))


def _calib(cfg):
    return jax.random.randint(jax.random.PRNGKey(0), (2, 128), 1,
                              cfg.vocab_size)


def _torch_tree(tree):
    """Arrays to host tensors; marker strings and group ints as they
    are."""
    return jax.tree_util.tree_map(
        lambda a: a if isinstance(a, (str, int))
        else torch.from_numpy(np.array(a)), tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    if isinstance(a, int):
        return np.asarray(a)
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(got, want, rtol=0.0, bitwise=()):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = _np(g[k]), _np(w[k])
        if isinstance(b, np.ndarray) and b.dtype.kind == "f" and rtol \
                and not k.endswith(bitwise):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=k)
        else:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), k


# -- calibration -------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt-test", "gpt-test-moe"])
def test_activation_channel_scales_match_jax(name):
    jc, tc = jax_cfg(name), torch_cfg(name)
    p = jax_init(jc, jax.random.PRNGKey(0))
    ref = jq.activation_channel_scales(p, jc, _calib(jc))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, p), tc,
                            device="cpu")
    got = tgpt.activation_channel_scales(
        model, tc, torch.from_numpy(np.array(_calib(jc))))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0, err_msg=k)


def test_calibrated_int4_tree_equals_jax(params):
    """From JAX's statistic and from the port's own: nibbles bitwise,
    scales within rtol 1e-6."""
    jc, tc = jax_cfg("gpt-test"), torch_cfg("gpt-test")
    ref = jq.quantize_tree_int4(dict(params), model_cfg=jc,
                                calib_tokens=_calib(jc))
    act = jq.activation_channel_scales(params, jc, _calib(jc))
    tree = _torch_tree(params)
    given = tq.quantize_tree_int4(
        tree, act={k: torch.from_numpy(np.array(v)) for k, v in act.items()})
    _assert_trees_equal(given, ref, rtol=1e-6, bitwise=("values",))
    own = tq.quantize_tree_int4(tree, act=calibration_scales(
        tree, tc, torch.from_numpy(np.array(_calib(jc)))))
    _assert_trees_equal(own, ref, rtol=1e-6, bitwise=("values",))


def test_int8_awq_trio_equals_jax(params):
    rs = np.random.RandomState(3)
    w = rs.randn(2, 64, 48).astype(np.float32)
    act = (rs.rand(2, 64) * 3 + 0.1).astype(np.float32)
    jv, js_, jc_ = jq.quantize_int8_awq(jnp.asarray(w), jnp.asarray(act))
    tv, ts_, tc_ = tq.quantize_int8_awq(torch.from_numpy(w),
                                        torch.from_numpy(act))
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    for a, b in ((ts_, js_), (tc_, jc_)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        ref = jq.dequantize_int8_awq(jv, js_, jc_, dt)
        got = tq.dequantize_int8_awq(*(torch.from_numpy(np.array(a))
                                       for a in (jv, js_, jc_)), tdt)
        assert _np(got).tobytes() == _np(ref).tobytes()
    jc = jax_cfg("gpt-test")
    ref_tree = jq.quantize_tree_int8_awq(params, jc, _calib(jc))
    act = jq.activation_channel_scales(params, jc, _calib(jc))
    got_tree = tq.quantize_tree_int8_awq(
        _torch_tree(params),
        {k: torch.from_numpy(np.array(v)) for k, v in act.items()})
    _assert_trees_equal(got_tree, ref_tree, rtol=1e-6, bitwise=("values",))
    back = tq.dequantize_tree(_torch_tree(ref_tree), torch.float32)
    ref_back = jq.dequantize_tree(ref_tree, jnp.float32)
    _assert_trees_equal(back, ref_back)


def _jax_engine(params, **over):
    return JaxEngine(jax_cfg("gpt-test"),
                     jax_schema.ServeConfig(**{**SERVE, **over}),
                     params=params, seed=0)


def _port_engine(params=None, **over):
    tp = None if params is None else params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), torch_cfg("gpt-test"),
        device="cpu")
    return InferenceEngine(torch_cfg("gpt-test"),
                           ServeConfig(**{**SERVE, **over}), params=tp,
                           seed=0, device="cpu")


def _tokens(engine, **sp):
    cls = JaxSampling if isinstance(engine, JaxEngine) else SamplingParams
    return [r.generated_tokens for r in engine.generate(PROMPTS, cls(**sp))]


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_int4_awq_engine_token_identical_to_jax(params, kv):
    je = _jax_engine(params, quantization="int4-awq", kv_quantization=kv)
    te = _port_engine(params, quantization="int4-awq", kv_quantization=kv)
    assert _tokens(te, **GREEDY) == _tokens(je, **GREEDY)
    assert te.stats()["quantization"] == je.stats()["quantization"] \
        == "int4-awq"
    assert te.stats()["weight_bytes"] == je.stats()["weight_bytes"]
    kinds = {type(leaf).__name__ for blk in te.params.blocks
             for leaf in blk.leaves().values()}
    assert "Quant4Tensor" in kinds
    chan = te.params.blocks[0].q.chan
    assert not torch.all(chan == 1)            # calibrated, not plain int4


# -- export ------------------------------------------------------------------

def _export_both(params, tmp_path, quant, fmt="safetensors", tree=None):
    jc, tc = jax_cfg("gpt-test"), torch_cfg("gpt-test")
    calib = _calib(jc)
    meta = {"model": "gpt-test"}
    suffix = ".safetensors" if fmt == "safetensors" else ".npz"
    jpath, tpath = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
    jexp.export_params(params if tree is None else tree, jpath, fmt=fmt,
                       quant=quant, metadata=meta, model_cfg=jc,
                       calib_tokens=calib)
    ttree = _torch_tree(params if tree is None else tree)
    texp.export_params(ttree, tpath, fmt=fmt, quant=quant, metadata=meta,
                       model_cfg=tc,
                       calib_tokens=torch.from_numpy(np.array(calib)))
    return jpath, tpath


@pytest.mark.parametrize("quant", QUANTS)
def test_export_bytes_and_both_directions(params, tmp_path, quant):
    jpath, tpath = _export_both(params, tmp_path, quant)
    if quant != "int4-awq":
        assert tpath.read_bytes() == jpath.read_bytes()
    # a JAX artifact in the port, a port artifact in JAX
    jtree, jmeta = jexp.load_exported(jpath)
    ttree, tmeta = texp.load_exported(jpath)
    assert tmeta == jmeta
    _assert_trees_equal(ttree, jtree)
    jtree2, jmeta2 = jexp.load_exported(tpath)
    assert jmeta2 == jmeta
    _assert_trees_equal(jtree2, jtree, rtol=1e-6 if quant == "int4-awq"
                        else 0.0, bitwise=("values",))


def test_prequantized_awq_tree_exports_byte_identical(params, tmp_path):
    """A tree JAX quantized as int4-awq, exported by each package without
    a quant argument (the markers tag the layout): the same bytes."""
    jc = jax_cfg("gpt-test")
    tree = jq.quantize_tree_int4(dict(params), model_cfg=jc,
                                 calib_tokens=_calib(jc))
    jpath, tpath = _export_both(params, tmp_path, None, tree=tree)
    assert tpath.read_bytes() == jpath.read_bytes()


def test_bf16_and_npz_artifacts(params, tmp_path):
    """bf16 travels as its bits (byte-identical file; bf16 tensors back in
    the port); a JAX npz artifact loads with the same fp32 tensors."""
    bf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    jexp.export_params(bf, tmp_path / "j.safetensors")
    texp.export_params(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16), bf), tmp_path / "t.safetensors")
    assert (tmp_path / "t.safetensors").read_bytes() == \
        (tmp_path / "j.safetensors").read_bytes()
    tree, _ = texp.load_exported(tmp_path / "j.safetensors")
    assert tree["embed"]["embedding"].dtype == torch.bfloat16
    _assert_trees_equal(tree, jexp.load_exported(
        tmp_path / "j.safetensors")[0])
    jpath, _ = _export_both(params, tmp_path, "int8", fmt="npz")
    ttree, tmeta = texp.load_exported(jpath)
    jtree, jmeta = jexp.load_exported(jpath)
    assert tmeta == jmeta
    _assert_trees_equal(ttree, jtree)


@pytest.mark.parametrize("quant", QUANTS)
def test_artifact_engine_token_identical_to_jax(params, tmp_path, quant):
    jpath, _ = _export_both(params, tmp_path, quant)
    je = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(
        **SERVE, artifact=str(jpath)), seed=0)
    te = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(
        **SERVE, artifact=str(jpath)), seed=0, device="cpu")
    assert _tokens(te, **GREEDY) == _tokens(je, **GREEDY)
    assert te.stats()["quantization"] == je.stats()["quantization"]
    assert te.stats()["weight_bytes"] == je.stats()["weight_bytes"]


def test_tied_artifact_overrides_the_template(params, tmp_path):
    """An artifact without an LM head served under the untied gpt-test
    template: both engines tie the embedding and serve the same tokens."""
    tied = {k: v for k, v in params.items() if k != "lm_head"}
    path = tmp_path / "tied.safetensors"
    jexp.export_params(tied, path)
    je = JaxEngine(jax_cfg("gpt-test"), jax_schema.ServeConfig(
        **SERVE, artifact=str(path)), seed=0)
    te = InferenceEngine(torch_cfg("gpt-test"), ServeConfig(
        **SERVE, artifact=str(path)), seed=0, device="cpu")
    assert te.cfg.tie_word_embeddings and je.cfg.tie_word_embeddings
    assert _tokens(te, **GREEDY) == _tokens(je, **GREEDY)


def _raises_both(fn_jax, fn_port, match):
    with pytest.raises(ValueError, match=match) as ej:
        fn_jax()
    with pytest.raises(ValueError, match=match) as et:
        fn_port()
    assert str(et.value) == str(ej.value)


def test_refusals_match_jax(params, tmp_path):
    tree = _torch_tree(params)
    for quant in ("int4-awq", "int8-awq"):
        _raises_both(
            lambda: jexp.export_params(params, tmp_path / "a.st",
                                       quant=quant),
            lambda: texp.export_params(tree, tmp_path / "a.st", quant=quant),
            "calibration")
    _raises_both(lambda: jexp.export_params(params, tmp_path / "a.st",
                                            quant="fp8"),
                 lambda: texp.export_params(tree, tmp_path / "a.st",
                                            quant="fp8"), "unsupported")
    _raises_both(lambda: jexp.export_params(params, tmp_path / "a.x",
                                            fmt="gguf"),
                 lambda: texp.export_params(tree, tmp_path / "a.x",
                                            fmt="gguf"), "format")
    # a legacy-oriented int4 leaf without layout metadata
    legacy = dict(params, blocks=dict(params["blocks"], q={"kernel": {
        "__quant__": "int4", "values": np.zeros((2, 64, 32), np.uint8),
        "scale": np.ones((2, 64, 1), np.float32),
        "chan": np.ones((2, 64), np.float32), "group": 64}}))
    _raises_both(lambda: jexp.export_params(legacy, tmp_path / "a.st"),
                 lambda: texp.export_params(_torch_tree(legacy),
                                            tmp_path / "a.st"),
                 "kernel orientation")
    # an int4 npz has no layout metadata: refused at load
    jpath, _ = _export_both(params, tmp_path, "int4", fmt="npz")
    with pytest.raises(ValueError, match="int4_layout"):
        jexp.load_exported(jpath)
    with pytest.raises(ValueError, match="int4_layout"):
        texp.load_exported(jpath)
    # serving: int8-awq artifacts, and a quantized artifact re-quantized
    jc = jax_cfg("gpt-test")
    awq = tmp_path / "awq.safetensors"
    jexp.export_params(params, awq, quant="int8-awq", model_cfg=jc,
                       calib_tokens=_calib(jc))
    q8, _ = _export_both(params, tmp_path, "int8")
    for path, over, match in ((awq, {}, "interchange"),
                              (q8, {"quantization": "int4"}, "re-export")):
        with pytest.raises(ValueError, match=match):
            JaxEngine(jc, jax_schema.ServeConfig(
                **SERVE, artifact=str(path), **over), seed=0)
        with pytest.raises(ValueError, match=match):
            InferenceEngine(torch_cfg("gpt-test"), ServeConfig(
                **SERVE, artifact=str(path), **over), seed=0, device="cpu")


def test_params_to_tree_inverts_params_from_jax(params):
    """The port's model back to the JAX layout, plain and quantized."""
    tc = torch_cfg("gpt-test")
    for tree in (params, jq.quantize_tree_int4(dict(params))):
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                tc, device="cpu")
        _assert_trees_equal(params_to_tree(model),
                            jax.tree_util.tree_map(np.asarray, tree))
