"""GGUF export and HF import of the port against the JAX package's (CPU,
gpt-test, fp32, JAX-initialised params carried across).

- ``export_gguf`` of the port's model writes the JAX package's bytes for
  f32, f16 and bf16 payloads, tied and untied embeddings; ``read_gguf``
  gives back the metadata and every tensor (bf16 as a torch tensor).
- A quantized model or tree and an MoE config are refused with JAX's
  errors.
- ``import_hf_checkpoint`` of llama-style and qwen-style (q/k/v bias)
  safetensors, written with the port's own writer, gives params bitwise
  equal to JAX's import of the same files; the port checkpoint it writes
  serves the greedy tokens of an engine built from the original params,
  and a ``TrainingEngine`` resumes its params with a fresh optimizer state.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_llm_training_and_inference_system_tpu.config import (
    get_model_config as jax_cfg)
from distributed_llm_training_and_inference_system_tpu.io import (
    gguf as jgguf, hf_import as jhf)
from distributed_llm_training_and_inference_system_tpu.models import (
    gpt as jgpt)
from distributed_llm_training_and_inference_system_tpu_torch.config import (
    ServeConfig, get_model_config as torch_cfg, loader as tloader)
from distributed_llm_training_and_inference_system_tpu_torch.io import (
    checkpoint as tckpt, gguf as tgguf, hf_import as thf)
from distributed_llm_training_and_inference_system_tpu_torch.io.export import (
    save_safetensors)
from distributed_llm_training_and_inference_system_tpu_torch.ops import (
    quantization as tq)
from distributed_llm_training_and_inference_system_tpu_torch.runtime.engine \
    import TrainingEngine
from distributed_llm_training_and_inference_system_tpu_torch.serve import (
    InferenceEngine, SamplingParams)
from distributed_llm_training_and_inference_system_tpu_torch.weights import (
    params_from_jax, params_to_tree)


def _cfgs(**kw):
    return (dataclasses.replace(jax_cfg("gpt-test"), **kw),
            dataclasses.replace(torch_cfg("gpt-test"), **kw))


def _jax_params(cfg, seed=0, bias=False):
    p = jgpt.init(cfg, jax.random.PRNGKey(seed))
    if bias:         # visibly nonzero, so a dropped mapping cannot pass
        for i, n in enumerate(("q", "k", "v")):
            p["blocks"][n]["bias"] = jax.random.normal(
                jax.random.PRNGKey(10 + i), p["blocks"][n]["bias"].shape) * .5
    return p


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_gguf_bytes_equal_jax(tmp_path, dtype, tied):
    jc, tc = _cfgs(tie_word_embeddings=tied)
    jp = _jax_params(jc, seed=1)
    jgguf.export_gguf(jp, jc, tmp_path / "j.gguf", dtype=dtype)
    model = params_from_jax(jp, tc, device="cpu")
    tgguf.export_gguf(model, tc, tmp_path / "t.gguf", dtype=dtype)
    want = (tmp_path / "j.gguf").read_bytes()
    assert (tmp_path / "t.gguf").read_bytes() == want
    # the JAX-layout tree of numpy arrays gives the same file
    tgguf.export_gguf(jax.tree_util.tree_map(np.asarray, jp), tc,
                      tmp_path / "n.gguf", dtype=dtype)
    assert (tmp_path / "n.gguf").read_bytes() == want


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_read_gguf_gives_back_metadata_and_tensors(tmp_path, dtype):
    jc, tc = _cfgs()
    jp = _jax_params(jc, seed=2)
    path = tgguf.export_gguf(params_from_jax(jp, tc, device="cpu"), tc,
                             tmp_path / "t.gguf", dtype=dtype)
    meta, tensors = tgguf.read_gguf(path)
    jmeta, jtensors = jgguf.read_gguf(path)
    assert meta == jmeta
    assert meta["general.architecture"] == "llama"
    assert meta["llama.block_count"] == tc.num_layers
    assert list(tensors) == list(jtensors)
    for name, arr in jtensors.items():
        got = tensors[name]
        if dtype == "bf16" and arr.ndim > 1:
            assert got.dtype == torch.bfloat16
            got = got.float().numpy()
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(arr, np.float32), name)
    q = np.array(jp["blocks"]["q"]["kernel"][1], np.float32).T
    want = {"f32": q, "f16": q.astype(np.float16).astype(np.float32),
            "bf16": torch.from_numpy(q).to(torch.bfloat16).float().numpy()}
    got = tensors["blk.1.attn_q.weight"]
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.asarray(got, np.float32), want[dtype])
    lazy, infos = tgguf.read_gguf(path, load_tensors=False)
    assert lazy == meta and set(infos) == set(tensors)


def test_quantized_and_moe_refused_with_jax_errors(tmp_path):
    jc, tc = _cfgs()
    jp = _jax_params(jc)
    model = params_from_jax(jp, tc, device="cpu")
    with pytest.raises(ValueError) as je:
        jgguf.export_gguf({**jp, "blocks": {**jp["blocks"], "q": {
            "kernel": {"__quant__": "int8", "values": 0, "scale": 0}}}}, jc,
            tmp_path / "j.gguf")
    q8 = tq.quantize_tree_int8(params_to_tree(model), min_ndim=3)
    for tree in (q8, tq.to_runtime_quant(q8)):
        with pytest.raises(ValueError) as te:
            tgguf.export_gguf(tree, tc, tmp_path / "t.gguf")
        assert str(te.value) == str(je.value)
    jm, tm = (dataclasses.replace(c, moe=type(c.moe)(num_experts=4,
                                                     experts_per_token=2))
              for c in (jc, tc))
    with pytest.raises(ValueError) as je:
        jgguf.export_gguf(jp, jm, tmp_path / "j.gguf")
    with pytest.raises(ValueError) as te:
        tgguf.export_gguf(model, tm, tmp_path / "t.gguf")
    assert str(te.value) == str(je.value) and "MoE" in str(te.value)


def _hf_dict(params, cfg) -> dict:
    """HF llama names of a JAX-layout tree (HF kernels are [out, in])."""
    b = {k: v for k, v in params["blocks"].items()}
    hf = {"model.embed_tokens.weight": np.asarray(params["embed"]
                                                  ["embedding"]),
          "model.norm.weight": np.asarray(params["final_norm"]["scale"])}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        hf[pre + "input_layernorm.weight"] = np.asarray(
            b["attn_norm"]["scale"][i])
        hf[pre + "post_attention_layernorm.weight"] = np.asarray(
            b["mlp_norm"]["scale"][i])
        for n in ("q", "k", "v", "o"):
            hf[pre + f"self_attn.{n}_proj.weight"] = np.asarray(
                b[n]["kernel"][i]).T
        if cfg.attention_bias:
            for n in ("q", "k", "v"):
                hf[pre + f"self_attn.{n}_proj.bias"] = np.asarray(
                    b[n]["bias"][i])
        for n in ("gate", "up", "down"):
            hf[pre + f"mlp.{n}_proj.weight"] = np.asarray(
                b["mlp"][n]["kernel"][i]).T
    if not cfg.tie_word_embeddings:
        hf["lm_head.weight"] = np.asarray(params["lm_head"]["kernel"]).T
    return {k: np.ascontiguousarray(v) for k, v in hf.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


SERVE = dict(model="gpt-test", max_batch_size=2, max_seq_len=64,
             prefill_chunk=32, kv_block_size=8, dtype="float32")


def _greedy(engine, prompts, n=6):
    return [r.generated_tokens for r in engine.generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=n))]


@pytest.mark.parametrize("style", ["llama", "qwen"])
def test_hf_import_bitwise_equal_jax_and_served(tmp_path, style):
    bias = style == "qwen"
    # the HF checkpoint's architecture; the import starts from the plain
    # gpt-test template and infers tie and bias from the tensors
    jc, tc = _cfgs(tie_word_embeddings=not bias, attention_bias=bias)
    jp = _jax_params(jc, seed=3, bias=bias)
    src = tmp_path / "hf"
    tensors = _hf_dict(jp, jc)
    names = sorted(tensors)
    half = len(names) // 2              # a two-file checkpoint
    save_safetensors({k: tensors[k] for k in names[:half]},
                     src / "model-00001.safetensors")
    save_safetensors({k: tensors[k] for k in names[half:]},
                     src / "model-00002.safetensors")

    want = jhf.hf_llama_to_params(jhf._collect_tensors(src), jc)
    got = thf.hf_llama_to_params(thf._collect_tensors(src), tc)
    wl, gl = _leaves(want), _leaves(got)
    assert set(gl) == set(wl)
    for k in wl:
        assert gl[k].dtype == wl[k].dtype and gl[k].shape == wl[k].shape, k
        assert gl[k].tobytes() == wl[k].tobytes(), k
    assert thf.infer_tied(thf._collect_tensors(src)) == (not bias)
    assert thf.infer_attention_bias(thf._collect_tensors(src)) == bias

    plain_j, plain_t = jax_cfg("gpt-test"), torch_cfg("gpt-test")
    _, jeff = jhf.import_hf_checkpoint(src, plain_j, tmp_path / "jck")
    out, teff = thf.import_hf_checkpoint(src, plain_t, tmp_path / "tck")
    assert (teff.tie_word_embeddings, teff.attention_bias) == (
        jeff.tie_word_embeddings, jeff.attention_bias) == (not bias, bias)
    mgr = tckpt.CheckpointManager(out)
    assert mgr.all_steps() == [0] and not mgr.is_jax()
    state, extra = mgr.restore()
    assert extra["config"]["imported"] == "hf-llama"
    assert extra["config"]["attention_bias"] == bias

    prompts = [[5, 17, 99, 3, 42], [7, 7, 1, 200, 31, 9, 12, 4, 88]]
    ref = InferenceEngine(teff, ServeConfig(**SERVE),
                          params=params_from_jax(jp, teff, device="cpu"),
                          device="cpu")
    served = InferenceEngine(teff, ServeConfig(**SERVE, artifact=str(out)),
                             device="cpu")
    for name, p in served.params.named_parameters():
        assert torch.equal(p, dict(ref.params.named_parameters())[name]), name
    assert _greedy(served, prompts) == _greedy(ref, prompts)

    # the trainer resumes the imported params, its optimizer state fresh
    run = tloader.load_run_config(cli_overrides={
        "checkpoint": {"path": str(out), "async_save": False},
        "data": {"max_length": 16}, "parallel": {"global_batch_size": 2}})
    run.model = teff
    eng = TrainingEngine(run, device="cpu")
    assert eng.initialize(resume=True) == 0
    for name, p in eng.state.model.named_parameters():
        assert torch.equal(p, state["params"][name]), name
    assert all(float(t.abs().sum()) == 0.0 for t in eng.state.opt_state.mu)
