"""Import HuggingFace-format (llama-style) safetensors weights (the JAX
package's ``io/hf_import.py``).

Maps a LOCAL HF safetensors file or directory into the JAX-layout param
tree (numpy, bitwise the JAX package's import) and writes a committed
**port** checkpoint (step 0, params only) that the port's serving engine
(``--artifact``), ``eval run``, ``export convert`` and a resumed
``TrainingEngine`` (fresh optimizer state) take. No network, no
transformers dependency: the safetensors reader is io/export.py's own.

Name mapping (llama family; rope convention matches — both use the
split-half rotate):

  model.embed_tokens.weight            -> embed.embedding            [V,H]
  model.layers.{i}.input_layernorm     -> blocks.attn_norm.scale[i]
  model.layers.{i}.self_attn.{q,k,v,o}_proj.weight (HF [out,in])
                                       -> blocks.{q,k,v,o}.kernel[i] [in,out]
  model.layers.{i}.post_attention_layernorm -> blocks.mlp_norm.scale[i]
  model.layers.{i}.mlp.{gate,up,down}_proj.weight
                                       -> blocks.mlp.{gate,up,down}.kernel[i]
  model.norm.weight                    -> final_norm.scale
  lm_head.weight (HF [V,H])            -> lm_head.kernel [H,V] (absent when
                                          tied: embed is reused)
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..config.schema import ModelConfig
from .export import load_safetensors


def _collect_tensors(src: str | Path) -> dict[str, np.ndarray]:
    src = Path(src)
    files = [src] if src.is_file() else sorted(src.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {src}")
    out: dict[str, np.ndarray] = {}
    for f in files:
        tensors, _ = load_safetensors(f)
        out.update({k: _numpy(v) for k, v in tensors.items()})
    return out


def _numpy(t) -> np.ndarray:
    """A host tensor as numpy (bf16 exactly widened to fp32)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def infer_tied(tensors: dict[str, np.ndarray]) -> bool:
    """HF convention: models with tied embeddings simply omit
    lm_head.weight from the checkpoint."""
    return "lm_head.weight" not in tensors


def infer_attention_bias(tensors: dict[str, np.ndarray]) -> bool:
    """qwen2-family checkpoints carry q/k/v projection biases; every other
    llama-family model omits them. Aligning the config to the checkpoint
    (like infer_tied) prevents present biases from being silently DROPPED
    under a template that left attention_bias off."""
    return "model.layers.0.self_attn.q_proj.bias" in tensors


def hf_llama_to_params(tensors: dict[str, np.ndarray],
                       cfg: ModelConfig, dtype=np.float32) -> Any:
    """Map HF llama tensor names to this framework's stacked param tree.

    ``cfg.tie_word_embeddings`` must agree with the checkpoint (see
    ``infer_tied``); import_hf_checkpoint aligns the config automatically.
    """
    L = cfg.num_layers
    tied_ckpt = infer_tied(tensors)
    if tied_ckpt != cfg.tie_word_embeddings:
        which = "omits" if tied_ckpt else "contains"
        raise ValueError(
            f"checkpoint {which} lm_head.weight ("
            f"{'tied' if tied_ckpt else 'untied'} embeddings) but model "
            f"template {cfg.name!r} sets tie_word_embeddings="
            f"{cfg.tie_word_embeddings} — align the template (the CLI "
            "infers this automatically)")

    def get(name):
        if name not in tensors:
            raise KeyError(
                f"HF checkpoint missing {name!r} (have e.g. "
                f"{sorted(tensors)[:3]}...)")
        return np.asarray(tensors[name], dtype)

    def stack(fmt, transpose=False):
        mats = [get(fmt.format(i=i)) for i in range(L)]
        if transpose:                      # HF [out, in] -> ours [in, out]
            mats = [m.T for m in mats]
        return np.stack(mats)

    blocks = {
        "attn_norm": {"scale": stack(
            "model.layers.{i}.input_layernorm.weight")},
        "mlp_norm": {"scale": stack(
            "model.layers.{i}.post_attention_layernorm.weight")},
        "mlp": {
            "gate": {"kernel": stack(
                "model.layers.{i}.mlp.gate_proj.weight", transpose=True)},
            "up": {"kernel": stack(
                "model.layers.{i}.mlp.up_proj.weight", transpose=True)},
            "down": {"kernel": stack(
                "model.layers.{i}.mlp.down_proj.weight", transpose=True)},
        },
    }
    for name in ("q", "k", "v", "o"):
        blocks[name] = {"kernel": stack(
            f"model.layers.{{i}}.self_attn.{name}_proj.weight",
            transpose=True)}
    if cfg.attention_bias:
        # qwen2-family checkpoints carry q/k/v projection biases (o has
        # none); models.layers adds them per head after the matmul
        for name in ("q", "k", "v"):
            blocks[name]["bias"] = stack(
                f"model.layers.{{i}}.self_attn.{name}_proj.bias")

    params = {
        "embed": {"embedding": get("model.embed_tokens.weight")},
        "blocks": blocks,
        "final_norm": {"scale": get("model.norm.weight")},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": get("lm_head.weight").T}

    # shape validation against the model config
    H, V = cfg.hidden_size, cfg.vocab_size
    got = params["embed"]["embedding"].shape
    if got != (V, H):
        raise ValueError(f"embed shape {got} != config ({V}, {H}) — wrong "
                         "--model template for this checkpoint?")
    got = params["blocks"]["q"]["kernel"].shape
    want = (L, H, cfg.num_heads * cfg.head_dim)
    if got != want:
        raise ValueError(f"q kernel {got} != {want}")
    return params


def import_hf_checkpoint(src: str | Path, cfg: ModelConfig,
                         out_dir: str | Path) -> tuple[Path, ModelConfig]:
    """Import HF llama safetensors into a committed port checkpoint
    (step 0, ``{"step", "params"}`` by port parameter name).

    Returns (checkpoint dir, effective model config) — tie_word_embeddings
    AND attention_bias are aligned to what the checkpoint actually
    contains (HF tied models omit lm_head.weight; qwen2-family models
    carry q/k/v biases), so downstream commands must use the returned
    config."""
    import dataclasses

    from ..weights import named_from_tree
    from .checkpoint import CheckpointManager

    tensors = _collect_tensors(src)
    tied = infer_tied(tensors)
    bias = infer_attention_bias(tensors)
    if tied != cfg.tie_word_embeddings or bias != cfg.attention_bias:
        cfg = dataclasses.replace(cfg, tie_word_embeddings=tied,
                                  attention_bias=bias)
    params = hf_llama_to_params(tensors, cfg)
    mgr = CheckpointManager(out_dir, async_save=False)
    mgr.save(0, {"step": 0, "params": named_from_tree(params)},
             extra={"config": {"model": cfg.name, "source": str(src),
                               "imported": "hf-llama",
                               "tie_word_embeddings": tied,
                               "attention_bias": bias}})
    return Path(out_dir), cfg
