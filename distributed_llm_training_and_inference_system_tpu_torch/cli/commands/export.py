"""`llmctl-torch export` — checkpoint conversion (the JAX package's
``export convert`` / ``import-hf`` / ``synth``).

``convert`` reads a checkpoint (the port's or the JAX package's) and writes
a safetensors or npz artifact (``io.export.export_params``, optionally
quantized; the awq kinds calibrate with the JAX command's tokens on the
global ``--device``) or a GGUF file (``io.gguf.export_gguf``); for the
same checkpoint the files are byte for byte the JAX command's.
``import-hf`` writes a port checkpoint from local HF safetensors.
``synth`` writes a random-init artifact (numpy, the JAX command's
generator and quantizers) with bf16 leaves stored as their bits.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..main import CommandError


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog,
                                 description="Model export and conversion.")
    sub = ap.add_subparsers(dest="sub", metavar="{convert,import-hf,synth}")
    c = sub.add_parser("convert", help="Convert a training checkpoint into a "
                                       "deployment artifact.")
    c.add_argument("--ckpt", dest="ckpt_dir", required=True,
                   help="Checkpoint directory (CheckpointManager layout).")
    c.add_argument("--format", dest="fmt", default="safetensors",
                   choices=["safetensors", "npz", "gguf"],
                   help="gguf writes a llama-architecture GGUF v3 container "
                        "(f16/bf16 payloads, no ggml quant blocks).")
    c.add_argument("--quant", default=None,
                   choices=["int8", "int8-awq", "int4", "int4-awq"],
                   help="Quantize weights before export (*-awq = "
                        "activation-aware channel scaling from a "
                        "calibration pass).")
    c.add_argument("--model", dest="model_name", default=None,
                   help="Model template (defaults to the checkpoint's "
                        "recorded model).")
    c.add_argument("--calib-seq", default=512, type=int,
                   help="Calibration tokens for the awq kinds.")
    c.add_argument("--out", dest="out_path", required=True)
    c.add_argument("--step", default=None, type=int,
                   help="Checkpoint step (default: latest).")
    h = sub.add_parser("import-hf", help="Import a local HuggingFace "
                                         "llama-format checkpoint.")
    h.add_argument("--src", required=True,
                   help="HF safetensors file or directory (llama-style "
                        "names).")
    h.add_argument("--model", dest="model_name", required=True,
                   help="Model template matching the checkpoint's "
                        "architecture.")
    h.add_argument("--out", dest="out_dir", required=True)
    s = sub.add_parser("synth", help="Synthesize a random-init deployment "
                                     "artifact (no checkpoint).")
    s.add_argument("--model", dest="model_name", required=True,
                   help="Model template to synthesize (e.g. gpt-7b).")
    s.add_argument("--quant", default="int8",
                   choices=["none", "int8", "int4"],
                   help="Quantize block kernels at synthesis.")
    s.add_argument("--seed", default=0, type=int)
    s.add_argument("--out", dest="out_path", required=True)
    return ap


def run(args) -> int:
    if args.sub is None:
        build_parser("llmctl-torch export").print_help()
        return 0
    if args.sub == "convert":
        return convert(args)
    if args.sub == "import-hf":
        return import_hf(args.src, args.model_name, args.out_dir)
    return synth(args.model_name, args.quant, args.seed, args.out_path)


def _calibration_tokens(n: int, vocab_size: int, device) -> torch.Tensor:
    """The JAX command's calibration tokens: ``jax.random.randint(
    PRNGKey(0), (1, n), 1, vocab)`` through the port's threefry copy."""
    from ...serve.sampling import prng_key, randint
    return randint(prng_key(torch.zeros((), dtype=torch.int64,
                                        device=device)),
                   (1, n), 1, vocab_size)


def convert(args) -> int:
    """Convert a training checkpoint into a deployment artifact."""
    from ...config.presets import get_model_config
    from ...config.schema import _parse_bool
    from ...device import resolve_device
    from ...io.checkpoint import CheckpointManager, apply_ckpt_model_overrides
    from ...io.export import export_params
    from ...weights import checkpoint_tree

    ckpt_dir, quant, fmt = args.ckpt_dir, args.quant, args.fmt
    if not Path(ckpt_dir).is_dir():
        raise CommandError(f"no checkpoint directory {ckpt_dir}")
    ckpt = CheckpointManager(ckpt_dir)
    if ckpt.latest_step() is None:
        raise CommandError(f"no checkpoints under {ckpt_dir}")
    step = args.step
    params, extra = checkpoint_tree(ckpt_dir, step)
    meta = {"source_step": str(step or ckpt.latest_step())}
    if isinstance(extra, dict) and "config" in extra:
        meta["model"] = str(extra["config"].get("model", ""))
        # architecture facts the serve loader must honour
        tied = extra["config"].get("tie_word_embeddings")
        if tied is not None:
            meta["tie_word_embeddings"] = str(
                _parse_bool("checkpoint tie_word_embeddings", tied)).lower()

    def resolved_model_cfg(why: str):
        name = args.model_name or meta.get("model") or ""
        if not name:
            raise CommandError(f"{why} needs --model "
                               "(or a checkpoint that records it)")
        return apply_ckpt_model_overrides(get_model_config(name), extra)

    model_cfg = calib = None
    if quant:                        # quantize (and calibrate) on the device
        device = resolve_device(args.root.device)
        params = _to(params, device)
        if quant in ("int8-awq", "int4-awq"):
            model_cfg = resolved_model_cfg(f"--quant {quant} calibration")
            calib = _calibration_tokens(args.calib_seq, model_cfg.vocab_size,
                                        device)
    if fmt == "gguf":
        if quant:
            raise CommandError(
                "gguf export is f16/bf16-only (no ggml quant blocks); "
                "quantized serving artifacts use --format safetensors")
        from ...io.gguf import export_gguf
        gcfg = resolved_model_cfg("--format gguf")
        tok_dir = ckpt_dir if (Path(ckpt_dir) / "tokenizer.json").exists() \
            else None
        path = export_gguf(params, gcfg, args.out_path, tokenizer_dir=tok_dir)
    else:
        path = export_params(params, args.out_path, fmt=fmt, quant=quant,
                             metadata=meta, model_cfg=model_cfg,
                             calib_tokens=calib)
    size_mb = Path(path).stat().st_size / 1e6
    print(f"exported {fmt}{'+' + quant if quant else ''} artifact: "
          f"{path} ({size_mb:.1f} MB)")
    return 0


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def import_hf(src: str, model_name: str, out_dir: str) -> int:
    """Import a local HuggingFace llama-format checkpoint into a port
    checkpoint."""
    from ...config.presets import get_model_config
    from ...io.hf_import import import_hf_checkpoint

    if not Path(src).exists():
        raise CommandError(f"no such file or directory {src}")
    cfg = get_model_config(model_name)
    path, eff = import_hf_checkpoint(src, cfg, out_dir)
    tie_note = ("" if eff.tie_word_embeddings == cfg.tie_word_embeddings
                else f" (tie_word_embeddings inferred as "
                     f"{eff.tie_word_embeddings} from the checkpoint)")
    print(f"imported HF checkpoint -> {path} (step 0, model "
          f"{eff.name}){tie_note}")
    return 0


def _bf16(x: np.ndarray) -> torch.Tensor:
    """An fp32 array rounded to a bf16 tensor (nearest even)."""
    return torch.from_numpy(x).to(torch.bfloat16)


def synth(model_name: str, quant: str, seed: int, out_path: str) -> int:
    """Synthesize a random-init deployment artifact (no checkpoint).

    Weights come from numpy as the JAX command makes them (clipped normal
    0.02, residual projections scaled 1/sqrt(2L), PCG64 from ``seed``),
    quantized with the absmax-int8 / group-wise int4 semantics of
    ``ops.quantization``."""
    from ...config.presets import get_model_config
    from ...io.export import export_params

    cfg = get_model_config(model_name)
    if cfg.is_moe:
        raise CommandError("synth does not cover MoE templates yet")
    H, D = cfg.hidden_size, cfg.head_dim
    Nq, Nkv, F, V, L = (cfg.num_heads, cfg.num_kv_heads, cfg.ffn_size,
                        cfg.vocab_size, cfg.num_layers)
    std = 0.02
    resid_std = std / float(np.sqrt(2.0 * L))
    rng = np.random.Generator(np.random.PCG64(seed))

    def dense_f32(*shape, scale=std):
        x = rng.standard_normal(shape, dtype=np.float32)
        np.clip(x, -3.0, 3.0, out=x)
        x *= scale
        return x

    def dense(*shape, scale=std):
        return _bf16(dense_f32(*shape, scale=scale))

    def q8(*shape, scale=std):
        if quant == "none":
            return {"kernel": dense(*shape, scale=scale)}
        if quant == "int4":
            return {"kernel": _q4_numpy(shape, scale)}
        vals = np.empty(shape, np.int8)
        scales = np.empty((shape[0], shape[1], 1), np.float32)
        for layer in range(shape[0]):
            x = dense_f32(*shape[1:], scale=scale)
            absmax = np.abs(x).max(axis=-1, keepdims=True)
            s = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
            np.clip(np.round(x / s), -127, 127, out=x)
            vals[layer] = x.astype(np.int8)
            scales[layer] = s
        return {"kernel": {"__quant__": "int8", "values": vals,
                           "scale": scales}}

    def _q4_numpy(shape, scale, group=128):
        """Group-wise int4 over the INPUT axis in kernel orientation:
        packed uint8 [L, in/2, out], scales fp32 [L, in/group, out]."""
        L_, n_in, n_out = shape
        if n_in % group:
            raise CommandError(
                f"int4 synth needs in % {group} == 0 (got {n_in})")
        vals = np.empty((L_, n_in // 2, n_out), np.uint8)
        scales = np.empty((L_, n_in // group, n_out), np.float32)
        for layer in range(L_):
            w = dense_f32(n_in, n_out, scale=scale)
            wt = np.ascontiguousarray(w.T)                 # [out, in]
            xb = wt.reshape(n_out, n_in // group, group)
            absmax = np.abs(xb).max(axis=-1, keepdims=True)
            sc = np.maximum(absmax / 7.0, 1e-12)
            q = np.clip(np.round(xb / sc), -7, 7).astype(
                np.int8).reshape(n_out, n_in)
            lo = (q[:, 0::2] & 0xF).astype(np.uint8)
            hi = (q[:, 1::2] & 0xF).astype(np.uint8)
            vals[layer] = (lo | (hi << 4)).T               # [in/2, out]
            scales[layer] = sc[..., 0].astype(np.float32).T
        return {"__quant__": "int4", "values": vals, "scale": scales,
                "chan": np.ones((L_, n_in), np.float32), "group": group}

    zeros = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)  # noqa: E731
    blocks = {
        "attn_norm": {"scale": zeros(L, H)},
        "q": q8(L, H, Nq * D),
        "k": q8(L, H, Nkv * D),
        "v": q8(L, H, Nkv * D),
        "o": q8(L, Nq * D, H, scale=resid_std),
        "mlp_norm": {"scale": zeros(L, H)},
        "mlp": {
            "gate": q8(L, H, F),
            "up": q8(L, H, F),
            "down": q8(L, F, H, scale=resid_std),
        },
    }
    if cfg.attention_bias:
        blocks["q"]["bias"] = zeros(L, Nq * D)
        blocks["k"]["bias"] = zeros(L, Nkv * D)
        blocks["v"]["bias"] = zeros(L, Nkv * D)
    params = {
        "embed": {"embedding": dense(V, H)},
        "blocks": blocks,
        "final_norm": {"scale": zeros(H)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(H, V)}

    meta = {"model": model_name, "synthetic": "random-init",
            "seed": str(seed),
            "tie_word_embeddings": str(cfg.tie_word_embeddings).lower()}
    if quant != "none":
        meta["quant"] = quant
    path = export_params(params, out_path, fmt="safetensors", metadata=meta)
    size_gb = Path(path).stat().st_size / 1e9
    print(f"synthesized {model_name} artifact "
          f"({quant or 'bf16'}): {path} ({size_gb:.2f} GB)")
    return 0
