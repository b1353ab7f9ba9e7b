"""GGUF v3 export: a self-contained writer and a reader (the JAX
package's ``io/gguf.py``; the files are byte for byte the JAX package's).

The container from its public spec: little-endian magic ``GGUF``, version
3, a metadata key/value table, tensor-info records (name, dims in ggml
order, type, aligned data offset), then the aligned tensor payload.

Scope: llama-architecture decoder exports (stacked [L, ...] kernels split
per layer into ``blk.{i}.*`` tensors with llama.cpp's names and the
``llama.*`` metadata). F32 / F16 / BF16 payloads; bf16 is rounded to
nearest even by PyTorch's conversion and stored as its uint16 bits (no
``ml_dtypes``), and read back as a ``torch.bfloat16`` tensor. Quantized
GGML block formats are not emitted: quantized deployment artifacts use the
safetensors int8/int4 path (io/export.py).
"""

from __future__ import annotations

import re
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models.gpt import GPT
from ..ops.quantization import _is_quant_marker, _is_runtime_quant

# byte-fallback vocab entries (sentencepiece / this framework's fallback)
_BYTE_TOKEN = re.compile(r"<0x[0-9A-Fa-f]{2}>")

GGUF_MAGIC = 0x46554747          # "GGUF" little-endian
GGUF_VERSION = 3
ALIGNMENT = 32

# metadata value types
_T_UINT8, _T_INT8, _T_UINT16, _T_INT16 = 0, 1, 2, 3
_T_UINT32, _T_INT32, _T_FLOAT32, _T_BOOL = 4, 5, 6, 7
_T_STRING, _T_ARRAY, _T_UINT64, _T_INT64, _T_FLOAT64 = 8, 9, 10, 11, 12

# ggml tensor types (subset emitted here)
GGML_F32, GGML_F16, GGML_BF16 = 0, 1, 30
_GGML_NP = {GGML_F32: np.float32, GGML_F16: np.float16}


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(v: Any) -> bytes:
    """Pack a python value with its type tag (scalars, strings, and
    homogeneous lists of int / float / string)."""
    if isinstance(v, bool):
        return struct.pack("<IB", _T_BOOL, int(v))
    if isinstance(v, int):
        return struct.pack("<Iq", _T_INT64, v) if v < 0 else \
            struct.pack("<IQ", _T_UINT64, v)
    if isinstance(v, float):
        return struct.pack("<If", _T_FLOAT32, v)
    if isinstance(v, str):
        return struct.pack("<I", _T_STRING) + _pack_str(v)
    if isinstance(v, (list, tuple)):
        if not v:
            raise ValueError("cannot infer element type of empty array")
        out = struct.pack("<I", _T_ARRAY)
        if all(isinstance(x, str) for x in v):
            out += struct.pack("<IQ", _T_STRING, len(v))
            for x in v:
                out += _pack_str(x)
        elif all(isinstance(x, bool) for x in v):
            out += struct.pack("<IQ", _T_BOOL, len(v))
            out += b"".join(struct.pack("<B", int(x)) for x in v)
        elif all(isinstance(x, int) for x in v):
            out += struct.pack("<IQ", _T_INT32, len(v))
            out += b"".join(struct.pack("<i", x) for x in v)
        elif all(isinstance(x, (int, float)) for x in v):
            out += struct.pack("<IQ", _T_FLOAT32, len(v))
            out += b"".join(struct.pack("<f", float(x)) for x in v)
        else:
            raise ValueError(f"unsupported array element mix: {v[:3]}")
        return out
    raise ValueError(f"unsupported metadata value {type(v)}")


def _ggml_type(arr: np.ndarray, want: str) -> int:
    if want == "f32":
        return GGML_F32
    if want == "f16":
        return GGML_F16
    if want == "bf16":
        return GGML_BF16
    raise ValueError(f"unsupported gguf tensor dtype {want!r}")


def bf16_bits(arr: np.ndarray) -> np.ndarray:
    """uint16 bits of ``arr`` rounded to bf16 (nearest even)."""
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _tensor_bytes(arr: np.ndarray, gtype: int) -> bytes:
    if gtype == GGML_BF16:
        return bf16_bits(arr).tobytes()
    return np.ascontiguousarray(arr.astype(_GGML_NP[gtype])).tobytes()


def write_gguf(path: str | Path, metadata: dict[str, Any],
               tensors: dict[str, np.ndarray], dtype: str = "f16") -> Path:
    """Write a GGUF v3 file. ``tensors`` maps gguf tensor name -> array
    (numpy-order shapes; dims are reversed into ggml order on disk, where
    ne[0] is the contiguous axis). 1-D tensors (norms) stay f32 — llama.cpp
    requires f32 norm weights regardless of the file's main dtype."""
    path = Path(path)
    meta = {"general.alignment": ALIGNMENT, **metadata}

    infos, blobs, offset = [], [], 0
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        gtype = GGML_F32 if arr.ndim == 1 else _ggml_type(arr, dtype)
        blob = _tensor_bytes(arr, gtype)
        pad = (-offset) % ALIGNMENT
        offset += pad
        infos.append((name, arr.shape[::-1], gtype, offset))
        blobs.append((pad, blob))
        offset += len(blob)

    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                            len(infos), len(meta)))
        for k, v in meta.items():
            f.write(_pack_str(k))
            f.write(_pack_value(v))
        for name, dims, gtype, off in infos:
            f.write(_pack_str(name))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", gtype, off))
        pad = (-f.tell()) % ALIGNMENT      # data section starts aligned
        f.write(b"\x00" * pad)
        for pad_n, blob in blobs:
            f.write(b"\x00" * pad_n)
            f.write(blob)
    return path


# ---------------------------------------------------------------------------
# Reader (verification)
# ---------------------------------------------------------------------------

def _read_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f) -> Any:
    (t,) = struct.unpack("<I", f.read(4))
    scalars = {_T_UINT8: "<B", _T_INT8: "<b", _T_UINT16: "<H",
               _T_INT16: "<h", _T_UINT32: "<I", _T_INT32: "<i",
               _T_FLOAT32: "<f", _T_UINT64: "<Q", _T_INT64: "<q",
               _T_FLOAT64: "<d"}
    if t in scalars:
        (v,) = struct.unpack(scalars[t],
                             f.read(struct.calcsize(scalars[t])))
        return v
    if t == _T_BOOL:
        return bool(f.read(1)[0])
    if t == _T_STRING:
        return _read_str(f)
    if t == _T_ARRAY:
        et, n = struct.unpack("<IQ", f.read(12))
        if et == _T_STRING:
            return [_read_str(f) for _ in range(n)]
        if et == _T_BOOL:
            return [bool(b) for b in f.read(n)]
        fmt = scalars[et]
        sz = struct.calcsize(fmt)
        return [struct.unpack(fmt, f.read(sz))[0] for _ in range(n)]
    raise ValueError(f"unknown gguf value type {t}")


def read_gguf(path: str | Path,
              load_tensors: bool = True) -> tuple[dict, dict]:
    """Parse a GGUF file -> (metadata, tensors). Tensors come back in
    numpy-order shapes (ggml dims reversed): numpy arrays, BF16 payloads as
    ``torch.bfloat16`` tensors."""
    path = Path(path)
    with open(path, "rb") as f:
        magic, version, n_tensors, n_meta = struct.unpack("<IIQQ",
                                                          f.read(24))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path} is not GGUF")
        if version != GGUF_VERSION:
            raise ValueError(f"unsupported gguf version {version}")
        meta = {}
        for _ in range(n_meta):
            k = _read_str(f)
            meta[k] = _read_value(f)
        infos = []
        for _ in range(n_tensors):
            name = _read_str(f)
            (nd,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{nd}Q", f.read(8 * nd))
            gtype, off = struct.unpack("<IQ", f.read(12))
            infos.append((name, dims, gtype, off))
        align = int(meta.get("general.alignment", ALIGNMENT))
        base = f.tell() + ((-f.tell()) % align)
        tensors = {}
        if load_tensors:
            for name, dims, gtype, off in infos:
                shape = dims[::-1]
                count = int(np.prod(shape)) if shape else 1
                f.seek(base + off)
                if gtype == GGML_BF16:
                    dt = np.dtype(np.uint16)
                elif gtype in _GGML_NP:
                    dt = np.dtype(_GGML_NP[gtype])
                else:
                    raise ValueError(f"tensor {name}: unsupported ggml "
                                     f"type {gtype} (quantized gguf blocks "
                                     "are out of scope)")
                buf = f.read(count * dt.itemsize)
                arr = np.frombuffer(buf, dt).reshape(shape)
                tensors[name] = (torch.from_numpy(arr.view(np.int16).copy())
                                 .view(torch.bfloat16)
                                 if gtype == GGML_BF16 else arr)
        else:
            tensors = {name: {"shape": dims[::-1], "type": gtype,
                              "offset": off}
                       for name, dims, gtype, off in infos}
    return meta, tensors


# ---------------------------------------------------------------------------
# Param-pytree -> gguf (llama architecture)
# ---------------------------------------------------------------------------

def _has_quantized(tree: Any) -> bool:
    """Whether a tree holds a quantized kernel: a runtime QuantTensor /
    Quant4Tensor leaf or an export-form ``{"__quant__": ...}`` dict."""
    if _is_runtime_quant(tree) or _is_quant_marker(tree):
        return True
    if isinstance(tree, dict):
        return any(_has_quantized(v) for v in tree.values())
    return False


def _tree_f32(tree: Any) -> Any:
    """A tree's leaves as fp32 numpy arrays (bf16 exactly widened)."""
    if isinstance(tree, dict):
        return {k: _tree_f32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().float().numpy()
    return np.asarray(tree, np.float32)


def export_gguf(params: Any, model_cfg, out_path: str | Path,
                dtype: str = "f16", tokenizer_dir: str | None = None) -> Path:
    """Export full-precision params (a ``models.gpt.GPT``, or a JAX-layout
    tree of tensors or arrays) as a llama-architecture GGUF.

    Tensor naming follows llama.cpp's convention (``token_embd.weight``,
    ``blk.{i}.attn_q.weight``, ...). Kernels are stored TRANSPOSED
    ([out, in] row-major): ggml matmuls consume weights with the input
    dim contiguous, matching HF->gguf converter behaviour. Quantized
    pytrees are refused — requantizing an already-quantized tree
    compounds error; export from the checkpoint instead.
    """
    from ..weights import params_to_tree
    if isinstance(params, GPT):
        params = params_to_tree(params)
    if _has_quantized(params):
        raise ValueError("gguf export needs the full-precision "
                         "checkpoint (got a quantized tree)")

    cfg = model_cfg
    if cfg.is_moe:
        raise ValueError("gguf export covers dense llama-architecture "
                         "models; MoE trees have no llama.* mapping here")
    np_params = _tree_f32(params)
    blocks = np_params["blocks"]
    L = cfg.num_layers

    tensors: dict[str, np.ndarray] = {}
    tensors["token_embd.weight"] = np_params["embed"]["embedding"]
    for i in range(L):
        pre = f"blk.{i}."
        # stored (1 + s), gguf expects the multiplicative weight
        tensors[pre + "attn_norm.weight"] = \
            1.0 + blocks["attn_norm"]["scale"][i]
        tensors[pre + "attn_q.weight"] = blocks["q"]["kernel"][i].T
        tensors[pre + "attn_k.weight"] = blocks["k"]["kernel"][i].T
        tensors[pre + "attn_v.weight"] = blocks["v"]["kernel"][i].T
        tensors[pre + "attn_output.weight"] = blocks["o"]["kernel"][i].T
        for proj in ("q", "k", "v"):
            if "bias" in blocks[proj]:   # qwen-style attention bias
                tensors[pre + f"attn_{proj}.bias"] = \
                    blocks[proj]["bias"][i]
        tensors[pre + "ffn_norm.weight"] = \
            1.0 + blocks["mlp_norm"]["scale"][i]
        tensors[pre + "ffn_gate.weight"] = blocks["mlp"]["gate"]["kernel"][i].T
        tensors[pre + "ffn_up.weight"] = blocks["mlp"]["up"]["kernel"][i].T
        tensors[pre + "ffn_down.weight"] = blocks["mlp"]["down"]["kernel"][i].T
    tensors["output_norm.weight"] = 1.0 + np_params["final_norm"]["scale"]
    if "lm_head" in np_params:
        tensors["output.weight"] = np_params["lm_head"]["kernel"].T
    # tied embeddings: llama.cpp reuses token_embd as output

    meta: dict[str, Any] = {
        "general.architecture": "llama",
        "general.name": cfg.name,
        "llama.block_count": L,
        "llama.context_length": cfg.max_position_embeddings,
        "llama.embedding_length": cfg.hidden_size,
        "llama.feed_forward_length": cfg.ffn_size,
        "llama.attention.head_count": cfg.num_heads,
        "llama.attention.head_count_kv": cfg.num_kv_heads,
        "llama.attention.layer_norm_rms_epsilon": float(cfg.norm_eps),
        "llama.rope.freq_base": float(cfg.rope.base),
        "llama.vocab_size": cfg.vocab_size,
    }

    vocab = merges = None
    specials: set[str] = set()
    if tokenizer_dir:
        vocab, merges, specials = _hf_vocab(tokenizer_dir)
        if vocab is not None and not merges:
            # a vocab without BPE merges (WordPiece / Unigram tokenizer)
            # cannot be represented as gguf's "gpt2" model — tagging it
            # gpt2 anyway would export a file llama.cpp refuses at load.
            # Fall back to the self-describing byte tokenizer and say so.
            import logging
            logging.getLogger(__name__).warning(
                "%s/tokenizer.json has a vocab but no BPE merges; gguf "
                "export falls back to the byte-level tokenizer (the "
                "gpt2 vocab form requires merges)", tokenizer_dir)
            vocab = None
    if vocab is None:
        # self-describing fallback: the framework's byte-level tokenizer
        # (serve/tokenizer.py) — ids 0-255 are raw bytes. NOTE: the model
        # name "llmctl-bytes" is not a vocab llama.cpp knows how to load;
        # the container is spec-valid and self-describing, but third-party
        # loaders need an HF ``tokenizer_dir`` export to run it.
        vocab = [f"<0x{i:02X}>" for i in range(256)]
        vocab += [f"<extra_{i}>" for i in range(256, cfg.vocab_size)]
        meta["tokenizer.ggml.model"] = "llmctl-bytes"
    else:
        meta["tokenizer.ggml.model"] = "gpt2"
        if len(vocab) < cfg.vocab_size:   # padded embedding rows
            pad = [f"<extra_{i}>"
                   for i in range(len(vocab), cfg.vocab_size)]
            vocab = vocab + pad
            specials |= set(pad)   # padding is never real text
        # llama.cpp's gpt2/BPE loader requires the merge list to
        # reconstruct the tokenizer; without it the file is refused
        # (merges-less vocabs fell back to the byte tokenizer above)
        meta["tokenizer.ggml.merges"] = merges
    if meta["tokenizer.ggml.model"] == "llmctl-bytes":
        # fallback vocab is self-generated: ids 0-255 are bytes, the
        # <extra_i> rows are padding (never produced as text)
        specials = {t for t in vocab if not _BYTE_TOKEN.fullmatch(t)}
    vocab = vocab[:cfg.vocab_size]
    meta["tokenizer.ggml.tokens"] = vocab
    # token_type per llama.cpp llama_token_type: NORMAL=1, CONTROL=3,
    # BYTE=6. CONTROL comes from the tokenizer's OWN special list
    # (added_tokens[].special) — an angle-bracket string heuristic would
    # silently drop ordinary tokens like '<br>' from detokenized output
    # (loaders exclude CONTROL tokens). <0xNN> byte-fallback entries are
    # BYTE, not CONTROL, for the same reason: a CONTROL tag would make
    # every byte the model emits vanish from the text.
    meta["tokenizer.ggml.token_type"] = [
        3 if t in specials else 6 if _BYTE_TOKEN.fullmatch(t) else 1
        for t in vocab]

    return write_gguf(out_path, meta, tensors, dtype=dtype)


def _hf_vocab(tokenizer_dir: str) -> tuple[
        list[str] | None, list[str] | None, set[str]]:
    """Best-effort (vocab, merges, special tokens) from a local HF
    tokenizer dir. Merges come back in gguf's "left right" string form
    (newer tokenizer.json files store them as [left, right] pairs — both
    accepted). Specials are the tokenizer's OWN declaration
    (added_tokens[].special), the authoritative source for gguf's
    CONTROL token_type."""
    import json
    d = Path(tokenizer_dir)
    for name in ("tokenizer.json",):
        p = d / name
        if p.exists():
            try:
                tok = json.loads(p.read_text())
                model = tok.get("model", {})
                vocab = model.get("vocab")
                if not isinstance(vocab, dict):
                    return None, None, set()
                inv = sorted(vocab.items(), key=lambda kv: kv[1])
                merges = []
                for m in model.get("merges") or []:
                    if isinstance(m, str):
                        merges.append(m)
                    elif isinstance(m, (list, tuple)) and len(m) == 2:
                        merges.append(f"{m[0]} {m[1]}")
                specials = {
                    t.get("content") for t in tok.get("added_tokens") or []
                    if isinstance(t, dict) and t.get("special")
                    and isinstance(t.get("content"), str)}
                return [k for k, _ in inv], merges or None, specials
            except (json.JSONDecodeError, OSError):
                return None, None, set()
    return None, None, set()
