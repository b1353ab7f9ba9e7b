"""Export artifacts: safetensors written and read by hand, npz, quantized
trees (the JAX package's ``io/export.py``, file for file).

A safetensors file is an 8-byte little-endian header length, a JSON header
mapping each tensor name to ``{dtype, shape, data_offsets}`` (with a
``__metadata__`` map of strings first), padded with spaces to 8 bytes,
then the tensors' row-major bytes in sorted name order; both packages
write the same bytes for the same tree and metadata. bf16 travels as its
uint16 bits (no ``safetensors`` or ``ml_dtypes`` package is needed) and is
read back with ``torch.from_numpy(u16).view(torch.bfloat16)``. npz has no
bf16: a bf16 leaf is written widened to fp32 (exact).

Trees are JAX-layout dicts (``weights.params_to_tree``) of torch tensors or
numpy arrays; a quantized leaf is an export-form ``{"__quant__": kind,
values, scale[, chan, group]}`` dict, flattened to ``<path>.values`` etc.
(the marker string itself is not stored; ``unflatten_exported`` re-forms
it from the suffixes). ``load_exported`` returns host torch tensors.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_DTYPE_TO_ST = {
    "float32": "F32", "float16": "F16", "bfloat16": "BF16",
    "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8",
    "uint8": "U8", "bool": "BOOL", "float64": "F64",
}
_ST_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ST.items()}


def _host_array(a) -> tuple[np.ndarray, str]:
    """(numpy array of the leaf's bytes, its dtype name): a bf16 tensor
    as its uint16 bits, tagged "bfloat16"."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = a.numpy()
    a = np.asarray(a)
    return a, str(a.dtype)


def save_safetensors(tensors: dict[str, Any], path: str | Path,
                     metadata: Optional[dict[str, str]] = None) -> None:
    """Write a {name: tensor or array} dict as a .safetensors file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    blobs: list[bytes] = []
    for name in sorted(tensors):
        a, dt = _host_array(tensors[name])
        if dt not in _DTYPE_TO_ST:
            raise ValueError(
                f"dtype {dt} of tensor {name!r} unsupported by safetensors")
        blob = np.ascontiguousarray(a).tobytes()
        header[name] = {"dtype": _DTYPE_TO_ST[dt], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)


def load_safetensors(path: str | Path
                     ) -> tuple[dict[str, torch.Tensor], dict[str, str]]:
    """Read a .safetensors file -> ({name: host tensor}, metadata)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data = f.read()
    meta = header.pop("__metadata__", {})
    out = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        dt = _ST_TO_DTYPE[info["dtype"]]
        raw = np.frombuffer(data[start:end],
                            dtype=np.uint16 if dt == "bfloat16" else dt)
        t = torch.from_numpy(raw.reshape(info["shape"]).copy())
        out[name] = t.view(torch.bfloat16) if dt == "bfloat16" else t
    return out, meta


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Dotted-path leaves of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _int4_leaves(node, out: list) -> list:
    if isinstance(node, dict):
        if node.get("__quant__") == "int4":
            out.append(node)
        else:
            for v in node.values():
                _int4_leaves(v, out)
    return out


def _kernel_oriented(leaf) -> bool:
    """True iff an int4 leaf's packed/scale shapes are those of the kernel
    orientation (packed [..., in/2, out], scale [..., in/group, out])."""
    packed, scale = leaf["values"], leaf["scale"]
    group = int(np.asarray(leaf.get("group", 128)))
    if len(packed.shape) < 2 or len(scale.shape) != len(packed.shape):
        return False
    n_in, n_out = packed.shape[-2] * 2, packed.shape[-1]
    return scale.shape[-1] == n_out and scale.shape[-2] * group == n_in


def export_params(params: Any, out_path: str | Path,
                  fmt: str = "safetensors", quant: Optional[str] = None,
                  metadata: Optional[dict] = None, model_cfg=None,
                  calib_tokens=None) -> Path:
    """Export a param tree (or a ``models.gpt.GPT``). fmt: safetensors |
    npz. quant: None | int8 | int8-awq | int4 | int4-awq (the awq kinds
    need ``model_cfg`` and ``calib_tokens`` for the calibration forward);
    every refusal of the JAX exporter is kept."""
    from ..models.gpt import GPT
    from ..ops import quantization as q
    from ..weights import calibration_scales, params_to_tree
    if isinstance(params, GPT):
        params = params_to_tree(params)
    out_path = Path(out_path)
    meta = dict(metadata or {})
    meta["format"] = fmt
    if quant:
        meta["quant"] = quant
        if quant in ("int4", "int4-awq"):
            # the packed-nibble orientation: [L, in/2, out]
            meta["int4_layout"] = "kernel"
        if quant == "int8":
            params = q.quantize_tree_int8(params, min_ndim=3)
        elif quant == "int8-awq":
            if model_cfg is None or calib_tokens is None:
                raise ValueError(
                    "int8-awq needs model_cfg and calib_tokens for the "
                    "activation-aware calibration pass")
            params = q.quantize_tree_int8_awq(
                params, calibration_scales(params, model_cfg, calib_tokens))
        elif quant in ("int4", "int4-awq"):
            if quant == "int4-awq" and (model_cfg is None
                                        or calib_tokens is None):
                raise ValueError(
                    "int4-awq needs model_cfg and calib_tokens for the "
                    "activation-aware calibration pass")
            params = q.quantize_tree_int4(
                params, act=(calibration_scales(params, model_cfg,
                                                calib_tokens)
                             if quant == "int4-awq" else None))
        else:
            raise ValueError(f"unsupported quant {quant!r} "
                             "(int8 | int8-awq | int4 | int4-awq)")
    # a pre-quantized tree's int4 markers tag the layout themselves, only
    # where every int4 leaf's shapes validate against the kernel
    # orientation (a mislabelled legacy tree would dequantize to garbage)
    int4 = _int4_leaves(params, [])
    if int4:
        meta.setdefault("quant", "int4")
        if all(_kernel_oriented(leaf) for leaf in int4):
            meta.setdefault("int4_layout", "kernel")
        elif "int4_layout" not in meta:
            raise ValueError(
                "int4 leaves do not match the kernel orientation "
                "([..., in/2, out] packed with [..., in/group, out] "
                "scales) and no int4_layout metadata was provided — "
                "refusing to tag; pass metadata={'int4_layout': ...} "
                "describing the actual layout")
    flat = {k: (np.asarray(v, np.int32) if isinstance(v, int) else v)
            for k, v in _flatten(params).items()
            if not k.endswith("__quant__")}
    if fmt == "safetensors":
        save_safetensors(flat, out_path, metadata=meta)
    elif fmt == "npz":
        arrays = {}
        for k, v in flat.items():
            a, dt = _host_array(v)
            arrays[k] = (torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).float().numpy() if dt == "bfloat16" else a)
        np.savez(out_path, **arrays)
    else:
        raise ValueError(f"unsupported export format {fmt!r}")
    return out_path


def unflatten_exported(flat: dict[str, Any], quant: Optional[str]) -> Any:
    """The param tree of an export's dotted-path tensors, with the
    ``{"__quant__": ...}`` marker leaves re-formed from the ``.values`` /
    ``.scale`` suffix pair: ``chan`` and ``group`` => int4, ``chan`` alone
    => int8-awq, else the metadata's kind."""
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def walk(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if "values" in node and "scale" in node:
            if "chan" in node and "group" in node:
                kind = "int4"
            elif "chan" in node:
                kind = "int8-awq"
            else:
                kind = quant or "int8"
            out = {"__quant__": kind, "values": node["values"],
                   "scale": node["scale"]}
            if "chan" in node:
                out["chan"] = node["chan"]
            if "group" in node:
                out["group"] = int(np.asarray(node["group"]))
            return out
        return {k: walk(v) for k, v in node.items()}

    return walk(root)


def load_exported(path: str | Path) -> tuple[Any, dict]:
    """An ``export_params`` artifact as (param tree of host tensors with
    quant-marker leaves, metadata). An int4 artifact without the
    ``int4_layout="kernel"`` marker is refused: the packed-nibble
    orientation is ambiguous from shapes alone."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            flat = {k: torch.from_numpy(np.array(z[k])) for k in z.files}
        meta: dict = {"format": "npz"}
    else:
        flat, meta = load_safetensors(path)
    tree = unflatten_exported(flat, meta.get("quant"))
    if _int4_leaves(tree, []) and meta.get("int4_layout") != "kernel":
        raise ValueError(
            f"int4 artifact {path} lacks int4_layout='kernel' metadata "
            "(pre-round-3 [out, in/2] layout or npz without metadata); "
            "refusing to guess the packed-nibble orientation")
    return tree, meta
