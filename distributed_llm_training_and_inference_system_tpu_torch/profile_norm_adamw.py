"""Device time of the RMSNorm or the fused AdamW kernel alone.

    python -m distributed_llm_training_and_inference_system_tpu_torch.profile_norm_adamw \
        --kernel rmsnorm|adamw [--out F.json]

It builds the kernel's source alone (``rmsnorm.cu`` or ``adamw.cu``) and
prints ptxas's registers and spill bytes for each template. ``rmsnorm``:
at the entry forward's [1, 1024, 2048], at [8, 4096] and at [8192, 4096],
bf16 x and scale, the kernel once against its plain version, the CUDA
kernels one call runs (torch.profiler), and the kernel's time (CUDA
events, L2 flushed before every call) beside the plain version, one
``F.rms_norm`` call with its weight made outside the window, the byte
bound and the share of it. ``adamw``: one update of the 170 eligible
gpt-1b leaves (fp32 p, g, mu, nu) through ``fused_adamw_apply``: launches
and CUDA kernels a call, then the kernel's time beside the plain path,
``torch._fused_adamw_`` on the same tensors and the byte bound. It ends
with the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from .ops import build
from .profile_flash import card_line, time_ms
from .profiling import ptxas_entries

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_FP32 = 67e12                    # fp32 outside the tensor cores
NORM_SHAPES = ((1, 1024, 2048), (8, 4096), (8192, 4096))
ADAM_FLOPS = 20                      # fp32 operations an element, about


def _bound(nbytes: int, ops: int) -> dict:
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def rmsnorm_work(rows: int, H: int, item: int = 2,
                 scale_item: int = 2) -> dict:
    """Bytes and operations of one RMSNorm call, and its bound: x read
    once and the output written once in a dtype of ``item`` bytes, the
    scale read once; 4 fp32 operations an element (square, add, two
    products)."""
    return _bound(2 * rows * H * item + H * scale_item, 4 * rows * H)


def adamw_work(n: int, mu_item: int = 4, nu_item: int = 4) -> dict:
    """Bytes and operations of one AdamW update of ``n`` elements: p and
    g (fp32) read, mu and nu read in their dtypes, p, mu and nu written
    once (28 B an element at fp32 moments); ~20 fp32 operations an
    element."""
    moments = mu_item + nu_item
    return _bound(n * (8 + moments) + n * (4 + moments), ADAM_FLOPS * n)


_TYPES = (("f", "fp32"), ("13__nv_bfloat16", "bf16"))
_NAME = re.compile(r"(rmsnorm_warp_kernel|rmsnorm_block_kernel|"
                   r"rmsnorm_kernel|adamw_kernel)I")


def _template_args(mangled: str) -> list[str]:
    """The readable template arguments at the start of ``mangled`` (up to
    the list's closing E): fp32, bf16 (a substitution S..._ names the
    bf16 seen first) and integers."""
    out, i = [], 0
    while i < len(mangled):
        m = re.match(r"Li(\d+)E", mangled[i:])
        if m:
            out.append(m.group(1))
            i += m.end()
            continue
        m = re.match(r"S\w*?_", mangled[i:])
        if m:
            out.append("bf16")
            i += m.end()
            continue
        for code, name in _TYPES:
            if mangled.startswith(code, i):
                out.append(name)
                i += len(code)
                break
        else:
            break
    return out


def kernel_ptxas(log: str) -> dict:
    """{"kernel<args>": {registers, spill_stores, spill_loads}} of the
    RMSNorm and AdamW templates in nvcc -Xptxas -v output."""
    out = {}
    for name, figs in ptxas_entries(log).items():
        m = _NAME.search(name)
        if m:
            args = _template_args(name[m.end():])
            out[f"{m.group(1)}<{', '.join(args)}>"] = figs
    return out


def cuda_activity(fn, calls: int = 3) -> dict:
    """{CUDA kernel name: {"launches": a call, "ms": device ms a call}} of
    ``fn`` in a torch.profiler window of ``calls`` calls (CUDA activity).
    The profiler can drop kernels of a window (seen on an H100), so of
    three windows the one that saw the most kernels is kept."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                out[e.key] = {"launches": e.count / calls,
                              "ms": us / 1e3 / calls}
        if launches_of(out) > launches_of(best):
            best = out
    return best


def launches_of(activity: dict, key: str = "") -> float:
    """The launches a call of the kernels of ``activity`` whose name holds
    ``key``."""
    return sum(a["launches"] for k, a in activity.items() if key in k)


def _flusher():
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    return flush_buf.zero_


def _warm() -> None:
    """The card's clocks up before the first timed call."""
    warm = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(100):
        warm @ warm
    torch.cuda.synchronize()


def measure_rmsnorm() -> dict:
    import torch.nn.functional as F
    from .models import layers
    from .ops import rmsnorm as rn
    flush = _flusher()
    _warm()
    saved = rn.rmsnorm_kernel.launches
    res = {}
    for shape in NORM_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        sc = (torch.randn(shape[-1], generator=g, device="cuda") * 0.1
              ).to(torch.bfloat16)
        weight = 1 + sc

        def run():
            return layers.rms_norm(x, sc, 1e-5, impl="cuda")
        out, ref = run(), layers.rms_norm(x, sc, 1e-5)
        err = (out.float() - ref.float()).abs().max().item()
        kernels = cuda_activity(run)
        r = dict(rmsnorm_work(x.numel() // shape[-1], shape[-1]),
                 shape=list(shape), max_abs_err=err, cuda_kernels=kernels,
                 ms=time_ms(run, flush=flush),
                 plain_ms=time_ms(lambda: layers.rms_norm(x, sc, 1e-5),
                                  flush=flush),
                 library_ms=time_ms(lambda: F.rms_norm(
                     x, (shape[-1],), weight, 1e-5), flush=flush))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["over_library"] = r["ms"] / r["library_ms"]
        res["x".join(map(str, shape))] = r
        print(f"rmsnorm {list(shape)} bf16: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, F.rms_norm {r['library_ms']:.4f} ms "
              f"({r['over_library']:.2f}x), bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}) -> {r['share_of_bound']:.1%} of bound; "
              f"{launches_of(kernels):g} CUDA kernel(s) a call; max abs "
              f"error against plain {err:.3e}", flush=True)
        del x, sc, weight, out, ref
    rn.rmsnorm_kernel.launches = saved
    return res


def gpt1b_leaf_shapes() -> list[tuple]:
    from .config import get_model_config
    from .exec import fused_update as fu
    from .models import gpt
    meta = gpt.GPT(get_model_config("gpt-1b"), device="meta")
    return [tuple(p.shape) for p in meta.parameters()
            if p.dim() >= 2 and p.numel() >= fu.KERNEL_MIN_ELEMENTS]


def measure_adamw() -> dict:
    from .exec import fused_update as fu
    from .ops.adamw_cuda import adamw_kernel
    shapes = gpt1b_leaf_shapes()
    g = torch.Generator(device="cuda").manual_seed(21)
    P = [torch.randn(s, generator=g, device="cuda") for s in shapes]
    G = [torch.randn(s, generator=g, device="cuda") * 1e-2 for s in shapes]
    M = [torch.randn(s, generator=g, device="cuda") * 1e-3 for s in shapes]
    V = [torch.rand(s, generator=g, device="cuda") * 1e-5 for s in shapes]
    count = torch.tensor(6, dtype=torch.int32, device="cuda")
    lr = torch.tensor(3e-4, device="cuda")
    clip = torch.tensor(0.37, device="cuda")
    kw = dict(lr=lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              decay_mask=[True] * len(shapes), clip_scale=clip)
    _warm()

    def run():
        fu.fused_adamw_apply(P, G, M, V, count, **kw)
    saved = adamw_kernel.launches
    run()
    torch.cuda.synchronize()
    launches = adamw_kernel.launches - saved
    kernels = {k: a["launches"] for k, a in cuda_activity(run, calls=2).items()
               if "adamw" in k}
    k_ms = time_ms(run, iters=10, warmup=2)
    adamw_kernel.launches = saved
    p_ms = time_ms(lambda: fu.fused_adamw_apply(
        P, G, M, V, count, use_kernel=False, **kw), iters=5, warmup=1)
    steps = [torch.full((), 6.0, device="cuda") for _ in shapes]
    inv_clip = (1.0 / clip).reshape(1)

    def lib():
        torch._fused_adamw_(P, G, M, V, [], steps, lr=3e-4, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False,
                            grad_scale=inv_clip, found_inf=None)
    l_ms = time_ms(lib, iters=10, warmup=2)
    n = sum(p.numel() for p in P)
    r = dict(adamw_work(n), leaves=len(shapes), params=n, launches=launches,
             cuda_kernels=kernels, ms=k_ms, plain_ms=p_ms, library_ms=l_ms)
    r["share_of_bound"] = r["bound_ms"] / k_ms
    r["over_library"] = k_ms / l_ms
    print(f"adamw over {len(shapes)} gpt-1b leaves ({n} params, fp32 "
          f"moments): {launches} launch(es), CUDA kernels a call "
          f"{kernels}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"torch._fused_adamw_ {l_ms:.3f} ms ({r['over_library']:.2f}x), "
          f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}) -> "
          f"{r['share_of_bound']:.1%} of bound", flush=True)
    del P, G, M, V
    torch.cuda.empty_cache()
    return r


KERNELS = {"rmsnorm": ("rmsnorm", measure_rmsnorm),
           "adamw": ("adamw", measure_adamw)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_norm_adamw: needs a CUDA card")
    card = card_line()
    source, measure = KERNELS[a.kernel]
    figs = kernel_ptxas(build.build([source])[source])
    for name, f in figs.items():
        print(f"ptxas {name}: {f}", flush=True)
    out = {"card": card, "ptxas": figs, "result": measure()}
    print(f"card: {card}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
