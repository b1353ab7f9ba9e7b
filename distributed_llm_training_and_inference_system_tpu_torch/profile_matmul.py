"""Device time of the W4A16 or W8A16 matmul kernels at llama-8b-gqa's
projections.

    python -m distributed_llm_training_and_inference_system_tpu_torch.profile_matmul \
        [--kernel w4|w8] [--rows 1 8 44 64] [--out matmul.json]

It builds the kernel's source alone (``int4_matmul.cu`` or
``int8_matmul.cu``) and prints ptxas's registers and spill bytes for each
template, then, at the four projection shapes of llama-8b-gqa (4096->4096,
4096->1024, 4096->14336, 14336->4096; W4 group 128) and each row count,
checks the kernel once against its plain version and reports its time
(CUDA events, L2 flushed before every call), the time of ``x @ w_bf16`` on
the same inputs (the dequantized weight, 2 bytes a weight), the byte bound
and the kernel's share of it. W8 goes through ``matmul_w8``, so each shape
takes the route the serving path gives it (the k-split for the down
projection). It ends with the launch-weighted kernel time of one decode
step at 8 rows (7 projections a layer x 32 layers: for W8, 6 whole-K and 1
k-split launches a layer) and the card's name and power limit. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from .ops import build
from .ops import int4_matmul as w4
from .ops import int8_matmul as w8
from .ops import quantization as tq
from .profile_flash import card_line, time_ms
from .profiling import ptxas_entries

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_BF16 = 989e12                   # dense tensor-core bf16
GROUP = 128                          # llama-8b-gqa's int4 group
# [in, out] of llama-8b-gqa's projections, and how many a layer runs:
# q and o, k and v, gate and up, down
PROJECTIONS = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2,
               (14336, 4096): 1}
LAYERS = 32
ROWS = (1, 8, 44, 64)


def w4_work(rows: int, n_in: int, n_out: int, group: int = GROUP,
            item: int = 2) -> dict:
    """Bytes and operations of one W4 call, and its bound: the nibbles
    (half a byte a weight), the fp32 group scales and channel scales, x
    read once and y written once in a dtype of ``item`` bytes; 2 flops a
    weight and row against the bf16 tensor-core peak."""
    return _bound(n_in * n_out // 2 + (n_in // group) * n_out * 4 + n_in * 4
                  + rows * n_in * item + rows * n_out * item,
                  2 * rows * n_in * n_out)


def _bound(nbytes: int, ops: int) -> dict:
    t_ops, t_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def w8_work(rows: int, n_in: int, n_out: int, item: int = 2) -> dict:
    """Bytes and operations of one W8 call, and its bound: the int8 values
    (one byte a weight), the fp32 scale of each input row, x read once and
    y written once in a dtype of ``item`` bytes; 2 flops a weight and row
    against the bf16 tensor-core peak."""
    return _bound(n_in * n_out + n_in * 4 + rows * n_in * item
                  + rows * n_out * item, 2 * rows * n_in * n_out)


def decode_step_ms(per_shape_ms: dict) -> float:
    """Matmul kernel time of one decode step from {(in, out): ms}: each
    projection as often as a layer runs it, times the layers."""
    return LAYERS * sum(n * per_shape_ms[s] for s, n in PROJECTIONS.items())


_W4 = re.compile(r"int4_matmul_kernelILi(\d+)ELb([01])E(f|13__nv_bfloat16)E")


def w4_ptxas(log: str) -> dict:
    """{"int4_matmul_kernel<rows, group16|any, dtype>": {registers,
    spill_stores, spill_loads}} from nvcc -Xptxas -v output."""
    out = {}
    for name, figs in ptxas_entries(log).items():
        k = _W4.search(name)
        if k:
            out[f"int4_matmul_kernel<{k.group(1)}, "
                f"{'group16' if k.group(2) == '1' else 'any'}, "
                f"{'fp32' if k.group(3) == 'f' else 'bf16'}>"] = figs
    return out


_W8 = re.compile(r"int8_matmul_kernelILi(\d+)E(f|13__nv_bfloat16)E")


def w8_ptxas(log: str) -> dict:
    """{"int8_matmul_kernel<rows, dtype>": {registers, spill_stores,
    spill_loads}} from nvcc -Xptxas -v output."""
    out = {}
    for name, figs in ptxas_entries(log).items():
        k = _W8.search(name)
        if k:
            out[f"int8_matmul_kernel<{k.group(1)}, "
                f"{'fp32' if k.group(2) == 'f' else 'bf16'}>"] = figs
    return out


def case(rows: int, n_in: int, n_out: int, seed: int = 6):
    """bf16 x, an int4 weight of ``n_in x n_out`` with channel scales, and
    the same weight dequantized to bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02
    x = torch.randn(rows, n_in, generator=g, device="cuda").to(torch.bfloat16)
    act = torch.rand(n_in, generator=g, device="cuda") + 0.25
    packed, scale, chan = tq.quantize_int4_groupwise(w, GROUP, act_scale=act)
    w_bf16 = tq.dequantize_int4_groupwise(packed, scale, chan, GROUP,
                                          torch.bfloat16)
    return x, packed, scale, chan, w_bf16


def case_w8(rows: int, n_in: int, n_out: int, seed: int = 5):
    """bf16 x, an int8 weight of ``n_in x n_out`` with its row scales, and
    the same weight dequantized to bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02
    x = torch.randn(rows, n_in, generator=g, device="cuda").to(torch.bfloat16)
    values, scale = tq.quantize_int8(w)
    return x, values, scale, tq.dequantize_int8(values, scale, torch.bfloat16)


# per kernel: its source, ptxas parse, inputs and the bf16 weight, kernel,
# plain version, work and launch counters
KERNELS = {
    "w4": ("int4_matmul", w4_ptxas, case,
           lambda a: w4.int4_matmul_kernel(*a, GROUP),
           lambda a: w4.matmul_w4_plain(*a, GROUP),
           w4_work, (w4.int4_matmul_kernel,)),
    "w8": ("int8_matmul", w8_ptxas, case_w8, lambda a: w8.matmul_w8(*a),
           lambda a: w8.matmul_w8_plain(*a),
           w8_work, (w8.int8_matmul_kernel, w8.int8_matmul_ksplit_kernel)),
}


def measure(rows_list=ROWS, kernel: str = "w4") -> dict:
    make, run, plain, work, counters = KERNELS[kernel][2:]
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    # the card's clocks up before the first timed call
    warm = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(100):
        warm @ warm
    del warm
    res = {}
    saved = [c.launches for c in counters]
    for rows in rows_list:
        for (n_in, n_out) in PROJECTIONS:
            *args, w_bf16 = make(rows, n_in, n_out)
            x = args[0]
            out = run(args)
            ref = plain(args)
            err = ((out.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            k_ms = time_ms(lambda: run(args), flush=flush)
            l_ms = time_ms(lambda: x @ w_bf16, flush=flush)
            r = dict(work(rows, n_in, n_out), rows=rows, n_in=n_in,
                     n_out=n_out, ms=k_ms, library_ms=l_ms,
                     max_err_of_max=err)
            if kernel == "w8":
                r["route"] = w8.w8_route(n_in, n_out)
            r["share_of_bound"] = r["bound_ms"] / k_ms
            r["over_library"] = k_ms / l_ms
            res[f"{rows}x{n_in}->{n_out}"] = r
            print(f"rows {rows:2d} {n_in:5d}->{n_out:<5d}: kernel "
                  f"{k_ms:.4f} ms, x @ w_bf16 {l_ms:.4f} ms "
                  f"({r['over_library']:.2f}x), bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}) -> "
                  f"{r['share_of_bound']:.1%} of bound; error against "
                  f"plain {err:.2e} of the max", flush=True)
            del args, x, w_bf16, out, ref
        torch.cuda.empty_cache()
    for c, n in zip(counters, saved):
        c.launches = n
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="w4")
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS))
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_matmul: needs a CUDA card")
    card = card_line()
    source, parse = KERNELS[a.kernel][:2]
    figs = parse(build.build([source])[source])
    for name, f in figs.items():
        print(f"ptxas {name}: {f}", flush=True)
    res = measure(a.rows, a.kernel)
    out = {"card": card, "ptxas": figs, "shapes": res}
    if 8 in a.rows:
        step = {s: res[f"8x{s[0]}->{s[1]}"] for s in PROJECTIONS}
        out["decode_step_8_rows"] = {
            "kernel_ms": decode_step_ms({s: r["ms"] for s, r in step.items()}),
            "library_ms": decode_step_ms({s: r["library_ms"]
                                          for s, r in step.items()}),
            "bound_ms": decode_step_ms({s: r["bound_ms"]
                                        for s, r in step.items()})}
        d = out["decode_step_8_rows"]
        print(f"one decode step at 8 rows ({LAYERS} layers x "
              f"{sum(PROJECTIONS.values())} {a.kernel.upper()} launches): "
              f"kernel "
              f"{d['kernel_ms']:.3f} ms, x @ w_bf16 {d['library_ms']:.3f} "
              f"ms, bound {d['bound_ms']:.3f} ms", flush=True)
    print(f"card: {card}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
