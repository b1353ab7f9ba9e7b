"""Device time of the paged-attention kernel across context lengths.

    python -m distributed_llm_training_and_inference_system_tpu_torch.profile_kernel \
        [--sets ragged ...] [--out kernel.json]

llama-8b-gqa decode geometry (B=8 slots, T=1, 32 q heads over 8 kv heads,
D=128, pages of 64, a 32-page table as serving's max_seq_len of 2048
gives, bf16 q). It builds ``paged_attention.cu`` alone and prints ptxas's
registers and spill bytes for each template. Then, for each set of slot
lengths and each page kind (fp, int8, int4), it reports the kernel's time
(CUDA events, L2 flushed before every call), its device time from
``torch.profiler`` (back to back, L2 warm), the bound (the bytes the
call must move over 3.35 TB/s), the kernel's share of it, the live
blocks and splits of the split plan, the error against the plain version,
and for fp pages the time of SDPA (``enable_gqa``) over the pre-gathered
cache and the kernel's ratio to it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_BF16 = 989e12                   # dense tensor-core bf16
B, NQ, NKV, D, PS, MAXP = 8, 32, 8, 128, 64, 32
LENGTH_SETS = {
    "uniform-64": [64] * B,
    "uniform-512": [512] * B,
    "uniform-2048": [2048] * B,
    "ragged": [2048, 1, 64, 65, 777, 1500, 130, 2000],   # chip_smoke phase 4
    "one-long": [2048] + [64] * (B - 1),
}
KINDS = ("fp", "int8", "int4")


def row_bytes(kind: str, d: int = D, item: int = 2) -> int:
    """Bytes of one stored K or V row of one kv head: fp pages in q's
    dtype; int8 one byte a value, int4 half a byte, both with a 4-byte
    fp32 scale."""
    return {"fp": d * item, "int8": d + 4, "int4": d // 2 + 4}[kind]


def paged_work(lengths, kind: str = "fp", T: int = 1, nq: int = NQ,
               nkv: int = NKV, d: int = D, maxp: int = MAXP,
               item: int = 2) -> dict:
    """Bytes and operations of one decode call and its bound: each live K
    and V row read once, q read and the output written once, the table
    and starts; 2 flops a product for q.k and p.v over the keys each
    query sees. ``lengths`` are the slots' live keys (start + T)."""
    live = sum(lengths)
    nbytes = (2 * len(lengths) * T * nq * d * item
              + 2 * live * nkv * row_bytes(kind, d, item)
              + len(lengths) * maxp * 4 + len(lengths) * 4)
    ops = 4 * nq * d * sum(n - T + j + 1 for n in lengths for j in range(T))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_BF16 * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def split_report(lengths, T: int = 1, nq: int = NQ, nkv: int = NKV,
                 maxp: int = MAXP, ps: int = PS, sms: int = 132) -> dict:
    """The split plan of a call and what this run's lengths make of it:
    splits a row tile, live splits over all row tiles and slots, and live
    blocks (live splits times kv heads) against the grid."""
    from .ops.paged_attention_cuda import split_plan, split_ranges
    plan = split_plan(len(lengths), T, nq, nkv, maxp, ps, sms)
    live = sum(len(r) for n in lengths
               for r in split_ranges(plan, n - T, T, nq // nkv, maxp, ps))
    gx, gy, gz = plan["grid"]
    return {"keys_per_split": plan["keys_per_split"],
            "n_splits": plan["n_splits"], "live_splits": live,
            "live_blocks": live * nkv, "grid_blocks": gx * gy * gz}


_PAGED = re.compile(r"(paged_attention_(?:tc_)?kernel)ILi(\d)ELi(\d+)EE")
_KIND_NAMES = {"0": "fp", "1": "int8", "2": "int4"}


def paged_ptxas(log: str) -> dict:
    """{name: {registers, spill_stores, spill_loads}} from nvcc -Xptxas -v
    output, for the bf16 body "paged_attention_tc_kernel<kind, NT=k-steps>"
    and the fp32 body "paged_attention_kernel<kind, CW=columns a lane>"."""
    from .profiling import ptxas_entries
    out = {}
    for name, figs in ptxas_entries(log).items():
        k = _PAGED.search(name)
        if k:
            what = "NT" if "_tc_" in k.group(1) else "CW"
            out[f"{k.group(1)}<{_KIND_NAMES[k.group(2)]}, "
                f"{what}={k.group(3)}>"] = figs
    return out


def case(lengths, kind: str = "fp", seed: int = 0):
    """bf16 q, pages of ``kind`` scattered over the pool in random order,
    the table and the starts of a decode step (T = 1)."""
    from .ops import paged_attention as pa
    from .ops import quantization as tq
    NP = B * MAXP + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    perm = (torch.randperm(NP - 1, generator=g, device="cuda") + 1).tolist()
    tables = torch.zeros(B, MAXP, dtype=torch.int32)
    for b, n in enumerate(lengths):
        used = -(-n // PS)
        tables[b, :used] = torch.tensor(perm[b * MAXP:b * MAXP + used])
    q = torch.randn(B, 1, NQ, D, generator=g, device="cuda")
    kp = torch.randn(NP, NKV, PS, D, generator=g, device="cuda")
    vp = torch.randn(NP, NKV, PS, D, generator=g, device="cuda")
    if kind == "fp":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    elif kind == "int8":
        kp, vp = (pa.QuantPages(*tq.quantize_int8_rows(p)) for p in (kp, vp))
    else:
        kp, vp = (pa.Int4Pages(tq.pack_int4_rows(v, axis=-2), s)
                  for v, s in (tq.quantize_int4_rows(p) for p in (kp, vp)))
    starts = torch.tensor([n - 1 for n in lengths], dtype=torch.int32,
                          device="cuda")
    return q.to(torch.bfloat16), kp, vp, tables.cuda(), starts


def measure(lengths, kind: str, flush) -> dict:
    from torch.profiler import ProfilerActivity, profile

    import torch.nn.functional as F

    from .ops import paged_attention as pa
    from .profile_flash import time_ms
    q, kp, vp, tables, starts = case(lengths, kind)

    def run():
        return pa.paged_attention_multi(q, kp, vp, tables, starts)
    ms = time_ms(run, flush=flush)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            run()
        torch.cuda.synchronize()
    dev_ms = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
                 for ev in prof.key_averages()
                 if "paged_attention" in ev.key) / 1e3 / 20
    ref = pa.paged_attention_multi(q, kp, vp, tables, starts, impl="gather")
    err = (run().float() - ref.float()).abs().max().item()
    r = dict(paged_work(lengths, kind), **split_report(lengths), kind=kind,
             lengths=lengths, ms=ms, device_ms=dev_ms, max_abs_err=err)
    r["share_of_bound"] = r["bound_ms"] / ms
    if kind == "fp":
        kg = pa._gather_pages(kp, tables)              # [B, Nkv, L, D]
        vg = pa._gather_pages(vp, tables)
        L = kg.shape[2]
        mask = (torch.arange(L, device="cuda")[None, :]
                < (starts.long() + 1)[:, None])[:, None, None, :]
        ql = q[:, 0, :, None, :]
        r["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            ql, kg, vg, attn_mask=mask, enable_gqa=True), flush=flush)
        r["over_sdpa"] = ms / r["sdpa_ms"]
    return r


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", nargs="+", choices=list(LENGTH_SETS),
                    default=list(LENGTH_SETS))
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernel: needs a CUDA card")
    from .ops import build
    from .ops.paged_attention_cuda import (
        paged_attention_int4_kernel, paged_attention_int8_kernel,
        paged_attention_kernel)
    from .profile_flash import card_line
    card = card_line()
    figs = paged_ptxas(build.build(["paged_attention"])["paged_attention"])
    for name, f in figs.items():
        print(f"ptxas {name}: {f}", flush=True)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    counters = (paged_attention_kernel, paged_attention_int8_kernel,
                paged_attention_int4_kernel)
    saved = [c.launches for c in counters]
    res = {"card": card, "ptxas": figs, "sets": {}}
    for name in a.sets:
        lengths = LENGTH_SETS[name]
        for kind in KINDS:
            r = measure(lengths, kind, flush_buf.zero_)
            res["sets"][f"{name}/{kind}"] = r
            lib = (f", SDPA {r['sdpa_ms']:.4f} ms ({r['over_sdpa']:.2f}x)"
                   if kind == "fp" else "")
            print(f"{name:13s} {kind:4s} kernel {r['ms']:.4f} ms (warm "
                  f"{r['device_ms']:.4f}){lib}, bound "
                  f"{r['bound_ms']:.4f} ms -> {r['share_of_bound']:.1%}; "
                  f"{r['n_splits']} splits of {r['keys_per_split']} keys, "
                  f"{r['live_blocks']} of {r['grid_blocks']} blocks live; "
                  f"err {r['max_abs_err']:.2e}", flush=True)
        torch.cuda.empty_cache()
    for c, n in zip(counters, saved):
        c.launches = n
    print(f"card: {card}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
