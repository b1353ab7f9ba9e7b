"""Device time of the flash-attention kernels at the training shape.

    python -m distributed_llm_training_and_inference_system_tpu_torch.profile_flash \
        [--batch 4] [--out flash.json]

gpt-1b's training shape (B x 2048, 16/16 heads, D=128, bf16, causal). It
builds ``flash_attention.cu`` alone, prints ptxas's registers and spills of
the bf16 forward and backward kernels with each one's shared memory and
blocks an SM, checks the forward and the backward pair once against their
plain versions, and reports each kernel's time (CUDA events, L2 flushed
before every call), its bound and share of it, and SDPA's forward and
backward on the same inputs beside the forward and the pair, with the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch

from .ops import attention as fa
from .ops import attention_cuda as fac
from .ops import build
from .profiling import ptxas_entries

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_BF16 = 989e12                   # dense tensor-core bf16
REGS_PER_SM = 65536
SMEM_PER_SM = 233472                 # 228 KB; 1 KB of it reserved a block
THREADS = 128                        # the bf16 kernels' block
TILE = 64                            # rows a tile
FWD_ROWS = 128                       # q rows a forward block
HOLD_CYCLES = 2_000_000              # ~1 ms of the card's clock


def _bound(ops: int, nbytes: int) -> dict:
    t_ops, t_bytes = ops / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def fwd_work(B: int, S: int, Nq: int, Nkv: int, D: int,
             item: int = 2) -> dict:
    """Operations and bytes of the forward kernel over a causal B x S
    attention, and its bound: 2 D flops a live (q, key) pair for each of
    q.k and p.v; q, k, v, segments and positions read once, out and lse
    written once."""
    pairs = B * Nq * S * (S + 1) // 2
    q_b = B * S * Nq * D * item
    kv_b = B * S * Nkv * D * item
    rows = 4 * 2 * B * (Nq + Nkv) * S     # segments and positions, int32
    return _bound(4 * D * pairs, q_b + 2 * kv_b + q_b + 4 * B * Nq * S + rows)


def bwd_work(B: int, S: int, Nq: int, Nkv: int, D: int,
             item: int = 2) -> dict:
    """Operations and bytes of the two backward kernels over a causal
    B x S attention (every row attends row + 1 keys), and each one's bound:
    the larger of ops over the bf16 peak and bytes over the memory rate.
    A live (q, key) pair costs 2 D flops a product: dq takes three (s, dp,
    ds.k), dk/dv four (s, dp, p^T.dO, ds^T.q). Bytes: each input read once,
    each output written once."""
    pairs = B * Nq * S * (S + 1) // 2
    q_b = B * S * Nq * D * item
    kv_b = B * S * Nkv * D * item
    rows = 4 * 2 * B * (Nq + Nkv) * S     # segments and positions, int32
    lse_b = 4 * B * Nq * S
    work = {"flash_bwd_dq": (6 * D * pairs,
                             q_b + 2 * kv_b + 2 * q_b + 2 * lse_b + rows),
            "flash_bwd_dkv": (8 * D * pairs,
                              2 * q_b + 2 * kv_b + 2 * kv_b + 2 * lse_b
                              + rows)}
    return {name: _bound(ops, nbytes) for name, (ops, nbytes) in work.items()}


def ptxas_figures(log: str, marker: str = "_bf16_kernel") -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} of the entry
    functions whose mangled name holds ``marker`` in nvcc -Xptxas -v
    output; the kernel is named by its demangled stem and head dim (nvcc
    names the anonymous namespace after the file, so the stem is the
    kernel's own name, which template arguments follow)."""
    out = {}
    for name, figs in ptxas_entries(log).items():
        if marker not in name:
            continue
        stem = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)\w*?_kernel)I",
                         name).group(1)
        dim = re.search(r"ILi(\d+)E", name)
        out[f"{stem}<{dim.group(1) if dim else '?'}>"] = figs
    return out


def bwd_smem_bytes(D: int, ints: int, streamed_rows: int) -> int:
    """Dynamic shared memory of a bf16 backward block (the launcher's
    ``bwd_bf16_smem``): 6 tiles of 64 x (D + 8) bf16, two stages of
    ``ints`` 4-byte arrays of 64, one class byte a streamed tile."""
    nt = -(-streamed_rows // TILE)
    return 6 * TILE * (D + 8) * 2 + 2 * ints * TILE * 4 + -(-nt // 16) * 16


def fwd_smem_bytes(D: int, kv_rows: int) -> int:
    """Dynamic shared memory of a bf16 forward block (the launcher's
    ``fwd_bf16_smem``): the Q tile of FWD_ROWS x (D + 8) bf16, two stages
    of K and V tiles of 64 x (D + 8) and of kpos/kseg, the block's q
    positions and segments, one class byte a kv tile."""
    nt = -(-kv_rows // TILE)
    return ((FWD_ROWS + 4 * TILE) * (D + 8) * 2
            + (4 * TILE + 2 * FWD_ROWS) * 4 + -(-nt // 16) * 16)


def resident_blocks(registers: int, smem: int) -> int:
    """Blocks of 128 threads an SM holds: registers are given out per
    warp in units of 256, shared memory per block plus 1 KB reserved."""
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = REGS_PER_SM // (per_warp * THREADS // 32)
    by_smem = SMEM_PER_SM // (smem + 1024)
    return min(by_regs, by_smem, 2048 // THREADS)


def _with_smem(figs: dict, prefix: str, smem) -> dict:
    """The entries of ``figs`` named ``prefix``..., each with its block's
    shared memory ``smem(name, D)`` and the blocks an SM holds."""
    out = {}
    for name, f in figs.items():
        if not name.startswith(prefix):
            continue
        D = int(name.rsplit("<", 1)[1].rstrip(">"))
        f = dict(f, smem_bytes=smem(name, D))
        f["resident_blocks"] = resident_blocks(f.get("registers", 255),
                                               f["smem_bytes"])
        out[name] = f
    return out


def bwd_ptxas(log: str, S: int = 2048) -> dict:
    """ptxas figures of the bf16 backward kernels in ``log``, each with its
    block's shared memory when S rows are streamed and the blocks an SM
    holds."""
    return _with_smem(ptxas_figures(log), "flash_bwd", lambda name, D:
                      bwd_smem_bytes(D, 2 if "_dq_" in name else 4, S))


def fwd_ptxas(log: str, S: int = 2048) -> dict:
    """The same for the bf16 forward kernel over S keys."""
    return _with_smem(ptxas_figures(log), "flash_fwd",
                      lambda name, D: fwd_smem_bytes(D, S))


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5, flush=None) -> float:
    """Mean device time of ``fn`` from CUDA events around each call, the
    L2 cache overwritten before every call when ``flush`` is given. The card
    spins ~1 ms before each start event, so the host has queued the whole
    call by then and a slow host (autograd's engine) is not timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(HOLD_CYCLES)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def measure(B: int = 4, S: int = 2048, N: int = 16, D: int = 128) -> dict:
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(B, S, N, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    segs = torch.ones(B, S, dtype=torch.int32, device="cuda")
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    qf, kf, vf, sq, pq, sk, pk, _ = fa.fold_gqa(q, k, v, segs, pos)
    dof = fa.fold_gqa(do, k, v, segs, pos)[0]
    scale = 1.0 / D ** 0.5
    fwd_args = (qf, kf, vf, sq, sk, pq, pk, True, scale)
    out, lse = fac.flash_fwd(*fwd_args)
    ref_out, ref_lse = fa._fwd_plain(*fwd_args)
    err = {"out": ((out.float() - ref_out.float()).abs().max()
                   / ref_out.float().abs().max()).item(),
           "lse": (lse - ref_lse).abs().max().item()}
    del ref_out, ref_lse
    delta = (dof.float() * out.float()).sum(-1, keepdim=True)
    args = (qf, kf, vf, sq, sk, pq, pk, dof, lse, delta, True, scale)
    got = (fac.flash_bwd_dq(*args), *fac.flash_bwd_dkv(*args))
    ref = (fa._bwd_dq_plain(*args), *fa._bwd_dkv_plain(*args))
    err.update({n: ((a.float() - b.float()).abs().max()
                    / b.float().abs().max()).item()
                for n, a, b in zip(("dq", "dk", "dv"), got, ref)})
    del ref
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()
    t = {"flash_fwd": time_ms(lambda: fac.flash_fwd(*fwd_args), flush=flush),
         "flash_bwd_dq": time_ms(lambda: fac.flash_bwd_dq(*args),
                                 flush=flush),
         "flash_bwd_dkv": time_ms(lambda: fac.flash_bwd_dkv(*args),
                                  flush=flush)}
    ql, kl, vl, dol = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = time_ms(lambda: sdpa(ql, kl, vl, is_causal=True), flush=flush)
    qr, kr, vr = (x.requires_grad_(True) for x in (ql, kl, vl))
    lib_out = sdpa(qr, kr, vr, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), dol, retain_graph=True), flush=flush)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fl_out = sdpa(qr, kr, vr, is_causal=True)
    sdpa_flash = time_ms(lambda: torch.autograd.grad(
        fl_out, (qr, kr, vr), dol, retain_graph=True), flush=flush)
    res = {"shape": {"B": B, "S": S, "Nq": N, "Nkv": N, "D": D,
                     "dtype": "bfloat16", "causal": True},
           "max_err_vs_plain": err, "sdpa_forward_ms": sdpa_fwd,
           "sdpa_backward_ms": sdpa_bwd,
           "sdpa_flash_backend_backward_ms": sdpa_flash}
    work = dict(bwd_work(B, S, N, N, D), flash_fwd=fwd_work(B, S, N, N, D))
    for name, w in work.items():
        res[name] = dict(w, ms=t[name], share_of_bound=w["bound_ms"] / t[name])
    res["fwd_over_sdpa_forward"] = t["flash_fwd"] / sdpa_fwd
    pair = t["flash_bwd_dq"] + t["flash_bwd_dkv"]
    res["pair_ms"] = pair
    res["pair_over_sdpa_backward"] = pair / sdpa_bwd
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flash: needs a CUDA card")
    card = card_line()
    log = build.build(["flash_attention"])["flash_attention"]
    figs = {**fwd_ptxas(log), **bwd_ptxas(log)}
    for name, f in figs.items():
        print(f"ptxas {name}: {f}", flush=True)
    res = measure(B=a.batch)
    res.update(card=card, ptxas=figs)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        r = res[name]
        print(f"{name}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) -> {r['share_of_bound']:.1%} of bound, "
              f"{r['ops'] / r['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    print(f"forward {res['flash_fwd']['ms']:.4f} ms, SDPA forward "
          f"{res['sdpa_forward_ms']:.4f} ms -> "
          f"{res['fwd_over_sdpa_forward']:.2f}x", flush=True)
    print(f"pair {res['pair_ms']:.4f} ms, SDPA backward "
          f"{res['sdpa_backward_ms']:.4f} ms -> "
          f"{res['pair_over_sdpa_backward']:.2f}x (flash backend forced: "
          f"{res['sdpa_flash_backend_backward_ms']:.4f} ms)", flush=True)
    print(f"error against plain: out/dq/dk/dv of the max, lse absolute: "
          f"{res['max_err_vs_plain']}", flush=True)
    print(f"card: {card}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
