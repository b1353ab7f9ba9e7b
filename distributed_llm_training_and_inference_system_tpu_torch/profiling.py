"""Device time by kernel from a ``torch.profiler`` window, and ptxas's
figures from a build log, for the ``profile_*`` scripts.

Each script names its own kernels (``own``: pairs of name substrings and a
category); everything else falls into matmuls, copies or other
elementwise/reduction kernels.
"""

from __future__ import annotations

import re

MATMUL = ("gemm", "cutlass", "nvjet", "sm90_xmma", "gemv")


def category(name: str, own=()) -> str:
    n = name.lower()
    for keys, label in own:
        if any(k in n for k in keys):
            return label
    if any(k in n for k in MATMUL):
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "other elementwise/reduction"


def device_breakdown(prof, steps: int, own=()):
    """(device ms per step by category, the 15 costliest kernels per step)
    of a profile (CUDA activity) that covered ``steps`` steps."""
    from torch.autograd import DeviceType
    by_kernel, by_cat = {}, {}
    for ev in prof.key_averages():
        # kernels and copies only: an aten op's device time is its
        # kernels' time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us <= 0:
            continue
        ms = dev_us / 1e3 / steps
        by_kernel[ev.key] = (ms, ev.count / steps)
        cat = category(ev.key, own)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    top = sorted(({"name": k[:90], "ms_per_step": ms, "calls_per_step": n}
                  for k, (ms, n) in by_kernel.items()),
                 key=lambda d: -d["ms_per_step"])[:15]
    return by_cat, top


def print_breakdown(by_cat: dict, top: list) -> None:
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:30s} {ms:8.3f} ms/step")
    for k in top:
        print(f"  {k['ms_per_step']:8.3f} ms  x{k['calls_per_step']:6.1f}  "
              f"{k['name']}")


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_entries(log: str) -> dict:
    """{mangled kernel name: {registers, spill_stores, spill_loads}} of
    every entry function in nvcc -Xptxas -v output, in the log's order."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out
