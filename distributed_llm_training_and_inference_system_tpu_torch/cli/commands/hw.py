"""`llmctl-torch hw` — hardware probe and microbenchmark (the JAX
package's ``hw probe`` / ``hw benchmark``).

``probe`` reads the cards from ``torch.cuda.get_device_properties`` and
``nvidia-smi --query-gpu=name,power.limit``, the host from ``/proc``, and
prints a plain-text table; ``--emit`` writes the profile (TOML or JSON) in
the JAX command's layout, whose ``[hardware]`` section
``config.schema.HardwareConfig`` reads. ``benchmark`` times a bf16 matmul
(``torch.matmul``: a probe of the card, not a port of a kernel) and a
device-to-device copy through ``utils.timing.time_fn`` (CUDA events on
the card, the best of 3 windows of 10 calls). With ``--device cpu`` both
report the host only (``probe``) or time on the host's clock
(``benchmark``), labelled as such.
"""

from __future__ import annotations

import argparse
import json
import os
import platform as _platform
import subprocess
from pathlib import Path

import torch

from ...device import resolve_device
from ...metrics.observability import memory_info
from ...utils.timing import time_fn
from ...utils.tomlio import dump_toml

# NVIDIA's data sheet figures of one H100 SXM (dense, 700 W)
_KNOWN_CARDS = {
    "h100": ((989.0, 3350.0), ("h100",)),
}


def _cpu_info() -> dict:
    """Model, physical and logical cores and mean clock from
    /proc/cpuinfo."""
    model, mhz, cores, phys = "", [], set(), None
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if key == "model name" and not model:
                model = val
            elif key == "cpu MHz":
                mhz.append(float(val))
            elif key == "physical id":
                phys = val
            elif key == "core id":
                cores.add((phys, val))
    return {
        "model": model or _platform.processor() or _platform.machine(),
        "cores_physical": len(cores),
        "cores_logical": os.cpu_count() or 0,
        "freq_mhz": sum(mhz) / len(mhz) if mhz else 0.0,
    }


def _memory_info() -> dict:
    m = memory_info()
    return {"total_gb": m["total"] / 1e9, "available_gb": m["available"] / 1e9}


def nvidia_smi() -> list[dict]:
    """name and power limit of each card as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    out = []
    for line in res.stdout.strip().splitlines():
        name, _, power = line.rpartition(",")
        out.append({"name": name.strip(), "power_limit": power.strip(),
                    "line": line.strip()})
    return out


def _chip_info(device: torch.device) -> dict:
    """The cards: platform, count, name, memory, SMs and power limit."""
    if device.type != "cuda":
        return {"platform": "cpu", "num_chips": 0, "num_hosts": 1,
                "device_kind": "cpu", "devices": []}
    n = torch.cuda.device_count()
    smi = nvidia_smi()
    devices = []
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        devices.append({"id": i, "name": p.name,
                        "memory_gb": p.total_memory / 1e9,
                        "sm_count": p.multi_processor_count,
                        "compute_capability": f"{p.major}.{p.minor}",
                        "power_limit": smi[i]["power_limit"]
                        if i < len(smi) else ""})
    return {"platform": "gpu", "num_chips": n, "num_hosts": 1,
            "device_kind": devices[0]["name"], "devices": devices,
            "hbm_gb_per_chip": devices[0]["memory_gb"],
            "nvidia_smi": [s["line"] for s in smi]}


def _limits(chips: dict) -> dict:
    kind = chips.get("device_kind", "").lower()
    for name, ((tflops, bw), aliases) in _KNOWN_CARDS.items():
        if any(a in kind for a in aliases):
            return {"peak_bf16_tflops": tflops, "hbm_bw_gbps": bw,
                    "source": "datasheet", "chip_family": name}
    return {"peak_bf16_tflops": 0.0, "hbm_bw_gbps": 0.0,
            "source": "unknown card" if chips["platform"] == "gpu"
            else "no card (cpu)", "chip_family": kind or "cpu"}


def build_parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog,
                                 description="Hardware probing and "
                                             "benchmarking.")
    sub = ap.add_subparsers(dest="sub", metavar="{probe,benchmark}")
    pr = sub.add_parser("probe", help="Probe CPU, memory and cards; "
                                      "optionally emit a profile.")
    pr.add_argument("--emit", dest="emit_path", default=None,
                    help="Write the profile to a TOML/JSON file.")
    bm = sub.add_parser("benchmark", help="Measure achieved matmul TFLOP/s "
                                          "and copy bandwidth.")
    bm.add_argument("--matmul-size", default=4096, type=int)
    bm.add_argument("--mem-size-mb", default=256, type=int)
    return ap


def run(args) -> int:
    device = resolve_device(args.root.device)
    if args.sub in (None, "probe"):
        return probe(getattr(args, "emit_path", None), device)
    return benchmark(args.matmul_size, args.mem_size_mb, device)


def probe_profile(device: torch.device) -> dict:
    cpu, mem, chips = _cpu_info(), _memory_info(), _chip_info(device)
    limits = _limits(chips)
    return {
        "system": {"os": _platform.system(),
                   "python": _platform.python_version(),
                   "torch": torch.__version__,
                   "cuda": torch.version.cuda or ""},
        "cpu": cpu, "memory": mem, "chips": chips, "limits": limits,
        "hardware": {
            "platform": chips["platform"],
            "chip_type": chips["device_kind"],
            "num_chips": chips["num_chips"],
            "num_hosts": chips["num_hosts"],
            "hbm_gb_per_chip": chips.get("hbm_gb_per_chip", 0.0),
            "peak_bf16_tflops": limits["peak_bf16_tflops"],
            "hbm_bw_gbps": limits["hbm_bw_gbps"],
        },
    }


def probe(emit_path, device: torch.device) -> int:
    """Probe CPU, memory and cards; optionally emit a profile."""
    profile = probe_profile(device)
    chips, cpu = profile["chips"], profile["cpu"]
    rows = [("Platform", f"{chips['platform']} ({chips['device_kind']})"),
            ("Cards", f"{chips['num_chips']} on {chips['num_hosts']} host(s)"),
            ("CPU", f"{cpu['model']} ({cpu['cores_logical']} threads)"),
            ("Host memory", f"{profile['memory']['total_gb']:.1f} GB")]
    for d in chips["devices"]:
        rows.append((f"Card {d['id']}",
                     f"{d['name']}, {d['memory_gb']:.1f} GB, "
                     f"{d['sm_count']} SMs, sm_{d['compute_capability']}, "
                     f"power limit {d['power_limit']}"))
    lim = profile["limits"]
    rows.append(("Peak bf16", f"{lim['peak_bf16_tflops']:.1f} TFLOP/s a "
                              f"card ({lim['source']})"))
    width = max(len(k) for k, _ in rows)
    print("Hardware Profile")
    for k, v in rows:
        print(f"  {k:<{width}}  {v}")
    if emit_path:
        p = Path(emit_path)
        if p.suffix == ".json":
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(profile, indent=2))
        else:
            dump_toml(profile, p)
        print(f"Profile written to {p}")
    return 0


def benchmark_numbers(matmul_size: int, mem_size_mb: int,
                      device: torch.device) -> dict:
    """Achieved bf16 matmul TFLOP/s at matmul_size^3 and copy GB/s (one
    read and one write of mem_size_mb a call)."""
    n = matmul_size
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = torch.bfloat16
    a = torch.randn((n, n), generator=gen, device=device, dtype=dtype)
    b = torch.randn((n, n), generator=gen, device=device, dtype=dtype)
    c = torch.empty((n, n), device=device, dtype=dtype)
    mm_s = time_fn(lambda: torch.matmul(a, b, out=c), iters=30,
                   device=device)
    elems = mem_size_mb * 1024 * 1024 // 4
    src = torch.ones(elems, device=device, dtype=torch.float32)
    dst = torch.empty_like(src)
    cp_s = time_fn(lambda: dst.copy_(src), iters=30, device=device)
    return {"device": str(device),
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "matmul_size": n, "matmul_s": mm_s,
            "matmul_tflops": 2 * n ** 3 / mm_s / 1e12,
            "copy_mb": mem_size_mb, "copy_s": cp_s,
            "copy_gbps": 2 * elems * 4 / cp_s / 1e9}


def benchmark(matmul_size: int, mem_size_mb: int,
              device: torch.device) -> int:
    """Measure achieved matmul TFLOP/s and device copy bandwidth."""
    r = benchmark_numbers(matmul_size, mem_size_mb, device)
    where = "CUDA events" if device.type == "cuda" else "host clock"
    card = ""
    if device.type == "cuda":
        card = " [" + "; ".join(s["line"] for s in nvidia_smi()) + "]"
    print(f"device={r['device']} ({r['kind']}; {where}){card}")
    print(f"matmul {r['matmul_size']}x{r['matmul_size']}x{r['matmul_size']} "
          f"bf16: {r['matmul_tflops']:.2f} TFLOP/s (best of 3 windows of 10)")
    print(f"copy ({mem_size_mb} MB read + {mem_size_mb} MB written): "
          f"{r['copy_gbps']:.1f} GB/s (best of 3 windows of 10)")
    return 0
