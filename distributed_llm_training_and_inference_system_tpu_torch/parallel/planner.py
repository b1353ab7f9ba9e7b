"""Sequence-parallel scheme selection: ring or Ulysses attention.

The sp-scheme part of the JAX package's ``parallel/planner.py``
(``_sp_attn_flops_per_device``, ``sp_scheme_costs``, ``choose_sp_scheme``,
``load_sp_calibration``), which the training engine calls for
``attn_impl="auto"`` with sequence_parallel > 1. The prices are the JAX
package's analytic FLOPs and comm model taken against the port's
``HardwareConfig`` (an H100 by default: its bf16 peak, NVLink for the
inter-card links). A calibration file is used only when its ``chip_type``
is the configured card's, so a TPU's measured efficiencies never price a
GPU. ``MeshPlanner``, ``ServePlanner`` and the rest of that module wait
for ROADMAP queue 1 item 7b.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

from ..config.schema import HardwareConfig, ModelConfig

BYTES_BF16 = 2

SP_CALIBRATION_FILE = "tuning_results/sp_calibration.json"

# flash backward ~= 2.5x forward (score recompute + dq/dk/dv passes);
# identical for both schemes so it never flips the choice
_SP_BWD_MULT = 2.5


def load_sp_calibration(path: Optional[str] = None) -> Optional[dict]:
    """Measured per-scheme attention efficiencies (``$LLMCTL_SP_CALIBRATION``
    or ``tuning_results/sp_calibration.json``); None when missing, corrupt
    or not a JSON object."""
    p = Path(path or os.environ.get("LLMCTL_SP_CALIBRATION",
                                    SP_CALIBRATION_FILE))
    if not p.exists():
        return None
    try:
        data = json.loads(p.read_text())
    except (ValueError, OSError):
        return None
    return data if isinstance(data, dict) else None


def _sp_attn_flops_per_device(scheme: str, b: int, s: int, sp: int,
                              n_heads: int, head_dim: int) -> float:
    """Forward attention FLOPs on the critical path of one device.

    ring: sp lock-step hops, each bounded by one full (S/sp x S/sp)
    unmasked block (causal pruning idles a rank on dead chunks but cannot
    shorten the hop-serialised path): 4*b*(S/sp)*S*n*d.

    ulysses: one device runs full-S causal flash over n/sp heads; the
    kernel's block pruning halves the visited tiles: 2*b*S^2*(n/sp)*d.
    """
    if scheme == "ring":
        return 4.0 * b * (s / sp) * s * n_heads * head_dim
    return 2.0 * b * float(s) * s * (n_heads / sp) * head_dim


def sp_scheme_costs(model: ModelConfig, sp: int, seq_len: int,
                    micro_batch: int = 1,
                    hw: Optional[HardwareConfig] = None,
                    calibration: Optional[dict] = None) -> dict:
    """Price one training step's attention under each SP scheme (per
    device, all layers, fwd+bwd, compute + link comm, ms)."""
    hw = hw or HardwareConfig()
    if calibration is None:
        calibration = load_sp_calibration()
    if calibration and calibration.get("chip_type") != hw.chip_type:
        calibration = None
    cal = calibration or {}
    # uncalibrated: both schemes assumed to sustain the same fraction of
    # peak, so the analytic FLOPs/comm model decides
    ring_eff = float(cal.get("ring_efficiency", 0.4))
    uly_eff = float(cal.get("ulysses_efficiency", 0.4))
    peak = hw.peak_bf16_tflops * 1e12
    link = hw.ici_bw_gbps * 1e9
    b, s = micro_batch, seq_len
    n, nkv, d = model.num_heads, model.num_kv_heads, model.head_dim
    layers = model.num_layers

    ulysses_ok = (n % sp == 0) and (nkv % sp == 0)

    ring_compute = (_sp_attn_flops_per_device("ring", b, s, sp, n, d)
                    * (1 + _SP_BWD_MULT) / (peak * ring_eff))
    kv_local = 2 * b * (s / sp) * nkv * d * BYTES_BF16
    # the forward ring rotates kv, the backward kv and the dk/dv
    # accumulators; hops overlap the current chunk's compute (priced 50%)
    ring_comm = 0.5 * 3 * (sp - 1) * kv_local / link

    if ulysses_ok:
        uly_compute = (_sp_attn_flops_per_device("ulysses", b, s, sp, n, d)
                       * (1 + _SP_BWD_MULT) / (peak * uly_eff))
        # 4 all-to-alls forward (q/k/v scatter + out gather), mirrored in
        # the backward; each moves (sp-1)/sp of the local tensor and blocks
        qkvo = b * (s / sp) * (2 * n + 2 * nkv) * d * BYTES_BF16
        uly_comm = 2.0 * ((sp - 1) / sp) * qkvo / link
        uly_ms = (uly_compute + uly_comm) * layers * 1e3
    else:
        uly_comm = 0.0
        uly_ms = float("inf")

    return {
        "sp": sp, "seq_len": s,
        "ulysses_feasible": ulysses_ok,
        "ring_ms": (ring_compute + ring_comm) * layers * 1e3,
        "ulysses_ms": uly_ms,
        "ring_comm_ms": ring_comm * layers * 1e3,
        "ulysses_comm_ms": uly_comm * layers * 1e3,
        "calibrated": bool(cal),
    }


def choose_sp_scheme(model: ModelConfig, sp: int, seq_len: int,
                     micro_batch: int = 1,
                     hw: Optional[HardwareConfig] = None,
                     calibration: Optional[dict] = None) -> tuple[str, dict]:
    """('ring'|'ulysses', costs): Ulysses needs heads % sp == 0; otherwise
    the cheaper predicted attention time wins."""
    costs = sp_scheme_costs(model, sp, seq_len, micro_batch, hw, calibration)
    scheme = ("ulysses" if costs["ulysses_feasible"]
              and costs["ulysses_ms"] < costs["ring_ms"] else "ring")
    return scheme, costs
