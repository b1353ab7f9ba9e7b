"""Parallelism planner: analytic memory/FLOPs/comm model + mesh search.

The port's counterpart of the JAX package's ``parallel/planner.py``, in
plain Python: for the same inputs every plan, estimate, calibration and
sweep row equals JAX's (``tests/test_torch_planner.py``). The cost model
prices a mesh of ranks (``parallel/mesh.py``):

- memory: params/grads/optimizer sharded by (tp, fsdp, pp, zero) as
  ``parallel/sharding.py`` + ``parallel/zero.py`` lay them out;
  activations priced per remat policy, the S^2 attention term divided by
  the sequence-parallel degree
- compute: 6N + attention FLOPs (``models.gpt.flops_per_token``)
- comm: per-step collective volumes priced against ``ici_bw_gbps`` (the
  card-to-card links: NVLink on an H100 host) and ``dcn_bw_gbps`` —
  dp/fsdp grad reduce-scatter+all-gather, per-layer tp all-reduces, pp
  microbatch bubble, sp ring hops
- search: factorisations of the device count over (dp, fsdp, tp, pp,
  sp, ep) x microbatch x zero stage, scored by predicted step time; plans
  that overflow device memory are kept with the reason recorded

The sequence-parallel scheme choice (ring or Ulysses, ``choose_sp_scheme``)
is what the training engine calls for ``attn_impl="auto"``; ``llmctl-torch
tune sp`` calibrates it. ``ServePlanner`` prices serving configurations
(``plan serve``), ``calibrate_serve_planner`` measures a live engine.

A calibration file is used only when its ``chip_type`` is the configured
hardware's, so a TPU's measured efficiencies never price a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..config.schema import HardwareConfig, ModelConfig, ParallelConfig
from ..models.gpt import flops_per_token

BYTES_BF16 = 2
BYTES_F32 = 4


@dataclass
class PlanEstimate:
    """Predicted per-chip resource usage for one candidate plan."""
    params_gb: float
    grads_gb: float
    optimizer_gb: float
    activations_gb: float
    total_gb: float
    step_flops: float            # global FLOPs per optimizer step
    compute_time_s: float
    dp_comm_time_s: float
    tp_comm_time_s: float
    pp_bubble_frac: float
    sp_comm_time_s: float
    step_time_s: float
    tokens_per_sec_per_chip: float
    mfu: float
    fits: bool
    reject_reason: str = ""


@dataclass
class Plan:
    parallel: ParallelConfig
    estimate: PlanEstimate
    model: str = ""
    hardware: str = ""
    seq_len: int = 2048
    global_batch_size: int = 8

    def to_dict(self) -> dict:
        return {
            "metadata": {"model": self.model, "hardware": self.hardware,
                         "seq_len": self.seq_len,
                         "global_batch_size": self.global_batch_size},
            "parallelism": dataclasses.asdict(self.parallel),
            "estimate": dataclasses.asdict(self.estimate),
        }


CALIBRATION_FILE = "tuning_results/calibration.json"


def _load_json_calibration(env_var: str, default_path: str,
                           path: str | None) -> dict | None:
    """Shared calibration persistence: None on missing/corrupt/non-object
    files (a truncated or list-shaped JSON must not crash the planner)."""
    p = Path(path or os.environ.get(env_var, default_path))
    if p.exists():
        try:
            data = json.loads(p.read_text())
        except (ValueError, OSError):
            return None
        return data if isinstance(data, dict) else None
    return None


def _save_json_calibration(data: dict, env_var: str, default_path: str,
                           path: str | None) -> str:
    p = Path(path or os.environ.get(env_var, default_path))
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(data, indent=2))
    return str(p)


def load_calibration(path: str | None = None) -> dict | None:
    """Load the measured compute-efficiency calibration written by
    `llmctl plan verify` (or None if never calibrated)."""
    return _load_json_calibration("LLMCTL_CALIBRATION", CALIBRATION_FILE,
                                  path)


def save_calibration(data: dict, path: str | None = None) -> str:
    return _save_json_calibration(data, "LLMCTL_CALIBRATION",
                                  CALIBRATION_FILE, path)


class MeshPlanner:
    """Cost model + search over mesh factorisations."""

    # fraction of peak assumed when no measured calibration exists (the
    # JAX package's default, so uncalibrated plans equal JAX's).
    # `llmctl-torch plan verify` measures the figure on the local card and
    # persists it (tuning_results/calibration.json); the planner then
    # predicts with the measured efficiency instead.
    DEFAULT_COMPUTE_EFFICIENCY = 0.6

    def __init__(self, model: ModelConfig, hw: HardwareConfig,
                 compute_efficiency: float | None = None):
        self.model = model
        self.hw = hw
        if compute_efficiency is None:
            calib = load_calibration() or {}
            # apply only a calibration measured for this chip type —
            # `plan verify` stamps chip_type at save time; a value measured
            # on other silicon (or a file without the stamp) stays unused
            if calib.get("chip_type") == hw.chip_type:
                compute_efficiency = calib.get("compute_efficiency")
            if compute_efficiency is None:
                compute_efficiency = self.DEFAULT_COMPUTE_EFFICIENCY
        self.COMPUTE_EFFICIENCY = float(compute_efficiency)

    # -- memory ---------------------------------------------------------------

    def param_bytes_per_chip(self, par: ParallelConfig) -> float:
        shard = par.tensor_parallel * par.fsdp * par.pipeline_parallel
        if par.expert_parallel > 1 and self.model.is_moe:
            # expert weights (the bulk of a MoE) also divide by ep
            e_frac = self._expert_fraction()
            dense = self.model.param_count * (1 - e_frac) / shard
            experts = self.model.param_count * e_frac / (shard * par.expert_parallel)
            return (dense + experts) * BYTES_F32
        return self.model.param_count / shard * BYTES_F32

    def _expert_fraction(self) -> float:
        m = self.model
        if not m.is_moe:
            return 0.0
        expert_params = (m.num_layers * m.moe.num_experts * 3
                         * m.hidden_size * m.ffn_size)
        return expert_params / m.param_count

    def optimizer_bytes_per_chip(self, par: ParallelConfig) -> float:
        # AdamW: two fp32 moments per param
        base = 2 * self.param_bytes_per_chip(par)
        if par.zero_stage >= 1:
            base = base / max(par.data_parallel, 1)
        return base

    def activation_bytes_per_chip(self, par: ParallelConfig, seq_len: int,
                                  micro_batch: int) -> float:
        """Activation memory for one in-flight microbatch (bf16).

        Per layer, selective remat keeps ~4 H-wide tensors resident plus the
        attention S^2 statistics when not using flash (flash/ring kernels
        never materialise S^2 — priced as S-linear).
        """
        m = self.model
        layers_resident = m.num_layers / par.pipeline_parallel
        if par.pipeline_parallel > 1:
            # 1F1B keeps up to pp microbatches of stage activations alive
            layers_resident *= min(par.num_microbatches, par.pipeline_parallel)
        s_local = seq_len / par.sequence_parallel
        b = micro_batch
        h = m.hidden_size
        per_layer = {
            "none": 14 * b * s_local * h + 2 * b * s_local * m.ffn_size,
            "selective": 6 * b * s_local * h,
            # selective + the named flash-attention output pinned resident
            # (models/gpt.py _remat_wrap): one extra [b, s, Nq*D] per layer
            "selective_attn": 6 * b * s_local * h
            + b * s_local * m.num_heads * m.head_dim,
            "full": 2 * b * s_local * h,
        }[par.activation_checkpoint]
        per_layer /= par.tensor_parallel
        if m.is_moe:
            # sort-based capacity dispatch (models/layers.py moe_block):
            # the per-layer extras are the [E, C, H] expert input+output
            # buffers (E*C = capacity_factor * K * tokens, independent of
            # how E shards over ep) plus the [E*C, F] expert hidden.
            # Residency follows the SAME remat semantics as the dense
            # entries above: "none" saves everything, selective keeps the
            # H-wide buffers but discards the FFN-width hidden, "full"
            # recomputes it all (single-layer transient peak is not
            # modeled, matching the dense policy).
            tokens = b * s_local
            ec = m.moe.capacity_factor * m.moe.experts_per_token * tokens
            moe_extra = {
                "none": 2 * ec * h + ec * m.ffn_size / par.tensor_parallel,
                "selective": 2 * ec * h,
                "selective_attn": 2 * ec * h,
                "full": 0.0,
            }[par.activation_checkpoint]
            per_layer += moe_extra
        boundary = 2 * b * s_local * h  # residual stream at block boundaries
        return (per_layer * layers_resident + boundary) * BYTES_BF16

    # -- time -----------------------------------------------------------------

    def step_flops_global(self, seq_len: int, global_batch: int) -> float:
        return flops_per_token(self.model, seq_len) * seq_len * global_batch

    def estimate(self, par: ParallelConfig, seq_len: int,
                 global_batch: int) -> PlanEstimate:
        hw = self.hw
        chips = par.total_devices
        hbm = hw.hbm_gb_per_chip * 1e9
        ici = hw.ici_bw_gbps * 1e9
        peak = hw.peak_bf16_tflops * 1e12

        p_b = self.param_bytes_per_chip(par)
        g_b = p_b  # fp32 grads sharded like params
        o_b = self.optimizer_bytes_per_chip(par)
        a_b = self.activation_bytes_per_chip(par, seq_len, par.micro_batch_size)
        total = p_b + g_b + o_b + a_b + 0.5e9  # +runtime/framework headroom

        fl = self.step_flops_global(seq_len, global_batch)
        compute = fl / (chips * peak * self.COMPUTE_EFFICIENCY)

        # data-parallel gradient sync: reduce-scatter + all-gather of the
        # fp32 grads each step over the dp*fsdp group (bandwidth-optimal
        # ring: 2*(n-1)/n * bytes / bw)
        n_dp = par.data_parallel * par.fsdp
        grad_bytes = self.model.param_count * BYTES_F32 / (
            par.tensor_parallel * par.pipeline_parallel)
        dp_t = 2 * (n_dp - 1) / max(n_dp, 1) * grad_bytes / ici if n_dp > 1 else 0.0

        # tensor-parallel: 2 all-reduces (attn out + mlp out) per layer per
        # microbatch, each 2*(tp-1)/tp * act_bytes
        tp = par.tensor_parallel
        # total microbatch passes per step: accumulation chunks x pipeline
        # microbatches per chunk (search() keeps accum * num_microbatches ==
        # global_batch / (dp*fsdp*mb), so this never double-counts)
        n_micro = max(par.gradient_accumulation_steps, 1) * max(par.num_microbatches, 1)
        act_bytes = (par.micro_batch_size * seq_len / par.sequence_parallel
                     * self.model.hidden_size * BYTES_BF16)
        tp_t = 0.0
        if tp > 1:
            per_layer = 2 * 2 * (tp - 1) / tp * act_bytes / ici
            # fwd + bwd symmetric -> x2
            tp_t = 2 * per_layer * self.model.num_layers * n_micro

        # pipeline bubble: (pp-1)/(m + pp - 1) of the step is idle
        pp = par.pipeline_parallel
        m_ = max(par.num_microbatches, 1)
        bubble = (pp - 1) / (m_ + pp - 1) if pp > 1 else 0.0

        # sequence-parallel ring: each of sp-1 hops moves local KV (2 tensors)
        sp = par.sequence_parallel
        sp_t = 0.0
        if sp > 1:
            kv_bytes = (par.micro_batch_size * seq_len / sp
                        * self.model.num_kv_heads * self.model.head_dim
                        * 2 * BYTES_BF16)
            # per layer per microbatch, overlapped with compute (price 50%)
            sp_t = 0.5 * (sp - 1) * kv_bytes / ici * self.model.num_layers * n_micro * 2

        # dp sync overlaps with the backward pass of the last microbatch at
        # best — price it serial (conservative); tp/sp partially overlap.
        step_time = (compute / max(1 - bubble, 1e-9)) + dp_t + tp_t + sp_t

        fits = total <= hbm
        reason = "" if fits else (
            f"per-chip memory {total/1e9:.1f} GB exceeds HBM {hbm/1e9:.0f} GB")
        tokens_per_chip = seq_len * global_batch / max(chips, 1) / step_time
        mfu = fl / (chips * peak) / step_time
        return PlanEstimate(
            params_gb=p_b / 1e9, grads_gb=g_b / 1e9, optimizer_gb=o_b / 1e9,
            activations_gb=a_b / 1e9, total_gb=total / 1e9,
            step_flops=fl, compute_time_s=compute, dp_comm_time_s=dp_t,
            tp_comm_time_s=tp_t, pp_bubble_frac=bubble, sp_comm_time_s=sp_t,
            step_time_s=step_time, tokens_per_sec_per_chip=tokens_per_chip,
            mfu=mfu, fits=fits, reject_reason=reason)

    # -- search ---------------------------------------------------------------

    @staticmethod
    def _pow2_divisors(n: int, cap: int = 256) -> list[int]:
        return [d for d in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                if d <= cap and n % d == 0]

    def search(self, num_chips: int, seq_len: int, global_batch: int,
               max_candidates: int = 5, zero_stages=(0, 1),
               activation_checkpoint: str = "selective",
               long_context: bool = False) -> list[Plan]:
        """Enumerate mesh factorisations, return the top plans by predicted
        step time."""
        model = self.model
        candidates: list[Plan] = []
        layers = model.num_layers
        for tp in self._pow2_divisors(num_chips, cap=8):
            if model.num_heads % tp or model.num_kv_heads % tp:
                continue
            for pp in self._pow2_divisors(num_chips // tp, cap=16):
                if layers % pp:
                    continue
                for sp in (self._pow2_divisors(num_chips // tp // pp, cap=16)
                           if long_context else [1]):
                    if (seq_len // max(sp, 1)) % 128 and sp > 1:
                        continue
                    for ep in (self._pow2_divisors(num_chips // tp // pp // sp)
                               if model.is_moe else [1]):
                        if model.is_moe and model.moe.num_experts % ep:
                            continue
                        rest = num_chips // (tp * pp * sp * ep)
                        for fsdp in self._pow2_divisors(rest):
                            dp = rest // fsdp
                            batch_shards = dp * fsdp
                            if global_batch % batch_shards:
                                continue
                            for mb in (1, 2, 4, 8):
                                per_shard = global_batch // batch_shards
                                if per_shard % mb:
                                    continue
                                total_micro = per_shard // mb
                                if pp > 1:
                                    # pipeline window: prefer 2*pp microbatches
                                    # per accumulation chunk (smaller bubble),
                                    # fall back to pp; skip if neither divides
                                    if total_micro % (2 * pp) == 0:
                                        n_micro = 2 * pp
                                    elif total_micro % pp == 0 and total_micro >= pp:
                                        n_micro = pp
                                    else:
                                        continue
                                    accum = total_micro // n_micro
                                else:
                                    n_micro, accum = 1, total_micro
                                for zero in zero_stages:
                                    par = ParallelConfig(
                                        data_parallel=dp, fsdp=fsdp,
                                        tensor_parallel=tp, pipeline_parallel=pp,
                                        sequence_parallel=sp, expert_parallel=ep,
                                        zero_stage=zero,
                                        activation_checkpoint=activation_checkpoint,
                                        micro_batch_size=mb,
                                        global_batch_size=global_batch,
                                        gradient_accumulation_steps=accum,
                                        num_microbatches=n_micro)
                                    est = self.estimate(par, seq_len, global_batch)
                                    candidates.append(Plan(
                                        parallel=par, estimate=est,
                                        model=model.name,
                                        hardware=f"{self.hw.chip_type}-{num_chips}",
                                        seq_len=seq_len,
                                        global_batch_size=global_batch))
        fitting = [c for c in candidates if c.estimate.fits]
        pool = fitting if fitting else candidates
        pool.sort(key=lambda c: c.estimate.step_time_s)
        return pool[:max_candidates]

    def best(self, num_chips: int, seq_len: int, global_batch: int,
             **kw) -> Optional[Plan]:
        plans = self.search(num_chips, seq_len, global_batch, **kw)
        return plans[0] if plans else None


def manual_plan(model: ModelConfig, hw: HardwareConfig, par: ParallelConfig,
                seq_len: int, global_batch: int) -> Plan:
    """Estimate a user-specified plan (``plan compute``'s manual mode)."""
    est = MeshPlanner(model, hw).estimate(par, seq_len, global_batch)
    return Plan(parallel=par, estimate=est, model=model.name,
                hardware=f"{hw.chip_type}-{par.total_devices}",
                seq_len=seq_len, global_batch_size=global_batch)


# ---------------------------------------------------------------------------
# Sequence-parallel scheme selection (ring vs Ulysses)
# ---------------------------------------------------------------------------

SP_CALIBRATION_FILE = "tuning_results/sp_calibration.json"


def load_sp_calibration(path: str | None = None) -> dict | None:
    """Measured per-scheme attention efficiencies written by
    ``llmctl tune sp`` — None if never calibrated."""
    return _load_json_calibration("LLMCTL_SP_CALIBRATION",
                                  SP_CALIBRATION_FILE, path)


def save_sp_calibration(data: dict, path: str | None = None) -> str:
    return _save_json_calibration(data, "LLMCTL_SP_CALIBRATION",
                                  SP_CALIBRATION_FILE, path)


def _sp_attn_flops_per_device(scheme: str, b: int, s: int, sp: int,
                              n_heads: int, head_dim: int) -> float:
    """Forward attention FLOPs on the critical path of one device.

    ring: sp lock-step ppermute rounds, each bounded by one full
    (S/sp x S/sp) unmasked block — causal block-pruning idles devices on
    dead chunks but cannot shorten the ppermute-serialised critical path,
    so the wall-clock bound is the unmasked 4*b*(S/sp)*S*n*d.

    ulysses: one device runs full-S causal flash over n/sp heads; the
    kernel's block pruning halves the visited tiles -> 2*b*S^2*(n/sp)*d.
    """
    if scheme == "ring":
        return 4.0 * b * (s / sp) * s * n_heads * head_dim
    return 2.0 * b * float(s) * s * (n_heads / sp) * head_dim


def calibrate_sp_schemes(rows: list[dict], hw: HardwareConfig, *,
                         batch: int = 1, num_heads: int = 16,
                         head_dim: int = 128, sp: int = 8) -> dict:
    """Derive per-scheme compute efficiencies from measured per-device
    attention times (the ``llmctl-torch tune sp`` probe). *rows* =
    ``[{"S": n, "ring_compute_ms_per_device": x,
    "ulysses_compute_ms_per_device": y}, ...]`` measured at the probe
    shape (batch, num_heads, head_dim, sp). Efficiency = ideal FLOPs time
    / measured time, so ``sp_scheme_costs`` extrapolates the measurement
    to any (model, S, sp) through the same FLOPs model it prices with."""
    peak = hw.peak_bf16_tflops * 1e12
    effs: dict[str, list[float]] = {"ring": [], "ulysses": []}
    for r in rows:
        s = int(r["S"])
        for scheme, key in (("ring", "ring_compute_ms_per_device"),
                            ("ulysses", "ulysses_compute_ms_per_device")):
            meas_ms = float(r.get(key, 0.0))
            if meas_ms <= 0:
                continue
            ideal_ms = _sp_attn_flops_per_device(
                scheme, batch, s, sp, num_heads, head_dim) / peak * 1e3
            eff = ideal_ms / meas_ms
            if eff > 1.02:
                # faster than the FLOPs ideal is physically impossible:
                # the timing fence returned early or the probe shape is
                # wrong. Clamping would silently persist "100% of peak"
                # and poison every future scheme choice
                raise ValueError(
                    f"{scheme} probe at S={s} measured {meas_ms:.3f} ms, "
                    f"faster than the {ideal_ms:.3f} ms FLOPs ideal at "
                    f"{hw.chip_type} peak — fence broken or probe shape "
                    "wrong; refusing to calibrate")
            effs[scheme].append(max(eff, 1e-3))
    if not effs["ring"] or not effs["ulysses"]:
        raise ValueError("need at least one measured row per scheme")
    return {
        "chip_type": hw.chip_type,
        "probe": {"batch": batch, "num_heads": num_heads,
                  "head_dim": head_dim, "sp": sp,
                  "seq_lens": [int(r["S"]) for r in rows]},
        "ring_efficiency": round(sum(effs["ring"]) / len(effs["ring"]), 4),
        "ulysses_efficiency": round(
            sum(effs["ulysses"]) / len(effs["ulysses"]), 4),
    }


# flash backward ~= 2.5x forward (score recompute + dq/dk/dv passes);
# identical multiplier for both schemes so it never flips the choice,
# but it keeps the absolute ms meaningful next to step budgets.
_SP_BWD_MULT = 2.5


def sp_scheme_costs(model: ModelConfig, sp: int, seq_len: int,
                    micro_batch: int = 1, hw: HardwareConfig | None = None,
                    calibration: dict | None = None) -> dict:
    """Price one training step's attention under each SP scheme
    (per device, all layers, fwd+bwd, compute + link comm, ms)."""
    hw = hw or HardwareConfig()
    if calibration is None:
        calibration = load_sp_calibration()
    if calibration and calibration.get("chip_type") != hw.chip_type:
        calibration = None
    cal = calibration or {}
    # uncalibrated default: both schemes assumed to sustain the same
    # fraction of peak, so the analytic FLOPs/comm model decides
    ring_eff = float(cal.get("ring_efficiency", 0.4))
    uly_eff = float(cal.get("ulysses_efficiency", 0.4))
    peak = hw.peak_bf16_tflops * 1e12
    ici = hw.ici_bw_gbps * 1e9
    b, s = micro_batch, seq_len
    n, nkv, d = model.num_heads, model.num_kv_heads, model.head_dim
    layers = model.num_layers

    ulysses_ok = (n % sp == 0) and (nkv % sp == 0)

    ring_compute = (_sp_attn_flops_per_device("ring", b, s, sp, n, d)
                    * (1 + _SP_BWD_MULT) / (peak * ring_eff))
    kv_local = 2 * b * (s / sp) * nkv * d * BYTES_BF16
    # fwd ring rotates kv; bwd ring rotates kv AND the dk/dv accumulators;
    # hops overlap with the current chunk's compute (price 50%, matching
    # MeshPlanner.estimate's sp_t)
    ring_comm = 0.5 * 3 * (sp - 1) * kv_local / ici

    if ulysses_ok:
        uly_compute = (_sp_attn_flops_per_device("ulysses", b, s, sp, n, d)
                       * (1 + _SP_BWD_MULT) / (peak * uly_eff))
        # 4 all-to-alls fwd (q/k/v scatter + out gather), mirrored in bwd;
        # each moves (sp-1)/sp of the local tensor and BLOCKS the layer
        qkvo = b * (s / sp) * (2 * n + 2 * nkv) * d * BYTES_BF16
        uly_comm = 2.0 * ((sp - 1) / sp) * qkvo / ici
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
                     hw: HardwareConfig | None = None,
                     calibration: dict | None = None) -> tuple[str, dict]:
    """The ring-vs-Ulysses selection rule: returns ('ring'|'ulysses',
    costs). Ulysses requires heads % sp == 0; otherwise
    the cheaper predicted attention time wins, using measured per-scheme
    efficiencies when ``llmctl tune sp`` has calibrated this chip."""
    costs = sp_scheme_costs(model, sp, seq_len, micro_batch, hw, calibration)
    scheme = ("ulysses" if costs["ulysses_feasible"]
              and costs["ulysses_ms"] < costs["ring_ms"] else "ring")
    return scheme, costs


# ---------------------------------------------------------------------------
# Serving planner
# ---------------------------------------------------------------------------

@dataclass
class ServePlan:
    """Predicted serving budget/latency for one configuration (the serve
    counterpart of PlanEstimate: serving has interacting tp /
    weight-quant / KV-quant / batch knobs)."""
    weight_gb: float
    kv_pool_gb: float
    kv_pages: int
    page_tokens: int
    max_resident_at_ctx: int        # concurrent requests at context_len
    prefill_ms: float               # one prompt, FLOPs-bound estimate
    decode_ms_per_step: float       # whole batch, HBM-bound estimate
    decode_tok_s: float             # batch tokens/sec at full residency
    ttft_ms: float                  # queue-empty: prefill only
    fits: bool
    reject_reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


SERVE_CALIBRATION_FILE = "tuning_results/serve_calibration.json"


def load_serve_calibration(path: str | None = None) -> dict | None:
    """Measured (decode_efficiency, mfu_prefill) written by
    ``llmctl plan serve --calibrate`` — None if never calibrated."""
    return _load_json_calibration("LLMCTL_SERVE_CALIBRATION",
                                  SERVE_CALIBRATION_FILE, path)


def save_serve_calibration(data: dict, path: str | None = None) -> str:
    return _save_json_calibration(data, "LLMCTL_SERVE_CALIBRATION",
                                  SERVE_CALIBRATION_FILE, path)


def calibrate_serve_planner(model: ModelConfig, hw: HardwareConfig,
                            engine) -> dict:
    """Derive the ServePlanner efficiencies from a LIVE engine's measured
    device times (engine.measure_device_times):

    - decode_efficiency = analytic step bytes / (measured step time x
      peak HBM bandwidth) — what fraction of peak the decode pass
      sustains end-to-end;
    - mfu_prefill = prefill FLOPs / (measured prefill time x peak bf16
      rate).

    The serve counterpart of `plan verify`'s train-side calibration loop:
    predictions inherit measured hardware behaviour instead of guessed
    constants. A tensor-parallel engine's times are one rank's, so the
    bytes and FLOPs are divided by its ``tensor_parallel``."""
    sp = ServePlanner(model, hw)
    serve_cfg = engine.serve_cfg
    bucket = engine._bucket(min(512, serve_cfg.max_seq_len))
    # measure_device_times compiles+warms the bucket program itself
    cal = engine.measure_device_times(buckets=[bucket])
    prefill_ms = cal["prefill_ms"][bucket]
    decode_ms = cal["decode_ms_per_token"]

    wb = sp.weight_bytes(serve_cfg.quantization) \
        / max(serve_cfg.tensor_parallel, 1)
    flops = 2.0 * model.param_count * bucket \
        / max(serve_cfg.tensor_parallel, 1)
    mfu_prefill = flops / (hw.peak_bf16_tflops * 1e12) / (prefill_ms / 1e3)
    # decode probes run over empty slots: the traffic is the weight pass
    decode_eff = (wb / (hw.hbm_bw_gbps * 1e9)) / (decode_ms / 1e3)
    out = {
        "chip_type": hw.chip_type,
        "model": model.name,
        # the configuration the efficiencies were MEASURED under — a
        # mismatch (e.g. int8-calibrated efficiencies pricing bf16 rows)
        # is diagnosable from the file instead of silently skewing sweeps
        "measured_with": {
            "quantization": serve_cfg.quantization,
            "kv_quantization": serve_cfg.kv_quantization,
            "tensor_parallel": serve_cfg.tensor_parallel,
        },
        "prefill_bucket": bucket,
        "prefill_ms": round(prefill_ms, 3),
        "decode_ms_per_token": round(decode_ms, 4),
        "mfu_prefill": round(min(max(mfu_prefill, 1e-4), 1.0), 4),
        "decode_efficiency": round(min(max(decode_eff, 1e-4), 1.0), 4),
    }
    return out


class ServePlanner:
    """Analytic serving model, deliberately simple and HBM-centric:

    - decode is HBM-bandwidth-bound: step time = (weight bytes + KV bytes
      read for the resident batch) / membw / efficiency. Weight-only
      quantization divides the weight term; int8 KV halves the KV term
      but multiplies the step by a scatter/dequant overhead (1.18-1.63x
      by per-device kv heads; see estimate()).
    - prefill is compute-bound: 2*P*prompt_tokens FLOPs at
      ``mfu_prefill`` (default 0.5: prefill is the training step's
      matmul mix).

    The default efficiencies and the KV overhead's two anchors are the
    JAX package's, measured on a TPU; they are kept so that an
    uncalibrated plan equals JAX's, and ``plan serve --calibrate``
    replaces the efficiencies with the card's.
    - KV pool = HBM - weights - workspace; page bytes follow
      serve/kv_cache.py exactly (incl. int8 scale overhead).

    Calibratable: pass measured (decode_efficiency, mfu_prefill), or
    let ``plan serve --calibrate`` save them, to replace the defaults.
    """

    def __init__(self, model: ModelConfig, hw: HardwareConfig,
                 decode_efficiency: float | None = None,
                 mfu_prefill: float | None = None,
                 workspace_gb: float = 1.0,
                 calibration: dict | None = None):
        self.model = model
        self.hw = hw
        # measured calibration (plan serve --calibrate) beats the
        # defaults; explicit arguments beat both. A calibration from a
        # DIFFERENT chip type is ignored (same rule as the train planner).
        if calibration is None:
            calibration = load_serve_calibration()
        if calibration and calibration.get("chip_type") != hw.chip_type:
            calibration = None
        self.calibration = calibration
        self.decode_efficiency = (
            decode_efficiency if decode_efficiency is not None
            else (calibration or {}).get("decode_efficiency", 0.6))
        self.mfu_prefill = (
            mfu_prefill if mfu_prefill is not None
            else (calibration or {}).get("mfu_prefill", 0.5))
        self.workspace_gb = workspace_gb

    # -- components ---------------------------------------------------------

    def weight_bytes(self, quant: str = "none") -> float:
        m = self.model
        total = m.param_count
        embed = m.vocab_size * m.hidden_size
        head = 0 if m.tie_word_embeddings else embed
        block = total - embed - head - m.hidden_size
        per = {"none": BYTES_BF16,
               "int8": 1.0 + 4.0 / max(m.hidden_size, 1),
               "int4": 0.5 + 4.0 / 128 + 4.0 / max(m.hidden_size, 1),
               "int4-awq": 0.5 + 4.0 / 128 + 4.0 / max(m.hidden_size, 1),
               }[quant]
        # embeddings/lm_head always bf16 (engine policy)
        return (embed + head + m.hidden_size) * BYTES_BF16 + block * per

    def page_bytes(self, page_size: int, kv_quant: str = "none") -> float:
        m = self.model
        if kv_quant == "int8":
            return 2 * m.num_layers * page_size * m.num_kv_heads \
                * (m.head_dim + 4)
        if kv_quant == "int4":
            # two page slots per byte + the same fp32 per-row scale
            # (Int4Pages): the Mooncake capacity lever — ~2x int8's
            # slots per HBM byte at D=128
            return 2 * m.num_layers * page_size * m.num_kv_heads \
                * (m.head_dim / 2 + 4)
        return 2 * m.num_layers * page_size * m.num_kv_heads \
            * m.head_dim * BYTES_BF16

    # -- the estimate -------------------------------------------------------

    def estimate(self, *, batch: int = 8, context_len: int = 1024,
                 prompt_len: int = 512, page_size: int = 64,
                 quant: str = "none", kv_quant: str = "none",
                 tensor_parallel: int = 1) -> ServePlan:
        hw, m = self.hw, self.model
        tp = max(tensor_parallel, 1)
        wb = self.weight_bytes(quant) / tp
        hbm = hw.hbm_gb_per_chip * 1e9
        pool = hbm - wb - self.workspace_gb * 1e9
        pb = self.page_bytes(page_size, kv_quant) / tp
        pages = max(int(pool // pb), 0)
        fits = pages > 0
        reason = "" if fits else (
            f"weights ({wb/1e9:.1f} GB) + workspace exceed HBM "
            f"({hw.hbm_gb_per_chip} GB)")
        per_req_pages = -(-context_len // page_size)
        max_resident = pages // max(per_req_pages, 1) if fits else 0
        if fits and max_resident < batch:
            fits = False
            reason = (f"KV pool holds {max_resident} requests at ctx "
                      f"{context_len} < batch {batch}")

        # decode: one step reads all weights + the resident KV
        kv_read = batch * context_len * (pb / max(page_size, 1))
        bw = hw.hbm_bw_gbps * 1e9 * self.decode_efficiency
        decode_s = (wb + kv_read) / max(bw, 1.0)
        if kv_quant in ("int8", "int4"):
            # quantized KV pages add a per-row scatter and an in-kernel
            # dequant: a program-structure cost the byte model does not
            # see. A whole-step multiplier, linear in the per-device kv
            # heads between two anchors (1.18x at 16, 1.63x at 32, the
            # JAX package's TPU measurements), floored at 1.0; int4
            # reuses them. It exists to rank configs; a card's own
            # anchors are not measured.
            nkv_chip = m.num_kv_heads / tp
            overhead = max(1.0, 1.18 + 0.45 * (nkv_chip - 16) / 16)
            decode_s *= overhead
        # prefill: FLOPs-bound on this device's share
        flops = 2.0 * m.param_count * prompt_len / tp
        prefill_s = flops / (hw.peak_bf16_tflops * 1e12 * self.mfu_prefill)

        return ServePlan(
            weight_gb=wb / 1e9,
            kv_pool_gb=max(pool, 0.0) / 1e9,
            kv_pages=pages,
            page_tokens=page_size,
            max_resident_at_ctx=max_resident,
            prefill_ms=prefill_s * 1e3,
            decode_ms_per_step=decode_s * 1e3,
            decode_tok_s=batch / decode_s if decode_s > 0 else 0.0,
            ttft_ms=prefill_s * 1e3,
            fits=fits,
            reject_reason=reason,
        )

    def sweep(self, *, context_len: int = 1024, prompt_len: int = 512,
              page_size: int = 64, tensor_parallel: int = 1,
              quants: tuple = ("none", "int8", "int4"),
              kv_quants: tuple = ("none", "int8", "int4"),
              batches: tuple = (4, 8, 16, 32)) -> list[dict]:
        """Grid over the serving knobs; rows sorted by decode throughput
        among configs that fit (oversubscription is rejected inside
        estimate())."""
        rows = []
        for q in quants:
            for kq in kv_quants:
                for b in batches:
                    est = self.estimate(batch=b, context_len=context_len,
                                        prompt_len=prompt_len,
                                        page_size=page_size, quant=q,
                                        kv_quant=kq,
                                        tensor_parallel=tensor_parallel)
                    rows.append({"quant": q, "kv_quant": kq, "batch": b,
                                 **est.to_dict()})
        rows.sort(key=lambda r: (-r["fits"], -r["decode_tok_s"]))
        return rows
