"""Typed configuration schemas with validation.

The serving configs (``RopeConfig``, ``MoEConfig``, ``ModelConfig``,
``ServeConfig``) and the training configs (``SchedulerConfig``,
``OptimizerConfig``, ``ParallelConfig``, ``DataConfig``,
``CheckpointConfig``, ``TrainingConfig``, ``HardwareConfig``, ``RunConfig``).
Field names, defaults and validation rules are the JAX package's (``distributed_llm_training_and_inference_system_tpu/config/
schema.py``), held equal field for field by tests/test_torch_config.py,
except ``HardwareConfig``, whose defaults describe one H100 SXM card.
The port keeps its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


class ConfigError(ValueError):
    """Raised when a config file or value fails validation."""


def _take(d: dict, *names, default=None):
    """First present key among *names* (tolerates schema synonyms)."""
    for n in names:
        if n in d and d[n] is not None:
            return d[n]
    return default


def _parse_bool(name: str, v: Any) -> bool:
    """Strict bool parsing: ``bool("false")`` is True, so string-sourced
    configs go through the usual spellings and anything else is rejected."""
    if isinstance(v, bool):
        return v
    if isinstance(v, int) and v in (0, 1):
        return bool(v)
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("true", "1", "yes", "on"):
            return True
        if s in ("false", "0", "no", "off"):
            return False
    raise ConfigError(f"{name} must be a boolean (got {v!r})")


@dataclass
class RopeConfig:
    base: float = 10000.0
    scaling: str = "none"       # none | linear | ntk
    scaling_factor: float = 1.0

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "RopeConfig":
        if not d:
            return cls()
        return cls(
            base=float(_take(d, "base", "theta", default=10000.0)),
            scaling=str(_take(d, "scaling", default="none")),
            scaling_factor=float(_take(d, "scaling_factor", "factor",
                                       default=1.0)),
        )


@dataclass
class MoEConfig:
    """Mixture-of-experts settings (``models.layers.moe_block``): E experts,
    K of them a token, ``capacity_factor`` * K * N / E slots an expert for a
    call over N tokens, and the weight of the load-balancing aux loss.
    Expert parallelism is not ported (ROADMAP queue 1 item 7)."""
    num_experts: int = 0            # 0 = dense model
    experts_per_token: int = 2
    router_aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "MoEConfig":
        if not d:
            return cls()
        return cls(
            num_experts=int(_take(d, "num_experts", "experts", default=0)),
            experts_per_token=int(_take(d, "experts_per_token", "top_k",
                                        default=2)),
            router_aux_loss_weight=float(_take(d, "router_aux_loss_weight",
                                               default=0.01)),
            capacity_factor=float(_take(d, "capacity_factor", default=1.25)),
        )


@dataclass
class ModelConfig:
    """Decoder-only transformer architecture."""
    name: str = "gpt-125m"
    arch: str = "decoder-only"
    num_layers: int = 12
    hidden_size: int = 768
    ffn_size: int = 3072
    num_heads: int = 12
    num_kv_heads: int = 12          # < num_heads => grouped-query attention
    head_dim: int = 64
    vocab_size: int = 50304
    max_position_embeddings: int = 2048
    rope: RopeConfig = field(default_factory=RopeConfig)
    activation: str = "silu"        # silu (SwiGLU) | gelu (GeGLU) | relu
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    dropout: float = 0.0
    dtype: str = "bfloat16"         # activations/weights compute dtype
    moe: MoEConfig = field(default_factory=MoEConfig)

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    def validate(self) -> None:
        if self.num_kv_heads < 1 or self.num_heads < 1 or self.head_dim < 1:
            raise ConfigError("num_heads, num_kv_heads, head_dim must be >= 1")
        if self.num_heads % self.num_kv_heads != 0:
            raise ConfigError(
                f"num_heads ({self.num_heads}) must be a multiple of "
                f"num_kv_heads ({self.num_kv_heads})")
        if self.vocab_size <= 0 or self.num_layers <= 0:
            raise ConfigError("vocab_size and num_layers must be positive")
        if self.activation not in ("silu", "gelu", "relu"):
            raise ConfigError(f"unknown activation {self.activation!r}")
        if self.arch != "decoder-only":
            raise ConfigError(
                f"unsupported arch {self.arch!r} (decoder-only only)")

    @property
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        h, f, v = self.hidden_size, self.ffn_size, self.vocab_size
        kv_dim = self.num_kv_heads * self.head_dim
        q_dim = self.num_heads * self.head_dim
        attn = h * q_dim + 2 * h * kv_dim + q_dim * h
        if self.activation in ("silu", "gelu"):    # gated: gate, up, down
            mlp_dense = 3 * h * f
        else:
            mlp_dense = 2 * h * f
        if self.is_moe:
            mlp = self.moe.num_experts * mlp_dense + h * self.moe.num_experts
        else:
            mlp = mlp_dense
        norms = 2 * h
        per_layer = attn + mlp + norms
        emb = v * h
        head = 0 if self.tie_word_embeddings else v * h
        final_norm = h
        return emb + self.num_layers * per_layer + final_norm + head

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        attn = d.get("attention", {}) or {}
        num_heads = int(_take(d, "heads", "num_heads", "num_attention_heads",
                              default=12))
        hidden = int(_take(d, "hidden", "hidden_size", "d_model",
                           default=768))
        cfg = cls(
            name=str(_take(d, "name", default="custom")),
            arch=str(_take(d, "arch", default="decoder-only")),
            num_layers=int(_take(d, "layers", "num_layers",
                                 "num_hidden_layers", default=12)),
            hidden_size=hidden,
            ffn_size=int(_take(d, "ffn", "ffn_size", "intermediate_size",
                               default=4 * hidden)),
            num_heads=num_heads,
            num_kv_heads=int(_take(d, "kv_heads", "num_kv_heads",
                                   "num_key_value_heads", default=num_heads)),
            head_dim=int(_take(d, "head_dim", default=hidden // num_heads)),
            vocab_size=int(_take(d, "vocab_size", default=50304)),
            max_position_embeddings=int(_take(
                d, "max_position_embeddings", "max_seq_len", default=2048)),
            rope=RopeConfig.from_dict(d.get("rope")),
            activation=str(_take(d, "activation", "hidden_act",
                                 default="silu")),
            norm_eps=float(_take(d, "layer_norm_eps", "norm_eps",
                                 "rms_norm_eps", default=1e-5)),
            tie_word_embeddings=_parse_bool(
                "tie_word_embeddings",
                _take(d, "tie_word_embeddings", default=False)),
            attention_bias=_parse_bool(
                "attention_bias",
                attn.get("bias", _take(d, "attention_bias", default=False))),
            dropout=float(attn.get("dropout", _take(d, "dropout",
                                                    default=0.0))),
            dtype=str(_take(d, "dtype", default="bfloat16")),
            moe=MoEConfig.from_dict(d.get("moe")),
        )
        cfg.validate()
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ServeConfig:
    """Inference server config. Every field of the JAX package's
    ServeConfig is here with its default, so a config file means the same
    thing to both packages; features the port does not carry yet are
    refused by the engine at construction (serve/engine.py)."""
    model: str = "gpt-125m"
    artifact: str = ""              # checkpoint dir
    host: str = "0.0.0.0"
    port: int = 8080
    max_batch_size: int = 8
    max_seq_len: int = 2048
    prefill_chunk: int = 512        # prefill length bucketing granularity
    # max prompt tokens admitted between two decode dispatches
    prefill_budget_tokens: int = 2048
    # chunked prefill threshold (0 = whole-prompt prefill)
    chunked_prefill_tokens: int = 0
    # decode iterations per device dispatch (one host fetch per dispatch)
    decode_steps_per_dispatch: int = 8
    # latency-adaptive short dispatch of min(this, K-1) steps (0 = off)
    latency_dispatch_steps: int = 0
    # keep one un-fetched dispatch group in flight at >= half-full batches
    pipelined_decode: bool = True
    # tokens per KV-cache page
    kv_block_size: int = 64
    kv_num_blocks: int = 0          # 0 = auto-size from the memory budget
    kv_hbm_budget_gb: float = 4.0
    max_queue: int = 256
    dtype: str = "bfloat16"
    scheduler: str = "continuous"   # continuous | static
    # CORS: "*" = any origin, comma-separated list restricts, "" disables
    cors_origins: str = "*"
    temperature: float = 1.0
    speculative: str = "off"        # off | ngram
    speculative_tokens: int = 8     # verify window T (drafts = T-1)
    speculative_ngram: int = 3      # longest n-gram tried by the proposer
    speculative_min_acceptance: float = 0.05
    # automatic prefix caching of full prompt pages
    prefix_caching: bool = True
    tensor_parallel: int = 1
    quantization: str = "none"      # none | int8 | int4 | int4-awq
    int8_pallas_matmul: bool = False
    kv_quantization: str = "none"   # none | int8 | int4
    # KV admission: ondemand (grow chains, preempt newest) | reserve
    admission: str = "ondemand"
    preemption: str = "recompute"   # recompute | swap
    swap_space_gb: float = 4.0
    stream_abort_on_disconnect: bool = True

    def validate(self) -> None:
        if self.kv_quantization not in ("none", "int8", "int4"):
            raise ConfigError("kv_quantization must be none|int8|int4")
        if self.kv_quantization == "int4" and self.kv_block_size % 2:
            raise ConfigError(
                f"kv_quantization=int4 packs two page slots per byte; "
                f"kv_block_size {self.kv_block_size} must be even")
        if self.tensor_parallel < 1:
            raise ConfigError("tensor_parallel must be >= 1")
        if self.quantization not in ("none", "int8", "int4", "int4-awq"):
            raise ConfigError("quantization must be none|int8|int4|int4-awq")
        if self.chunked_prefill_tokens < 0:
            raise ConfigError("chunked_prefill_tokens must be >= 0")
        if self.latency_dispatch_steps < 0:
            raise ConfigError("latency_dispatch_steps must be >= 0")
        if self.speculative not in ("off", "ngram"):
            raise ConfigError(
                f"speculative must be off|ngram, got {self.speculative!r}")
        if self.speculative != "off" and self.speculative_tokens < 2:
            raise ConfigError("speculative_tokens must be >= 2")
        if self.scheduler not in ("continuous", "static"):
            raise ConfigError("scheduler must be continuous|static")
        if self.admission not in ("ondemand", "reserve"):
            raise ConfigError("admission must be ondemand|reserve")
        if self.preemption not in ("recompute", "swap"):
            raise ConfigError("preemption must be recompute|swap")

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "ServeConfig":
        if not d:
            return cls()
        kw = {}
        for f_ in dataclasses.fields(cls):
            if f_.name in d:
                if isinstance(f_.default, bool):
                    # bool before the generic coercion: bool is an int
                    # subclass and type(True)("false") is True
                    kw[f_.name] = _parse_bool(f_.name, d[f_.name])
                elif f_.default is not None:
                    kw[f_.name] = type(f_.default)(d[f_.name])
                else:
                    kw[f_.name] = d[f_.name]
        cfg = cls(**kw)
        cfg.validate()
        return cfg


# ---------------------------------------------------------------------------
# Training configs
# ---------------------------------------------------------------------------

@dataclass
class SchedulerConfig:
    type: str = "cosine"            # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "SchedulerConfig":
        if not d:
            return cls()
        return cls(
            type=str(_take(d, "type", default="cosine")),
            warmup_steps=int(_take(d, "warmup_steps", "warmup", default=100)),
            total_steps=int(_take(d, "total_steps", default=10000)),
            min_lr_ratio=float(_take(d, "min_lr_ratio", default=0.1)),
        )


@dataclass
class OptimizerConfig:
    """AdamW + schedule. ``moment_dtype``/``nu_dtype`` store Adam's mu and
    nu rounded (the update still computes in fp32); ``fused`` sends every
    leaf with ndim >= 2 and >= 65536 elements through the AdamW kernel
    (exec/fused_update.py); ``accum_dtype`` is the dtype of the
    gradient-accumulation carry."""
    type: str = "adamw"
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    nu_dtype: str = "float32"
    fused: bool = True
    accum_dtype: str = "float32"
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    def validate(self) -> None:
        if self.accum_dtype not in ("float32", "bfloat16"):
            raise ConfigError("accum_dtype must be float32|bfloat16")
        if self.type not in ("adamw", "adam", "sgd", "adafactor", "lion"):
            raise ConfigError(f"unknown optimizer {self.type!r}")
        if not (0 < self.lr < 1):
            raise ConfigError(f"suspicious learning rate {self.lr}")
        if self.moment_dtype not in ("float32", "bfloat16"):
            raise ConfigError("moment_dtype must be float32|bfloat16")
        if self.nu_dtype not in ("float32", "bfloat16"):
            raise ConfigError("nu_dtype must be float32|bfloat16")
        if self.nu_dtype != "float32" and not (
                self.fused and self.type in ("adamw", "adam")):
            raise ConfigError(
                "nu_dtype=bfloat16 requires fused adamw/adam (the optax "
                "chain cannot store nu in bf16)")

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "OptimizerConfig":
        if not d:
            return cls()
        betas = _take(d, "betas", default=(0.9, 0.95))
        cfg = cls(
            type=str(_take(d, "type", default="adamw")),
            lr=float(_take(d, "lr", "learning_rate", default=3e-4)),
            betas=(float(betas[0]), float(betas[1])),
            eps=float(_take(d, "eps", default=1e-8)),
            weight_decay=float(_take(d, "weight_decay", default=0.1)),
            grad_clip=float(_take(d, "grad_clip", "gradient_clipping",
                                  default=1.0)),
            moment_dtype=str(_take(d, "moment_dtype", default="float32")),
            nu_dtype=str(_take(d, "nu_dtype", default="float32")),
            fused=_parse_bool("fused", _take(d, "fused", default=True)),
            accum_dtype=str(_take(d, "accum_dtype", default="float32")),
            scheduler=SchedulerConfig.from_dict(d.get("scheduler")),
        )
        cfg.validate()
        return cfg


@dataclass
class ParallelConfig:
    """Parallelism plan. The port trains on one card: every degree above 1
    is refused by ``require_single_device`` (the training engine calls
    it), naming the ROADMAP item that will bring it."""
    strategy: str = "auto"          # auto | manual
    data_parallel: int = 1
    fsdp: int = 1
    tensor_parallel: int = 1
    pipeline_parallel: int = 1
    sequence_parallel: int = 1
    expert_parallel: int = 1
    zero_stage: int = 0
    activation_checkpoint: str = "selective"   # none | selective | full
    micro_batch_size: int = 1
    global_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    num_microbatches: int = 1
    pipeline_schedule: str = "1f1b"

    _DEGREES = ("data_parallel", "fsdp", "tensor_parallel",
                "pipeline_parallel", "sequence_parallel", "expert_parallel")

    def validate(self) -> None:
        for f_ in self._DEGREES:
            if getattr(self, f_) < 1:
                raise ConfigError(f"{f_} must be >= 1")
        if self.zero_stage not in (0, 1, 2, 3):
            raise ConfigError("zero_stage must be 0..3")
        if self.activation_checkpoint not in ("none", "selective",
                                              "selective_attn", "full"):
            raise ConfigError(
                "activation_checkpoint must be "
                "none|selective|selective_attn|full")
        if (self.pipeline_parallel > 1
                and self.num_microbatches < self.pipeline_parallel):
            raise ConfigError(
                "num_microbatches must be >= pipeline_parallel for a full "
                "pipeline")
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ConfigError("pipeline_schedule must be gpipe|1f1b")
        if self.zero_stage == 3 and self.fsdp <= 1:
            raise ConfigError(
                "zero_stage=3 means fully-sharded parameters, which this "
                "framework expresses as the fsdp mesh axis: set fsdp>1")

    def require_single_device(self) -> None:
        """Raise for any plan that needs more than one card."""
        over = [f"{f_}={getattr(self, f_)}" for f_ in self._DEGREES
                if getattr(self, f_) > 1]
        if over or self.zero_stage > 0:
            raise NotImplementedError(
                f"parallel training ({', '.join(over) or 'zero_stage'}) is "
                f"not ported yet: the port trains on one card (ROADMAP "
                f"queue 1 item 7)")

    @property
    def total_devices(self) -> int:
        n = 1
        for f_ in self._DEGREES:
            n *= getattr(self, f_)
        return n

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "ParallelConfig":
        if not d:
            return cls()
        sp = _take(d, "sequence_parallel", "context_parallel", default=1)
        if isinstance(sp, bool):    # the reference's dead bool flag
            sp = 1
        cfg = cls(
            strategy=str(_take(d, "strategy", default="auto")),
            data_parallel=int(_take(d, "data_parallel", "dp", default=1)),
            fsdp=int(_take(d, "fsdp", default=1)),
            tensor_parallel=int(_take(d, "tensor_parallel", "tp", default=1)),
            pipeline_parallel=int(_take(d, "pipeline_parallel", "pp",
                                        default=1)),
            sequence_parallel=int(sp),
            expert_parallel=int(_take(d, "expert_parallel", "ep", default=1)),
            zero_stage=int(_take(d, "zero_stage", default=0)),
            activation_checkpoint=str(_take(d, "activation_checkpoint",
                                            default="selective")),
            micro_batch_size=int(_take(d, "micro_batch_size", default=1)),
            global_batch_size=int(_take(d, "global_batch_size", default=8)),
            gradient_accumulation_steps=int(_take(
                d, "gradient_accumulation_steps", default=1)),
            num_microbatches=int(_take(
                d, "num_microbatches",
                default=_take(d, "pipeline_parallel", "pp", default=1))),
        )
        cfg.validate()
        return cfg


@dataclass
class DataConfig:
    """Training/validation data: "synthetic" or a directory of tokenized
    ``.bin`` shards (io/data.py)."""
    train: str = "synthetic"
    val: str = "synthetic"
    tokenizer: str = "gpt2"
    max_length: int = 2048
    pack_sequences: bool = True
    num_workers: int = 2
    prefetch_factor: int = 2
    seed: int = 0

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "DataConfig":
        if not d:
            return cls()
        return cls(
            train=str(_take(d, "train", "train_path", "dataset_path",
                            default="synthetic")),
            val=str(_take(d, "val", "val_path", default="synthetic")),
            tokenizer=str(_take(d, "tokenizer", default="gpt2")),
            max_length=int(_take(d, "max_length", "seq_len", default=2048)),
            pack_sequences=_parse_bool("pack_sequences", _take(
                d, "pack_sequences", default=True)),
            num_workers=int(_take(d, "num_workers", default=2)),
            prefetch_factor=int(_take(d, "prefetch_factor", default=2)),
            seed=int(_take(d, "seed", default=0)),
        )


@dataclass
class CheckpointConfig:
    """Atomic (tmp dir, then rename) checkpoints of the full train state
    (io/checkpoint.py); ``async_save`` writes on a background thread."""
    path: str = "checkpoints"
    interval_steps: int = 1000
    sharded: bool = True
    async_save: bool = True
    keep_latest: int = 5

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "CheckpointConfig":
        if not d:
            return cls()
        return cls(
            path=str(_take(d, "path", default="checkpoints")),
            interval_steps=int(_take(d, "interval_steps", "save_interval",
                                     default=1000)),
            sharded=_parse_bool("sharded", _take(d, "sharded", default=True)),
            async_save=_parse_bool("async_save", _take(
                d, "async", "async_save", default=True)),
            keep_latest=int(_take(d, "keep_latest", "save_total_limit",
                                  default=5)),
        )


@dataclass
class TrainingConfig:
    """The training loop: steps, intervals, seed, attention implementation
    (``auto`` is the flash kernel on a card, the plain attention on the
    CPU)."""
    max_steps: int = 1000
    eval_interval: int = 500
    save_interval: int = 1000
    log_interval: int = 10
    seed: int = 42
    mixed_precision: str = "bf16"   # bf16 | fp32
    deterministic: bool = False
    profile: bool = False
    profile_dir: str = "traces"
    eval_steps: int = 20            # batches per eval
    attn_impl: str = "auto"         # auto | xla | flash | ring | ulysses

    def validate(self) -> None:
        if self.mixed_precision not in ("bf16", "fp32", "no"):
            raise ConfigError("mixed_precision must be bf16|fp32|no")
        if self.attn_impl not in ("auto", "xla", "flash", "ring", "ulysses"):
            raise ConfigError("attn_impl must be auto|xla|flash|ring|ulysses")

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "TrainingConfig":
        if not d:
            return cls()
        cfg = cls(
            max_steps=int(_take(d, "max_steps", default=1000)),
            eval_interval=int(_take(d, "eval_interval", default=500)),
            save_interval=int(_take(d, "save_interval", default=1000)),
            log_interval=int(_take(d, "log_interval", default=10)),
            seed=int(_take(d, "seed", default=42)),
            mixed_precision=str(_take(d, "mixed_precision", default="bf16")),
            deterministic=_parse_bool("deterministic", _take(
                d, "deterministic", default=False)),
            profile=_parse_bool("profile", _take(d, "profile",
                                                 default=False)),
            profile_dir=str(_take(d, "profile_dir", default="traces")),
            eval_steps=int(_take(d, "eval_steps", default=20)),
            attn_impl=str(_take(d, "attn_impl", "attention_impl",
                                default="auto")),
        )
        cfg.validate()
        return cfg


@dataclass
class HardwareConfig:
    """The card the MFU and bandwidth figures are taken against. The
    defaults are one H100 SXM from NVIDIA's data sheet: 80 GB of HBM at
    3.35 TB/s, 989 TFLOP/s dense bf16, NVLink 450 GB/s each way. Field
    names are the JAX package's, so one config file serves both."""
    platform: str = "gpu"
    chip_type: str = "h100"
    num_chips: int = 1
    num_hosts: int = 1
    hbm_gb_per_chip: float = 80.0
    peak_bf16_tflops: float = 989.0
    hbm_bw_gbps: float = 3350.0
    ici_bw_gbps: float = 450.0      # NVLink, each way
    dcn_bw_gbps: float = 50.0       # one 400 Gb/s NIC
    topology: str = ""

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "HardwareConfig":
        if not d:
            return cls()
        dflt = cls()
        return cls(
            platform=str(_take(d, "platform", default=dflt.platform)),
            chip_type=str(_take(d, "chip_type", "chip", "gpu",
                                default=dflt.chip_type)),
            num_chips=int(_take(d, "num_chips", "chips", "gpu_count",
                                "gpus_per_node", default=1)),
            num_hosts=int(_take(d, "num_hosts", "nodes", default=1)),
            hbm_gb_per_chip=float(_take(d, "hbm_gb_per_chip", "memory_gb",
                                        default=dflt.hbm_gb_per_chip)),
            peak_bf16_tflops=float(_take(d, "peak_bf16_tflops",
                                         default=dflt.peak_bf16_tflops)),
            hbm_bw_gbps=float(_take(d, "hbm_bw_gbps",
                                    default=dflt.hbm_bw_gbps)),
            ici_bw_gbps=float(_take(d, "ici_bw_gbps", "intra_node_bw",
                                    default=dflt.ici_bw_gbps)),
            dcn_bw_gbps=float(_take(d, "dcn_bw_gbps", "inter_node_bw",
                                    default=dflt.dcn_bw_gbps)),
            topology=str(_take(d, "topology", default="")),
        )


# alias -> canonical field name for ModelConfig dict keys, used when user
# keys overlay a template's canonical dict (RunConfig.from_dict)
_MODEL_KEY_ALIASES: dict[str, str] = {
    "layers": "num_layers", "num_hidden_layers": "num_layers",
    "hidden": "hidden_size", "d_model": "hidden_size",
    "ffn": "ffn_size", "intermediate_size": "ffn_size",
    "heads": "num_heads", "num_attention_heads": "num_heads",
    "kv_heads": "num_kv_heads", "num_key_value_heads": "num_kv_heads",
    "max_seq_len": "max_position_embeddings",
    "hidden_act": "activation",
    "layer_norm_eps": "norm_eps", "rms_norm_eps": "norm_eps",
}


@dataclass
class RunConfig:
    """The full training-run preset: everything in one file."""
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)

    @classmethod
    def from_dict(cls, d: dict[str, Any], base_dir=None) -> "RunConfig":
        model_d = d.get("model", {}) or {}
        # a preset may point at a model JSON/TOML via config_file, relative
        # to the preset's directory, its parents or the working directory;
        # a declared but missing file is an error
        if "config_file" in model_d:
            from pathlib import Path
            from .loader import load_config_file
            rel = Path(model_d["config_file"])
            candidates = [rel] if rel.is_absolute() else []
            if base_dir is not None and not rel.is_absolute():
                b = Path(base_dir).resolve()
                candidates += [b / rel, b.parent / rel, b.parent.parent / rel]
            if not rel.is_absolute():
                candidates.append(Path.cwd() / rel)
            found = next((p for p in candidates if p.exists()), None)
            if found is None:
                raise ConfigError(
                    f"model.config_file {model_d['config_file']!r} not found "
                    f"(searched {[str(c) for c in candidates]})")
            loaded = load_config_file(found)
            loaded.update({k: v for k, v in model_d.items()
                           if k != "config_file"})
            model_d = loaded
        # a known template name seeds the architecture; explicit keys
        # overlay it under their canonical names
        name = model_d.get("name")
        if name:
            from .presets import MODEL_TEMPLATES, TEST_TEMPLATES
            tmpl = MODEL_TEMPLATES.get(name) or TEST_TEMPLATES.get(name)
            if tmpl is not None:
                base = dataclasses.asdict(tmpl)
                for k, v in model_d.items():
                    k = _MODEL_KEY_ALIASES.get(k, k)
                    if isinstance(v, dict) and isinstance(base.get(k), dict):
                        base[k] = {**base[k], **v}
                    else:
                        base[k] = v
                model_d = base
        return cls(
            model=ModelConfig.from_dict(model_d) if model_d else ModelConfig(),
            optimizer=OptimizerConfig.from_dict(d.get("optimizer")),
            data=DataConfig.from_dict(d.get("data")),
            parallel=ParallelConfig.from_dict(d.get("parallel")),
            checkpoint=CheckpointConfig.from_dict(d.get("checkpoint")),
            training=TrainingConfig.from_dict(d.get("training")),
            hardware=HardwareConfig.from_dict(d.get("hardware")),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
