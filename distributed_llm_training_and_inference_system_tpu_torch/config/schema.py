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
    On a mesh the experts' leading E axis is cut over ``ep``."""
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
    """The optimizer (adamw, adam, lion, adafactor or sgd) and its
    schedule. ``moment_dtype``/``nu_dtype`` store Adam's mu and
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
    """Parallelism plan. Data, FSDP, tensor, sequence, pipeline and expert
    parallelism and ZeRO run on a mesh of ranks (``parallel/``);
    ``require_supported`` (the training engine calls it) refuses the
    plans the port cannot train yet, naming their ROADMAP item."""
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

    def require_supported(self, model=None) -> None:
        """Raise for a plan the port cannot train: a pipeline over a model
        whose layers it does not divide (JAX's ``L % pp`` assertion; with
        ``model``), and a pipeline with sequence parallelism (ROADMAP queue
        1 item 7b, step 9). Data, FSDP, tensor, sequence, pipeline (GPipe
        and 1F1B, one rank a stage) and expert parallelism and ZeRO stages
        1-3 run on a mesh of ranks (``parallel/api.py``)."""
        pp = self.pipeline_parallel
        if pp > 1 and model is not None and model.num_layers % pp:
            raise ConfigError(f"layers {model.num_layers} not divisible by "
                              f"pipeline_parallel {pp}")
        if pp > 1 and self.sequence_parallel > 1:
            raise NotImplementedError(
                f"pipeline_parallel={pp} with sequence_parallel="
                f"{self.sequence_parallel} is not ported yet (ROADMAP queue "
                f"1 item 7b, step 9)")

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


def parse_fleet_endpoints(value) -> dict[int, str]:
    """Normalize a fleet endpoint map to {replica_id: base_url}.

    Accepts the three spellings operators actually produce: a dict with
    string or int keys (the TOML table ``[fleet.fleet_endpoints]``), a
    sequence of ``"id=url"`` strings (the repeated ``--fleet-endpoint``
    CLI flag), or one comma-separated ``"id=url,id=url"`` string. Raises
    :class:`ConfigError` (a ValueError) on malformed entries so a typo
    fails at config time, not at first KV ship."""
    if not value:
        return {}
    items: list[tuple[object, object]] = []
    if isinstance(value, dict):
        items = list(value.items())
    else:
        if isinstance(value, str):
            value = [p for p in value.split(",") if p.strip()]
        for entry in value:
            if not isinstance(entry, str) or "=" not in entry:
                raise ConfigError(
                    f"fleet endpoint entries must be 'replica=url', "
                    f"got {entry!r}")
            rid, _, url = entry.partition("=")
            items.append((rid, url))
    out: dict[int, str] = {}
    for rid, url in items:
        rid_s = str(rid).strip()
        if rid_s.lower() == "store":
            # the networked KV store service rides the endpoint map
            # under the KV_STORE_OWNER sentinel (-1) — "store=URL" is
            # the operator spelling (serve/fleet/store_service.py)
            key = -1
        else:
            try:
                key = int(rid_s)
            except ValueError:
                raise ConfigError(
                    f"fleet endpoint replica id must be an integer "
                    f"or 'store', got {rid!r}")
        url = str(url).strip().rstrip("/")
        if not url.startswith(("http://", "https://")):
            raise ConfigError(
                f"fleet endpoint for replica {key} must be an http(s) "
                f"base URL, got {url!r}")
        if key in out:
            raise ConfigError(
                f"duplicate fleet endpoint for replica {key}")
        out[key] = url
    return out


@dataclasses.dataclass
class FleetConfig:
    """Serve-fleet control plane (serve/fleet/): N engine replicas behind a
    router + supervisor. The per-replica engine is configured by ServeConfig;
    this layer only decides WHERE a request runs and what happens when a
    replica dies (Llumnix-style request-level rerouting above Orca-style
    iteration-level scheduling — PAPERS.md)."""
    replicas: int = 1
    # -- supervisor ----------------------------------------------------------
    probe_interval_s: float = 0.5   # health-probe cadence
    probe_failures: int = 3         # consecutive probe misses before the
    #                                 replica is declared dead and drained
    restart_backoff_s: float = 0.5  # first restart delay; doubles per
    #                                 consecutive restart of the same replica
    restart_backoff_max_s: float = 30.0
    max_restarts: int = 0           # 0 = unlimited
    # -- router --------------------------------------------------------------
    # prefix-affinity: requests whose first `affinity_prefix_tokens` tokens
    # hash to the same digest route to the same replica (consistent hashing
    # over `affinity_vnodes` ring points per replica), so each replica's
    # prefix cache stays hot for its share of the prompt population. 0
    # disables affinity (pure least-outstanding-tokens).
    affinity_prefix_tokens: int = 64
    affinity_vnodes: int = 32
    # affinity yields to load balance once the ring owner's queue is this
    # many requests deeper than the least-loaded replica's (a hot prefix
    # must not melt one replica while others idle)
    affinity_max_imbalance: int = 4
    # -- admission / backpressure -------------------------------------------
    # fleet-wide bound on queued-but-not-resident requests (sum over
    # replica queues + parked requeues). Above it, submissions are
    # rejected with 429 + Retry-After instead of growing tail latency.
    max_pending: int = 512
    retry_after_s: float = 1.0      # Retry-After hint on 429
    # per-request requeue budget (crash/drain rerouting); above it the
    # request fails loudly instead of ping-ponging between dying replicas
    max_requeues: int = 3
    # -- KV migration (serve/fleet/migration.py) ------------------------------
    # drain moves resident sequences to survivors WITH their paged KV
    # (two-phase copy: full pages pre-copied while decode continues, only
    # the partial tail stop-and-copied), so the destination restores pages
    # and resumes decode — zero re-prefill. Off = PR-2 behaviour: victims
    # re-prefill prompt+generated on the survivor.
    migrate_on_drain: bool = True
    # proactive rebalancing: when (hottest - coldest) outstanding tokens
    # exceed this fraction of the hottest replica's load for
    # `rebalance_poll_hysteresis` consecutive supervisor polls, the
    # longest-remaining resident sequences migrate hot -> cold. 0 disables
    # (placement bias on new requests remains the only balancing force).
    rebalance_imbalance_ratio: float = 0.0
    rebalance_poll_hysteresis: int = 3
    # fleet-wide bound on concurrently in-flight migrations: each one
    # holds a host-side page copy and steals a source step boundary, so
    # unbounded migration under churn would thrash instead of balance
    max_concurrent_migrations: int = 2
    # -- disaggregated prefill/decode (DistServe/Splitwise — PAPERS.md) ------
    # comma-separated per-replica roles, e.g. "prefill,decode" (must name
    # one role per replica). Empty = every replica "mixed" (classic
    # fleet). New requests route only to prefill-capable replicas
    # (prefill|mixed); when a prefill-role replica finishes a prompt's
    # prefill, the sequence leaves WITH its KV over the migration courier
    # to the least-outstanding-tokens decode-capable replica — the
    # degenerate one-phase migration (every page full and immutable) —
    # and decodes there with zero prefill compute. When no decode pool
    # has room the source decodes locally instead (handoff is an
    # optimization, never a correctness dependency). Needs at least one
    # prefill-capable replica: a decode-only fleet could admit nothing.
    roles: str = ""
    # role balancer: when the average prefill-replica queue depth exceeds
    # ratio * (average decode-replica queue depth + 1) for `hysteresis`
    # consecutive supervisor polls — or vice versa (decode-slot pressure
    # shows up as handoff backlog in decode queues: handoffs only queue
    # when every slot is busy) — the least-loaded replica of the
    # over-provisioned class is drained (with migration, so its
    # residents move out losslessly) and re-roled. 0 disables. The
    # floors keep at least this many replicas per role class so the
    # balancer can never starve a phase entirely.
    role_balance_ratio: float = 0.0
    role_balance_poll_hysteresis: int = 3
    role_min_prefill: int = 1
    role_min_decode: int = 1
    # crash-promoted mixed replicas (role-aware health) demote back to
    # their provisioned role once the crashed class is healthy again for
    # this many consecutive supervisor polls. 0 disables auto-demotion
    # (promotions then stay until the operator re-splits, PR-4 behavior).
    role_restore_hysteresis: int = 3
    # -- courier transport (serve/fleet/transport.py) ------------------------
    # every migration / handoff / salvaged-partial payload crosses the
    # courier: framed into <= courier_chunk_bytes chunks (CRC32 each,
    # whole-payload CRC verified end-to-end), per-chunk deadline, lost or
    # corrupt chunks retried with doubling backoff for up to
    # courier_max_retries resend rounds (ONLY missing chunks resend —
    # resumable transfer). A transfer that exhausts the budget drops the
    # payload and the destination re-prefills from tokens: degraded,
    # never wrong. "inproc" delivers within this process (threaded
    # replicas, byte-for-byte what PR-3/4 shipped); "http" POSTs chunks
    # to courier_endpoint's /fleet/courier/chunk (cross-host movement).
    courier_transport: str = "inproc"
    # wire codec for courier payloads (CacheGen-style, PAPERS.md):
    # "none" ships raw bytes (wire-compatible with prior PRs); "zlib"
    # deflates each chunk; "delta-zlib" additionally delta-encodes
    # quantized KV page planes along the token axis before deflate
    # (adjacent tokens' int8/int4 values are strongly correlated, so
    # deltas compress 2-4x where raw pages barely deflate). Compression
    # is per-chunk and pipelined (chunk k+1 deflates while k is on the
    # wire), decode-side CRCs verify the compressed frame AND the raw
    # payload, and a receiver that does not speak the declared codec
    # rejects the transfer loudly — a codec bug degrades to re-prefill,
    # never wrong KV. Fewer wire bytes directly shrink migration pause,
    # handoff stall, and prefix-fetch latency (Mooncake economics).
    courier_codec: str = "none"
    # zlib compression level for the compressing codecs (-1 = zlib's
    # library default, the historical behavior; 1 = fastest, 9 =
    # smallest). Recorded in each transfer's frame manifest, so
    # receivers stay level-agnostic and mixed-level fleets interoperate;
    # the tiered KV store encodes its at-rest frames at this level too.
    courier_zlib_level: int = -1
    courier_chunk_bytes: int = 256 * 1024
    courier_max_retries: int = 4
    courier_retry_backoff_ms: float = 2.0
    courier_retry_backoff_max_ms: float = 100.0
    courier_chunk_deadline_ms: float = 100.0
    courier_endpoint: str = ""      # http transport: dest fleet base URL
    # destination-side reassembly buffers and attached-but-unclaimed
    # payloads are evicted after this TTL (a sender that died mid-push,
    # or a placement that never submitted, must not leak host memory
    # forever). Evictions count in llmctl_fleet_courier_expired_total.
    # 0 disables expiry.
    courier_ticket_ttl_ms: float = 60_000.0
    # -- cross-host fleet (serve/fleet/remote.py + worker.py) ----------------
    # per-replica courier endpoint map: replica id -> base URL of the host
    # front that runs that replica's CourierReceiver (`llmctl fleet
    # worker` for remote replicas; this process's own fleet front for
    # in-proc replicas that must RECEIVE payloads pushed by remote
    # workers). Accepts a dict ({"0": "http://hostA:9000"}, the TOML
    # table form), a sequence of "id=url" strings (the repeated
    # `--fleet-endpoint` CLI flag), or one comma-separated string.
    fleet_endpoints: dict = dataclasses.field(default_factory=dict)
    # comma-separated replica ids served by a remote `llmctl fleet
    # worker` process instead of an in-process engine thread. Every id
    # listed here MUST have an entry in fleet_endpoints — that is
    # validated at fleet build time, not at first ship.
    remote_replicas: str = ""
    # per-call HTTP timeout for remote-replica control RPCs
    # (submit/probe/outbox/drain); failed calls reconnect under a
    # doubling backoff and probe misses tear the replica down exactly
    # like an engine-thread crash.
    remote_timeout_s: float = 5.0
    # upper bound on one worker->worker payload ship command (the
    # chunked push inside it already has per-chunk deadlines + retry
    # budget; this bounds the whole RPC so a hung worker can't wedge
    # placement).
    courier_ship_timeout_s: float = 30.0
    # -- fleet-global prefix cache (Mooncake-style KV reuse) -----------------
    # A placement that lands off the prefix-affinity owner (load bound,
    # role filter, drain, requeue) normally re-prefills a prefix whose
    # KV already exists somewhere in the fleet. With prefix_fetch on,
    # the router attaches a `prefix_owner` hint (from per-replica
    # prefix-page inventories) and the destination FETCHES the shared
    # full pages over the courier instead of recomputing them,
    # prefilling only the uncovered tail. Every failure mode (owner
    # evicted the pages, transfer aborted, timeout) degrades to plain
    # prefill — fetch is an optimization, never a correctness
    # dependency. Fetched pages credit reprefill_tokens_avoided.
    prefix_fetch: bool = True
    # don't bother fetching fewer than this many full pages (a one-page
    # fetch rarely beats just computing it; raise on slow links)
    prefix_fetch_min_pages: int = 1
    # bound on one fetch round trip (owner-side extract waits at most
    # one engine dispatch; the push inside has its own chunk deadlines)
    prefix_fetch_timeout_s: float = 5.0
    # newest prefix-page hashes each replica advertises in its probe /
    # inventory (bounds probe payloads and router hint work; 0 disables
    # the inventory and therefore all fetch hints)
    prefix_inventory_max: int = 512
    # TTL on the router's per-placement inventory reads (the PR-7 named
    # gap: every needs-prefill placement re-read every replica's
    # inventory). > 0 caches the {replica: hashes} map for that long —
    # invalidated outright on replica teardown/drain/undrain/restart,
    # so a dead owner's pages never outlive it in the hint path; a
    # within-TTL stale entry only costs a counted fetch miss. 0 = read
    # fresh every placement (exact hints; fine at small fleets).
    prefix_inventory_ttl_ms: float = 0.0
    # -- pipelined multi-replica prefill (serve/fleet/pipeline.py) -----------
    # needs-prefill prompts at least this many tokens long are split
    # into page-aligned chunks and streamed through the prefill pool as
    # a chunk pipeline (Mooncake-style chunked pipeline parallelism):
    # stage k computes chunk k against the shipped-in KV of chunks < k
    # while its finished pages pre-ship to stage k+1 over the courier —
    # transfer hides behind compute. Token-identical to single-replica
    # prefill (greedy and seeded); any stage failure collapses to a
    # counted single-replica prefill. 0 disables pipelining. Requires
    # prefix_fetch (stages import shipped chunks through the fetch
    # plane).
    pipeline_prefill_min_tokens: int = 0
    # most stages one prompt is split across (also bounded by the number
    # of accepting prefill-capable in-process replicas)
    pipeline_prefill_max_stages: int = 4
    # a stage that neither finishes nor reports chunk progress within
    # this window collapses the pipeline to single-replica prefill
    pipeline_prefill_stage_timeout_ms: float = 30_000.0
    # -- tiered fleet KV store (serve/fleet/kv_store.py) ---------------------
    # host-tier page cache behind the prefix inventory (Mooncake's
    # cluster-cache claim): replicas DEMOTE evicted/retired prefix pages
    # here in their compressed courier-frame form (encoded once, stored
    # as frames, replayed byte-identical on fetch), the store advertises
    # its holdings through the same hint path replica inventories use,
    # and a returning conversation whose pages left every HBM pool
    # restores from the store at wire speed instead of re-prefilling.
    # Requires prefix_fetch (the fetch plane IS the restore path).
    kv_store: bool = False
    # bounded DRAM ring capacity, in MB of COMPRESSED frames (LRU;
    # overflow spills to kv_store_dir when set, else drops the oldest)
    kv_store_dram_mb: float = 256.0
    # optional disk-spill directory ("" = DRAM only); also LRU-bounded
    kv_store_dir: str = ""
    kv_store_disk_mb: float = 1024.0
    # entries nobody fetched for this long are expired (0 = keep until
    # capacity pressure evicts them)
    kv_store_ttl_ms: float = 0.0
    # networked store backend (serve/fleet/store_service.py): base URL
    # of a standalone `llmctl fleet store` service. When set, this
    # front/worker uses a StoreClient against that service instead of
    # an in-proc FleetKVStore — N fronts and every remote worker then
    # share ONE logical store (demotions upload the already-encoded
    # frames; fetches replay them locally through the courier
    # receiver). "" = in-proc store (kv_store=true) or none.
    kv_store_endpoint: str = ""
    # -- replicated store tier (serve/fleet/store_tier.py) -------------------
    # comma-separated member URLs of a REPLICATED store tier: N
    # `llmctl fleet store` processes behind the one logical
    # KV_STORE_OWNER. Demotions/retire-flushes/ship-weights replicate
    # to every live member (kv_store_write_ack of them synchronously,
    # the rest async-mirrored) and the client fails over across members
    # on fetch — a SIGKILLed member costs zero counted misses while a
    # survivor holds the pages. Overrides kv_store_endpoint when set.
    kv_store_endpoints: str = ""
    # transient-error budget BEFORE a store RPC failure is surfaced:
    # each member gets up to this many retries with doubling backoff
    # (first wait kv_store_retry_backoff_ms) on connection
    # refused/reset/timeout; only after every live member exhausts its
    # budget does a fetch count a remote miss. Applies in single-store
    # mode too (the PR-16 behavior was miss-on-first-refusal).
    kv_store_retry_max: int = 2
    kv_store_retry_backoff_ms: float = 10.0
    # write-ack floor: a demotion/retire-flush/weight ship is
    # acknowledged once this many members durably hold it; remaining
    # live members are mirrored in the background. Must be <= the
    # member count; raise it to the member count for synchronous full
    # replication (what the chaos dryrun uses so a kill can never lose
    # the only copy).
    kv_store_write_ack: int = 1
    # hedged fetch: > 0 races a second member when the first has not
    # answered within this many ms (tail-latency insurance, Mooncake's
    # "fetch from any holder"); 0 disables hedging.
    kv_store_hedge_ms: float = 0.0
    # -- fleet SSE streaming (serve/fleet/streams.py) ------------------------
    # finished stream logs stay replayable (Last-Event-ID reconnect) for
    # this long before the hub GCs them; live logs never expire. 0 keeps
    # finished logs forever (tests only — production would leak).
    stream_log_ttl_ms: float = 60_000.0
    # per-subscriber backpressure bound: a subscriber holding more than
    # this many delivered-but-unconsumed token batches (a slow SSE
    # client buffering in its response queue) is DISCONNECTED by the hub
    # (counted in llmctl_fleet_stream_backpressure_drops_total) instead
    # of buffering without bound — the log keeps growing, so the client
    # reconnects with Last-Event-ID and replays exactly the unacked
    # tail. 0 disables the cap (PR-8 behavior).
    stream_max_buffered_batches: int = 256
    # -- HA front tier (serve/fleet/state.py + front.py) ---------------------
    # where the front-affine mutable state (stream logs, router ledger,
    # parked queue) lives. "memory" = this process's heap, the
    # single-front default, byte-for-byte the pre-store behavior.
    # "file" = a shared, fenced, append-only journal under
    # state_store_dir — N stateless fronts over the same directory and
    # the same remote workers serve ONE fleet, and a front's SIGKILL
    # mid-SSE is healed by the client reconnecting to any survivor with
    # Last-Event-ID (zero gaps, zero duplicates).
    state_store: str = "memory"
    state_store_dir: str = ""
    # snapshot+truncate compaction cadence for the file store's journal
    # (records written between compaction attempts; 0 disables). The
    # journal otherwise grows unboundedly — compaction folds the prefix
    # every attached front has already consumed into snapshot.jsonl
    # (terminal request groups collapsed to put+pop, counter records
    # aggregated, finished stream groups dropped) and truncates the
    # journal, flock-serialized and fencing-aware.
    state_compact_every: int = 1024
    # how many front processes `llmctl serve start` runs (via the
    # FleetFrontTier babysitter, each a `llmctl fleet front` child on
    # its own port, surfaced in `fleet status`). > 1 requires
    # state_store=file and all replicas remote — a front holding
    # in-process engines would not be stateless.
    fronts: int = 1
    # -- elastic autoscaling (serve/fleet/autoscaler.py) ---------------------
    # react to load: the supervisor-driven FleetAutoscaler adds replicas
    # when the fleet queues (spawning `llmctl fleet worker` processes
    # when a spawner is wired, in-proc engine replicas otherwise) and
    # retires the least-loaded replica when load fades — through the
    # lossless drain-with-migration + store-flush path, so scale-down
    # never destroys cached prefixes or in-flight tokens.
    autoscale: bool = False
    # hard floor/ceiling on live replicas (ceiling 0 = 2x provisioned)
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 0
    # scale up when queued-but-not-resident requests per healthy replica
    # exceed this for `autoscale_hysteresis_polls` consecutive polls
    autoscale_up_queue_per_replica: float = 4.0
    # scale down when the per-replica queue falls below this AND at
    # least one replica is fully idle, held for the same hysteresis
    autoscale_down_queue_per_replica: float = 0.5
    # consecutive over/under-threshold polls before a decision fires
    # (one bursty poll must not thrash the fleet)
    autoscale_hysteresis_polls: int = 2
    # polls to sit out after ANY scale action before the next one —
    # lets spawned replicas warm and drained load settle
    autoscale_cooldown_polls: int = 10
    # how long a spawned worker process gets to print its ready line
    # (LLMCTL_WORKER_READY port=N) before the spawn is rolled back
    autoscale_spawn_timeout_s: float = 30.0
    # what a scale-up actually spawns: "" / "engine" = an in-proc
    # engine replica (warm-spare pool); "worker" = a `llmctl fleet
    # worker` OS process whose argv `llmctl serve start` synthesizes
    # from its own model/config flags (including --weights-from-store
    # when kv_store_endpoint is set — a bare host bootstraps weights
    # over the courier, no shared artifact path needed)
    autoscale_spawn: str = ""
    # pool-pressure scale-up signal: when > 0 and the minimum
    # free-page ratio (pool_free_pages / pool_total_pages, from the
    # probes) across healthy replicas falls BELOW this, the fleet
    # scales up under the same hysteresis as queue pressure — KV
    # capacity exhausts before queues form under long-context load.
    # 0 disables (queue-depth-only, the PR-16 behavior).
    autoscale_up_free_page_ratio: float = 0.0
    # -- SLO priority classes (router admission + preemption) ----------------
    # queue slots (out of max_pending) held back from standard and
    # best-effort admission so interactive requests are still admissible
    # at saturation; 0 = single-class admission (pre-tier behavior)
    priority_headroom_requests: int = 0
    # preempt a best-effort resident (KV migrated, never dropped) when
    # an interactive request has been queued longer than this TTFT
    # target; 0 disables preemption
    interactive_ttft_target_ms: float = 0.0

    def role_list(self) -> list[str]:
        """Per-replica role assignment; empty config = all mixed."""
        if not self.roles:
            return ["mixed"] * self.replicas
        return [s.strip().lower() for s in self.roles.split(",")]

    def endpoint_map(self) -> dict[int, str]:
        """Normalized {replica_id: base_url} courier endpoint map."""
        return parse_fleet_endpoints(self.fleet_endpoints)

    def kv_store_endpoint_list(self) -> list:
        """Ordered store-tier member URLs: ``kv_store_endpoints``
        (comma-separated) when set, else the single
        ``kv_store_endpoint``, else empty. The first entry is the
        preferred member; clients rotate from it on failure."""
        eps = [e.strip().rstrip("/")
               for e in str(self.kv_store_endpoints or "").split(",")
               if e.strip()]
        if not eps and self.kv_store_endpoint:
            eps = [str(self.kv_store_endpoint).rstrip("/")]
        return eps

    def remote_replica_ids(self) -> set[int]:
        """Replica ids fronted by a remote `llmctl fleet worker`."""
        if not self.remote_replicas:
            return set()
        try:
            return {int(s) for s in
                    str(self.remote_replicas).split(",") if s.strip()}
        except ValueError:
            raise ConfigError(
                f"remote_replicas must be comma-separated replica ids, "
                f"got {self.remote_replicas!r}")

    def validate(self) -> None:
        if self.replicas < 1:
            raise ConfigError("fleet replicas must be >= 1")
        if self.probe_interval_s <= 0:
            raise ConfigError("probe_interval_s must be > 0")
        if self.probe_failures < 1:
            raise ConfigError("probe_failures must be >= 1")
        if self.restart_backoff_s < 0 or self.restart_backoff_max_s < 0:
            raise ConfigError("restart backoff values must be >= 0")
        if self.affinity_prefix_tokens < 0:
            raise ConfigError("affinity_prefix_tokens must be >= 0")
        if self.affinity_vnodes < 1:
            raise ConfigError("affinity_vnodes must be >= 1")
        if self.max_pending < 1:
            raise ConfigError("max_pending must be >= 1")
        if self.max_requeues < 0:
            raise ConfigError("max_requeues must be >= 0")
        if not 0.0 <= self.rebalance_imbalance_ratio < 1.0:
            raise ConfigError(
                "rebalance_imbalance_ratio must be in [0, 1) (0 disables)")
        if self.rebalance_poll_hysteresis < 1:
            raise ConfigError("rebalance_poll_hysteresis must be >= 1")
        if self.max_concurrent_migrations < 1:
            raise ConfigError("max_concurrent_migrations must be >= 1")
        if self.roles:
            rl = self.role_list()
            if len(rl) != self.replicas:
                raise ConfigError(
                    f"fleet roles names {len(rl)} replicas but the fleet "
                    f"has {self.replicas}")
            bad = sorted(set(rl) - {"prefill", "decode", "mixed"})
            if bad:
                raise ConfigError(
                    f"unknown fleet role(s) {bad}; each must be "
                    "prefill|decode|mixed")
            if not any(r in ("prefill", "mixed") for r in rl):
                raise ConfigError(
                    "fleet roles need at least one prefill-capable "
                    "(prefill or mixed) replica — a decode-only fleet "
                    "could never admit a new request")
        if self.role_balance_ratio < 0:
            raise ConfigError("role_balance_ratio must be >= 0 (0 disables)")
        if self.role_balance_poll_hysteresis < 1:
            raise ConfigError("role_balance_poll_hysteresis must be >= 1")
        if self.role_min_prefill < 1 or self.role_min_decode < 1:
            raise ConfigError("role_min_prefill/role_min_decode must be >= 1")
        if self.role_restore_hysteresis < 0:
            raise ConfigError(
                "role_restore_hysteresis must be >= 0 (0 disables)")
        if self.courier_transport not in ("inproc", "http"):
            raise ConfigError(
                f"unknown courier_transport "
                f"{self.courier_transport!r} (inproc|http)")
        if self.courier_transport == "http" and not self.courier_endpoint:
            raise ConfigError(
                "courier_transport=http needs courier_endpoint (the "
                "destination fleet front's base URL)")
        if self.courier_codec not in ("none", "zlib", "delta-zlib"):
            raise ConfigError(
                f"unknown courier_codec {self.courier_codec!r} "
                f"(none|zlib|delta-zlib)")
        if not -1 <= self.courier_zlib_level <= 9:
            raise ConfigError(
                f"courier_zlib_level {self.courier_zlib_level} outside "
                f"[-1, 9] (-1 = zlib default)")
        if self.courier_chunk_bytes < 1024:
            raise ConfigError("courier_chunk_bytes must be >= 1024")
        if self.courier_ticket_ttl_ms < 0:
            raise ConfigError(
                "courier_ticket_ttl_ms must be >= 0 (0 disables expiry)")
        if self.remote_timeout_s <= 0 or self.courier_ship_timeout_s <= 0:
            raise ConfigError(
                "remote_timeout_s / courier_ship_timeout_s must be > 0")
        if self.prefix_fetch_min_pages < 1:
            raise ConfigError("prefix_fetch_min_pages must be >= 1")
        if self.prefix_fetch_timeout_s <= 0:
            raise ConfigError("prefix_fetch_timeout_s must be > 0")
        if self.pipeline_prefill_min_tokens < 0:
            raise ConfigError(
                "pipeline_prefill_min_tokens must be >= 0 (0 disables "
                "pipelined prefill)")
        if self.pipeline_prefill_min_tokens > 0 and not self.prefix_fetch:
            raise ConfigError(
                "pipeline_prefill_min_tokens requires prefix_fetch "
                "(pipeline stages import shipped chunks through the "
                "prefix-fetch plane)")
        if self.pipeline_prefill_max_stages < 2:
            raise ConfigError("pipeline_prefill_max_stages must be >= 2 "
                              "(one stage is just a plain prefill)")
        if self.pipeline_prefill_stage_timeout_ms <= 0:
            raise ConfigError(
                "pipeline_prefill_stage_timeout_ms must be > 0")
        if self.prefix_inventory_max < 0:
            raise ConfigError(
                "prefix_inventory_max must be >= 0 (0 disables the "
                "inventory and therefore all prefix-fetch hints)")
        if self.prefix_inventory_ttl_ms < 0:
            raise ConfigError(
                "prefix_inventory_ttl_ms must be >= 0 (0 = read fresh "
                "per placement)")
        if self.kv_store:
            if not self.prefix_fetch:
                raise ConfigError(
                    "kv_store needs prefix_fetch — the fetch plane is "
                    "how store-held pages restore to a replica")
            if self.kv_store_dram_mb <= 0:
                raise ConfigError("kv_store_dram_mb must be > 0")
        if self.kv_store_disk_mb < 0:
            raise ConfigError("kv_store_disk_mb must be >= 0")
        if self.kv_store_ttl_ms < 0:
            raise ConfigError(
                "kv_store_ttl_ms must be >= 0 (0 = no expiry)")
        if self.kv_store_endpoint and not str(
                self.kv_store_endpoint).startswith(
                    ("http://", "https://")):
            raise ConfigError(
                f"kv_store_endpoint must be an http(s) base URL, got "
                f"{self.kv_store_endpoint!r}")
        if self.kv_store_endpoint and not self.prefix_fetch:
            raise ConfigError(
                "kv_store_endpoint needs prefix_fetch — the fetch "
                "plane is how store-held pages restore to a replica")
        members = self.kv_store_endpoint_list()
        for ep in ([] if not self.kv_store_endpoints else members):
            if not ep.startswith(("http://", "https://")):
                raise ConfigError(
                    f"kv_store_endpoints entries must be http(s) base "
                    f"URLs, got {ep!r}")
        if self.kv_store_endpoints and not self.prefix_fetch:
            raise ConfigError(
                "kv_store_endpoints needs prefix_fetch — the fetch "
                "plane is how store-held pages restore to a replica")
        if self.kv_store_retry_max < 0:
            raise ConfigError(
                "kv_store_retry_max must be >= 0 (0 = fail on the "
                "first refusal, the PR-16 behavior)")
        if self.kv_store_retry_backoff_ms < 0:
            raise ConfigError("kv_store_retry_backoff_ms must be >= 0")
        if self.kv_store_hedge_ms < 0:
            raise ConfigError(
                "kv_store_hedge_ms must be >= 0 (0 disables hedged "
                "fetches)")
        if self.kv_store_write_ack < 1:
            raise ConfigError(
                "kv_store_write_ack must be >= 1 (at least one member "
                "must durably hold a write before it is acknowledged)")
        if members and self.kv_store_write_ack > len(members):
            raise ConfigError(
                f"kv_store_write_ack ({self.kv_store_write_ack}) "
                f"exceeds the store-tier member count ({len(members)})")
        if self.state_compact_every < 0:
            raise ConfigError(
                "state_compact_every must be >= 0 (0 disables journal "
                "compaction)")
        if self.stream_log_ttl_ms < 0:
            raise ConfigError(
                "stream_log_ttl_ms must be >= 0 (0 keeps finished "
                "stream logs forever)")
        if self.stream_max_buffered_batches < 0:
            raise ConfigError(
                "stream_max_buffered_batches must be >= 0 (0 disables "
                "the per-subscriber backpressure cap)")
        if self.state_store not in ("memory", "file"):
            raise ConfigError(
                f"unknown state_store {self.state_store!r} "
                f"(memory|file)")
        if self.state_store == "file" and not self.state_store_dir:
            raise ConfigError(
                "state_store=file needs state_store_dir (the shared "
                "directory every front folds the journal from)")
        if self.fronts < 1:
            raise ConfigError("fleet fronts must be >= 1")
        if self.fronts > 1:
            if self.state_store != "file":
                raise ConfigError(
                    "fronts > 1 needs state_store=file — stateless "
                    "fronts must share the stream log and ledger")
            if len(self.remote_replica_ids()) < self.replicas:
                raise ConfigError(
                    "fronts > 1 needs every replica remote "
                    "(remote_replicas) — a front holding in-process "
                    "engines is not stateless")
        endpoints = self.endpoint_map()       # raises on malformed entries
        for rid in endpoints:
            # -1 is the KV_STORE_OWNER sentinel: the networked store
            # service's endpoint rides the same map ("store=URL")
            if rid != -1 and not 0 <= rid < self.replicas:
                raise ConfigError(
                    f"fleet endpoint names replica {rid} but the fleet "
                    f"has replicas 0..{self.replicas - 1}")
        remote = self.remote_replica_ids()
        for rid in sorted(remote):
            if not 0 <= rid < self.replicas:
                raise ConfigError(
                    f"remote_replicas names replica {rid} but the fleet "
                    f"has replicas 0..{self.replicas - 1}")
            if rid not in endpoints:
                raise ConfigError(
                    f"remote replica {rid} has no fleet endpoint — every "
                    f"remote replica needs a fleet_endpoints entry "
                    f"(--fleet-endpoint {rid}=http://host:port)")
        if self.courier_max_retries < 0:
            raise ConfigError("courier_max_retries must be >= 0")
        if self.courier_retry_backoff_ms < 0 \
                or self.courier_retry_backoff_max_ms < 0:
            raise ConfigError("courier retry backoff values must be >= 0")
        if self.courier_chunk_deadline_ms <= 0:
            raise ConfigError("courier_chunk_deadline_ms must be > 0")
        if self.autoscale_min_replicas < 1:
            raise ConfigError(
                "autoscale_min_replicas must be >= 1 — the scale-down "
                "floor keeps at least one replica serving")
        if self.autoscale_max_replicas and \
                self.autoscale_max_replicas < self.autoscale_min_replicas:
            raise ConfigError(
                "autoscale_max_replicas must be >= autoscale_min_replicas "
                "(0 = default ceiling of 2x the provisioned fleet)")
        if self.autoscale_up_queue_per_replica <= 0 \
                or self.autoscale_down_queue_per_replica < 0:
            raise ConfigError(
                "autoscale_up_queue_per_replica must be > 0 and "
                "autoscale_down_queue_per_replica >= 0")
        if self.autoscale_down_queue_per_replica \
                >= self.autoscale_up_queue_per_replica:
            raise ConfigError(
                "autoscale_down_queue_per_replica must be below "
                "autoscale_up_queue_per_replica — overlapping scale "
                "thresholds would oscillate the fleet")
        if self.autoscale_hysteresis_polls < 1:
            raise ConfigError("autoscale_hysteresis_polls must be >= 1")
        if self.autoscale_cooldown_polls < 0:
            raise ConfigError(
                "autoscale_cooldown_polls must be >= 0 (0 = no cooldown)")
        if self.autoscale_spawn_timeout_s <= 0:
            raise ConfigError("autoscale_spawn_timeout_s must be > 0")
        if self.autoscale_spawn not in ("", "engine", "worker"):
            raise ConfigError(
                f"unknown autoscale_spawn {self.autoscale_spawn!r} "
                f"(engine|worker; empty = engine)")
        if not 0 <= self.autoscale_up_free_page_ratio < 1:
            raise ConfigError(
                "autoscale_up_free_page_ratio must be in [0, 1) — it "
                "is a fraction of the KV pool (0 disables pool-"
                "pressure scale-up)")
        if self.autoscale and self.fronts > 1:
            raise ConfigError(
                "autoscale with fronts > 1 is not supported yet — each "
                "front would scale the shared worker set independently")
        if self.priority_headroom_requests < 0:
            raise ConfigError("priority_headroom_requests must be >= 0")
        if self.priority_headroom_requests >= self.max_pending:
            raise ConfigError(
                "priority_headroom_requests must be below max_pending — "
                "reserving every queue slot for interactive traffic "
                "would reject all standard requests")
        if self.interactive_ttft_target_ms < 0:
            raise ConfigError(
                "interactive_ttft_target_ms must be >= 0 (0 disables "
                "TTFT-driven preemption)")

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "FleetConfig":
        if not d:
            return cls()
        kw = {}
        for f_ in dataclasses.fields(cls):
            if f_.name in d:
                if f_.name == "fleet_endpoints":
                    # dict field (default_factory): accepts the TOML
                    # table, the repeated-CLI-flag list, or one string
                    kw[f_.name] = parse_fleet_endpoints(d[f_.name])
                elif isinstance(f_.default, bool):
                    # bool("false") is True — string configs need the shared
                    # parser, same as ServeConfig
                    kw[f_.name] = _parse_bool(f_.name, d[f_.name])
                else:
                    kw[f_.name] = type(f_.default)(d[f_.name])
        cfg = cls(**kw)
        cfg.validate()
        return cfg


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
