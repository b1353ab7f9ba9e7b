"""Built-in model templates (the JAX package's ``config/presets.py`` table,
entry for entry; held equal by tests/test_torch_config.py) and hardware
presets: JAX's TPU presets field for field (the planner's tests price
them), and the card's counterparts ``h100-1`` and ``h100-8``."""

from __future__ import annotations

import copy

from .schema import HardwareConfig, ModelConfig, MoEConfig, RopeConfig

MODEL_TEMPLATES: dict[str, ModelConfig] = {
    "gpt-125m": ModelConfig(
        name="gpt-125m", num_layers=12, hidden_size=768, ffn_size=2048,
        num_heads=12, num_kv_heads=12, head_dim=64, vocab_size=50304,
        max_position_embeddings=2048, activation="silu",
        tie_word_embeddings=True,
    ),
    "gpt-350m": ModelConfig(
        name="gpt-350m", num_layers=24, hidden_size=1024, ffn_size=2816,
        num_heads=16, num_kv_heads=16, head_dim=64, vocab_size=50304,
        max_position_embeddings=2048, activation="silu",
        tie_word_embeddings=True,
    ),
    "gpt-750m": ModelConfig(
        name="gpt-750m", num_layers=12, hidden_size=2048, ffn_size=5632,
        num_heads=16, num_kv_heads=16, head_dim=128, vocab_size=50304,
        max_position_embeddings=4096, activation="silu",
        tie_word_embeddings=True,
    ),
    "gpt-1b": ModelConfig(
        name="gpt-1b", num_layers=24, hidden_size=2048, ffn_size=5632,
        num_heads=16, num_kv_heads=16, head_dim=128, vocab_size=50304,
        max_position_embeddings=4096, activation="silu",
    ),
    "gpt-7b": ModelConfig(
        name="gpt-7b", num_layers=32, hidden_size=4096, ffn_size=11008,
        num_heads=32, num_kv_heads=32, head_dim=128, vocab_size=50304,
        max_position_embeddings=4096, activation="silu",
    ),
    "gpt-13b": ModelConfig(
        name="gpt-13b", num_layers=40, hidden_size=5120, ffn_size=13824,
        num_heads=40, num_kv_heads=40, head_dim=128, vocab_size=50304,
        max_position_embeddings=4096, activation="silu",
    ),
    "llama-7b": ModelConfig(
        name="llama-7b", num_layers=32, hidden_size=4096, ffn_size=11008,
        num_heads=32, num_kv_heads=32, head_dim=128, vocab_size=32000,
        max_position_embeddings=4096, activation="silu", norm_eps=1e-5,
        rope=RopeConfig(base=10000.0, scaling="linear"),
        tie_word_embeddings=False,
    ),
    # GQA-8, 128k vocab, rope base 5e5: the serving path's full-width model
    # (chip_smoke.py drives it on the card)
    "llama-8b-gqa": ModelConfig(
        name="llama-8b-gqa", num_layers=32, hidden_size=4096, ffn_size=14336,
        num_heads=32, num_kv_heads=8, head_dim=128, vocab_size=128256,
        max_position_embeddings=8192, activation="silu", norm_eps=1e-5,
        rope=RopeConfig(base=500000.0),
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", num_layers=32, hidden_size=4096, ffn_size=14336,
        num_heads=32, num_kv_heads=8, head_dim=128, vocab_size=32000,
        max_position_embeddings=32768, activation="silu", norm_eps=1e-5,
        rope=RopeConfig(base=1000000.0),
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", num_layers=28, hidden_size=3584, ffn_size=18944,
        num_heads=28, num_kv_heads=4, head_dim=128, vocab_size=152064,
        max_position_embeddings=32768, activation="silu", norm_eps=1e-6,
        rope=RopeConfig(base=1000000.0), attention_bias=True,
    ),
    "gpt-moe-8x1b": ModelConfig(
        name="gpt-moe-8x1b", num_layers=16, hidden_size=2048, ffn_size=5632,
        num_heads=16, num_kv_heads=16, head_dim=128, vocab_size=50304,
        max_position_embeddings=4096, activation="silu",
        moe=MoEConfig(num_experts=8, experts_per_token=2),
    ),
    "gpt-7b-4l": ModelConfig(
        name="gpt-7b-4l", num_layers=4, hidden_size=4096, ffn_size=11008,
        num_heads=32, num_kv_heads=32, head_dim=128, vocab_size=50304,
        max_position_embeddings=4096, activation="silu",
    ),
    "gpt-moe-1b": ModelConfig(
        name="gpt-moe-1b", num_layers=12, hidden_size=1024, ffn_size=2816,
        num_heads=8, num_kv_heads=8, head_dim=128, vocab_size=50304,
        max_position_embeddings=4096, activation="silu",
        moe=MoEConfig(num_experts=8, experts_per_token=2),
    ),
}

# Tiny models for tests (not listed in user-facing templates).
TEST_TEMPLATES: dict[str, ModelConfig] = {
    "gpt-test": ModelConfig(
        name="gpt-test", num_layers=2, hidden_size=64, ffn_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=256,
        max_position_embeddings=128, activation="silu", dtype="float32",
    ),
    "gpt-test-moe": ModelConfig(
        name="gpt-test-moe", num_layers=2, hidden_size=64, ffn_size=128,
        num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=256,
        max_position_embeddings=128, activation="silu", dtype="float32",
        moe=MoEConfig(num_experts=4, experts_per_token=2),
    ),
}


def get_model_config(name: str) -> ModelConfig:
    """Look up a template by name (also accepts test templates). Returns a
    deep copy so callers can mutate it freely."""
    if name in MODEL_TEMPLATES:
        return copy.deepcopy(MODEL_TEMPLATES[name])
    if name in TEST_TEMPLATES:
        return copy.deepcopy(TEST_TEMPLATES[name])
    raise KeyError(
        f"unknown model template {name!r}; available: "
        f"{sorted(MODEL_TEMPLATES)} (+test: {sorted(TEST_TEMPLATES)})")


# ---------------------------------------------------------------------------
# Hardware presets: the JAX package's TPU presets (public v4/v5e/v5p data
# sheet figures, its defaults for the fields they leave out: platform tpu,
# DCN 25 GB/s), and one H100 SXM host of 1 or 8 cards (HardwareConfig's
# defaults: NVIDIA's data sheet; the 8 cards NVLink all to all)
# ---------------------------------------------------------------------------

def _tpu(**kw) -> HardwareConfig:
    return HardwareConfig(**{"platform": "tpu", "dcn_bw_gbps": 25.0, **kw})


HARDWARE_PRESETS: dict[str, HardwareConfig] = {
    "v5e-1": _tpu(chip_type="v5e", num_chips=1, num_hosts=1,
                  hbm_gb_per_chip=16, peak_bf16_tflops=197,
                  hbm_bw_gbps=819, ici_bw_gbps=186, topology="1x1"),
    "v5e-4": _tpu(chip_type="v5e", num_chips=4, num_hosts=1,
                  hbm_gb_per_chip=16, peak_bf16_tflops=197,
                  hbm_bw_gbps=819, ici_bw_gbps=186, topology="2x2"),
    "v5e-8": _tpu(chip_type="v5e", num_chips=8, num_hosts=1,
                  hbm_gb_per_chip=16, peak_bf16_tflops=197,
                  hbm_bw_gbps=819, ici_bw_gbps=186, topology="2x4"),
    "v5e-64": _tpu(chip_type="v5e", num_chips=64, num_hosts=8,
                   hbm_gb_per_chip=16, peak_bf16_tflops=197,
                   hbm_bw_gbps=819, ici_bw_gbps=186, topology="8x8"),
    "v5e-256": _tpu(chip_type="v5e", num_chips=256, num_hosts=32,
                    hbm_gb_per_chip=16, peak_bf16_tflops=197,
                    hbm_bw_gbps=819, ici_bw_gbps=186, topology="16x16"),
    "v4-8": _tpu(chip_type="v4", num_chips=4, num_hosts=1,
                 hbm_gb_per_chip=32, peak_bf16_tflops=275,
                 hbm_bw_gbps=1228, ici_bw_gbps=448, topology="2x2x1"),
    "v5p-8": _tpu(chip_type="v5p", num_chips=4, num_hosts=1,
                  hbm_gb_per_chip=95, peak_bf16_tflops=459,
                  hbm_bw_gbps=2765, ici_bw_gbps=600, topology="2x2x1"),
    "cpu-8": HardwareConfig(platform="cpu", chip_type="cpu-fake",
                            num_chips=8, num_hosts=1, hbm_gb_per_chip=4,
                            peak_bf16_tflops=0.2, hbm_bw_gbps=50,
                            ici_bw_gbps=10, dcn_bw_gbps=25.0, topology="8"),
    "h100-1": HardwareConfig(num_chips=1, topology="1"),
    "h100-8": HardwareConfig(num_chips=8, topology="8"),
}


def get_hardware_preset(name: str) -> HardwareConfig:
    if name not in HARDWARE_PRESETS:
        raise KeyError(f"unknown hardware preset {name!r}; available: "
                       f"{sorted(HARDWARE_PRESETS)}")
    return HARDWARE_PRESETS[name]
