"""Plugin layer: autotuning (the JAX package's ``plugins/``)."""

from .autotuning import (
    AttentionTuner,
    AutoTuner,
    CollectiveTuner,
    MatMulTuner,
    Tunable,
    TuningConfig,
    TuningResult,
    create_auto_tuner,
)

__all__ = [
    "AttentionTuner",
    "AutoTuner",
    "CollectiveTuner",
    "MatMulTuner",
    "Tunable",
    "TuningConfig",
    "TuningResult",
    "create_auto_tuner",
]
