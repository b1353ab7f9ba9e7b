"""Typed config layer of the port: schemas, validation, model templates."""

from .schema import (  # noqa: F401
    CheckpointConfig,
    ConfigError,
    DataConfig,
    HardwareConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    ParallelConfig,
    RopeConfig,
    RunConfig,
    SchedulerConfig,
    ServeConfig,
    TrainingConfig,
)
from .presets import (  # noqa: F401
    MODEL_TEMPLATES,
    TEST_TEMPLATES,
    get_model_config,
)
