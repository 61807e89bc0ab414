"""Configuration: the root training tree and its groups, the structured-config
utilities and the registries (the JAX package's ``config/``)."""
from .configs import (  # noqa: F401
    CheckpointConfig,
    CommonConfig,
    DatasetConfig,
    GenerationConfig,
    MeshConfig,
    OptimizationConfig,
    TrainRootConfig,
)
from .registry import available, lookup, register, register_model, register_task  # noqa: F401
from .structured import MISSING, apply_overrides, from_dict, load_yaml, merge, to_dict  # noqa: F401
