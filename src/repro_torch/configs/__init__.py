"""Model configurations (pure dataclasses, copied from the reference)."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    ShapeConfig,
    SSMConfig,
    shape_supported,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    get_config,
    get_reduced,
)
