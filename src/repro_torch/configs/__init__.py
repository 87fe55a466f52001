from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, cells, get_config,
    list_configs, load_all, register,
)
