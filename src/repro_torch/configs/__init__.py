"""Architecture registry of the port: importing this package registers all
configs."""
from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,
                                      REGISTRY, SHAPES, ShapeCell, SSMConfig,
                                      get_config, runnable_cells)

from repro_torch.configs import (falcon_mamba_7b, gemma3_12b,  # noqa: F401
                                 h2o_danube_3_4b, hubert_xlarge,
                                 internvl2_76b, llama4_maverick_400b_a17b,
                                 qwen2_moe_a2_7b, stablelm_12b, yi_34b,
                                 zamba2_1_2b)

ALL_ARCHS = tuple(sorted(REGISTRY.keys()))

__all__ = [
    "AttnConfig", "ModelConfig", "MoEConfig", "SSMConfig", "ShapeCell",
    "SHAPES", "REGISTRY", "ALL_ARCHS", "get_config", "runnable_cells",
]
