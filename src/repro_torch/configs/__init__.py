"""Architecture registry of the port: importing this package registers
the configs the port runs. The JAX package's other configs (yi-34b,
stablelm-12b, llama4-maverick) are not ported yet."""
from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,
                                      REGISTRY, SSMConfig, get_config)

from repro_torch.configs import (falcon_mamba_7b, gemma3_12b,  # noqa: F401
                                 h2o_danube_3_4b, hubert_xlarge,
                                 internvl2_76b, qwen2_moe_a2_7b,
                                 zamba2_1_2b)

ALL_ARCHS = tuple(sorted(REGISTRY.keys()))

__all__ = ["AttnConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "REGISTRY", "ALL_ARCHS", "get_config"]
