"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=32000, ssm_state=64. Mamba2 backbone + ONE shared attention+MLP block
applied every 6 layers (weight-shared, zamba2-style; the LoRA modulation of
the shared block is simplified away — see DESIGN.md). [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import (AttnConfig, ModelConfig, SSMConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    attn=AttnConfig(pattern=("global",)),
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, chunk=128),
    shared_attn_every=6,
    source="[arXiv:2411.15242; hf]",
))
