"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408 vocab=151936,
MoE 60 routed top-4 + shared expert (4x merged -> d_shared=5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    attn=AttnConfig(pattern=("global",)),
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408, d_shared=5632,
                  every_k_layers=1),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
))
