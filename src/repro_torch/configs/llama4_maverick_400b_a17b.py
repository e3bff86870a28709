"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 routed top-1 + shared expert, MoE every other layer.

Early-fusion multimodality and iRoPE chunked attention are NOT reproduced
(treated as full attention; see DESIGN.md §Limitations) so long_500k is
skipped. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    attn=AttnConfig(pattern=("global",)),
    moe=MoEConfig(num_experts=128, top_k=1, d_expert=8192, d_shared=8192,
                  every_k_layers=2),
    rope_theta=500000.0,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
))
