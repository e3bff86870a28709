"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144. 5:1 local:global attention, 128k context, window=1024.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    attn=AttnConfig(pattern=("local",) * 5 + ("global",), window=1024),
    rope_theta=1000000.0,
    source="[hf:google/gemma-3-1b-pt; unverified]",
))
