"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352. [hf:stabilityai/stablelm-2-1_6b; hf]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    norm="layernorm",
    attn=AttnConfig(pattern=("global",)),
    source="[hf:stabilityai/stablelm-2-1_6b; hf]",
))
