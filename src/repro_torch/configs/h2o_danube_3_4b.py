"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000. llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attn=AttnConfig(pattern=("local",), window=4096),
    source="[arXiv:2401.16818; unverified]",
))
