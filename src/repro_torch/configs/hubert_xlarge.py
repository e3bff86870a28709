"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504.

Encoder-only transformer (same arch as wav2vec2). The audio conv frontend is
a stub: the model takes precomputed frame embeddings (batch["frames"]).
[arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    norm="layernorm",
    attn=AttnConfig(pattern=("global",), causal=False),
    frontend="audio",
    tie_embeddings=False,
    source="[arXiv:2106.07447; unverified]",
))
