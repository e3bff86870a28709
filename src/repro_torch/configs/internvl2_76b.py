"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. The InternViT frontend is a stub: the model takes precomputed
patch embeddings (batch["patch_embeds"]) in place of the first
frontend_len token embeddings.
[arXiv:2404.16821; unverified]
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    attn=AttnConfig(pattern=("global",)),
    frontend="vision",
    frontend_len=256,
    tie_embeddings=False,
    source="[arXiv:2404.16821; unverified]",
))
