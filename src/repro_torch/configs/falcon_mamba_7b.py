"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) d_ff=0
vocab=65024, ssm_state=16. Pure mamba1 blocks. [arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(kind="mamba1", d_state=16, d_conv=4, expand=2, dt_rank=256),
    source="[arXiv:2410.05355; unverified]",
))
