from repro_torch.kernels.flash_attention.flash_attention import (
    BLOCK_K, BLOCK_Q, FlashAttention, counter, flash_attention,
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_gqa_backward,
                                                     attention_ref,
                                                     attention_tiled)

__all__ = ["BLOCK_K", "BLOCK_Q", "FlashAttention", "attention_gqa_backward",
           "attention_ref", "attention_tiled", "counter", "flash_attention",
           "flash_attention_cuda"]
