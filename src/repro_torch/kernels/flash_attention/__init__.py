from repro_torch.kernels.flash_attention.flash_attention import (
    counter, flash_attention, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attention_ref", "counter", "flash_attention",
           "flash_attention_cuda"]
