"""Hot-path kernels of the port: each one a hand-written CUDA kernel for
Hopper (``csrc/``) behind a wrapper that launches it on CUDA tensors and
runs its plain torch version on CPU tensors."""
from repro_torch.kernels import backend, build
from repro_torch.kernels.csr_spmv import counter as _gather_counter
from repro_torch.kernels.flash_attention import counter as _flash_counter
from repro_torch.kernels.moe_gmm import counter as _gmm_counter
from repro_torch.kernels.scatter_combine import counter as _scatter_counter
from repro_torch.kernels.segment_combine import counter as _fold_counter

# launch counts of each kernel, by name
COUNTERS = {"segment_combine": _fold_counter, "csr_spmv": _gather_counter,
            "scatter_combine": _scatter_counter,
            "flash_attention": _flash_counter, "moe_gmm": _gmm_counter}

__all__ = ["COUNTERS", "backend", "build"]
