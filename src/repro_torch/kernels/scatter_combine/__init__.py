from repro_torch.kernels.scatter_combine.ref import scatter_combine_ref
from repro_torch.kernels.scatter_combine.scatter_combine import (
    counter, scatter_combine, scatter_combine_cuda)

__all__ = ["counter", "scatter_combine", "scatter_combine_cuda",
           "scatter_combine_ref"]
