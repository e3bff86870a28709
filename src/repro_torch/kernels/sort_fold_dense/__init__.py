from repro_torch.kernels.sort_fold_dense.ref import sort_fold_dense_ref
from repro_torch.kernels.sort_fold_dense.sort_fold_dense import (
    counter, sort_fold_dense, sort_fold_dense_cuda)

__all__ = ["counter", "sort_fold_dense", "sort_fold_dense_cuda",
           "sort_fold_dense_ref"]
