from repro_torch.kernels.csr_spmv.csr_spmv import (counter, edge_gather,
                                                   edge_gather_cuda)
from repro_torch.kernels.csr_spmv.ref import edge_gather_ref

__all__ = ["counter", "edge_gather", "edge_gather_cuda", "edge_gather_ref"]
