from repro_torch.kernels.moe_gmm.moe_gmm import (TILE_M, counter,
                                                 grouped_matmul_cuda, tile_n)
from repro_torch.kernels.moe_gmm.ops import (GroupedMatmul, grouped_matmul,
                                             tile_map, work_tiles)
from repro_torch.kernels.moe_gmm.ref import (grouped_matmul_dw,
                                             grouped_matmul_ref)

__all__ = ["GroupedMatmul", "TILE_M", "counter", "grouped_matmul",
           "grouped_matmul_cuda", "grouped_matmul_dw", "grouped_matmul_ref",
           "tile_map", "tile_n", "work_tiles"]
