"""Grouped matmul over expert-sorted tokens: the tile map, and the entry
point the MoE layer calls.

The JAX wrapper (``_group_pad``) scatters the sorted tokens into a
padded copy with one TILE_M-aligned slab per expert, so each tile of the
TPU kernel belongs to one expert, and gathers the result back by
``pos``. ``tile_map`` computes the same tile -> expert assignment
(``searchsorted`` over the cumulative tile counts, clipped to E - 1, a
static bound of ceil(T / TILE_M) + E tiles) but names each tile's first
row and row count in the UNPADDED sorted rows, so the kernel needs no
padded copy and no gather back. Tile i of the map is the i-th tile of
``_group_pad``'s layout that holds a row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.moe_gmm import TILE_M, grouped_matmul_cuda
from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref


def tile_map(group_sizes: torch.Tensor, T: int,
             block_m: int = TILE_M) -> torch.Tensor:
    """group_sizes: (E,) -> (ceil(T / block_m) + E, 3) int32 rows of
    (expert, first row, row count); unused entries have a count of 0.
    Rows past sum(group_sizes) belong to expert E - 1 and sizes past T
    are cut, as the reference's clipped searchsorted assigns them. Runs
    on the sizes' device, with no host sync."""
    E = group_sizes.shape[0]
    dev = group_sizes.device
    ends = torch.cumsum(group_sizes.long(), 0).clamp(max=T)
    ends[-1] = T
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    sizes = ends - starts
    n_tiles = (sizes + block_m - 1) // block_m
    tile_end = torch.cumsum(n_tiles, 0)
    bound = -(-T // block_m) + E
    i = torch.arange(bound, device=dev)
    eid = torch.searchsorted(tile_end, i, right=True).clamp(max=E - 1)
    j = i - (tile_end[eid] - n_tiles[eid])          # tile within its group
    rows = (sizes[eid] - j * block_m).clamp(0, block_m)
    return torch.stack([eid, starts[eid] + j * block_m, rows],
                       dim=1).to(torch.int32)


def grouped_matmul(tokens: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """tokens: (T, d) expert-sorted; w: (E, d, f); group_sizes: (E,).
    -> (T, f), out[t] = tokens[t] @ w[expert_of(t)]. The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    dev = tokens.device
    if dev.type == "cpu":
        return grouped_matmul_ref(tokens, w, group_sizes)
    if dev.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for device {dev}")
    tiles = tile_map(group_sizes, tokens.shape[0])
    return grouped_matmul_cuda(tokens.contiguous(), w.contiguous(), tiles)
