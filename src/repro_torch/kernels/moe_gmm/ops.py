"""Grouped matmul over expert-sorted tokens: the entry point the MoE
layer calls, and the torch replay of the kernel's tile schedule.

The JAX wrapper (``_group_pad``) scatters the sorted tokens into a
padded copy with one block_m-aligned slab per expert, so each tile of the
TPU kernel belongs to one expert, and gathers the result back by
``pos``. The CUDA kernel computes the same tile -> expert assignment
from the group sizes inside each block, but names each tile's first row
and row count in the UNPADDED sorted rows, so it needs no padded copy and
no gather back. ``tile_map`` replays that assignment (``searchsorted``
over the cumulative tile counts, clipped to E - 1, a static bound of
ceil(T / block_m) + E tiles): tile i of the map is the i-th tile of
``_group_pad``'s layout that holds a row. ``work_tiles`` replays the
bfloat16 kernel's flat work list over (row tile, column tile), which its
persistent blocks walk with a stride of the grid.

``GroupedMatmul`` is the kernel as an autograd Function. Its backward
takes dX = grouped_matmul(dY, W^T) through the SAME kernel, each
expert's weights transposed into a contiguous (E, f, d) copy first (one
more read and write of the weights a call), and dW_e = X_e^T dY_e a group
at a time in plain float32 torch (``ref.grouped_matmul_dw``), as the JAX
package's autodiff of ``grouped_matmul_ref`` computes it; that loop
reads the group sizes on the host, one sync a backward call. The JAX
package has no backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.moe_gmm import (TILE_M, grouped_matmul_cuda,
                                                 tile_n)
from repro_torch.kernels.moe_gmm.ref import (grouped_matmul_dw,
                                             grouped_matmul_ref)


def _groups(group_sizes: torch.Tensor, T: int, block_m: int):
    """(starts, sizes, tiles a group) after the reference's cuts: rows
    past sum(group_sizes) belong to expert E - 1, sizes past T are cut."""
    ends = torch.cumsum(group_sizes.long(), 0).clamp(max=T)
    ends[-1] = T
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    sizes = ends - starts
    return starts, sizes, (sizes + block_m - 1) // block_m


def tile_map(group_sizes: torch.Tensor, T: int,
             block_m: int = TILE_M) -> torch.Tensor:
    """group_sizes: (E,) -> (ceil(T / block_m) + E, 3) int32 rows of
    (expert, first row, row count); unused entries have a count of 0.
    Runs on the sizes' device, with no host sync."""
    E = group_sizes.shape[0]
    starts, sizes, n_tiles = _groups(group_sizes, T, block_m)
    tile_end = torch.cumsum(n_tiles, 0)
    bound = -(-T // block_m) + E
    i = torch.arange(bound, device=group_sizes.device)
    eid = torch.searchsorted(tile_end, i, right=True).clamp(max=E - 1)
    j = i - (tile_end[eid] - n_tiles[eid])          # tile within its group
    rows = (sizes[eid] - j * block_m).clamp(0, block_m)
    return torch.stack([eid, starts[eid] + j * block_m, rows],
                       dim=1).to(torch.int32)


def work_tiles(group_sizes: torch.Tensor, T: int, f: int,
               block_m: int = TILE_M, block_n: int = 0) -> torch.Tensor:
    """The kernel's work list, by its own arithmetic: work tile w is row
    tile w // n_col (the expert whose cumulative tile count first exceeds
    it) and column tile w % n_col, n_col = ceil(f / block_n), block_n 0
    meaning the bfloat16 kernel's ``tile_n(f)``. -> (n_work, 4) int32 rows
    of (expert, first row, row count, first column). Block b of a grid of
    G takes tiles b, b + G, b + 2G, ..."""
    block_n = block_n or tile_n(f)
    starts, sizes, n_tiles = _groups(group_sizes, T, block_m)
    tile_end = torch.cumsum(n_tiles, 0)
    n_col = -(-f // block_n)
    w = torch.arange(int(tile_end[-1]) * n_col, device=group_sizes.device)
    rt = w // n_col
    e = torch.searchsorted(tile_end, rt, right=True)
    j = rt - (tile_end[e] - n_tiles[e])
    rows = torch.minimum(sizes[e] - j * block_m,
                         torch.full_like(j, block_m))
    return torch.stack([e, starts[e] + j * block_m, rows,
                        (w - rt * n_col) * block_n], dim=1).to(torch.int32)


class GroupedMatmul(torch.autograd.Function):
    """``grouped_matmul_cuda(tokens, w, group_sizes)`` with a gradient
    for tokens and w: apply(tokens, w, group_sizes)."""

    @staticmethod
    def forward(ctx, tokens, w, group_sizes):
        ctx.save_for_backward(tokens, w, group_sizes)
        return grouped_matmul_cuda(tokens, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        tokens, w, group_sizes = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_cuda(dy.contiguous(),
                                     w.transpose(1, 2).contiguous(),
                                     group_sizes)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(tokens, dy, group_sizes, w.shape[0],
                                   w.dtype)
        return dx, dw, None


# the operator counter's by_op key of the kernel on meta tensors
META_OP = "moe_gmm.meta"


class GroupedMatmulMeta(torch.autograd.Function):
    """The kernel on meta tensors (no group sizes to read): the output's
    shape, and its work charged to the running counter: 2 d f flops a
    row, the rows and every expert's weights read and the output written
    once; backward dX (the same product on W^T) and dW (2 d f a row, the
    rows and dY read, dW written)."""

    @staticmethod
    def forward(ctx, tokens, w, group_sizes):
        from repro_torch.launch import op_cost
        (T, d), f = tokens.shape, w.shape[-1]
        out = torch.empty((T, f), dtype=tokens.dtype, device=tokens.device)
        io = sum(t.numel() * t.element_size() for t in (tokens, w, out))
        op_cost.charge(META_OP, float(io), 2.0 * T * d * f, matmul=True)
        ctx.like = [(t.shape, t.dtype) for t in (tokens, w)]
        ctx.io = io
        return out

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.launch import op_cost
        ((T, d), _), ((_, _, f), _) = ctx.like
        op_cost.charge(META_OP + ".backward", float(2 * ctx.io),
                       4.0 * T * d * f, matmul=True)
        return tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in ctx.like) + (None,)


def grouped_matmul(tokens: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """tokens: (T, d) expert-sorted; w: (E, d, f); group_sizes: (E,).
    -> (T, f), out[t] = tokens[t] @ w[expert_of(t)]. The kernel on CUDA
    tensors (one launch; differentiable through ``GroupedMatmul``), the
    plain version under autograd on CPU tensors, the output's shape and
    the kernel's charged work on meta tensors (``GroupedMatmulMeta``)."""
    dev = tokens.device
    if dev.type == "cpu":
        return grouped_matmul_ref(tokens, w, group_sizes)
    if dev.type == "meta":       # the operator counter's dry run
        return GroupedMatmulMeta.apply(tokens, w, group_sizes)
    if dev.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for device {dev}")
    return GroupedMatmul.apply(tokens.contiguous(), w.contiguous(),
                               group_sizes.contiguous())
