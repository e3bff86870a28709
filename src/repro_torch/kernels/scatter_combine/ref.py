"""Plain torch scatter group-by: the receiver combine (D1) that the CPU
path runs and the CUDA kernel is held to.

A dropped scatter (``mode="drop"`` in the reference) becomes a scatter
into one extra sink row that is sliced off afterwards, so a valid slot
past Np raises here where the kernel drops it. Float sums are taken in
another order than the reference's scatter-add, so they agree to
rounding; min/max agree exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_combine.ref import IDENT

_SCATTER_REDUCE = {"min": "amin", "max": "amax"}


def _rows(index: torch.Tensor, D: int) -> torch.Tensor:
    """(P, M) row index -> (P, M, D) int64 index for dim-1 scatter."""
    return index.long()[..., None].expand(*index.shape, D)


def scatter_combine_ref(slot, payload, valid, Np: int, op: str):
    """slot: (P, M) int; payload: (P, M, D); valid: (P, M) ->
    (dense (P, Np, D), has_msg (P, Np))."""
    ident = IDENT[op]
    P, M, D = payload.shape
    tgt = torch.where(valid, slot, Np)                       # Np = sink
    dense = torch.full((P, Np + 1, D), ident, dtype=payload.dtype,
                       device=payload.device)
    upd = torch.where(valid[..., None], payload, ident)
    if op == "sum":
        dense.scatter_add_(1, _rows(tgt, D), upd)
    else:
        dense.scatter_reduce_(1, _rows(tgt, D), upd, _SCATTER_REDUCE[op],
                              include_self=True)
    has = torch.zeros((P, Np + 1), dtype=torch.bool, device=payload.device)
    has.scatter_(1, tgt.long(), valid)        # invalid rows hit the sink
    return dense[:, :Np], has[:, :Np]
