"""Kernel choice + the engine-facing kernel entry points.

``resolve`` checks the ``PhysicalPlan.kernel_impl`` knob (auto | ref |
cuda) against the device of the tensors a superstep runs on: on a CUDA
tensor "auto" and "cuda" mean the CUDA kernels and "ref" raises; on a CPU
tensor "auto" and "ref" mean the plain torch versions and "cuda" raises;
a ``meta`` tensor (shapes only, for the operator counter) takes the plain
path.
There is no fallback from one to the other and no override from the
environment. The rest is the layer the superstep calls: the
partition-flattened edge gather, the batched blocked segmented fold and
the receiver's scatter and sorted-run folds into dense slots.
Only the innermost function depends on the device, so a CPU run walks
the control flow of a CUDA run. ``plan_edge_layout`` is the port's copy
of the reference's host layout for its row-blocked gather; no superstep
calls it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.plan import KERNEL_IMPLS
from repro_torch.kernels.csr_spmv.csr_spmv import edge_gather
from repro_torch.kernels.csr_spmv.ops import plan_layout_fixed
from repro_torch.kernels.scatter_combine.scatter_combine import \
    scatter_combine
from repro_torch.kernels.segment_combine.segment_combine import \
    segment_combine
from repro_torch.kernels.sort_fold_dense.sort_fold_dense import \
    sort_fold_dense

# Block sizes: GATHER_BLOCK_M / GATHER_BLOCK_R are the reference
# layout's tile and row block (plan_edge_layout), COMBINE_BLOCK_M the
# fold's tile.
GATHER_BLOCK_M = 512
GATHER_BLOCK_R = 256
COMBINE_BLOCK_M = 512

def resolve(impl: str, device) -> str:
    """-> "cuda" or "ref" for tensors on ``device``; raises where the
    knob and the device disagree."""
    if impl not in KERNEL_IMPLS:
        raise ValueError(
            f"kernel_impl={impl!r}: expected one of {KERNEL_IMPLS}")
    kind = torch.device(device).type
    if kind == "cuda":
        if impl == "ref":
            raise ValueError("kernel_impl='ref' on CUDA tensors: the plain "
                             "versions serve CPU tensors only")
        return "cuda"
    # meta tensors hold shapes without data: the operator counter's probe
    # supersteps (launch/op_cost.py) walk the plain path
    if kind in ("cpu", "meta"):
        if impl == "cuda":
            raise ValueError(f"kernel_impl='cuda' on {kind} tensors: load "
                             "the graph with device='cuda'")
        return "ref"
    raise ValueError(f"no kernels for device {device}")


def plan_edge_layout(edge_src, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's host-side gather layout for a (P, Ep) edge_src
    block over (P, n_rows) value rows, the partitions flattened into ONE
    (P*Ep,) edge stream over P*n_rows rows (the JAX engine's
    ``plan_edge_layout``, element for element). The port's gather walks
    the edges in their own order and reads no layout."""
    edge_src = np.asarray(edge_src)
    P, Ep = edge_src.shape
    off = (np.arange(P, dtype=np.int64) * n_rows)[:, None]
    flat = np.where(edge_src >= 0, edge_src + off, -1).reshape(-1)
    return plan_layout_fixed(flat, P * n_rows, block_m=GATHER_BLOCK_M,
                             block_r=GATHER_BLOCK_R)


def edge_gather_values(values: torch.Tensor,
                       edge_src: torch.Tensor) -> torch.Tensor:
    """``values[p, edge_src[p, e]]`` per edge. values: (P, Np, V);
    edge_src: (P, Ep), -1 = invalid. -> (P, Ep, V); invalid lanes read
    0.0 (masked downstream by the edge gate). The partitions are
    flattened into one edge stream over P * Np rows, one kernel launch.
    The gather is exact for every float, so no class channel rides
    along."""
    P, Np, V = values.shape
    Ep = edge_src.shape[1]
    off = (torch.arange(P, dtype=torch.int32, device=values.device)
           * Np)[:, None]
    flat_src = torch.where(edge_src >= 0, edge_src + off, -1).reshape(-1)
    out = edge_gather(values.reshape(P * Np, V), flat_src, None)
    return out.reshape(P, Ep, V)


def sorted_segment_fold(keys: torch.Tensor, payload: torch.Tensor,
                        valid: torch.Tensor, op: str):
    """Inclusive segmented fold over P key-sorted streams at once — the
    engine's sender-combine reduction. keys: (P, M), each row ascending
    with its invalid rows keyed int32 max at the tail; payload: (P, M,
    D); valid: (P, M). Returns (folded (P, M, D), is_last (P, M) —
    already masked by valid): each partition folded on its own in tiles
    of min(512, M) rows, a ragged last tile padded with (int32 max,
    identity) as the reference's padding does. One kernel launch on CUDA
    tensors."""
    return segment_combine(keys, payload, valid, op,
                           block_m=COMBINE_BLOCK_M)


def scatter_fold_dense(slot: torch.Tensor, payload: torch.Tensor,
                       valid: torch.Tensor, Np: int, op: str):
    """The receiver group-by of a named monoid (D1): fold each valid
    row's payload into dense slot ``slot`` of its partition. slot: (P, M)
    int; payload: (P, M, D); valid: (P, M). Returns (dense (P, Np, D),
    the identity where no valid row arrived; has (P, Np)). On CUDA
    tensors one kernel call (a fill and a pass over the rows) in which
    invalid rows, and valid ones whose slot lies outside [0, Np), write
    nothing; on CPU and meta tensors the plain scatter chain."""
    return scatter_combine(slot, payload, valid, Np, op)


def sorted_fold_dense(keys: torch.Tensor, payload: torch.Tensor,
                      valid: torch.Tensor, Np: int, op: str):
    """The receiver's sort group-by of a named monoid (D1), after its
    sort: fold each run of the P key-sorted streams into dense slot
    ``key`` of its partition. keys: (P, M) int32, each row ascending with
    its invalid rows keyed int32 max at the tail; payload: (P, M, D);
    valid: (P, M). Returns (dense (P, Np, D), the identity where no valid
    row arrived; has (P, Np)); keys outside [0, Np) are dropped. On CUDA
    tensors one kernel call (a fill and one pass with the fold's
    look-back, in the blocked schedule's brackets), in which only the
    last row of each kept run writes and the dropped tail is not read
    past one id a tile; on CPU tensors its plain replay."""
    return sort_fold_dense(keys, payload, valid, Np, op)
