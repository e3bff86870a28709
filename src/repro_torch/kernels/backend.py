"""The engine-facing kernel entry points: the partition-flattened edge
gather, the batched blocked segmented fold, the receiver's scatter
and sorted-run folds into dense slots, and the connector's bucket pack.

The device of the tensors chooses the implementation, and nothing else
does: each kernel wrapper launches its CUDA kernel on CUDA tensors and
runs its plain torch version on CPU tensors. The gather, the segmented
fold, the scatter fold and the bucket pack also take ``meta`` tensors
(shapes only, the operator counter's probe supersteps) down the plain
path; the sort group-by calls ``sorted_fold_dense`` on CUDA tensors
only. Any other device raises in the wrapper (``no kernel for device
...``); there is no fallback from one path to the other and no
override. Only the innermost function depends on the device, so a CPU
run walks the control flow of a CUDA run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bucket_pack.bucket_pack import bucket_pack
from repro_torch.kernels.csr_spmv.csr_spmv import edge_gather
from repro_torch.kernels.scatter_combine.scatter_combine import \
    scatter_combine
from repro_torch.kernels.segment_combine.segment_combine import \
    segment_combine
from repro_torch.kernels.sort_fold_dense.sort_fold_dense import \
    sort_fold_dense

# the blocked segmented fold's tile
COMBINE_BLOCK_M = 512


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
