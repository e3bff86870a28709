"""Kernel choice + the engine-facing kernel entry points.

``resolve`` checks the ``PhysicalPlan.kernel_impl`` knob (auto | ref |
cuda) against the device of the tensors a superstep runs on: on a CUDA
tensor "auto" and "cuda" mean the CUDA kernels and "ref" raises; on a CPU
tensor "auto" and "ref" mean the plain torch versions and "cuda" raises.
There is no fallback from one to the other and no override from the
environment. The rest is the layer the superstep calls: the gather
layout planner, the partition-flattened edge gather, and the blocked
segmented fold. Only the innermost function depends on the device, so a
CPU run walks the control flow of a CUDA run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.plan import KERNEL_IMPLS
from repro_torch.kernels.csr_spmv.csr_spmv import edge_gather
from repro_torch.kernels.csr_spmv.ops import plan_layout_fixed
from repro_torch.kernels.segment_combine.segment_combine import \
    segment_combine

# Engine block sizes: BM is the edge-stream tile, BR the gather's
# row block, COMBINE_BLOCK_M the fold's tile.
GATHER_BLOCK_M = 512
GATHER_BLOCK_R = 256
COMBINE_BLOCK_M = 512

INT32_MAX = 2 ** 31 - 1


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
    if kind == "cpu":
        if impl == "cuda":
            raise ValueError("kernel_impl='cuda' on CPU tensors: load the "
                             "graph with device='cuda'")
        return "ref"
    raise ValueError(f"no kernels for device {device}")


def plan_edge_layout(edge_src, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side gather layout for a (P, Ep) edge_src block over (P,
    n_rows) value rows, the partitions flattened into ONE (P*Ep,) edge
    stream over P*n_rows rows, so one kernel launch serves all of them."""
    edge_src = np.asarray(edge_src)
    P, Ep = edge_src.shape
    off = (np.arange(P, dtype=np.int64) * n_rows)[:, None]
    flat = np.where(edge_src >= 0, edge_src + off, -1).reshape(-1)
    return plan_layout_fixed(flat, P * n_rows, block_m=GATHER_BLOCK_M,
                             block_r=GATHER_BLOCK_R)


def edge_gather_values(values: torch.Tensor, edge_src: torch.Tensor,
                       layout: Optional[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> torch.Tensor:
    """``values[p, edge_src[p, e]]`` per edge. values: (P, Np, V);
    edge_src: (P, Ep), -1 = invalid; layout from ``plan_edge_layout`` (as
    tensors on the values' device). -> (P, Ep, V); invalid lanes read 0.0
    (masked downstream by the edge gate). The gather is exact for every
    float, so no class channel rides along."""
    P, Np, V = values.shape
    Ep = edge_src.shape[1]
    off = (torch.arange(P, dtype=torch.int32, device=values.device)
           * Np)[:, None]
    flat_src = torch.where(edge_src >= 0, edge_src + off, -1).reshape(-1)
    out = edge_gather(values.reshape(P * Np, V), flat_src, None, layout,
                      block_m=GATHER_BLOCK_M, block_r=GATHER_BLOCK_R)
    return out.reshape(P, Ep, V)


def sorted_segment_fold(keys: torch.Tensor, payload: torch.Tensor,
                        valid: torch.Tensor, op: str):
    """Inclusive segmented fold over a key-sorted stream — the engine's
    sender-combine reduction. keys: (M,) ascending, invalid rows keyed
    int32 max at the tail; payload: (M, D). Returns (folded (M, D),
    is_last (M,) — already masked by valid). M is padded to a tile
    multiple, so every tile but a lone short one is full."""
    M, D = payload.shape
    BM = min(COMBINE_BLOCK_M, M)
    pad = (-M) % BM
    if pad:
        dev = payload.device
        keys = torch.cat([keys, torch.full((pad,), INT32_MAX,
                                           dtype=keys.dtype, device=dev)])
        payload = torch.cat([payload, torch.zeros((pad, D),
                                                  dtype=payload.dtype,
                                                  device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    folded, is_last = segment_combine(keys, payload, valid, op,
                                      block_m=BM)
    return folded[:M], is_last[:M]
