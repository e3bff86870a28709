"""Peaks of the card and the bytes the graph kernels need.

A roofline share is the least time the card could take over the time the
kernel took: bytes the algorithm needs over the HBM peak, divided by the
kernel's device time. The bytes count each input the work needs read
once and each output written once, from the benchmark's own edge list and
the algorithm's model of what each superstep sends
(``algorithms/<algorithm>.py`` ``sending_edges``), never from what the
port's code happens to touch, so no share can pass 100 %."""
from __future__ import annotations

import torch

# NVIDIA H100 SXM5 80 GB (data sheet): HBM3 bandwidth, bytes a second
H100_HBM_BYTES_PER_S = 3.35e12
ID_BYTES = 4           # an int32 vertex id
VALUE_BYTES = 4        # a float32 value or payload column


def distinct_owner_dst(src: torch.Tensor, dst: torch.Tensor, n: int,
                       parts: int) -> int:
    """Distinct (src % parts, dst) pairs: the rows a sender combine folds
    a message stream into, one a destination in each sending partition."""
    return int(torch.unique((src % parts) * n + dst).numel())


def fold_bytes(edges: torch.Tensor, n: int, parts: int, masks,
               msg_dims: int) -> float:
    """The sender combine's fold over the supersteps whose sending edges
    ``masks`` gives (``None``: every edge): each message's key and
    payload read once, each folded row's key and payload written once."""
    row = ID_BYTES + VALUE_BYTES * msg_dims
    total = 0.0
    for m in masks:
        src, dst = ((edges[:, 0], edges[:, 1]) if m is None
                    else (edges[m, 0], edges[m, 1]))
        total += row * (src.numel() + distinct_owner_dst(src, dst, n, parts))
    return total


def gather_bytes(edges: torch.Tensor, masks, value_dims: int) -> float:
    """The edge gather over the supersteps that send: each sending edge's
    source id read once, each distinct source's value row read once, one
    value an edge written once."""
    total = 0.0
    for m in masks:
        src = edges[:, 0] if m is None else edges[m, 0]
        total += (ID_BYTES + VALUE_BYTES) * src.numel() + \
            VALUE_BYTES * value_dims * int(torch.unique(src).numel())
    return total


def share_pct(nbytes: float, seconds: float) -> float | None:
    """Percent of the HBM roofline, or None where nothing was timed."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / H100_HBM_BYTES_PER_S / seconds
