"""Plain torch grouped matmul over expert-sorted tokens.

tokens: (T, d) sorted by expert id; w: (E, d, f); group_sizes: (E,).
out[t] = tokens[t] @ w[expert_of(t)], accumulated in float32, returned in
tokens.dtype. The JAX reference gathers a (d, f) weight per token; this
version multiplies each expert's row range by its weight once, which is
the same function without the (T, d, f) copy.
"""
from __future__ import annotations

import torch


def expert_of_tokens(group_sizes: torch.Tensor, T: int) -> torch.Tensor:
    """searchsorted(cumsum(sizes), arange(T), right) — unclipped, as in
    the reference."""
    ends = torch.cumsum(group_sizes.long(), 0)
    return torch.searchsorted(ends, torch.arange(T, device=ends.device),
                              right=True)


def grouped_matmul_ref(tokens: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    T, d = tokens.shape
    E, _, f = w.shape
    eid = expert_of_tokens(group_sizes, T).clamp(0, E - 1)
    out = torch.empty((T, f), dtype=tokens.dtype, device=tokens.device)
    # rows of expert e are contiguous; rows past sum(sizes) clip to E-1
    counts = torch.bincount(eid, minlength=E).tolist()
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = slice(start, start + n)
            out[rows] = (tokens[rows].float() @ w[e].float()).to(out.dtype)
        start += n
    return out
