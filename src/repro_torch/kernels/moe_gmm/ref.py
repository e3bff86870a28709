"""Plain torch grouped matmul over expert-sorted tokens.

tokens: (T, d) sorted by expert id; w: (E, d, f); group_sizes: (E,).
out[t] = tokens[t] @ w[expert_of(t)], accumulated in float32, returned in
tokens.dtype. The JAX reference gathers a (d, f) weight per token; this
version multiplies each expert's row range by its weight once, which is
the same function without the (T, d, f) copy. ``grouped_matmul_dw`` is
its weight gradient, the backward's plain half.
"""
from __future__ import annotations

import torch


def expert_of_tokens(group_sizes: torch.Tensor, T: int) -> torch.Tensor:
    """searchsorted(cumsum(sizes), arange(T), right) — unclipped, as in
    the reference."""
    ends = torch.cumsum(group_sizes.long(), 0)
    return torch.searchsorted(ends, torch.arange(T, device=ends.device),
                              right=True)


def expert_rows(group_sizes: torch.Tensor, T: int, E: int):
    """(e, rows) for each expert with rows, ``rows`` the slice of its
    contiguous rows among T. Rows past sum(sizes) clip to E - 1, as the
    reference reads them. One host read of the sizes a call."""
    eid = expert_of_tokens(group_sizes, T).clamp(0, E - 1)
    start = 0
    for e, n in enumerate(torch.bincount(eid, minlength=E).tolist()):
        if n:
            yield e, slice(start, start + n)
        start += n


def grouped_matmul_ref(tokens: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    T, d = tokens.shape
    E, _, f = w.shape
    out = torch.empty((T, f), dtype=tokens.dtype, device=tokens.device)
    # one unbind, not w[e] a group: under autograd each w[e] would write a
    # full-size zero gradient to be summed, unbind stacks the groups' once
    ws = w.unbind(0)
    for e, rows in expert_rows(group_sizes, T, E):
        out[rows] = (tokens[rows].float() @ ws[e].float()).to(out.dtype)
    return out


def grouped_matmul_dw(tokens: torch.Tensor, dy: torch.Tensor,
                      group_sizes: torch.Tensor, E: int,
                      dtype) -> torch.Tensor:
    """dW (E, d, f) of out = grouped_matmul(tokens, w, group_sizes) for
    dY = dout (T, f): dW_e = X_e^T dY_e over expert e's rows, in float32,
    cast to ``dtype``; an empty group's dW is zero."""
    T, d = tokens.shape
    dw = torch.zeros((E, d, dy.shape[1]), dtype=dtype, device=tokens.device)
    for e, rows in expert_rows(group_sizes, T, E):
        dw[e] = (tokens[rows].float().T @ dy[rows].float()).to(dtype)
    return dw
