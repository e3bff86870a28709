"""Group-by operators (paper Section 5.3.1, Figure 7), batched over the
leading partition axis P.

* scatter      — hash group-by analogue: monoid scatter straight into
                 dense vid-slot-aligned buffers (named ops only).
* sort         — sort-based group-by: stable argsort by key + segmented
                 fold (named ops and custom combine UDFs).
* run-combine  — one-pass combine of presorted runs (the receiver side of
                 the m-to-n partitioning MERGING connector).

The scatter group-by runs through ``kernels/backend.py``: the
scatter_combine kernel on CUDA tensors, its plain chain on CPU tensors.
Elsewhere a dropped scatter (``mode="drop"`` in the reference) becomes a
scatter into one extra sink row that is sliced off afterwards. Float
sums are taken in another order than the reference's scatter-add and
``associative_scan``, so they agree to rounding; min/max agree exactly.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import backend as kbackend

INT32_MAX = 2 ** 31 - 1

MONOIDS = {
    "sum": (torch.add, 0.0),
    "min": (torch.minimum, float("inf")),
    "max": (torch.maximum, float("-inf")),
}


def row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum of a (P, n) bool tensor along dim 1, taken
    as ONE flat scan minus each row's offset. torch scans an innermost
    dim with one block per row, so a few long rows (P partitions of Ep
    edges) leave the card nearly idle; a flat scan spreads over it."""
    P, n = mask.shape
    c = torch.cumsum(mask.reshape(-1), 0, dtype=torch.int64).reshape(P, n)
    if P > 1 and n > 0:
        ends = c[:-1, -1]
        c = c - torch.cat([ends.new_zeros(1), ends])[:, None]
    return c


def compact(mask: torch.Tensor, cap: int):
    """O(N) stream compaction per row of a (P, n) mask: indices of True
    entries, -1 padded. Returns (idx (P, cap) int32, count (P,) int32,
    overflow (P,) int32)."""
    P, n = mask.shape
    pos = row_cumsum(mask) - 1
    count = mask.sum(dim=1)
    tgt = torch.where(mask & (pos < cap), pos, cap)          # cap = sink
    idx = torch.full((P, cap + 1), -1, dtype=torch.int32,
                     device=mask.device)
    src = torch.arange(n, dtype=torch.int32,
                       device=mask.device).expand(P, n)
    idx.scatter_(1, tgt, src)
    return (idx[:, :cap], torch.clamp_max(count, cap).to(torch.int32),
            torch.clamp_min(count - cap, 0).to(torch.int32))


def _rows(index: torch.Tensor, D: int) -> torch.Tensor:
    """(P, M) row index -> (P, M, D) int64 index for dim-1 scatter/gather."""
    return index.long()[..., None].expand(*index.shape, D)


# ---------------------------------------------------------------------------
# scatter (hash) group-by -> dense slots
# ---------------------------------------------------------------------------


def scatter_combine_dense(slot, payload, valid, Np: int, op: str):
    """slot: (P, M) int; payload: (P, M, D); valid: (P, M) ->
    (dense (P, Np, D), has_msg (P, Np))."""
    return kbackend.scatter_fold_dense(slot, payload, valid, Np, op)


# ---------------------------------------------------------------------------
# sort-based group-by -> compact unique (slot, payload) runs
# ---------------------------------------------------------------------------


def segmented_fold(flags: torch.Tensor, vals: torch.Tensor,
                   combine: Callable) -> torch.Tensor:
    """Inclusive segmented fold along dim -2 of ``vals`` (..., M, D);
    ``flags`` (..., M) mark segment starts. A Hillis-Steele log-step
    network over the whole row: exact for min/max, a different bracketing
    of float sums than the reference's ``associative_scan``."""
    M = vals.shape[-2]
    f, v = flags, vals
    sh = 1
    while sh < M:
        pv = v[..., :-sh, :]
        pf = f[..., :-sh]
        head_v, tail_v = v[..., :sh, :], v[..., sh:, :]
        head_f, tail_f = f[..., :sh], f[..., sh:]
        tail_v = torch.where(tail_f[..., None], tail_v, combine(pv, tail_v))
        v = torch.cat([head_v, tail_v], dim=-2)
        f = torch.cat([head_f, tail_f | pf], dim=-1)
        sh *= 2
    return v


def _starts(key: torch.Tensor) -> torch.Tensor:
    first = torch.ones(key.shape[:-1] + (1,), dtype=torch.bool,
                       device=key.device)
    return torch.cat([first, key[..., 1:] != key[..., :-1]], dim=-1)


def _lasts(key: torch.Tensor) -> torch.Tensor:
    last = torch.ones(key.shape[:-1] + (1,), dtype=torch.bool,
                      device=key.device)
    return torch.cat([key[..., 1:] != key[..., :-1], last], dim=-1)


def sort_combine(slot, payload, valid, combine: Callable):
    """Stable sort by slot and fold each run. Returns (sorted_slot (P, M),
    folded (P, M, D), is_last (P, M)) where is_last marks one entry per
    group."""
    D = payload.shape[-1]
    key = torch.where(valid, slot, INT32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    ks = torch.gather(key, -1, order)
    ps = torch.gather(payload, -2, _rows(order, D))
    vs = torch.gather(valid, -1, order)
    folded = segmented_fold(_starts(ks), ps, combine)
    return ks, folded, _lasts(ks) & vs


def sort_combine_dense(slot, payload, valid, Np: int, op):
    """Sort group-by materialized to dense slots (full-outer join input).
    ``op`` is a monoid name or a custom ``(combine, identity)`` pair:
    combine is elementwise over (..., D) rows, identity a (D,) tensor."""
    fn, ident = MONOIDS[op] if isinstance(op, str) else op
    P, M, D = payload.shape
    ks, folded, is_last = sort_combine(slot, payload, valid, fn)
    tgt = torch.where(is_last & (ks < Np), ks, Np)           # Np = sink
    dense = torch.empty((P, Np + 1, D), dtype=payload.dtype,
                        device=payload.device)
    dense[:] = torch.as_tensor(ident, dtype=payload.dtype,
                               device=payload.device)
    dense.scatter_(1, _rows(tgt, D), folded)
    has = torch.zeros((P, Np + 1), dtype=torch.bool, device=payload.device)
    has.scatter_(1, tgt.long(), is_last)
    return dense[:, :Np], has[:, :Np]


# ---------------------------------------------------------------------------
# run-combine (receiver of the merging connector): R presorted runs of
# length C per partition; one segmented pass per run, then <= R partials
# per slot are scatter-combined.
# ---------------------------------------------------------------------------


def run_combine_dense(slot_runs, payload_runs, valid_runs, Np: int,
                      op: str):
    """slot_runs: (P, R, C); payload_runs: (P, R, C, D)."""
    fn, _ = MONOIDS[op]
    P, R, C = slot_runs.shape
    key = torch.where(valid_runs, slot_runs, INT32_MAX)
    folded = segmented_fold(_starts(key), payload_runs, fn)
    lasts = _lasts(key) & valid_runs
    return scatter_combine_dense(key.reshape(P, R * C),
                                 folded.reshape(P, R * C, -1),
                                 lasts.reshape(P, R * C), Np, op)
