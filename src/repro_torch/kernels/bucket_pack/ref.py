"""Plain torch bucket pack: the connector's route into owner buckets that
the CPU path runs and the CUDA kernel is held to.

A stable argsort by owner, gathers by that order, each owner's first
index by ``searchsorted``, and scatters into buckets that carry one extra
sink slot a source for the rows they drop (the reference's
``mode="drop"``), sliced off afterwards. Every row is sorted, gathered
and scattered, valid or not.
"""
from __future__ import annotations

import torch


def bucket_pack_ref(dst, payload, valid, P: int, bucket_cap: int, *,
                    partition: str = "hash", capacity: int = 0):
    """dst: (S, K) global vid; payload: (S, K, D); valid: (S, K). ->
    (b_dst (S, P, C) int32, b_payload (S, P, C, D), b_valid (S, P, C),
    overflow (S,) int32): per source row, each valid row at its owner's
    bucket in input order, the first C of each owner kept, the rest
    counted in overflow; slots past a bucket's count hold -1, 0, False."""
    S, K = dst.shape
    D = payload.shape[-1]
    dev = dst.device
    if partition == "range":
        owner = torch.where(valid, torch.clamp_max(dst // capacity, P - 1),
                            P)
    else:
        owner = torch.where(valid, dst % P, P)
    order = torch.argsort(owner, dim=1, stable=True)
    so = torch.gather(owner, 1, order)
    sd = torch.gather(dst, 1, order)
    sp = torch.gather(payload, 1, order[..., None].expand(S, K, D))
    sv = torch.gather(valid, 1, order)
    # position within owner bucket: index - first index of this owner
    bounds = torch.arange(P + 1, dtype=so.dtype, device=dev)
    first = torch.searchsorted(so.contiguous(),
                               bounds.expand(S, P + 1).contiguous(),
                               side="left")
    pos = torch.arange(K, device=dev) - torch.gather(first, 1, so.long())
    keep = sv & (pos < bucket_cap)
    sink = P * bucket_cap
    flat = torch.where(keep, so.long() * bucket_cap + pos, sink)
    b_dst = torch.full((S, sink + 1), -1, dtype=torch.int32, device=dev)
    b_dst.scatter_(1, flat, sd.to(torch.int32))
    b_pay = torch.zeros((S, sink + 1, D), dtype=payload.dtype, device=dev)
    b_pay.scatter_(1, flat[..., None].expand(S, K, D), sp)
    b_val = torch.zeros((S, sink + 1), dtype=torch.bool, device=dev)
    b_val.scatter_(1, flat, keep)
    overflow = (sv & (pos >= bucket_cap)).sum(dim=1).to(torch.int32)
    return (b_dst[:, :-1].reshape(S, P, bucket_cap),
            b_pay[:, :-1].reshape(S, P, bucket_cap, D),
            b_val[:, :-1].reshape(S, P, bucket_cap),
            overflow)
