"""Connectors (paper Section 4): m-to-n partitioning / partitioning-merging
data exchange, with fixed-capacity buckets + validity masks (overflow is
counted and surfaces in GS so the driver can grow capacity).

This slice has one transport: ``exchange_emulated`` (partitions stacked on
the leading axis, exchange = transpose) on one device. The all-to-all
transport across devices comes with the multi-device slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.groupby import row_cumsum

INT32_MAX = 2 ** 31 - 1


def bucket_by_owner(dst, payload, valid, P: int, bucket_cap: int, *,
                    sort_by_dst: bool, partition: str = "hash",
                    capacity: int = 0, presorted: bool = False):
    """Per source partition: route messages into P fixed-capacity buckets.

    dst: (S, K) global vid; payload: (S, K, D); valid: (S, K), for S
    source partitions. sort_by_dst=True is the 'partitioning merging'
    connector (buckets arrive dst-sorted). partition="range" with
    presorted=True (input already dst-sorted) skips the sort — owners are
    contiguous in dst order.
    Returns (b_dst (S,P,C), b_payload (S,P,C,D), b_valid (S,P,C),
    overflow (S,) int32).

    Layout contract: valid entries occupy a PREFIX of each bucket (their
    positions are per-owner ranks 0..count-1); run_host's regrow widens
    runs in place on that basis."""
    S, K = dst.shape
    D = payload.shape[-1]
    dev = dst.device
    if partition == "range":
        owner = torch.where(valid, torch.clamp_max(dst // capacity, P - 1),
                            P)
    else:
        owner = torch.where(valid, dst % P, P)
    if partition == "range" and presorted:
        # dst ascending among valid rows => owners contiguous: positions
        # are rank among valid minus the owner's first rank
        vrank = row_cumsum(valid) - 1
        owner_start = torch.full((S, P + 1), INT32_MAX, dtype=torch.int64,
                                 device=dev)
        owner_start.scatter_reduce_(
            1, owner.long(), torch.where(valid, vrank, INT32_MAX), "amin",
            include_self=True)
        so, sd, sp, sv = owner, dst, payload, valid
        pos = vrank - torch.gather(owner_start, 1, owner.long())
    else:
        if sort_by_dst or partition == "range":
            # stable two-pass radix: by dst, then owner; for range
            # partitioning dst order already groups owners
            o1 = torch.argsort(torch.where(valid, dst, INT32_MAX), dim=1,
                               stable=True)
            if partition == "range":
                order = o1
            else:
                o2 = torch.argsort(torch.gather(owner, 1, o1), dim=1,
                                   stable=True)
                order = torch.gather(o1, 1, o2)
        else:
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
        pos = torch.arange(K, device=dev) - torch.gather(first, 1,
                                                         so.long())
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


def exchange_emulated(b_dst, b_pay, b_val):
    """Stacked-global transport: (P_src, P_dst, C, ...) -> transpose.
    Receiver p sees P_src runs of C messages."""
    return (b_dst.transpose(0, 1), b_pay.transpose(0, 1),
            b_val.transpose(0, 1))
