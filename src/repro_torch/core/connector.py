"""Connectors (paper Section 4): m-to-n partitioning / partitioning-merging
data exchange, with fixed-capacity buckets + validity masks (overflow is
counted and surfaces in GS so the driver can grow capacity).

Two transports for the same bucketed exchange:
* emulated      — partitions stacked on the leading axis, exchange =
                  transpose (one device: ``run_host``, ``run_jit``);
* all-to-all    — ``torch.distributed.all_to_all_single`` over the ranks
                  of a ``ShardAxis`` (``core/sharded.py``), the
                  counterpart of the reference's ``exchange_shard_map``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

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


@dataclass(frozen=True)
class ShardAxis:
    """The port's shard description (``EngineConfig.axis_name``): this
    process is rank ``rank`` of ``world`` ranks joined in the
    ``torch.distributed`` process ``group`` (None = the default group),
    over ``backend``. Rank w owns the contiguous global partitions
    [w * P/world, (w+1) * P/world)."""
    rank: int
    world: int
    group: Any = field(default=None, compare=False)
    backend: str = "gloo"


def _wire(b_dst, b_pay, b_val):
    """(R, n, C) int32 / (R, n, C, D) float32 / (R, n, C) bool -> the
    (R, n, C, W) uint8 wire slots: dst | payload | valid, W = (1+D)*4+1
    bytes, the reference's message width (bit casts, no conversion)."""
    R, n, C = b_dst.shape
    D = b_pay.shape[-1]
    return torch.cat([
        b_dst.to(torch.int32).contiguous().view(torch.uint8)
        .reshape(R, n, C, 4),
        b_pay.to(torch.float32).contiguous().view(torch.uint8)
        .reshape(R, n, C, 4 * D),
        b_val.to(torch.uint8).reshape(R, n, C, 1)], dim=-1)


def _unwire(w, D: int):
    R, n, C, _ = w.shape
    dst = w[..., :4].contiguous().view(torch.int32).reshape(R, n, C)
    pay = w[..., 4:4 + 4 * D].contiguous().view(torch.float32) \
        .reshape(R, n, C, D)
    return dst, pay, w[..., -1] != 0


def exchange_all_to_all(b_dst, b_pay, b_val, axis: ShardAxis, *,
                        dst_major: bool = True):
    """All-to-all transport: this rank's buckets (R, n_parts, C, ...),
    R resident source rows and one bucket a global destination
    partition, exchanged with ``all_to_all_single`` over ``axis``.

    Rank j owns the destinations [j*n_parts/N, (j+1)*n_parts/N), so the
    bucket axis splits into N contiguous chunks, one a rank. Every slot
    travels as its wire bytes (dst, payload, valid) in ONE collective;
    ``all_to_all_single`` splits dim 0, so the rank-chunk axis is made
    leading and contiguous before the call and the layout restored
    after it.

    The raw result is worker-major: ``y[p, j*chunk + q]`` holds source
    rank j's row p destined to local partition q (``dst_major=False``,
    which the out-of-core sharded driver lands into per-destination inbox
    pages itself). ``dst_major=True`` (R == chunk, the in-memory layout)
    reorders it to ``out[q, s]`` = the run from global source partition
    s = j*R + p into local destination q — element for element the
    ``exchange_emulated`` transpose."""
    import torch.distributed as dist
    R, n_parts, C = b_dst.shape
    D = b_pay.shape[-1]
    N = axis.world
    if n_parts % N:
        raise ValueError(f"{n_parts} bucket partitions do not split over "
                         f"{N} ranks")
    chunk = n_parts // N
    if dst_major and R != chunk:
        raise ValueError(f"dst_major needs one row a local partition: "
                         f"{R} rows, {chunk} partitions a rank")
    w = _wire(b_dst, b_pay, b_val)
    W = w.shape[-1]
    send = w.reshape(R, N, chunk, C, W).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)            # (N src ranks, R, chunk, ...)
    dist.all_to_all_single(recv, send, group=axis.group)
    if dst_major:
        out = recv.permute(2, 0, 1, 3, 4)    # (q, j, p): run s = j*R + p
    else:
        out = recv.permute(1, 0, 2, 3, 4)    # (p, j, q): worker-major
    return _unwire(out.reshape(-1, n_parts, C, W), D)
