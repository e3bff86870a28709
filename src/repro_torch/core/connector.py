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

from repro_torch.kernels import backend as kbackend

INT32_MAX = 2 ** 31 - 1


def bucket_by_owner(dst, payload, valid, P: int, bucket_cap: int, *,
                    sort_by_dst: bool, partition: str = "hash",
                    capacity: int = 0, presorted: bool = False):
    """Per source partition: route messages into P fixed-capacity buckets.

    dst: (S, K) global vid; payload: (S, K, D); valid: (S, K), for S
    source partitions. sort_by_dst=True is the 'partitioning merging'
    connector (buckets arrive dst-sorted); range partitioning keeps dst
    order in its buckets too. presorted=True (input already dst-sorted
    among its valid rows) skips that sort.
    Returns (b_dst (S,P,C), b_payload (S,P,C,D), b_valid (S,P,C),
    overflow (S,) int32).

    Layout contract: valid entries occupy a PREFIX of each bucket (their
    positions are per-owner ranks 0..count-1); run_host's regrow widens
    runs in place on that basis.

    The pack itself is stable (``kbackend.bucket_pack``: the kernel on
    CUDA tensors, the plain chain on CPU and meta ones), so a bucket
    keeps its rows in input order; a stream that must arrive in dst
    order and is not yet takes one stable argsort by dst first."""
    if (sort_by_dst or partition == "range") and not presorted:
        o1 = torch.argsort(torch.where(valid, dst, INT32_MAX), dim=1,
                           stable=True)
        dst = torch.gather(dst, 1, o1)
        payload = torch.gather(payload, 1,
                               o1[..., None].expand(payload.shape))
        valid = torch.gather(valid, 1, o1)
    return kbackend.bucket_pack(dst, payload, valid, P, bucket_cap,
                                partition=partition, capacity=capacity)


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
