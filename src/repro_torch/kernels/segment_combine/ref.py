"""Plain torch versions of the segmented combine (sorted-run group-by
fold): the readable oracle, and the replay of the kernel's blocked
schedule that the CPU path runs and the CUDA kernel is held to."""
from __future__ import annotations

import math

import torch

INT32_MAX = 2 ** 31 - 1
IDENT = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def combine_fn(op: str):
    """The monoid; torch.minimum / torch.maximum propagate NaN as the
    reference's jnp.minimum / jnp.maximum do."""
    return {"sum": torch.add, "min": torch.minimum,
            "max": torch.maximum}[op]


def segment_lasts(seg2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """is_last: the last valid row of each run of equal ids."""
    last = torch.ones(1, dtype=torch.bool, device=seg2.device)
    return torch.cat([seg2[1:] != seg2[:-1], last]) & valid


def segment_combine_ref(seg_ids, payload, valid, op: str = "sum"):
    """seg_ids: (M,) int32 sorted; payload: (M, D); valid: (M,).
    -> (folded (M, D), is_last (M,)): folded[i] is the running aggregate
    over seg_ids == seg_ids[i] up to i. A whole-row log-step network:
    exact for min/max, another bracketing of float sums than the kernel."""
    fn = combine_fn(op)
    x = torch.where(valid[:, None], payload, IDENT[op]).float()
    f = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                   seg_ids[1:] != seg_ids[:-1]])
    sh = 1
    while sh < x.shape[0]:
        tail = torch.where(f[sh:, None], x[sh:], fn(x[:-sh], x[sh:]))
        x = torch.cat([x[:sh], tail])
        f = torch.cat([f[:sh], f[sh:] | f[:-sh]])
        sh *= 2
    return x, segment_lasts(seg_ids, valid)


def _tile_network(seg: torch.Tensor, x: torch.Tensor, op: str):
    """The kernel's in-tile segmented inclusive scan, for all tiles at
    once. seg: (T, BM) int32; x: (T, BM, D) float32. The same shifts in
    the same order as the reference's _segmented_scan_tile."""
    fn = combine_fn(op)
    T, BM, D = x.shape
    dev = x.device
    boundary = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=dev),
                          seg[:, 1:] != seg[:, :-1]], dim=1)
    f, v = boundary, x
    for k in range(int(math.ceil(math.log2(max(BM, 2))))):
        sh = 1 << k
        pv = torch.cat([torch.full((T, sh, D), IDENT[op], device=dev),
                        v[:, :-sh]], dim=1)[:, :BM]
        pf = torch.cat([torch.ones((T, sh), dtype=torch.bool, device=dev),
                        f[:, :-sh]], dim=1)[:, :BM]
        v = torch.where(f[..., None], v, fn(pv, v))
        f = f | pf
    return v, boundary


def segment_combine_blocked(seg_ids, payload, valid, op: str = "sum", *,
                            block_m: int = 512):
    """Plain-torch replay of the kernel's EXACT computation order: per-tile
    Hillis-Steele network, then the sequential carry of (last segment id,
    running value) spliced into each tile's first segment — the
    reference's segment_combine_blocked, add for add, so float sums agree
    bit for bit.

    A ragged final tile is padded with (int32 max, identity); the in-tile
    network is causal, so pads cannot reach real rows, and is_last is read
    over the padded stream. The carry is
    computed for all tiles at once where a tile does not continue its
    predecessor's segment, and by a loop over only the tiles that do."""
    fn = combine_fn(op)
    M, D = payload.shape
    dev = payload.device
    BM = min(block_m, M)
    seg2 = torch.where(valid, seg_ids, INT32_MAX)
    pay = torch.where(valid[:, None], payload, IDENT[op]).float()
    T = -(-M // BM)
    pad = T * BM - M
    segp = torch.cat([seg2, torch.full((pad,), INT32_MAX, dtype=seg2.dtype,
                                       device=dev)]).reshape(T, BM)
    payp = torch.cat([pay, torch.full((pad, D), IDENT[op],
                                      device=dev)]).reshape(T, BM, D)
    v, boundary = _tile_network(segp, payp, op)
    first = torch.cumsum(boundary, dim=1) == 1      # first segment's rows
    last_local = v[:, -1, :]
    seg_last = segp[:, -1]
    cseg = torch.cat([torch.full((1,), -2, dtype=segp.dtype, device=dev),
                      seg_last[:-1]])                # carried id into t
    # carry into tile t+1: combine(carry(t), last(t)) when tile t is one
    # segment that continues the carried id, else last(t)
    cont_out = first[:, -1] & (seg_last == cseg)
    carry = torch.cat([torch.full((1, D), IDENT[op], device=dev),
                       last_local[:-1]])
    for t in torch.nonzero(cont_out[:-1]).flatten().tolist():
        carry[t + 1] = fn(carry[t], last_local[t])
    cont = (segp == cseg[:, None]) & first
    v = torch.where(cont[..., None], fn(carry[:, None, :], v), v)
    folded = v.reshape(T * BM, D)[:M]
    # is_last over the padded stream: a ragged stream's last row keyed
    # int32 max continues into the pad, as in the reference
    validp = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                           device=dev)])
    return folded, segment_lasts(segp.reshape(-1), validp)[:M]
