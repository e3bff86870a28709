"""Plain torch fold of sorted runs into dense slots (the D1 sort group-by):
the version the CUDA kernel is held to, on CPU tensors and on the card.

It replays the kernel's schedule, which is ``segment_combine_blocked``'s:
each stream cut in tiles of min(512, M) rows, the in-tile network, then
the carry of a run across tiles, oldest first; so a float sum equals the
kernel's bit for bit. The carry is taken for every tile at once, once a
step of the longest chain of tiles that one run of a kept slot spans
whole: a dropped run (the invalid tail, slots outside [0, Np)) carries
nothing that is read.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_combine.ref import (IDENT, INT32_MAX,
                                                     _tile_network,
                                                     combine_fn)


def sort_fold_dense_ref(keys, payload, valid, Np: int, op: str, *,
                        block_m: int = 512):
    """keys: (P, M) int32, each stream ascending with its invalid rows keyed
    int32 max at its tail; payload: (P, M, D) float32; valid: (P, M).
    -> (dense (P, Np, D) float32: each run's fold of its valid rows in
    slot ``key``, the identity where no run arrived; has (P, Np) bool).
    Rows whose slot lies outside [0, Np) are dropped."""
    fn = combine_fn(op)
    ident = IDENT[op]
    P, M, D = payload.shape
    dev = payload.device
    dense = torch.full((P, Np, D), ident, dtype=torch.float32, device=dev)
    has = torch.zeros((P, Np), dtype=torch.bool, device=dev)
    if P == 0 or M == 0 or Np == 0:
        return dense, has
    BM = min(block_m, M)
    T = -(-M // BM)
    pad = T * BM - M
    key = torch.cat([torch.where(valid, keys, INT32_MAX),
                     torch.full((P, pad), INT32_MAX, dtype=keys.dtype,
                                device=dev)], dim=1).reshape(P, T, BM)
    x = torch.cat([torch.where(valid[..., None], payload, ident).float(),
                   torch.full((P, pad, D), ident, device=dev)], dim=1)
    v, boundary = _tile_network(key.reshape(P * T, BM),
                                x.reshape(P * T, BM, D), op)
    v = v.reshape(P, T, BM, D)
    first = (torch.cumsum(boundary, dim=1) == 1).reshape(P, T, BM)
    last = v[:, :, -1, :]                                   # (P, T, D)
    seg_last = key[:, :, -1]
    cseg = torch.cat([torch.full((P, 1), -2, dtype=key.dtype, device=dev),
                      seg_last[:, :-1]], dim=1)       # the id carried into t
    # tile t passes fn(carry in, its last value) on when it is one run
    # that continues a kept slot; else its own last value
    through = first[:, :, -1] & (seg_last == cseg) & (cseg >= 0) & \
        (cseg < Np)
    t_idx = torch.arange(T, device=dev)
    # the tiles of the longest chain: each step fixes one more tile of it
    since = t_idx - torch.cummax(torch.where(through, -1, t_idx),
                                 dim=1).values
    out = last
    for _ in range(int(since.max())):
        carry = torch.cat([torch.full((P, 1, D), ident, device=dev),
                           out[:, :-1]], dim=1)
        out = torch.where(through[..., None], fn(carry, last), last)
    carry = torch.cat([torch.full((P, 1, D), ident, device=dev),
                       out[:, :-1]], dim=1)                 # X_{t-1}
    cont = (key == cseg[..., None]) & first
    v = torch.where(cont[..., None], fn(carry[:, :, None, :], v), v)
    v = v.reshape(P, T * BM, D)[:, :M]
    key = key.reshape(P, T * BM)[:, :M]
    nxt = torch.cat([key[:, 1:], torch.full((P, 1), INT32_MAX,
                                            dtype=key.dtype, device=dev)],
                    dim=1)
    end = (key != nxt) & (key >= 0) & (key < Np)      # a kept run's last row
    p_idx, r_idx = torch.nonzero(end, as_tuple=True)
    slot = key[p_idx, r_idx].long()
    dense[p_idx, slot] = v[p_idx, r_idx]
    has[p_idx, slot] = True
    return dense, has
