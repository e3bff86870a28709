"""Host-side layout of the row-blocked edge gather (numpy, one-off per
graph): edges sorted by source row and padded so that each BM-slot tile
reads rows of one BR-row block. The port's own copy of the reference's
``csr_spmv/ops.py`` layout functions, element for element."""
from __future__ import annotations

import numpy as np


def plan_layout(edge_src: np.ndarray, n_rows: int, *, block_m: int = 512,
                block_r: int = 256):
    """Pad each row-block's edge range to a BM multiple. Returns
    (perm (Ep,) int64 padded slot -> original edge or -1,
    tile_row (n_tiles,) int32)."""
    edge_src = np.asarray(edge_src)
    E = len(edge_src)
    order = np.argsort(np.where(edge_src >= 0, edge_src, n_rows),
                       kind="stable")
    src_sorted = edge_src[order]
    n_blocks = (n_rows + block_r - 1) // block_r
    blk_ids = np.where(src_sorted >= 0, src_sorted // block_r, n_blocks)
    counts = np.bincount(blk_ids, minlength=n_blocks + 1)[:n_blocks]
    padded = ((counts + block_m - 1) // block_m) * block_m
    padded = np.maximum(padded, 0)
    p_starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    Ep = int(np.sum(padded)) or block_m
    perm = np.full(Ep, -1, np.int64)
    valid_e = src_sorted >= 0
    blk = np.minimum(blk_ids, n_blocks - 1)
    pos = np.arange(E) - starts[blk] + p_starts[blk]
    perm[pos[valid_e]] = order[valid_e]
    tile_row = np.repeat(np.arange(n_blocks), padded // block_m) \
        .astype(np.int32)
    if len(tile_row) == 0:
        tile_row = np.zeros(Ep // block_m, np.int32)
    return perm, tile_row


def layout_capacity(n_edge_slots: int, n_rows: int, *, block_m: int = 512,
                    block_r: int = 256) -> int:
    """Worst-case padded slot count of ``plan_layout``: E rounded up plus
    one block per row block. A function of shapes only."""
    n_blocks = (n_rows + block_r - 1) // block_r
    cap = ((n_edge_slots + block_m - 1) // block_m + n_blocks) * block_m
    return max(cap, block_m)


def plan_layout_fixed(edge_src: np.ndarray, n_rows: int, *,
                      block_m: int = 512, block_r: int = 256):
    """``plan_layout`` padded to shapes that depend only on (len(edge_src),
    n_rows, block_m, block_r). Pad slots carry perm = -1 and tile_row = 0.
    perm is int32."""
    perm, tile_row = plan_layout(edge_src, n_rows, block_m=block_m,
                                 block_r=block_r)
    cap = layout_capacity(len(edge_src), n_rows, block_m=block_m,
                          block_r=block_r)
    perm_f = np.full(cap, -1, np.int32)
    perm_f[:len(perm)] = perm
    tile_f = np.zeros(cap // block_m, np.int32)
    tile_f[:len(tile_row)] = tile_row
    return perm_f, tile_f
