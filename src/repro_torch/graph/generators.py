"""Synthetic graph generators (numpy only) — the port's own copy of
``repro.graph.generators``: stand-ins for the paper's Webmap (power-law
web crawl) and BTC (semantic graph, near-uniform degree) datasets, plus
the random-walk down-sampler the paper used to build Webmap samples.
"""
from __future__ import annotations

import numpy as np


def rmat_graph(n_vertices: int, n_edges: int, *, seed: int = 0,
               a=0.57, b=0.19, c=0.19) -> np.ndarray:
    """R-MAT power-law generator (Graph500's a/b/c; Webmap stand-in).
    Self-loops are dropped. -> (E, 2) int64."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n_vertices, 2))))
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for lvl in range(scale):
        r = rng.random(n_edges)
        go_right_src = r > (a + b)                 # c + d quadrants
        go_right_dst = ((r > a) & (r <= a + b)) | (r > a + b + c)
        src |= go_right_src.astype(np.int64) << lvl
        dst |= go_right_dst.astype(np.int64) << lvl
    src %= n_vertices
    dst %= n_vertices
    keep = src != dst
    return np.stack([src[keep], dst[keep]], axis=1)


def uniform_graph(n_vertices: int, n_edges: int, *, seed: int = 0,
                  undirected: bool = True) -> np.ndarray:
    """Near-uniform-degree generator (BTC stand-in: avg degree ~8.94 across
    all sample sizes)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    keep = src != dst
    e = np.stack([src[keep], dst[keep]], axis=1)
    if undirected:
        e = np.concatenate([e, e[:, ::-1]], axis=0)
    return e


def grid_graph(side: int) -> np.ndarray:
    """2-D lattice (road-network stand-in: high diameter, small frontier).
    Directed both ways. -> (E, 2)."""
    idx = np.arange(side * side).reshape(side, side)
    e = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
         np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)]
    e = np.concatenate(e, 0)
    return np.concatenate([e, e[:, ::-1]], 0)


def chain_graph(n_vertices: int) -> np.ndarray:
    """Simple path (genome-assembly path-merging demo)."""
    v = np.arange(n_vertices - 1, dtype=np.int64)
    return np.stack([v, v + 1], axis=1)


def random_walk_sample(edges: np.ndarray, n_vertices: int,
                       target_vertices: int, *, seed: int = 0,
                       restart: float = 0.15) -> np.ndarray:
    """Random-walk graph sampler (the paper built Webmap samples with a
    Pregelix random-walk sampler; this is the numpy equivalent). Returns
    the induced edge list on the visited vertex set, renumbered."""
    rng = np.random.default_rng(seed)
    order = np.argsort(edges[:, 0], kind="stable")
    se = edges[order]
    starts = np.searchsorted(se[:, 0], np.arange(n_vertices + 1))
    visited = set()
    cur = int(rng.integers(n_vertices))
    visited.add(cur)
    steps = 0
    while len(visited) < target_vertices and steps < target_vertices * 50:
        steps += 1
        lo, hi = starts[cur], starts[cur + 1]
        if hi <= lo or rng.random() < restart:
            cur = int(rng.integers(n_vertices))
        else:
            cur = int(se[int(rng.integers(lo, hi)), 1])
        visited.add(cur)
    keep = np.fromiter((int(s) in visited and int(d) in visited
                        for s, d in edges), bool, len(edges))
    sub = edges[keep]
    ids = {v: i for i, v in enumerate(sorted(visited))}
    return np.array([[ids[int(s)], ids[int(d)]] for s, d in sub],
                    np.int64).reshape(-1, 2)


# named dataset registry (sizes scaled for a single host; each step ~2x)
DATASETS = {
    "webmap-tiny": lambda: (rmat_graph(20_000, 240_000, seed=1), 20_000),
    "webmap-xsmall": lambda: (rmat_graph(40_000, 560_000, seed=2), 40_000),
    "webmap-small": lambda: (rmat_graph(80_000, 820_000, seed=3), 80_000),
    "webmap-medium": lambda: (rmat_graph(160_000, 1_200_000, seed=4),
                              160_000),
    "webmap-large": lambda: (rmat_graph(320_000, 1_800_000, seed=5),
                             320_000),
    "btc-tiny": lambda: (uniform_graph(30_000, 90_000, seed=6), 30_000),
    "btc-xsmall": lambda: (uniform_graph(60_000, 270_000, seed=7), 60_000),
    "btc-small": lambda: (uniform_graph(120_000, 540_000, seed=8), 120_000),
    "btc-medium": lambda: (uniform_graph(240_000, 1_070_000, seed=9),
                           240_000),
    "btc-large": lambda: (uniform_graph(480_000, 2_140_000, seed=10),
                          480_000),
}


def graph500(scale: int, edge_factor: int = 16, *, seed: int = 22):
    """Graph500 Kronecker/R-MAT shape at ``scale`` (2**scale vertices,
    edge_factor * 2**scale edges generated; LDBC Graphalytics'
    graph500-<scale>). Edges are not de-duplicated or relabelled, and
    self-loops are dropped. -> (edges (E, 2) int64, n_vertices)."""
    n = 2 ** scale
    return rmat_graph(n, edge_factor * n, seed=seed), n
