"""Graphs made on the device from a seed. A configuration file names its
generator under ``"generator"``, a file of its own, ``generators/<name>.py``,
whose ``make(cfg, gen, device)`` draws the edges with the
``torch.Generator`` ``gen``; the same seed on the same device gives the same
graph. Every generator hands its draw to ``simple_undirected``, which gives
the graph the form LDBC Graphalytics lists its datasets in.

A configuration with a ``"dataset_seed"`` is one dataset, as Graphalytics
ships one file a dataset: its graph is drawn from that seed, and the run's
seed only relabels it (``relabel_in_partitions``), so every seed gives
the same work under new ids. Without one, the run's seed draws the
graph."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Graph:
    edges: torch.Tensor      # (E, 2) int64 (src, dst) on the device
    n: int                   # vertices
    listed_edges: int        # edges as the source lists them: a pair once

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


def simple_undirected(src: torch.Tensor, dst: torch.Tensor,
                      n: int) -> Graph:
    """Graphalytics' form of a generated edge list over ``n`` vertex ids:
    self-loops and duplicate pairs dropped, a pair in either direction
    counted once; isolated vertices dropped and the rest renumbered
    0 .. n' - 1 in id order; each pair stored in both directions, the
    list sorted by (src, dst) as a dataset's edge file orders it."""
    keep = src != dst
    lo = torch.minimum(src[keep], dst[keep])
    hi = torch.maximum(src[keep], dst[keep])
    del keep
    pairs = torch.unique(lo * n + hi)
    del lo, hi
    lo, hi = pairs // n, pairs % n
    present = torch.zeros(n, dtype=torch.bool, device=pairs.device)
    present[lo] = True
    present[hi] = True
    new_id = torch.cumsum(present, 0) - 1
    n2 = int(present.sum())
    lo, hi = new_id[lo], new_id[hi]
    del new_id, present
    keys = torch.sort(torch.cat([lo * n2 + hi, hi * n2 + lo])).values
    edges = torch.stack([keys // n2, keys % n2], dim=1)
    return Graph(edges, n2, int(pairs.numel()))


def relabel_in_partitions(g: Graph, parts: int,
                          gen: torch.Generator) -> Graph:
    """The same graph under new ids: the ids of each hash partition
    (vid % parts) shuffled among themselves, so each partition keeps its
    vertices' and edges' counts; the list sorted again by (src, dst)."""
    n = g.n
    vid = torch.arange(n, device=g.edges.device)
    new_id = torch.empty_like(vid)
    for r in range(parts):
        cls = vid[r::parts]
        perm = torch.randperm(cls.numel(), generator=gen,
                              device=g.edges.device)
        new_id[cls] = cls[perm]
    e = new_id[g.edges]
    keys = torch.sort(e[:, 0] * n + e[:, 1]).values
    return Graph(torch.stack([keys // n, keys % n], dim=1), n,
                 g.listed_edges)


def make_graph(cfg: dict, seed: int, device) -> Graph:
    """The configuration's graph for ``seed`` on ``device``: drawn from
    ``seed``, or from the configuration's ``dataset_seed`` and relabelled
    from ``seed``."""
    from bench import manifest
    gen = torch.Generator(device=device)
    dataset_seed = cfg.get("dataset_seed")
    gen.manual_seed(int(seed if dataset_seed is None else dataset_seed))
    g = manifest.generator(cfg["generator"]).make(cfg, gen, device)
    if dataset_seed is not None:
        gen.manual_seed(int(seed))
        g = relabel_in_partitions(g, int(cfg["partitions"]), gen)
    return g
