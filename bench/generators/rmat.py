"""Graph500's Kronecker (R-MAT) graph, as LDBC Graphalytics' ``graph500-*``
datasets hold it: ``edge_factor * 2**scale`` edges drawn over ``2**scale``
vertex ids, each id bit chosen at one of the ``scale`` levels by the
quadrant probabilities a/b/c (d the rest); the ids then permuted at
random, as the Graph500 generator does, so no range of ids holds the hot
vertices; then ``simple_undirected``. A torch copy of the draw of
``repro_torch.graph.generators.rmat_graph``."""
import torch

from bench.graphs import Graph, simple_undirected


def make(cfg: dict, gen: torch.Generator, device) -> Graph:
    scale = int(cfg["scale"])
    n = 2 ** scale
    m = int(cfg["edge_factor"]) * n
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for lvl in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        src |= (r > a + b).long() << lvl                    # c + d quadrants
        dst |= (((r > a) & (r <= a + b)) | (r > a + b + c)).long() << lvl
    del r
    perm = torch.randperm(n, generator=gen, device=device)
    return simple_undirected(perm[src], perm[dst], n)
