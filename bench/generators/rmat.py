"""Graph500's Kronecker (R-MAT) graph, as LDBC Graphalytics' ``graph500-*``
datasets hold it: ``edge_factor * 2**scale`` edges drawn over ``2**scale``
vertex ids, each id bit chosen at one of the ``scale`` levels by the
quadrant probabilities a/b/c (d the rest); the ids then permuted at
random, as the Graph500 generator does, so no range of ids holds the hot
vertices; then Graphalytics' form (``graphs.unique_pairs``,
``graphs.graph_of_pairs``). A torch copy of the draw of
``repro_torch.graph.generators.rmat_graph``: the same uniform draws, the
ids set bit by bit in blocks of ``graphs.BLOCK`` in the narrowest type
that holds them."""
import torch

from bench.graphs import (BLOCK, Graph, graph_of_pairs, id_dtype,
                          unique_pairs)


def make(cfg: dict, gen: torch.Generator, device) -> Graph:
    scale = int(cfg["scale"])
    n = 2 ** scale
    m = int(cfg["edge_factor"]) * n
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    idt = id_dtype(n)
    src = torch.zeros(m, dtype=idt, device=device)
    dst = torch.zeros(m, dtype=idt, device=device)
    for lvl in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        for i in range(0, m, BLOCK):
            rb = r[i:i + BLOCK]
            src[i:i + BLOCK] |= (rb > a + b).to(idt) << lvl   # c + d
            dst[i:i + BLOCK] |= (((rb > a) & (rb <= a + b)) |
                                 (rb > a + b + c)).to(idt) << lvl
        del r, rb
    perm = torch.randperm(n, generator=gen, device=device).to(idt)
    for i in range(0, m, BLOCK):
        src[i:i + BLOCK] = perm[src[i:i + BLOCK]]
        dst[i:i + BLOCK] = perm[dst[i:i + BLOCK]]
    del perm
    pairs = unique_pairs(src, dst, n)
    del src, dst
    return graph_of_pairs(pairs, n)
