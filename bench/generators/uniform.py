"""Near-uniform degree, the stand-in for the Pregelix paper's BTC graph:
``pairs`` endpoint pairs drawn uniformly over ``vertices`` ids, then
Graphalytics' form (``graphs.unique_pairs``, ``graphs.graph_of_pairs``:
each pair stored both ways, so the mean stored
degree is about 2 * pairs / vertices). A torch copy of the draw of
``repro_torch.graph.generators.uniform_graph``."""
import torch

from bench.graphs import Graph, graph_of_pairs, unique_pairs


def make(cfg: dict, gen: torch.Generator, device) -> Graph:
    n = int(cfg["vertices"])
    m = int(cfg["pairs"])
    src = torch.randint(0, n, (m,), generator=gen, device=device)
    dst = torch.randint(0, n, (m,), generator=gen, device=device)
    pairs = unique_pairs(src, dst, n)
    del src, dst
    return graph_of_pairs(pairs, n)
