from repro_torch.graph.algorithms import (BFS, SSSP, ConnectedComponents,
                                          KCore, PageRank, PathMerge,
                                          Reachability)
from repro_torch.graph.generators import (DATASETS, chain_graph, graph500,
                                          grid_graph, random_walk_sample,
                                          rmat_graph, uniform_graph)

__all__ = ["BFS", "SSSP", "ConnectedComponents", "KCore", "PageRank",
           "PathMerge", "Reachability", "DATASETS", "chain_graph",
           "graph500", "grid_graph", "random_walk_sample", "rmat_graph",
           "uniform_graph"]
