from repro_torch.graph.algorithms import (SSSP, ConnectedComponents,
                                          PageRank)
from repro_torch.graph.generators import (DATASETS, chain_graph, graph500,
                                          grid_graph, rmat_graph,
                                          uniform_graph)

__all__ = ["SSSP", "ConnectedComponents", "PageRank", "DATASETS",
           "chain_graph", "graph500", "grid_graph", "rmat_graph",
           "uniform_graph"]
