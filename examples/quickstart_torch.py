"""Quickstart on the PyTorch port: single-source shortest paths on a
synthetic web graph with the paper's Figure 9 plan hints (left-outer
join, hash group-by, unmerged connector), as ``quickstart.py`` does on
JAX. Runs on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import PhysicalPlan, gather_values, load_graph, run_host
from repro_torch.graph import SSSP, rmat_graph

N = 5_000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    edges = rmat_graph(N, 10 * N, seed=0)

    # the paper's Figure 9 hints: LEFT-OUTER join + hash group-by +
    # unmerged connector for the message-sparse SSSP
    plan = PhysicalPlan(join="left_outer", groupby="scatter",
                        connector="partitioning", sender_combine=True)

    vert = load_graph(edges, N, P=4, value_dims=1, device=args.device)
    res = run_host(vert, SSSP(source=0), plan, max_supersteps=40)

    dist = gather_values(res.vertex, N)[:, 0]
    reached = dist < 1e37
    print(f"supersteps: {res.supersteps}, wall: {res.wall_s:.2f}s")
    print(f"reached {reached.sum()} / {N} vertices")
    print(f"max finite distance: {dist[reached].max():.0f}")
    print("per-superstep active counts:",
          [s["active"] for s in res.stats if "active" in s])
    return {"edges": edges, "n": N, "dist": dist, "result": res}


if __name__ == "__main__":
    main()
