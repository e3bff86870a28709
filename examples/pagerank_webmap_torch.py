"""End-to-end graph analytics on the PyTorch port, as
``pagerank_webmap.py`` does on JAX: PageRank on the Webmap stand-in with
checkpoints and a top-k report, then the recovery drill — the latest
checkpoint reloaded onto a DIFFERENT partition count (P = 3). Runs on
the card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/pagerank_webmap_torch.py [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import gather_values, load_graph, run_host
from repro_torch.graph import DATASETS, PageRank
from repro_torch.runtime import (latest_checkpoint, load_checkpoint,
                                 repartition)

ITERATIONS = 12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    edges, n = DATASETS["webmap-tiny"]()
    pr = PageRank(n, iterations=ITERATIONS)
    vert = load_graph(edges, n, P=4, value_dims=2, device=args.device)

    with tempfile.TemporaryDirectory() as ckpt:
        res = run_host(vert, pr, pr.suggested_plan, max_supersteps=14,
                       checkpoint_every=5, checkpoint_dir=ckpt)
        ranks = gather_values(res.vertex, n)[:, 0]
        top = np.argsort(-ranks)[:5]
        print(f"PageRank on webmap-tiny ({n} vertices, {len(edges)} edges)")
        print(f"supersteps={res.supersteps} wall={res.wall_s:.2f}s")
        print("top-5:", [(int(v), round(float(ranks[v]), 6)) for v in top])

        # elastic recovery drill: reload the latest checkpoint onto 3
        # workers
        v, m, gs = load_checkpoint(latest_checkpoint(ckpt),
                                   device=args.device)
        v3, m3 = repartition(v, m, new_P=3)
        step = int(gs.superstep)
        print(f"recovered checkpoint at superstep {step} "
              f"onto P=3 partitions: {tuple(v3.vid.shape)}")
    return {"edges": edges, "n": n, "ranks": ranks,
            "iterations": ITERATIONS, "result": res,
            "recovered_superstep": step, "repartitioned": v3}


if __name__ == "__main__":
    main()
