"""Genomix-style graph mutation on the PyTorch port (paper Section 6,
genome assembly), as ``path_merge_genomix.py`` does on JAX: iterative
chain compaction with vertex deletion, the resolve UDF and the
message-resurrection semantics of the full-outer join, under the delta
storage plan the paper recommends for mutation-heavy jobs. Runs on the
card unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/path_merge_genomix_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import load_graph, run_host
from repro_torch.graph import PathMerge, chain_graph

N = 200


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    edges = chain_graph(N)  # a simple path, like a resolved genome contig
    pm = PathMerge(rounds=16)
    vert = load_graph(edges, N, P=4, value_dims=2, device=args.device)
    res = run_host(vert, pm, pm.suggested_plan, max_supersteps=18)

    vid = res.vertex.vid.reshape(-1).cpu().numpy()
    vals = res.vertex.value.reshape(-1, 2).cpu().numpy()
    alive = vid >= 0
    acc = vals[alive, 0]
    print(f"chain of {N} vertices compacted to {alive.sum()} "
          f"in {res.supersteps} supersteps")
    print(f"accumulated length mass conserved: {acc.sum():.0f} == {N}")
    assert np.isclose(acc.sum(), N)
    return {"n": N, "alive": int(alive.sum()), "mass": float(acc.sum()),
            "result": res}


if __name__ == "__main__":
    main()
