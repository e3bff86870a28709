"""PageRank as the port runs it (``repro_torch.graph.PageRank``): ranks
start at 1/n; each of the ``iterations - 1`` later supersteps sets
rank = (1 - damping) / n + damping * (sum of rank / max(out-degree, 1)
over in-edges), duplicate edges counted and dangling mass dropped. The
reference is a float64 power iteration of that update; the control is
the same iteration in bfloat16, the precision below the float32 that the
port computes in."""
from __future__ import annotations

import numpy as np
import torch

from bench import graphs


def power_iteration(edges: torch.Tensor, n: int, damping: float,
                    iterations: int, dtype) -> torch.Tensor:
    """The iteration over blocks of ``graphs.BLOCK`` edges, so a graph's
    sends never stand on the device whole beside its edge list."""
    blocks = [slice(a, a + graphs.BLOCK)
              for a in range(0, edges.shape[0], graphs.BLOCK)]
    deg = torch.zeros(n, dtype=torch.int64, device=edges.device)
    for b in blocks:
        deg += torch.bincount(edges[b, 0], minlength=n)
    deg = deg.clamp_min(1).to(dtype)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=edges.device)
    for _ in range(iterations - 1):
        acc = torch.zeros(n, dtype=dtype, device=edges.device)
        share = r / deg
        for b in blocks:
            acc.index_add_(0, edges[b, 1], share[edges[b, 0]])
        r = (1.0 - damping) / n + damping * acc
    return r


def reference(edges: torch.Tensor, n: int, args: dict) -> torch.Tensor:
    return power_iteration(edges, n, args["damping"], args["iterations"],
                           torch.float64)


def control(edges: torch.Tensor, n: int, args: dict) -> np.ndarray:
    """The reference in bfloat16, as the program's (n, 1) values."""
    r = power_iteration(edges, n, args["damping"], args["iterations"],
                        torch.bfloat16)
    return r.float().cpu().numpy()[:, None]


def compare(values: np.ndarray, expected: torch.Tensor) -> dict:
    """``values``: the job's (n, V) vertex values in vid order, rank in
    column 0. -> the largest relative error of a rank."""
    want = expected.cpu().numpy()
    got = values[:, 0].astype(np.float64)
    rel = np.abs(got - want) / np.abs(want)
    return {"max_rel_err": float(np.nan_to_num(rel, nan=np.inf).max())}


def sending_edges(edges: torch.Tensor, n: int, args: dict):
    """Every edge sends in each superstep but the last: ``None`` (all
    edges) for each of the ``iterations - 1`` sending supersteps."""
    return [None] * (int(args["iterations"]) - 1)
