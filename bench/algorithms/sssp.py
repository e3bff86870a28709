"""Single-source shortest paths with unit weights, as the port's
``repro_torch.graph.SSSP`` runs them: the distance of every vertex is
its hop count from the source. The reference is a plain breadth-first
search, a level at a time over the whole edge list. The answer is exact:
the comparison counts the vertices whose distance differs.

Hop counts are small integers, which every float format down to
bfloat16 holds exactly, so no lower precision can fail the comparison.
The control breaks the guarantee instead, in the way that would tempt a
change to the driver: a frontier that outgrows its capacity drops what
does not fit, where the program regrows and redoes the superstep."""
from __future__ import annotations

import numpy as np
import torch

# the program writes this float32 distance for a vertex it never reached
UNREACHED = 1e38
# the control's frontier capacity: this share of the vertices a level
CONTROL_FRONTIER_SHARE = 1 / 64


def bfs_levels(edges: torch.Tensor, n: int, source: int,
               frontier_cap: int | None = None) -> torch.Tensor:
    """(n,) int64 hop counts from ``source``, -1 where unreached. With
    ``frontier_cap`` a level expands only its first ``frontier_cap``
    vertices in vid order, and the rest are dropped."""
    src, dst = edges[:, 0], edges[:, 1]
    dev = edges.device
    level = torch.full((n,), -1, dtype=torch.int64, device=dev)
    level[source] = 0
    front = torch.zeros(n, dtype=torch.bool, device=dev)
    front[source] = True
    k = 0
    while bool(front.any()):
        if frontier_cap is not None:
            ids = torch.nonzero(front).squeeze(1)
            front[ids[frontier_cap:]] = False
        nxt = torch.zeros(n, dtype=torch.bool, device=dev)
        nxt[dst[front[src]]] = True
        nxt &= level < 0
        k += 1
        level[nxt] = k
        front = nxt
    return level


def reference(edges: torch.Tensor, n: int, args: dict) -> torch.Tensor:
    return bfs_levels(edges, n, int(args["source"]))


def control(edges: torch.Tensor, n: int, args: dict) -> np.ndarray:
    """The BFS with a frontier capped at ``CONTROL_FRONTIER_SHARE`` of the
    vertices, as the program's (n, 1) float32 distances."""
    cap = max(int(n * CONTROL_FRONTIER_SHARE), 1)
    lv = bfs_levels(edges, n, int(args["source"]), cap).cpu().numpy()
    return np.where(lv >= 0, lv, np.float32(3.4e38)).astype(
        np.float32)[:, None]


def compare(values: np.ndarray, expected: torch.Tensor) -> dict:
    """``values``: the job's (n, V) distances in vid order. -> the number
    of vertices whose hop count, or whether it was reached, differs."""
    want = expected.cpu().numpy()
    got = values[:, 0]
    got_reached = got < UNREACHED
    want_reached = want >= 0
    wrong = (got_reached != want_reached) | (
        want_reached & (got.astype(np.float64) != want))
    return {"wrong_vertices": int(wrong.sum())}


def sending_edges(edges: torch.Tensor, n: int, args: dict):
    """A vertex sends along its out-edges once, in the superstep of its
    hop count (the source in superstep 0): one (E,) mask a superstep."""
    level = bfs_levels(edges, n, int(args["source"]))
    src_level = level[edges[:, 0]]
    return [src_level == k for k in range(int(level.max()) + 1)]
