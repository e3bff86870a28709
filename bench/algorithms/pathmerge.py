"""Path merging as the port's ``repro_torch.graph.PathMerge`` runs it on its
own plan (full-outer, delta storage, the sort group-by and the sender
combine), from ``graph/algorithms.py`` and ``core/superstep.py``:

- each vertex starts with acc 1 and its out-degree: value (acc, degree);
- in superstep s, messages sent in s - 1 are summed per destination; a
  deleted vertex that is sent one comes back first, with value zero
  (D1's resurrect), and every live vertex then adds its sum to acc;
- a live vertex is mergeable when its degree is 1, vid % 2 == s % 2 and
  s < ``rounds``: it sends its acc along its out-edges and then deletes
  itself (D6 runs after the sends);
- in superstep ``rounds`` every vertex halts and nothing is sent, so a job
  is ``rounds`` + 1 supersteps.

The reference replays that in int64 over the benchmark's own edges. The
values are small integers, so the comparison is exact: it counts the
vertices whose (acc, degree) differs, zeros where deleted. Every merge
forwards its acc, so acc summed over the live vertices stays the vertex
count; the reference checks that of itself, and the comparison prints
the program's sum.

The values are integers that every float format holds exactly, so no
lower precision can fail the comparison. The control breaks the
guarantee instead, in the shortcut that would tempt a change to D1 or
D6: no resurrection, so a message to a vertex deleted the superstep
before is lost."""
from __future__ import annotations

import sys

import numpy as np
import torch


class Replay:
    """A job's end state: (n,) int64 ``acc`` and ``degree`` of the live
    vertices, (n,) bool ``live``; the vertices ``deleted`` and
    ``resurrected`` in each superstep; with ``keep_sends`` the (E,)
    masks of the edges sent along in each superstep before ``rounds``.
    (A plain class: the harness loads this file outside ``sys.modules``,
    where a dataclass cannot resolve its annotations.)"""

    def __init__(self, acc, degree, live):
        self.acc, self.degree, self.live = acc, degree, live
        self.deleted, self.resurrected, self.sends = [], [], []

    def values(self) -> torch.Tensor:
        """(n, 2) int64 as ``gather_values`` reads the program's state."""
        z = torch.zeros_like(self.acc)
        return torch.stack([torch.where(self.live, self.acc, z),
                            torch.where(self.live, self.degree, z)], dim=1)


def replay(edges: torch.Tensor, n: int, rounds: int, *,
           resurrect: bool = True, keep_sends: bool = False) -> Replay:
    src, dst = edges[:, 0], edges[:, 1]
    dev = edges.device
    vid = torch.arange(n, device=dev)
    degree = torch.bincount(src, minlength=n)
    acc = torch.ones(n, dtype=torch.int64, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    out = Replay(acc, degree, live)
    inbox = has = None
    for s in range(rounds + 1):
        back = torch.zeros_like(live)
        if inbox is not None:
            if resurrect:
                back = has & ~live
                acc = torch.where(back, 0, acc)
                degree = torch.where(back, 0, degree)
                live = live | back
            acc = acc + torch.where(has & live, inbox, 0)
        out.resurrected.append(int(back.sum()))
        if s == rounds:
            out.deleted.append(0)
            break
        merge = live & (degree == 1) & (vid % 2 == s % 2)
        send = merge[src]
        if keep_sends:
            out.sends.append(send)
        inbox = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, dst[send], acc[src[send]])
        has = torch.zeros(n, dtype=torch.bool, device=dev)
        has[dst[send]] = True
        live = live & ~merge
        out.deleted.append(int(merge.sum()))
    out.acc, out.degree, out.live = acc, degree, live
    return out


def reference(edges: torch.Tensor, n: int, args: dict) -> torch.Tensor:
    r = replay(edges, n, int(args["rounds"]))
    mass = int(r.acc[r.live].sum())
    if mass != n:
        raise AssertionError(f"the reference lost mass: {mass} of {n}")
    return r.values()


def control(edges: torch.Tensor, n: int, args: dict) -> np.ndarray:
    """The replay without resurrection, as the program's (n, 2) float32
    values."""
    r = replay(edges, n, int(args["rounds"]), resurrect=False)
    return r.values().float().cpu().numpy()


def compare(values: np.ndarray, expected: torch.Tensor) -> dict:
    """``values``: the job's (n, 2) (acc, degree) in vid order, zeros where
    deleted. -> the number of vertices whose row differs. Prints acc
    summed over the live vertices beside the vertex count."""
    got = torch.from_numpy(values).to(expected.device, torch.float64)
    mass = float(got[:, 0].sum())
    print(f"[pathmerge] acc over the live vertices {mass:.0f}, vertices "
          f"{expected.shape[0]}", file=sys.stderr, flush=True)
    wrong = (got != expected.to(torch.float64)).any(dim=1)
    return {"wrong_vertices": int(wrong.sum())}


def sending_edges(edges: torch.Tensor, n: int, args: dict):
    """The mergeable vertices' out-edges, one (E,) mask for each superstep
    before ``rounds``."""
    return replay(edges, n, int(args["rounds"]), keep_sends=True).sends
