"""The job generator: one traffic mix file, ``traffic/<mix>.json``, says
what jobs the analyst sends, and this code, the same for every mix,
turns it into programs. Keys of a mix:

- ``algorithm``: the file under ``algorithms/`` that judges the answers;
- ``program``: the class of ``repro_torch.graph`` a job runs;
- ``args``: its fixed arguments;
- ``bind``: arguments drawn per job, each by the name of a draw, the file
  ``draws/<name>.py`` (which may read further keys of the mix);
- ``plan``: ``"suggested"`` (the program's own plan hint) or the fields of
  a ``PhysicalPlan``;
- ``max_supersteps``, ``compare_jobs`` (how many of the window's jobs a
  run judges, drawn from the seed) and ``limits`` (the largest reading of
  each number the comparison gives that still counts as correct).
"""
from __future__ import annotations

import numpy as np
import torch

from bench import manifest


class JobStream:
    """The arguments of job 0, 1, 2, ... of a run, the same for the same
    seed and graph. Job 0 is the warm-up job of the set-up."""

    def __init__(self, traffic: dict, edges: torch.Tensor, n: int,
                 seed: int):
        self.traffic = traffic
        rng = np.random.default_rng([int(seed), 1])
        self.draws = {name: manifest.draw(kind).make(traffic, edges, n, rng)
                      for name, kind in traffic.get("bind", {}).items()}

    def job(self, i: int) -> dict:
        a = dict(self.traffic.get("args", {}))
        a.update({name: value(i) for name, value in self.draws.items()})
        return a


def make_program(traffic: dict, args: dict):
    import repro_torch.graph as graph
    return getattr(graph, traffic["program"])(**args)


def plan_for(traffic: dict, program):
    from repro_torch.core import PhysicalPlan
    plan = traffic.get("plan", "suggested")
    if plan == "suggested":
        return program.suggested_plan
    return PhysicalPlan(**plan)
