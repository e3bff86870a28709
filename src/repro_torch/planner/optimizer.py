"""Plan-space enumeration + min-cost selection — the port's copy of
``repro.planner.optimizer`` (the paper hand-tunes its Section 5.3 plan
choices per algorithm in Figure 9; this module derives them from
statistics instead).

The space is join x group-by x connector x sender_combine x storage from
``core/plan.py``, pruned by ``PhysicalPlan.validate`` (the scatter /
hash group-by cannot run a custom combine UDF). Storage defaults to the
base plan's policy — in-memory drivers never pay a write-back, so
varying it would only produce cost ties; an out-of-core driver passes
``storages=STORAGES``. There is no kernel dimension: the device of the
tensors picks the kernel, and the cost model reads it from the machine
(``MachineModel.cuda_kernels``). Partitioning and merge cadence are
inherited from the base plan: they are load-time choices, not
per-superstep ones.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.plan import DEFAULT_PLAN, PhysicalPlan
from repro_torch.planner.cost import (H100_MACHINE, GraphStats,
                                      MachineModel, Observation, PlanCost,
                                      estimate)

JOINS = ("full_outer", "left_outer")
GROUPBYS = ("scatter", "sort")
CONNECTORS = ("partitioning", "partitioning_merging")


def plan_space(program, base: Optional[PhysicalPlan] = None, *,
               joins: Tuple[str, ...] = JOINS,
               groupbys: Tuple[str, ...] = GROUPBYS,
               connectors: Tuple[str, ...] = CONNECTORS,
               sender_combines: Tuple[bool, ...] = (True, False),
               storages: Optional[Tuple[str, ...]] = None,
               ) -> Iterator[PhysicalPlan]:
    """Valid plans for `program`, varying the per-superstep dimensions of
    `base`. Invalid combinations are pruned via PhysicalPlan.validate.
    ``storages=None`` inherits the base plan's storage policy."""
    base = base if base is not None else DEFAULT_PLAN
    storages = storages if storages is not None else (base.storage,)
    for join in joins:
        for groupby in groupbys:
            for connector in connectors:
                for sc in sender_combines:
                    for storage in storages:
                        plan = dataclasses.replace(
                            base, join=join, groupby=groupby,
                            connector=connector, sender_combine=sc,
                            storage=storage)
                        try:
                            plan.validate(program.combine_op)
                        except ValueError:
                            continue
                        yield plan


def rank(program, g: GraphStats, obs: Observation, *,
         base: Optional[PhysicalPlan] = None,
         machine: MachineModel = H100_MACHINE,
         **space_kw) -> List[Tuple[PhysicalPlan, PlanCost]]:
    """All valid plans, cheapest first, with their modeled costs."""
    scored = [(p, estimate(p, g, obs, machine))
              for p in plan_space(program, base, **space_kw)]
    if not scored:
        raise ValueError(
            f"no valid physical plan for combine_op="
            f"{program.combine_op!r} in the restricted space {space_kw!r}")
    return sorted(scored, key=lambda pc: pc[1].seconds(machine))


def choose(program, g: GraphStats, obs: Observation, *,
           base: Optional[PhysicalPlan] = None,
           machine: MachineModel = H100_MACHINE,
           **space_kw) -> Tuple[PhysicalPlan, PlanCost]:
    """Min-cost plan for the given graph/program statistics."""
    return rank(program, g, obs, base=base, machine=machine, **space_kw)[0]
