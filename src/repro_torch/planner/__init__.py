"""Adaptive cost-based plan optimizer of the port (the reference's
``repro.planner``):

* ``stats``     one typed per-superstep record + collector (Section 5.7's
                statistics collector) with straggler flags
* ``cost``      analytical per-superstep cost model over the plan space,
                with the H100's and the CPU's machine models, calibratable
                against the operator counter (``launch/op_cost.py``)
* ``optimizer`` enumerate + prune + min-cost plan for given statistics
* ``adaptive``  mid-run replanning with hysteresis at superstep boundaries

Entry points: ``run_host(..., plan="auto")`` and
``run_jit(..., plan="auto")``.
"""
from repro_torch.planner.adaptive import (AdaptiveConfig,
                                          AdaptiveController, migrate_msgs,
                                          resolve_auto_plan)
from repro_torch.planner.cost import (CPU_MACHINE, H100_MACHINE,
                                      GraphStats, MachineModel,
                                      Observation, PlanCost, bucket_cap,
                                      calibrate_machine, estimate,
                                      machine_for, op_calibrate,
                                      refit_frontier_cap)
from repro_torch.planner.optimizer import choose, plan_space, rank
from repro_torch.planner.stats import (StatsCollector, SuperstepStats,
                                       msg_bytes)

__all__ = [
    "AdaptiveConfig", "AdaptiveController", "migrate_msgs",
    "resolve_auto_plan", "H100_MACHINE", "CPU_MACHINE", "GraphStats",
    "MachineModel", "Observation", "PlanCost", "bucket_cap",
    "calibrate_machine", "estimate", "machine_for", "op_calibrate",
    "refit_frontier_cap", "choose", "plan_space", "rank", "StatsCollector",
    "SuperstepStats", "msg_bytes",
]
