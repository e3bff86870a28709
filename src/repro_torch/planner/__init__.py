"""Planner layer of the port. This slice holds the statistics collector;
the cost model and the adaptive optimizer come with the planner slice."""
from repro_torch.planner.stats import (StatsCollector, SuperstepStats,
                                       msg_bytes)

__all__ = ["StatsCollector", "SuperstepStats", "msg_bytes"]
