"""Per-superstep statistics collection (paper Section 5.7) — the port's
own copy of ``repro.planner.stats``, so ``run_host``'s stats records
carry the same keys. The collector feeds the adaptive controller
(``planner.adaptive``) and flags stragglers among steady supersteps
(``runtime.failure.StragglerMonitor``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# message wire format: int32 dst + float32 payload per dim + bool valid
_DST_BYTES = 4
_PAYLOAD_BYTES = 4
_VALID_BYTES = 1


def msg_bytes(messages: int, msg_dims: int) -> int:
    """Live bytes crossing the exchange for `messages` messages."""
    return messages * (_DST_BYTES + _PAYLOAD_BYTES * msg_dims + _VALID_BYTES)


@dataclass
class SuperstepStats:
    """One superstep (or one driver event: regrow / frontier-refit /
    plan-switch / recalibrate) of a run. Event records carry ``event`` +
    ``extra`` only."""
    superstep: int
    active: int = 0
    messages: int = 0
    frontier_density: float = 0.0   # active / LIVE vertices (not slots)
    bytes_exchanged: int = 0        # live message bytes, all partitions
    wall_s: float = 0.0
    # the superstep ran on a newly built superstep (the first one, and
    # after a regrow, a frontier refit or a plan switch): where the
    # reference recompiles, so straggler flags and the controller's
    # windows skip the same supersteps
    recompiled: bool = False
    event: Optional[str] = None
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        if self.event is not None:
            d = {"superstep": self.superstep, "event": self.event}
            d.update(self.extra)
            return d
        d = {"superstep": self.superstep, "active": self.active,
             "messages": self.messages, "wall_s": self.wall_s,
             "recompiled": self.recompiled,
             "frontier_density": self.frontier_density,
             "bytes_exchanged": self.bytes_exchanged}
        d.update(self.extra)
        return d


class StatsCollector:
    """Builds ``SuperstepStats`` records from driver observables and keeps
    the run history the adaptive controller windows over."""

    def __init__(self, *, n_partitions: int, vertex_capacity: int,
                 msg_dims: int, n_vertices: Optional[int] = None):
        """n_vertices = LIVE vertex count; densities are fractions of it
        (slot capacities carry slack). Falls back to total slots when
        unknown."""
        self.n_partitions = n_partitions
        self.vertex_capacity = vertex_capacity
        self.msg_dims = msg_dims
        self.n_vertices = n_vertices
        self.records: List[SuperstepStats] = []
        from repro_torch.runtime.failure import StragglerMonitor
        self.stragglers = StragglerMonitor()

    @property
    def total_vertices(self) -> int:
        if self.n_vertices:
            return self.n_vertices
        return max(self.n_partitions * self.vertex_capacity, 1)

    def record(self, superstep: int, *, active: int, messages: int,
               wall_s: float, recompiled: bool = False,
               **extra) -> SuperstepStats:
        if not recompiled:
            # straggler detection sees only steady supersteps: a rebuilt
            # superstep is not the partition's fault
            flag = self.stragglers.observe(superstep, wall_s)
            if flag is not None:
                extra["straggler"] = flag
        rec = SuperstepStats(
            superstep=superstep, active=active, messages=messages,
            frontier_density=min(active / self.total_vertices, 1.0),
            bytes_exchanged=msg_bytes(messages, self.msg_dims),
            wall_s=wall_s, recompiled=recompiled, extra=extra)
        self.records.append(rec)
        return rec

    def event(self, superstep: int, event: str, **extra) -> SuperstepStats:
        rec = SuperstepStats(superstep=superstep, event=event, extra=extra)
        self.records.append(rec)
        return rec
