"""Physical plan choices (the paper's Section 5.3 "tailored executions").

join:       full_outer (scan every slot; dense message buffers) |
            left_outer (compact the frontier, gather only those rows)
groupby:    scatter (monoid scatter into dense slots) |
            sort (sort by dst + segmented fold)
connector:  partitioning (unsorted buckets) |
            partitioning_merging (buckets sorted by dst before the exchange)
sender_combine: pre-aggregate messages per destination on the sender.
storage:    the out-of-core write-back policy; a label in memory.
partition:  hash (vid % P) | range (vid // capacity).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

# the documented name of every dimension (the reference's sets)
JOINS = ("full_outer", "left_outer")
GROUPBYS = ("scatter", "sort")
CONNECTORS = ("partitioning", "partitioning_merging")
# the two write-back policies the planner's storage dimension ranges over
STORAGES = ("inplace", "delta")
PARTITIONS = ("hash", "range")


@dataclass(frozen=True)
class PhysicalPlan:
    join: str = "full_outer"          # full_outer | left_outer
    groupby: str = "scatter"          # scatter | sort
    connector: str = "partitioning"   # partitioning | partitioning_merging
    sender_combine: bool = True
    storage: str = "inplace"          # inplace | delta
    merge_every: int = 4              # delta storage merge cadence
    partition: str = "hash"           # hash | range
    # left_outer: initial frontier capacity / Np (the host driver shrinks
    # it when the live set collapses)
    frontier_capacity: float = 1.0

    def validate(self, combine_op: str):
        """Raise on a name outside its documented set (the superstep
        compares names as strings, so a misspelt one would run another
        plan) and on a scatter group-by of a custom combine UDF."""
        for dim, allowed in (("join", JOINS), ("groupby", GROUPBYS),
                             ("connector", CONNECTORS),
                             ("storage", STORAGES),
                             ("partition", PARTITIONS)):
            name = getattr(self, dim)
            if name not in allowed:
                raise ValueError(f"{dim}={name!r}: expected one of "
                                 f"{' | '.join(allowed)}")
        if self.groupby == "scatter" and combine_op == "custom":
            raise ValueError(
                "scatter (hash) group-by needs a named monoid combine op; "
                "use groupby='sort' for custom combine UDFs")
        return self

    @classmethod
    def from_dict(cls, d: dict) -> "PhysicalPlan":
        """The plan a snapshot stored (``dataclasses.asdict``). The
        reference's snapshots also store its kernel_impl, which the port
        has no field for (the device picks the kernel): keys that name
        no field are dropped."""
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


DEFAULT_PLAN = PhysicalPlan()
# the paper's Figure 9 hints for SSSP: left-outer join + unmerged connector
SPARSE_PLAN = PhysicalPlan(join="left_outer", groupby="scatter",
                           connector="partitioning")

# left-outer frontier capacities never refit below this floor
FRONTIER_FLOOR = 64


def bucket_capacity(plan: PhysicalPlan, edge_capacity: int,
                    vertex_capacity: int, n_parts: int, *,
                    slack: float = 1.5) -> int:
    """Per-(src,dst)-partition message bucket capacity for `plan`."""
    cap = int((edge_capacity / n_parts + 8) * slack)
    if plan.sender_combine:
        # after sender-side combining, <= Np distinct receivers per bucket
        cap = min(cap, vertex_capacity + 8)
    return max(cap, 8)
