"""The Pregelix built-in algorithm library (paper Section 6) as torch
VertexPrograms: PageRank, SSSP, connected components, BFS, reachability,
k-core peeling and Genomix-style path merging. Each hint block mirrors
the paper's Figure 9 (join / group-by / connector per algorithm).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plan import PhysicalPlan
from repro_torch.core.program import ComputeOut, VertexProgram

INF = float(np.float32(3.4e38))


class PageRank(VertexProgram):
    """value = [rank, out_degree]. Messages = rank contributions (sum).
    Paper hint: full-outer join (message-dense), scatter group-by."""

    value_dims = 2
    msg_dims = 1
    agg_dims = 1
    combine_op = "sum"
    suggested_plan = PhysicalPlan(join="full_outer", groupby="scatter",
                                  sender_combine=True)

    def __init__(self, num_vertices: int, damping: float = 0.85,
                 iterations: int = 15):
        self.n = num_vertices
        self.d = damping
        self.iters = iterations

    def init_value(self, vid, out_degree, gs):
        rank = torch.full(vid.shape, 1.0 / self.n, dtype=torch.float32,
                          device=vid.device)
        return torch.stack([rank, out_degree], dim=-1)

    def compute(self, vid, value, msg, has_msg, active, gs):
        incoming = msg[..., 0]
        rank = torch.where(gs.superstep == 0, value[..., 0],
                           (1.0 - self.d) / self.n + self.d * incoming)
        new_val = torch.stack([rank, value[..., 1]], dim=-1)
        last = gs.superstep >= self.iters - 1
        return ComputeOut(value=new_val,
                          halt=last.expand(vid.shape),
                          send_gate=(~last).expand(vid.shape),
                          aggregate=rank[..., None])

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        deg = torch.clamp_min(src_value[..., 1], 1.0)
        return (src_value[..., 0] / deg)[..., None]


class SSSP(VertexProgram):
    """Single source shortest paths (paper Figure 9). value = [dist].
    Messages = candidate distances (min). Paper hint: LEFT-OUTER join +
    hash group-by + unmerged connector — message-sparse."""

    value_dims = 1
    msg_dims = 1
    agg_dims = 1
    combine_op = "min"
    suggested_plan = PhysicalPlan(join="left_outer", groupby="scatter",
                                  connector="partitioning",
                                  sender_combine=True)

    def __init__(self, source: int):
        self.source = source

    def init_value(self, vid, out_degree, gs):
        dist = torch.where(vid == self.source, 0.0, INF)
        return dist[..., None]

    def compute(self, vid, value, msg, has_msg, active, gs):
        cur = value[..., 0]
        incoming = torch.where(has_msg, msg[..., 0], INF)
        new = torch.minimum(cur, incoming)
        improved = new < cur
        seed = (gs.superstep == 0) & (vid == self.source)
        send = improved | seed
        return ComputeOut(value=new[..., None],
                          halt=torch.ones_like(send),  # msgs re-activate
                          send_gate=send,
                          aggregate=torch.where(new < INF, 1.0,
                                                0.0)[..., None])

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return (src_value[..., 0] + edge_val)[..., None]


class ConnectedComponents(VertexProgram):
    """Label propagation: min component id (paper's CC)."""

    value_dims = 1
    msg_dims = 1
    agg_dims = 1
    combine_op = "min"
    suggested_plan = PhysicalPlan(join="full_outer", groupby="scatter",
                                  sender_combine=True)

    def init_value(self, vid, out_degree, gs):
        return torch.where(vid >= 0, vid, 0).float()[..., None]

    def compute(self, vid, value, msg, has_msg, active, gs):
        cur = value[..., 0]
        incoming = torch.where(has_msg, msg[..., 0], INF)
        new = torch.minimum(cur, incoming)
        improved = new < cur
        send = improved | (gs.superstep == 0)
        return ComputeOut(value=new[..., None],
                          halt=torch.ones_like(send),
                          send_gate=send,
                          aggregate=torch.zeros(vid.shape + (1,),
                                                device=vid.device))

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return src_value[..., 0:1]


class BFS(VertexProgram):
    """Breadth-first levels from a source. value = [level] (unreached
    encoded as INF)."""

    value_dims = 1
    msg_dims = 1
    agg_dims = 1
    combine_op = "min"
    suggested_plan = PhysicalPlan(join="left_outer", groupby="scatter",
                                  sender_combine=True)

    def __init__(self, source: int):
        self.source = source

    def init_value(self, vid, out_degree, gs):
        return torch.where(vid == self.source, 0.0, INF)[..., None]

    def compute(self, vid, value, msg, has_msg, active, gs):
        cur = value[..., 0]
        incoming = torch.where(has_msg, msg[..., 0], INF)
        new = torch.minimum(cur, incoming)
        improved = new < cur
        send = improved | ((gs.superstep == 0) & (vid == self.source))
        return ComputeOut(value=new[..., None],
                          halt=torch.ones_like(send),
                          send_gate=send,
                          aggregate=torch.where(new < INF, 1.0,
                                                0.0)[..., None])

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return (src_value[..., 0] + 1.0)[..., None]


class Reachability(VertexProgram):
    """Boolean reachability from a source (paper's built-in library)."""

    value_dims = 1
    msg_dims = 1
    agg_dims = 1
    combine_op = "max"
    suggested_plan = PhysicalPlan(join="left_outer", groupby="scatter",
                                  sender_combine=True)

    def __init__(self, source: int):
        self.source = source

    def init_value(self, vid, out_degree, gs):
        return (vid == self.source).float()[..., None]

    def compute(self, vid, value, msg, has_msg, active, gs):
        reached = value[..., 0] > 0
        incoming = has_msg & (msg[..., 0] > 0)
        new = reached | incoming
        newly = new & ~reached
        send = newly | ((gs.superstep == 0) & (vid == self.source))
        return ComputeOut(value=new.float()[..., None],
                          halt=torch.ones_like(send),
                          send_gate=send,
                          aggregate=new.float()[..., None])

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return torch.ones_like(src_value[..., 0:1])


class KCore(VertexProgram):
    """k-core decomposition (peeling): a vertex dies when its count of
    LIVE neighbors drops below k; death notifications are summed by the
    combiner. value = [live_degree, alive]. It counts along out-edges, so
    it is the k-core only on a symmetric (undirected) edge list."""

    value_dims = 2
    msg_dims = 1
    agg_dims = 1
    combine_op = "sum"
    suggested_plan = PhysicalPlan(join="full_outer", groupby="scatter",
                                  sender_combine=True)

    def __init__(self, k: int):
        self.k = k

    def init_value(self, vid, out_degree, gs):
        return torch.stack([out_degree, torch.ones_like(out_degree)],
                           dim=-1)

    def compute(self, vid, value, msg, has_msg, active, gs):
        deg = value[..., 0] - torch.where(has_msg, msg[..., 0], 0.0)
        alive = value[..., 1] > 0
        dies = alive & (deg < self.k)
        new_alive = alive & ~dies
        return ComputeOut(
            value=torch.stack([deg, new_alive.float()], dim=-1),
            halt=torch.ones_like(dies),        # messages re-activate
            send_gate=dies,                    # notify neighbors of death
            aggregate=new_alive.float()[..., None])

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return torch.ones_like(src_value[..., 0:1])


class PathMerge(VertexProgram):
    """Genomix-style chain compaction (paper Section 6, genome assembly):
    vertices on a simple path (out-degree 1) merge into their successor by
    deleting themselves and forwarding their accumulated length. Exercises
    graph MUTATIONS (delete + resolve). value = [acc_len, out_degree]."""

    value_dims = 2
    msg_dims = 1
    agg_dims = 1
    combine_op = "sum"
    mutates = True
    suggested_plan = PhysicalPlan(join="full_outer", groupby="sort",
                                  storage="delta")

    def __init__(self, rounds: int = 8):
        self.rounds = rounds

    def init_value(self, vid, out_degree, gs):
        return torch.stack([torch.ones_like(out_degree), out_degree],
                           dim=-1)

    def compute(self, vid, value, msg, has_msg, active, gs):
        acc = value[..., 0] + torch.where(has_msg, msg[..., 0], 0.0)
        deg = value[..., 1]
        # odd/even pairing avoids merging both ends of an edge at once
        mergeable = (deg == 1) & (vid % 2 == gs.superstep % 2) & (vid >= 0)
        done = gs.superstep >= self.rounds
        return ComputeOut(
            value=torch.stack([acc, deg], dim=-1),
            halt=done.expand(vid.shape),
            send_gate=mergeable & ~done,
            aggregate=acc[..., None],
            delete_self=mergeable & ~done)

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return src_value[..., 0:1]
