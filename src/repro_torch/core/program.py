"""Vectorized Pregel programs (the paper's UDFs, Table 2) over torch
tensors.

The paper's per-vertex ``compute`` is a batched function over vid-aligned
tensors with a leading partition axis P; message generation along
out-edges is an edge-parallel ``send``. Every tensor a program receives
lies on the device the job runs on, and what it returns must too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ComputeOut:
    """Output of the vectorized compute UDF (paper Section 3)."""
    value: torch.Tensor                 # (P, Np, V) updated vertex values
    halt: torch.Tensor                  # (P, Np) vote-to-halt
    send_gate: torch.Tensor             # (P, Np) emit along out-edges?
    aggregate: Optional[torch.Tensor] = None   # (P, Np, A) contribution
    # graph mutations (all optional):
    insert_vid: Optional[torch.Tensor] = None    # (P, Np) vid to insert or -1
    insert_value: Optional[torch.Tensor] = None  # (P, Np, V)
    delete_self: Optional[torch.Tensor] = None   # (P, Np) bool
    # own-edge rewrites (edges are owned by the src partition -> local):
    new_edge_dst: Optional[torch.Tensor] = None  # (P, Ep) or -2 keep
    new_edge_val: Optional[torch.Tensor] = None  # (P, Ep) or nan keep

    def has_mutations(self) -> bool:
        return any(x is not None for x in (
            self.insert_vid, self.delete_self, self.new_edge_dst,
            self.new_edge_val))


class VertexProgram:
    """Subclass and override. All tensors carry the (P, partition-local)
    leading axes. A program whose compute may delete or insert vertices
    sets ``mutates = True``: then a message to an empty slot re-creates
    its vertex (Pregel semantics)."""

    value_dims: int = 1
    msg_dims: int = 1
    agg_dims: int = 1
    combine_op: str = "sum"   # "sum" | "min" | "max" | "custom"
    mutates: bool = False

    # -- identity element of the combiner monoid (on the CPU; the engine
    # moves it to the job's device)
    def combine_identity(self) -> torch.Tensor:
        fill = {"sum": 0.0, "min": float("inf"),
                "max": float("-inf")}.get(self.combine_op, 0.0)
        return torch.full((self.msg_dims,), fill, dtype=torch.float32)

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Custom associative combine (used when combine_op == 'custom'),
        elementwise over (..., D) payload rows."""
        raise NotImplementedError

    def init_value(self, vid: torch.Tensor, out_degree: torch.Tensor,
                   gs) -> torch.Tensor:
        """Initial vertex value. vid: (P,Np). -> (P,Np,V) float32."""
        return torch.zeros(vid.shape + (self.value_dims,),
                           dtype=torch.float32, device=vid.device)

    def compute(self, vid, value, msg, has_msg, active, gs) -> ComputeOut:
        raise NotImplementedError

    def send(self, src_vid, src_value, edge_val, dst_vid,
             gs) -> torch.Tensor:
        """Edge-parallel message payloads. src_value: (P,Ep,V) gathered new
        values of each edge's source. -> (P,Ep,D)."""
        raise NotImplementedError

    def aggregate_identity(self) -> torch.Tensor:
        return torch.zeros((self.agg_dims,), dtype=torch.float32)

    def resolve(self, vid, values, count) -> torch.Tensor:
        """Resolve conflicting inserts of the same vid (values summed by
        default). values: (..., V) pre-combined sum; count: multiplicity."""
        return values

    def is_converged(self, gs) -> torch.Tensor:
        """Optional extra convergence predicate on the global state."""
        return torch.zeros((), dtype=torch.bool, device=gs.halt.device)
