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
    # graph mutations: the port runs them from the mutation slice on
    insert_vid: Optional[torch.Tensor] = None
    insert_value: Optional[torch.Tensor] = None
    delete_self: Optional[torch.Tensor] = None
    new_edge_dst: Optional[torch.Tensor] = None
    new_edge_val: Optional[torch.Tensor] = None

    def mutates(self) -> bool:
        return any(x is not None for x in (
            self.insert_vid, self.insert_value, self.delete_self,
            self.new_edge_dst, self.new_edge_val))


class VertexProgram:
    """Subclass and override. All tensors carry the (P, partition-local)
    leading axes."""

    value_dims: int = 1
    msg_dims: int = 1
    agg_dims: int = 1
    combine_op: str = "sum"   # "sum" | "min" | "max" | "custom"

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

    def is_converged(self, gs) -> torch.Tensor:
        """Optional extra convergence predicate on the global state."""
        return torch.zeros((), dtype=torch.bool, device=gs.halt.device)
