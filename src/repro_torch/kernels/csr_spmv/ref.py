"""Plain torch edge gather (message generation: gather + scale).

payload[e] = values[edge_src[e]] * edge_val[e]  (0.0 for pad edges)
"""
from __future__ import annotations

from typing import Optional

import torch


def edge_gather_ref(values: torch.Tensor, edge_src: torch.Tensor,
                    edge_val: Optional[torch.Tensor] = None) -> torch.Tensor:
    """values: (N, V); edge_src: (E,) int32 (-1 pad); edge_val: (E,) or
    None (a weight of one). -> (E, V)."""
    ok = edge_src >= 0
    g = values[edge_src.clamp(min=0).long()]
    if edge_val is not None:
        g = g * edge_val[:, None]
    return torch.where(ok[:, None], g, 0.0)
