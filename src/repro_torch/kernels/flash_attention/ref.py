"""Plain torch attention: masked softmax over one (batch*head) slice
batch, the port of the JAX package's ``attention_ref``. q: (B, Sq, hd),
k/v: (B, Sk, hd); the queries are the LAST Sq positions of the keys."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
                >= torch.arange(Sk, device=q.device)[None])
        s = torch.where(mask[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", w, v.float()).to(q.dtype)
