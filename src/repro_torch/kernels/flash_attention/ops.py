"""Attention over (B, S, H, hd) tensors with GQA head grouping.

On CUDA tensors the kernel reads KV head h // G for query head h through
the tensors' strides (no repeat, no transpose), differentiable through
``FlashAttention`` (its backward folds dK and dV over each GQA group).
On CPU tensors the plain version runs over K and V repeated to H heads,
as the JAX wrapper does, under autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    FlashAttention
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    dev = q.device
    if dev.type == "cuda":
        return FlashAttention.apply(q, k, v, causal)
    if dev.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    return attention_gqa_ref(q, k, v, causal=causal)


def attention_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True) -> torch.Tensor:
    """The plain version of ``flash_attention``, on any device."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    vf = v.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    of = attention_ref(qf, kf, vf, causal=causal)
    return of.reshape(B, H, Sq, hd).transpose(1, 2)
