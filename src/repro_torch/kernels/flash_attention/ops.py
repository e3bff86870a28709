"""Attention over (B, S, H, hd) tensors with GQA head grouping.

On CUDA tensors the kernel reads KV head h // G for query head h through
the tensors' strides (no repeat, no transpose), differentiable through
``FlashAttention`` (its backward folds dK and dV over each GQA group).
On CPU tensors the plain version runs over K and V repeated to H heads,
as the JAX wrapper does, under autograd. On ``meta`` tensors (the
operator counter's dry run) ``FlashMeta`` returns the output's shape
and charges the kernel's work to the running counter (``META_OP``),
its backward's too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    FlashAttention
from repro_torch.kernels.flash_attention.ref import attention_ref


# the operator counter's by_op key of the kernel on meta tensors
META_OP = "flash_attention.meta"


def _visible_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs a head computes: queries aligned to the keys'
    end (query i sees keys <= Sk - Sq + i) when causal."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    return Sq * off + Sq * (Sq + 1) // 2


class FlashMeta(torch.autograd.Function):
    """The kernel on meta tensors: the output's shape, and its work
    charged to the running counter: forward 2 matrix products (QK^T, PV)
    of 2 hd flops a visible pair a head, q, k, v read and out written
    once; backward 5 (S recomputed, dV, dP, dQ, dK), q, k, v, out, dout
    read and dq, dk, dv written once."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        from repro_torch.launch import op_cost
        B, Sq, H, hd = q.shape
        ctx.pairs = B * H * _visible_pairs(Sq, k.shape[1], causal)
        ctx.io = sum(t.numel() * t.element_size() for t in (q, k, v))
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        ctx.out_bytes = out.numel() * out.element_size()
        op_cost.charge(META_OP, float(ctx.io + ctx.out_bytes),
                       4.0 * hd * ctx.pairs, matmul=True)
        # shapes, not tensors: a checkpointed layer keeps nothing alive
        ctx.like = [(t.shape, t.dtype) for t in (q, k, v)]
        return out

    @staticmethod
    def backward(ctx, do):
        from repro_torch.launch import op_cost
        hd = ctx.like[0][0][-1]
        op_cost.charge(META_OP + ".backward",
                       float(2 * ctx.io + 2 * ctx.out_bytes),
                       10.0 * hd * ctx.pairs, matmul=True)
        return tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in ctx.like) + (None,)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    dev = q.device
    if dev.type == "cuda":
        return FlashAttention.apply(q, k, v, causal)
    if dev.type == "meta":
        return FlashMeta.apply(q, k, v, causal)
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
