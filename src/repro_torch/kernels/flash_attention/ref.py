"""Plain torch attention: masked softmax over one (batch*head) slice
batch, the port of the JAX package's ``attention_ref``. q: (B, Sq, hd),
k/v: (B, Sk, hd); the queries are the LAST Sq positions of the keys.
``attention_tiled`` replays the bfloat16 CUDA kernel's tile-level
numerics in torch. ``attention_gqa_backward`` is the kernel's backward
(plain torch, by query block: the JAX package has no backward kernel, so
its gradient is autodiff of the XLA path)."""
from __future__ import annotations

import math

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


def attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 64, split_p: bool = True) -> torch.Tensor:
    """The bfloat16 kernel's arithmetic, tile by tile, in float32: each
    warpgroup's block_q // 2 query rows walk the key tiles of block_k in
    order (the kernel also walks the tiles wholly above these rows'
    diagonal, which mask to zeros and change nothing); scores scaled by
    hd**-0.5 * log2(e) (one float32 product, as the kernel folds it) and
    masked to -1e30; running max and sum in base 2; p split into hi =
    bf16(p) and lo = bf16(p - hi) before the PV product; out = acc /
    max(l, 1e-30). split_p=False rounds p to bf16 alone, the error the
    split avoids. -> float32 (B, Sq, hd), before the kernel's cast to q's
    dtype."""
    B, Sq, hd = q.shape
    Sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = torch.tensor(hd ** -0.5, dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)
    off = Sk - Sq
    rows_per = block_q // 2
    out = torch.empty((B, Sq, hd), dtype=torch.float32, device=q.device)
    for r0 in range(0, Sq, rows_per):
        r1 = min(r0 + rows_per, Sq)
        row = torch.arange(r0, r1, device=q.device)[:, None]
        last = min(Sk - 1, r0 + rows_per - 1 + off) if causal else Sk - 1
        m = torch.full((B, r1 - r0, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, r1 - r0, 1), device=q.device)
        acc = torch.zeros((B, r1 - r0, hd), device=q.device)
        for k0 in range(0, last + 1, block_k):
            k1 = min(k0 + block_k, Sk)      # keys past Sk add exact zeros
            s = (qf[:, r0:r1] @ kf[:, k0:k1].transpose(1, 2)) * c
            if causal:
                key = torch.arange(k0, k1, device=q.device)[None]
                s = torch.where(key > row + off, NEG_INF, s)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            m = m_new
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = p.to(torch.bfloat16).float()
            lo = (p - hi).to(torch.bfloat16).float() if split_p else 0 * hi
            acc = acc * alpha + hi @ vf[:, k0:k1] + lo @ vf[:, k0:k1]
        out[:, r0:r1] = acc / l.clamp(min=1e-30)
    return out


def attention_gqa_backward(q, k, v, do, *, causal: bool = True,
                           block_q: int = 256):
    """Gradients of softmax(q k^T / sqrt(hd)) v, masked causally as
    ``attention_ref`` masks, with respect to q, k and v. q, do: (B, Sq, H,
    hd); k/v: (B, Sk, KV, hd), query head h reading KV head h // (H // KV).
    -> (dq, dk, dv) in the dtypes of q, k and v.

    One block of ``block_q`` queries at a time (against only the keys a
    causal block sees), all in float32: the scores and the softmax
    recomputed from q and k, then dP = dO V^T, D = rowsum(P * dP) (=
    rowsum(dO * O)), dS = P (dP - D), dQ = dS K / sqrt(hd), and dK, dV
    summed over the block's queries and the GQA group. A block holds
    (B, H, block_q, Sk) float32 scores; no (B*H, S, S) tensor is made.
    Its work is about 2.5 times the forward's (five products to two)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    off = Sk - Sq
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        n = q1 - q0
        ke = min(Sk, q1 + off) if causal else Sk
        qb = q[:, q0:q1].float().reshape(B, n, KV, G, hd)
        dob = do[:, q0:q1].float().reshape(B, n, KV, G, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qb, kf[:, :ke]) * scale
        if causal:
            mask = (torch.arange(q0, q1, device=q.device)[:, None] + off
                    >= torch.arange(ke, device=q.device)[None])
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dp = torch.einsum("bqkgh,bskh->bkgqs", dob, vf[:, :ke])
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del dp
        dq[:, q0:q1] = (torch.einsum("bkgqs,bskh->bqkgh", ds, kf[:, :ke])
                        * scale).reshape(B, n, H, hd).to(q.dtype)
        dk[:, :ke] += torch.einsum("bkgqs,bqkgh->bskh", ds, qb) * scale
        dv[:, :ke] += torch.einsum("bkgqs,bqkgh->bskh", p, dob)
    return dq, dk.to(k.dtype), dv.to(v.dtype)
