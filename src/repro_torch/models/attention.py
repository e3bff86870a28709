"""Attention: GQA prefill through the flash-attention kernel, and
single-token decode against a KV cache in plain torch.

On CUDA tensors the prefill core is the hand-written flash-attention
kernel (the JAX package runs its Pallas kernel there on the TPU and a
blocked online-softmax in XLA elsewhere); on CPU tensors it is the plain
masked softmax. Sliding-window attention, its ring cache and the
recursive-halving causal schedule belong to a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import rope
from repro_torch.models.param import Spec

NEG_INF = -1e30
LOCAL_SLICE = ("sliding-window attention and its ring cache arrive with "
               "the local-attention slice (gemma3, h2o-danube)")


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": Spec((d, h, hd), fan_in=d),
        "wk": Spec((d, kv, hd), fan_in=d),
        "wv": Spec((d, kv, hd), fan_in=d),
        "wo": Spec((h, hd, d), fan_in=h * hd),
    }


def blocked_attention(q, k, v, *, causal: bool,
                      window: Optional[int] = None,
                      causal_mode: str = "masked_full"):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd)."""
    if window is not None and not (causal and window >= q.shape[1]):
        raise NotImplementedError(LOCAL_SLICE)
    if causal and causal_mode == "recursive":
        raise NotImplementedError(
            "causal_mode='recursive' (recursive-halving schedule) arrives "
            "with the training slice")
    if causal_mode not in ("masked_full", "recursive"):
        raise ValueError(f"causal_mode={causal_mode!r}")
    return fa_ops.flash_attention(q, k, v, causal=causal)


def _proj_in(x, w):
    """(B,S,d) @ (d,h,hd) -> (B,S,h,hd)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def _proj_out(o, w):
    """(B,S,h,hd) @ (h,hd,d) -> (B,S,d)."""
    h, hd, d = w.shape
    return o.flatten(-2) @ w.reshape(h * hd, d)


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    local: bool, positions: torch.Tensor,
                    causal_mode: str = "masked_full"):
    """Training/prefill path. x: (B,S,d). Returns (out, (k, v))."""
    if local:
        raise NotImplementedError(LOCAL_SLICE)
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if cfg.attn.causal:  # decoder archs use RoPE; encoder stub skips it
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, causal=cfg.attn.causal,
                          causal_mode=causal_mode)
    return _proj_out(o, p["wo"]), (k, v)


def apply_attention_decode(p: dict, x: torch.Tensor, cache_k, cache_v,
                           cache_len: int, cfg: ModelConfig, *,
                           local: bool):
    """One-token decode. x: (B,1,d); cache_k/v: (B,Smax,KV,hd) with
    positions < cache_len filled; cache_len < Smax. Writes this token's
    K/V at slot cache_len IN PLACE (the JAX version returns new caches)
    and attends to slots <= cache_len. Scores and softmax in f32; the
    weights are cast to the cache's dtype before the PV product.
    Returns (out, cache_k, cache_v)."""
    if local:
        raise NotImplementedError(LOCAL_SLICE)
    B, _, d = x.shape
    Smax, KV, hd = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    H = cfg.num_heads
    G = H // KV
    if not 0 <= cache_len < Smax:
        raise ValueError(f"cache_len={cache_len} outside a cache of "
                         f"{Smax} slots")
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q = rope(_proj_in(x, p["wq"]), pos, cfg.rope_theta)
    k = rope(_proj_in(x, p["wk"]), pos, cfg.rope_theta)
    v = _proj_in(x, p["wv"])
    cache_k[:, cache_len] = k[:, 0]
    cache_v[:, cache_len] = v[:, 0]
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     cache_k.float()) * hd ** -0.5
    valid = torch.arange(Smax, device=x.device) <= cache_len
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w.to(cache_v.dtype), cache_v)
    out = _proj_out(o.reshape(B, 1, H, hd), p["wo"])
    return out, cache_k, cache_v
