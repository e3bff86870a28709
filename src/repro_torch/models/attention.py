"""Attention: GQA prefill, sliding-window (local) attention, and
single-token decode against a KV cache (a ring of ``window`` slots on
local layers).

Global layers' prefill core is the hand-written flash-attention kernel on
CUDA tensors (the JAX package runs its Pallas kernel there on the TPU)
and the plain masked softmax on CPU tensors. Local layers run in plain
torch, by query block, on either device: the JAX package never hands a
window to its kernel, and runs them in XLA (``_sliding_window``, or plain
causal when the window covers the sequence). Decode is plain torch. The
recursive-halving causal schedule belongs to the training slice and
raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import rope
from repro_torch.models.param import Spec

NEG_INF = -1e30
Q_BLOCK = 512                 # query rows a block of the local path


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": Spec((d, h, hd), fan_in=d),
        "wk": Spec((d, kv, hd), fan_in=d),
        "wv": Spec((d, kv, hd), fan_in=d),
        "wo": Spec((h, hd, d), fan_in=h * hd),
    }


def local_attention(q, k, v, *, window: Optional[int],
                    q_block: int = Q_BLOCK) -> torch.Tensor:
    """Causal attention whose query i sees keys j with i - window < j <=
    i (``window=None``: every j <= i), one block of ``q_block`` queries at
    a time against only the keys that block can see, so the scores never
    span (S, S). The counterpart of the JAX package's ``_sliding_window``
    and of its ``_scan_attention`` on a causal call: scores in float32,
    the finite -1e30 mask, the weights cast to v's dtype before the PV
    product, the denominator floored at 1e-30. q: (B,S,H,hd), k/v:
    (B,S,KV,hd) -> (B,S,H,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, S, KV, G, hd)
    out = torch.empty_like(q)
    for q0 in range(0, S, q_block):
        q1 = min(q0 + q_block, S)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None]
        mask = kpos <= qpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = torch.einsum("bqkgh,bskh->bkgqs", qg[:, q0:q1].float(),
                         k[:, k0:q1].float()) * scale
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        acc = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(),
                           v[:, k0:q1].float())
        o = acc / l.clamp(min=1e-30)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(B, q1 - q0, H, hd) \
            .to(q.dtype)
    return out


def blocked_attention(q, k, v, *, causal: bool,
                      window: Optional[int] = None,
                      causal_mode: str = "masked_full"):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd). A causal call with
    a window takes the local path (plain torch; ``window >= S`` is plain
    causal), as the JAX package takes XLA's; every other call the flash
    kernel (CPU tensors: its plain version)."""
    if causal_mode not in ("masked_full", "recursive"):
        raise ValueError(f"causal_mode={causal_mode!r}")
    if window is not None and causal:
        return local_attention(q, k, v,
                               window=window if window < q.shape[1] else None)
    if causal and causal_mode == "recursive":
        raise NotImplementedError(
            "causal_mode='recursive' (recursive-halving schedule) arrives "
            "with the training slice")
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
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if cfg.attn.causal:  # decoder archs use RoPE; encoder stub skips it
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = blocked_attention(q, k, v, causal=cfg.attn.causal,
                          window=cfg.attn.window if local else None,
                          causal_mode=causal_mode)
    return _proj_out(o, p["wo"]), (k, v)


def is_ring(cfg: ModelConfig, slots: int, local: bool) -> bool:
    """A local layer's cache of exactly ``window`` slots is a ring:
    position p lives at slot p % window."""
    return local and slots == cfg.attn.window


def write_slot(cfg: ModelConfig, slots: int, cache_len: int,
               local: bool) -> int:
    """The slot decode writes position ``cache_len`` to."""
    if is_ring(cfg, slots, local):
        return cache_len % slots
    if not 0 <= cache_len < slots:
        raise ValueError(f"cache_len={cache_len} outside a cache of "
                         f"{slots} slots")
    return cache_len


def apply_attention_decode(p: dict, x: torch.Tensor, cache_k, cache_v,
                           cache_len: int, cfg: ModelConfig, *,
                           local: bool):
    """One-token decode. x: (B,1,d); cache_k/v: (B,Smax,KV,hd) with
    positions < cache_len filled. Writes this token's K/V IN PLACE (the
    JAX version returns new caches) at slot ``cache_len``, or at
    ``cache_len % window`` in a local layer's ring, and attends to the
    positions it can see: slots <= cache_len, on a local layer only those
    within the window, and in a ring once wrapped every slot. Scores and
    softmax in f32; the weights are cast to the cache's dtype before the
    PV product. Returns (out, cache_k, cache_v)."""
    B, _, d = x.shape
    Smax, KV, hd = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    H = cfg.num_heads
    G = H // KV
    at = write_slot(cfg, Smax, cache_len, local)
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q = rope(_proj_in(x, p["wq"]), pos, cfg.rope_theta)
    k = rope(_proj_in(x, p["wk"]), pos, cfg.rope_theta)
    v = _proj_in(x, p["wv"])
    cache_k[:, at] = k[:, 0]
    cache_v[:, at] = v[:, 0]
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     cache_k.float()) * hd ** -0.5
    kpos = torch.arange(Smax, device=x.device)
    if is_ring(cfg, Smax, local):
        valid = kpos <= cache_len if cache_len < Smax else None
    else:
        valid = kpos <= cache_len
        if local:
            valid &= kpos > cache_len - cfg.attn.window
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", w.to(cache_v.dtype), cache_v)
    out = _proj_out(o.reshape(B, 1, H, hd), p["wo"])
    return out, cache_k, cache_v
