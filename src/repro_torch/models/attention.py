"""Attention: GQA prefill and training, sliding-window (local)
attention, and single-token decode against a KV cache (a ring of
``window`` slots on local layers).

Global layers' core is the hand-written flash-attention kernel on CUDA
tensors (the JAX package runs its Pallas kernel there on the TPU), with
a backward of its own (``kernels/flash_attention/ops.py``), and the plain
masked softmax under autograd on CPU tensors. Local layers run in plain
torch, by query block, on either device: the JAX package never hands a
window to its kernel, and runs them in XLA (``_sliding_window``, or plain
causal when the window covers the sequence). Decode is plain torch. The
recursive-halving causal schedule (``causal_mode="recursive"``) is the
JAX package's XLA schedule, blocked online softmax in plain torch, and
runs only on CPU tensors: on CUDA tensors the kernel takes every call
with no window, as the JAX package's Pallas kernel does on the TPU
before it reads ``causal_mode``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import rope
from repro_torch.models import sharded
from repro_torch.models.param import Spec

NEG_INF = -1e30
Q_BLOCK = 512                 # query rows a block of the local path


def attn_specs(cfg: ModelConfig) -> dict:
    """Heads sharded on "model" (TP), as the JAX package's. Where the
    heads do not divide the axis (yi 56, llama4 40) the projections are
    replicated (FSDP still shards their storage) and the sharded
    attention runs sequence-parallel: queries sharded on S, K/V whole."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    if h % 16:
        rep = (None, None, None)
        return {
            "wq": Spec((d, h, hd), fan_in=d, placement=rep),
            "wk": Spec((d, kv, hd), fan_in=d, placement=rep),
            "wv": Spec((d, kv, hd), fan_in=d, placement=rep),
            "wo": Spec((h, hd, d), fan_in=h * hd, placement=rep),
        }
    return {
        "wq": Spec((d, h, hd), fan_in=d, placement=(None, "model", None)),
        "wk": Spec((d, kv, hd), fan_in=d, placement=(None, "model", None)),
        "wv": Spec((d, kv, hd), fan_in=d, placement=(None, "model", None)),
        "wo": Spec((h, hd, d), fan_in=h * hd,
                   placement=("model", None, None)),
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
                      window: Optional[int] = None, q_block: int = Q_BLOCK,
                      kv_block: int = Q_BLOCK,
                      causal_mode: str = "masked_full"):
    """q: (B,S,H,hd), k/v: (B,S,KV,hd) -> (B,S,H,hd). A causal call with
    a window takes the local path (plain torch, ``q_block`` queries a
    block; ``window >= S`` is plain causal), as the JAX package takes
    XLA's. Every other call on CUDA tensors takes the flash kernel,
    whatever ``causal_mode`` says. On CPU tensors, a causal call under
    ``causal_mode="recursive"`` with S > q_block takes the
    recursive-halving schedule (tiles of q_block x kv_block; the JAX
    package needs S a multiple of both, the port cuts ragged tiles); the
    rest the kernel's plain version (the masked softmax)."""
    if causal_mode not in ("masked_full", "recursive"):
        raise ValueError(f"causal_mode={causal_mode!r}")
    S = q.shape[1]
    if window is not None and causal:
        return local_attention(q, k, v, window=window if window < S else None,
                               q_block=q_block)
    if (causal and causal_mode == "recursive" and S > q_block
            and q.device.type == "cpu"):
        B, _, H, hd = q.shape
        KV = k.shape[2]
        qg = q.reshape(B, S, KV, H // KV, hd)
        acc, _, l = _recursive_causal(qg, k, v, 0, 0, hd ** -0.5, q_block,
                                      kv_block, depth=3)
        # (B,KV,G,S,hd) -> (B,S,H,hd); the JAX package reshapes without
        # this transpose, which scrambles heads when H > 1 (ROADMAP)
        return _finalize(acc, l, q.dtype).permute(0, 3, 1, 2, 4) \
            .reshape(B, S, H, hd)
    return fa_ops.flash_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# Recursive-halving schedule (blocked online softmax; CPU tensors)
# ---------------------------------------------------------------------------


def _block_attend(q, k, v, qpos, kpos, *, causal: bool, scale: float):
    """One (q-block, kv-block) tile. q: (B,Qb,KV,G,hd), k/v: (B,Kb,KV,hd).
    -> unnormalised float32 (acc (B,KV,G,Qb,hd), m, l (B,KV,G,Qb))."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if causal:
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(),
                       v.float())
    return acc, m, p.sum(-1)


def _online_combine(carry, new):
    acc0, m0, l0 = carry
    acc1, m1, l1 = new
    m = torch.maximum(m0, m1)
    a0 = torch.exp(m0 - m)
    a1 = torch.exp(m1 - m)
    return acc0 * a0[..., None] + acc1 * a1[..., None], m, l0 * a0 + l1 * a1


def _finalize(acc, l, dtype):
    return (acc / l.clamp(min=1e-30)[..., None]).to(dtype)


def _scan_attention_state(qg, k, v, *, causal: bool, q_block: int,
                          kv_block: int, scale: float, qoff: int = 0,
                          koff: int = 0):
    """Every query block against every key block, online: -> float32
    (acc (B,KV,G,S,hd), m, l (B,KV,G,S)). Queries sit at positions qoff +
    i, keys at koff + j."""
    B, S, KV, G, hd = qg.shape
    Sk = k.shape[1]
    dev = qg.device
    out = []
    for q0 in range(0, S, q_block):
        n = min(q_block, S - q0)
        qpos = qoff + q0 + torch.arange(n, device=dev)
        state = (torch.zeros((B, KV, G, n, hd), device=dev),
                 torch.full((B, KV, G, n), NEG_INF, device=dev),
                 torch.zeros((B, KV, G, n), device=dev))
        for k0 in range(0, Sk, kv_block):
            kpos = koff + torch.arange(k0, min(k0 + kv_block, Sk),
                                       device=dev)
            state = _online_combine(state, _block_attend(
                qg[:, q0:q0 + n], k[:, k0:k0 + kv_block],
                v[:, k0:k0 + kv_block], qpos, kpos, causal=causal,
                scale=scale))
        out.append(state)
    return tuple(torch.cat(parts, dim=3) for parts in zip(*out))


def _recursive_causal(qg, k, v, qoff, koff, scale, q_block, kv_block,
                      depth):
    """(acc, m, l) of causal attention of qg against k/v starting at the
    same position. Recursive halving: [A(Q1,K1); D(Q2,K1) A(Q2,K2)], the
    dense block D with no masked-out tiles."""
    S = qg.shape[1]
    if depth == 0 or S <= q_block:
        return _scan_attention_state(qg, k, v, causal=True,
                                     q_block=min(q_block, S),
                                     kv_block=min(kv_block, S), scale=scale,
                                     qoff=qoff, koff=koff)
    h = S // 2
    top = _recursive_causal(qg[:, :h], k[:, :h], v[:, :h], qoff, koff,
                            scale, q_block, kv_block, depth - 1)
    lo_dense = _scan_attention_state(qg[:, h:], k[:, :h], v[:, :h],
                                     causal=False, q_block=min(q_block, h),
                                     kv_block=min(kv_block, h), scale=scale,
                                     qoff=qoff + h, koff=koff)
    lo_diag = _recursive_causal(qg[:, h:], k[:, h:], v[:, h:], qoff + h,
                                koff + h, scale, q_block, kv_block,
                                depth - 1)
    lo = _online_combine(lo_dense, lo_diag)
    return tuple(torch.cat([a, b], dim=3) for a, b in zip(top, lo))


def _proj_in(x, w):
    """(B,S,d) @ (d,h,hd) -> (B,S,h,hd)."""
    if sharded.is_dtensor(x):
        return sharded.proj_in(x, w)
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def _proj_out(o, w):
    """(B,S,h,hd) @ (h,hd,d) -> (B,S,d)."""
    h, hd, d = w.shape
    out = o.flatten(-2) @ w.reshape(h * hd, d)
    if sharded.is_dtensor(out):       # the dry run's sharded model
        return sharded.settle(out)
    return out


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    local: bool, positions: torch.Tensor,
                    causal_mode: str = "masked_full"):
    """Training/prefill path. x: (B,S,d). Returns (out, (k, v))."""
    if sharded.is_dtensor(x):         # the dry run's sharded model
        return sharded.apply_attention(p, x, cfg, local=local,
                                       positions=positions,
                                       causal_mode=causal_mode)
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if cfg.attn.causal:  # decoder archs use RoPE; encoder stub skips it
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    o = blocked_attention(q, k, v, causal=cfg.attn.causal,
                          window=cfg.attn.window if local else None,
                          q_block=min(Q_BLOCK, S), kv_block=min(Q_BLOCK, S),
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
