"""Common layers: norms, RoPE, SwiGLU MLP, embeddings (all functional)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded
from repro_torch.models.param import Spec

# ---------------------------------------------------------------------------
# Norms (params kept in f32 for stability)
# ---------------------------------------------------------------------------


def norm_specs(d: int, kind: str) -> dict:
    out = {"scale": Spec((d,), "ones", dtype=torch.float32,
                         placement=(None,))}
    if kind == "layernorm":
        out["bias"] = Spec((d,), "zeros", dtype=torch.float32,
                           placement=(None,))
    return out


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6):
    """f32 compute, cast back to x.dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq       # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rest = x[..., 2 * half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), rest], dim=-1)


# ---------------------------------------------------------------------------
# SwiGLU MLP (TP: d_ff sharded on "model")
# ---------------------------------------------------------------------------


def mlp_specs(d: int, d_ff: int) -> dict:
    return {
        "w_gate": Spec((d, d_ff), fan_in=d, placement=(None, "model")),
        "w_up": Spec((d, d_ff), fan_in=d, placement=(None, "model")),
        "w_down": Spec((d_ff, d), fan_in=d_ff, placement=("model", None)),
    }


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    if sharded.is_dtensor(x):         # the dry run's sharded model
        return sharded.mlp(p, x)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding (vocab sharded on "model")
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> dict:
    out = {"embedding": Spec((cfg.vocab_size, cfg.d_model),
                             fan_in=cfg.d_model,
                             placement=("model", None))}
    if not cfg.tie_embeddings:
        out["unembed"] = Spec((cfg.d_model, cfg.vocab_size),
                              fan_in=cfg.d_model,
                              placement=(None, "model"))
    return out


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    if sharded.is_dtensor(tokens):    # the dry run's sharded model
        return sharded.embed(p["embedding"], tokens)
    return p["embedding"][tokens.long()]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return x @ p["unembed"]
    return x @ p["embedding"].T
