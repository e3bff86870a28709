"""Model assembly: the stage plan, the parameter tree, the KV caches, and
the prefill and decode forwards.

Depth is organized into stages as in the JAX package (``stage_plan``):
each stage repeats a period of sublayers, and its parameters are stacked
on a leading layer axis. Where the JAX package scans over that axis, the
port runs a Python loop over layers. This slice serves attention + MoE /
MLP decoders with global attention: SSM layers, the hybrid shared block,
modality frontends, the int8 KV cache and the training forward raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (LOCAL_SLICE, apply_attention,
                                          apply_attention_decode,
                                          attn_specs)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed,
                                       embed_specs, mlp_specs, norm_specs,
                                       unembed)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.param import (DTYPES, ParamTree, layer_slice,
                                      materialize, stack)

SSM_SLICE = "SSM layers (mamba1/mamba2) arrive with the SSM slice"
HYBRID_SLICE = "the hybrid shared attention block arrives with the zamba2 slice"
FRONTEND_SLICE = "modality frontends arrive with the audio/vision slices"
TRAIN_SLICE = "forward_train arrives with the training slice"
INT8_SLICE = "the int8 KV cache (quantize=True) arrives with its own slice"

# ---------------------------------------------------------------------------
# Stage plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubLayer:
    kind: str                 # "attn_global" | "attn_local" | "ssm"
    moe: bool = False
    shared_after: bool = False


def stage_plan(cfg: ModelConfig):
    """-> list of (period: tuple[SubLayer], repeats: int)."""
    L = cfg.num_layers
    kinds = [cfg.layer_kind(i) for i in range(L)]
    moes = [cfg.is_moe_layer(i) for i in range(L)]
    period = len(cfg.attn.pattern)
    if cfg.moe is not None:
        period = max(period, cfg.moe.every_k_layers)
    if cfg.shared_attn_every:
        period = max(period, cfg.shared_attn_every)
    stages = []
    n_full = L // period
    if n_full:
        subs = tuple(
            SubLayer(kinds[i], moes[i],
                     shared_after=(cfg.shared_attn_every > 0
                                   and (i + 1) % cfg.shared_attn_every == 0))
            for i in range(period))
        stages.append((subs, n_full))
    rem = L - n_full * period
    if rem:
        tail = tuple(SubLayer(kinds[n_full * period + i],
                              moes[n_full * period + i])
                     for i in range(rem))
        stages.append((tail, 1))
    return stages


def check_servable(cfg: ModelConfig):
    """Raise for the parts of a config that later slices bring."""
    if cfg.frontend is not None:
        raise NotImplementedError(FRONTEND_SLICE)
    if cfg.shared_attn_every:
        raise NotImplementedError(HYBRID_SLICE)
    for subs, _ in stage_plan(cfg):
        for sub in subs:
            if sub.kind == "ssm":
                raise NotImplementedError(SSM_SLICE)
            if sub.kind == "attn_local":
                raise NotImplementedError(LOCAL_SLICE)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _sublayer_specs(cfg: ModelConfig, sub: SubLayer) -> dict:
    d = cfg.d_model
    s = {"norm1": norm_specs(d, cfg.norm), "attn": attn_specs(cfg)}
    if sub.moe:
        s["norm2"] = norm_specs(d, cfg.norm)
        s["moe"] = moe_specs(cfg)
    elif cfg.d_ff:
        s["norm2"] = norm_specs(d, cfg.norm)
        s["mlp"] = mlp_specs(d, cfg.d_ff)
    return s


def model_specs(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, under the JAX package's names."""
    check_servable(cfg)
    stages = []
    for subs, repeats in stage_plan(cfg):
        period = {f"sub{i}": _sublayer_specs(cfg, s)
                  for i, s in enumerate(subs)}
        stages.append(stack(period, repeats))
    return {"embed": embed_specs(cfg),
            "final_norm": norm_specs(cfg.d_model, cfg.norm),
            "stages": stages}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cuda") -> ParamTree:
    """Random parameters from ``gen`` (a generator on ``device``), in
    cfg.dtype, with norms and the router in float32."""
    return materialize(model_specs(cfg), gen, device, DTYPES[cfg.dtype])


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                quantize: bool = False, device="cuda"):
    """Zeroed K/V caches of max_len slots in cfg.dtype: a list of stages,
    each ``{"sub<i>": {"k", "v"}}`` stacked on the layer axis, (L, B,
    max_len, KV, hd)."""
    if quantize:
        raise NotImplementedError(INT8_SLICE)
    check_servable(cfg)
    dt = DTYPES[cfg.dtype]
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    stages = []
    for subs, repeats in stage_plan(cfg):
        shape = (repeats, batch, max_len, kv, hd)
        stages.append({f"sub{i}": {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
            for i in range(len(subs))})
    return stages


# ---------------------------------------------------------------------------
# Forward: prefill
# ---------------------------------------------------------------------------


def _ffn(p: dict, x: torch.Tensor, sub: SubLayer, cfg: ModelConfig):
    if sub.moe:
        mo, _ = apply_moe(p["moe"], apply_norm(p["norm2"], x, cfg.norm), cfg)
        return x + mo
    if cfg.d_ff:
        return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm))
    return x


def _embed_inputs(params, batch, cfg: ModelConfig):
    if cfg.frontend is not None:
        raise NotImplementedError(FRONTEND_SLICE)
    return embed(params["embed"], batch["tokens"])


def forward_train(params, batch, cfg: ModelConfig, **kw):
    raise NotImplementedError(TRAIN_SLICE)


def forward_prefill(params, batch, cfg: ModelConfig, *,
                    causal_mode: str = "masked_full",
                    max_len: Optional[int] = None):
    """Full-sequence forward emitting KV caches. -> (last_hidden (B,1,d),
    caches). The caches are S slots long, as the JAX package emits them,
    or ``max_len`` slots with the prompt's K/V at the front, ready for
    ``max_len - S`` decode steps."""
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if max_len is not None and max_len < S:
        raise ValueError(f"max_len={max_len} < prompt length {S}")
    caches = init_caches(cfg, B, max_len or S, device=x.device)
    for si, (subs, repeats) in enumerate(stage_plan(cfg)):
        for layer in range(repeats):
            layer_p = layer_slice(params["stages"][si], layer)
            for i, sub in enumerate(subs):
                p = layer_p[f"sub{i}"]
                h = apply_norm(p["norm1"], x, cfg.norm)
                a, (k, v) = apply_attention(p["attn"], h, cfg, local=False,
                                            positions=positions,
                                            causal_mode=causal_mode)
                x = x + a
                c = caches[si][f"sub{i}"]
                c["k"][layer, :, :S] = k
                c["v"][layer, :, :S] = v
                x = _ffn(p, x, sub, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x[:, -1:], caches


# ---------------------------------------------------------------------------
# Forward: decode (single token)
# ---------------------------------------------------------------------------


def forward_decode(params, tokens, caches, cache_len: int,
                   cfg: ModelConfig):
    """tokens: (B,1) int. Writes the token's K/V at slot ``cache_len`` of
    every layer's cache IN PLACE. -> (logits (B,1,V), caches)."""
    x = embed(params["embed"], tokens)
    for si, (subs, repeats) in enumerate(stage_plan(cfg)):
        for layer in range(repeats):
            layer_p = layer_slice(params["stages"][si], layer)
            for i, sub in enumerate(subs):
                p = layer_p[f"sub{i}"]
                c = caches[si][f"sub{i}"]
                h = apply_norm(p["norm1"], x, cfg.norm)
                a, _, _ = apply_attention_decode(
                    p["attn"], h, c["k"][layer], c["v"][layer], cache_len,
                    cfg, local=False)
                x = _ffn(p, x + a, sub, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["embed"], x), caches
