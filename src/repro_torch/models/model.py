"""Model assembly: the stage plan, the parameter tree, the KV and SSM
caches, and the training, prefill and decode forwards.

Depth is organized into stages as in the JAX package (``stage_plan``):
each stage repeats a period of sublayers, and its parameters are stacked
on a leading layer axis. Where the JAX package scans over that axis, the
port runs a Python loop over layers. Served here: attention + MoE / MLP
decoders with global and sliding-window (local) attention, local layers
keeping a ring of ``window`` cache slots (gemma3, h2o-danube); Mamba1 and
Mamba2 layers with their decode states (falcon-mamba); the hybrid's one
weight-shared attention + MLP block after each period (zamba2); and the
int8 KV cache (``quantize=True``); the audio frontend stub (precomputed
frames in place of token embeddings, an encoder's own unembedding) and
the vision stub (projected patch embeddings in place of the first
``frontend_len`` token embeddings). ``forward_train`` checkpoints each
layer (``torch.utils.checkpoint``, non-reentrant), as the JAX package's
``jax.checkpoint`` of its scan body does, so a backward pass holds one
layer's activations at a time and replays that layer's forward.

On DTensor parameters and inputs (the production dry run) the same
forwards run sharded: the pieces DTensor has no rule for go to
``models/sharded.py``, the caches are placed as the dry run's (``_put``,
``_store_prompt_kv`` and ``_attn_decode_cached`` hand them over).

Local caches are laid out ring-aligned from prefill on: position p lives
at slot p % window. The JAX package's prefill instead stores the prompt's
last ``window`` positions at slots 0 .. window-1, which its ring decode
reads correctly only when (prompt - window) % window == 0; the port does
not copy that.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (apply_attention,
                                          apply_attention_decode, attn_specs,
                                          write_slot)
from repro_torch.models.layers import (apply_mlp, apply_norm, embed,
                                       embed_specs, mlp_specs, norm_specs,
                                       unembed)
from repro_torch.models.moe import apply_moe, moe_specs
from repro_torch.models.param import (DTYPES, ParamTree, Spec,
                                      full_placement, layer_views,
                                      materialize, sanitize, stack,
                                      tree_map_specs)

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


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


FSDP_THRESHOLD_BYTES = 2 << 30  # params/TP16 above this -> FSDP over "data"


def use_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() * 2 / 16 > FSDP_THRESHOLD_BYTES


def resolve_profile(cfg: ModelConfig, profile: str = "auto") -> str:
    """Sharding profile, as the JAX package's:
    * "zero": pure ZeRO-3 data parallelism over the flattened (data,
      model) axes, each leaf sharded on its largest dim, no tensor
      parallelism;
    * "tp": tensor parallelism on "model" (+ FSDP over "data" for archs
      whose params/16 exceed 2 GiB). "auto" is "tp", the JAX package's
      production default."""
    return "tp" if profile == "auto" else profile


def _zero_transform(tree):
    """Replace every Spec's placement with ZeRO-3: largest dim sharded
    over ("data", "model") when divisible by 256, else "data" when by 16,
    else replicated."""
    def f(s: Spec):
        spec = [None] * len(s.shape)
        if math.prod(s.shape) >= 4096:
            for axes, n in ((("data", "model"), 256), (("data",), 16)):
                placed = False
                for j in sorted(range(len(s.shape)),
                                key=lambda k: -s.shape[k]):
                    if s.shape[j] % n == 0 and s.shape[j] > 1:
                        spec[j] = axes if len(axes) > 1 else axes[0]
                        placed = True
                        break
                if placed:
                    break
        return dataclasses.replace(s, placement=tuple(spec))

    return tree_map_specs(f, tree)


def _axis_names(placement) -> set:
    out = set()
    for e in placement:
        out.update(e if isinstance(e, tuple) else (e,))
    return out


def _add_fsdp(tree):
    """ZeRO-3/FSDP: insert "data" into the largest unsharded dim of big
    matrices (each is all-gathered where a layer uses it; its gradient
    reduce-scatters)."""
    def f(s: Spec):
        if math.prod(s.shape) * 2 < (1 << 20) or \
                "data" in _axis_names(s.placement):
            return s
        spec = full_placement(s)
        for i in sorted(range(len(s.shape)), key=lambda i: -s.shape[i]):
            if spec[i] is None and s.shape[i] % 16 == 0:
                spec[i] = "data"
                return dataclasses.replace(s, placement=tuple(spec))
        return s
    return tree_map_specs(f, tree)


def _sublayer_specs(cfg: ModelConfig, sub: SubLayer) -> dict:
    d = cfg.d_model
    if sub.kind == "ssm":
        return {"norm1": norm_specs(d, cfg.norm),
                "ssm": (ssm_mod.mamba1_specs(cfg) if cfg.ssm.kind == "mamba1"
                        else ssm_mod.mamba2_specs(cfg))}
    s = {"norm1": norm_specs(d, cfg.norm), "attn": attn_specs(cfg)}
    if sub.moe:
        s["norm2"] = norm_specs(d, cfg.norm)
        s["moe"] = moe_specs(cfg)
    elif cfg.d_ff:
        s["norm2"] = norm_specs(d, cfg.norm)
        s["mlp"] = mlp_specs(d, cfg.d_ff)
    return s


def _shared_block_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"norm1": norm_specs(d, cfg.norm), "attn": attn_specs(cfg),
            "norm2": norm_specs(d, cfg.norm), "mlp": mlp_specs(d, cfg.d_ff)}


def model_specs(cfg: ModelConfig, profile: str = "auto") -> dict:
    """The parameter tree's shapes and placements, under the JAX
    package's names, for sharding ``profile`` ("auto" | "tp" | "zero":
    ``resolve_profile``; the shapes do not depend on it). An audio
    model's ``embed`` holds only its ``unembed`` (its inputs are frame
    embeddings); a vision model adds ``vision_proj.w``."""
    profile = resolve_profile(cfg, profile)
    fsdp = profile == "tp" and use_fsdp(cfg)
    tr = _zero_transform if profile == "zero" else \
        (_add_fsdp if fsdp else (lambda t: t))
    stages = []
    for subs, repeats in stage_plan(cfg):
        period = {f"sub{i}": _sublayer_specs(cfg, s)
                  for i, s in enumerate(subs)}
        stages.append(stack(sanitize(tr(period)), repeats))
    d = cfg.d_model
    embed_s = embed_specs(cfg)
    if cfg.frontend == "audio":
        embed_s = {"unembed": Spec((d, cfg.vocab_size), fan_in=d,
                                   placement=(None, "model"))}
    specs = {"embed": tr(embed_s),
             "final_norm": norm_specs(d, cfg.norm),
             "stages": stages}
    if cfg.shared_attn_every:
        specs["shared_block"] = tr(_shared_block_specs(cfg))
    if cfg.frontend == "vision":
        specs["vision_proj"] = {"w": Spec((d, d), fan_in=d,
                                          placement=(None, None))}
    return sanitize(specs)


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cuda") -> ParamTree:
    """Random parameters from ``gen`` (a generator on ``device``), in
    cfg.dtype, with norms, the router and the SSM's A_log, D, dt bias and
    norm scale in float32."""
    return materialize(model_specs(cfg), gen, device, DTYPES[cfg.dtype])


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------


def _cache_len_for(cfg: ModelConfig, sub: SubLayer, max_len: int) -> int:
    if sub.kind == "attn_local":
        return min(cfg.attn.window, max_len)  # ring buffer
    return max_len


def _ssm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    f = (ssm_mod.mamba1_init_state if cfg.ssm.kind == "mamba1"
         else ssm_mod.mamba2_init_state)
    return f(cfg, batch, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                quantize: bool = False, device="cuda"):
    """Zeroed caches for ``max_len`` positions: a list of stages, each
    ``{"sub<i>": ...}`` stacked on the layer axis. Attention sublayers
    hold ``{"k", "v"}`` (L, B, slots, KV, hd) in cfg.dtype, slots being
    max_len, or min(window, max_len) on a local layer (a ring when it is
    window); ``quantize=True`` holds them as ``{"k8", "v8"}`` int8 with
    ``{"ks", "vs"}`` (L, B, slots, KV) float32 scales. SSM sublayers hold
    their decode state; a sublayer followed by the shared block also has
    ``"shared<i>"``, that block's K/V of max_len slots (never quantized,
    as in the JAX package)."""
    dt = DTYPES[cfg.dtype]
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    z = lambda shape, t: torch.zeros(shape, dtype=t, device=device)
    stages = []
    for subs, repeats in stage_plan(cfg):
        period = {}
        for i, sub in enumerate(subs):
            if sub.kind == "ssm":
                st = {k: z((repeats,) + tuple(a.shape), a.dtype) for k, a in
                      _ssm_init_state(cfg, batch, dt, "meta").items()}
            else:
                shape = (repeats, batch, _cache_len_for(cfg, sub, max_len),
                         kv, hd)
                if quantize:
                    st = {"k8": z(shape, torch.int8),
                          "v8": z(shape, torch.int8),
                          "ks": z(shape[:-1], torch.float32),
                          "vs": z(shape[:-1], torch.float32)}
                else:
                    st = {"k": z(shape, dt), "v": z(shape, dt)}
            period[f"sub{i}"] = st
            if sub.shared_after:
                shape = (repeats, batch, max_len, kv, hd)
                period[f"shared{i}"] = {"k": z(shape, dt), "v": z(shape, dt)}
        stages.append(period)
    return stages


def _quantize_kv(k: torch.Tensor):
    """Per (…, head) row: scale = max |k| / 127 (at least 1e-8), codes =
    round(k / scale) as int8. -> (codes, float32 scales)."""
    kf = k.float()
    s = (kf.abs().amax(-1) / 127.0).clamp(min=1e-8)
    return torch.round(kf / s[..., None]).to(torch.int8), s


def _dequantize_kv(k8: torch.Tensor, s: torch.Tensor, dt) -> torch.Tensor:
    return (k8.float() * s[..., None]).to(dt)


def _store_kv(c: dict, layer: int, slots, k, v):
    """Write K/V rows (B, n, KV, hd) at ``slots`` (a slice or an index) of
    layer ``layer``'s cache, quantized when the cache is int8."""
    if "k8" in c:
        for name, t in (("k", k), ("v", v)):
            codes, scale = _quantize_kv(t)
            c[f"{name}8"][layer][:, slots] = codes
            c[f"{name}s"][layer][:, slots] = scale
    else:
        c["k"][layer][:, slots] = k
        c["v"][layer][:, slots] = v


def _store_prompt_kv(c: dict, layer: int, k, v):
    """The prompt's K/V (B, S, KV, hd) into a cache of C slots: the last
    min(C, S) positions, position p at slot p % C (a ring wraps; a cache
    of at least S slots takes every position at its own index)."""
    if sharded.is_dtensor(k):         # the dry run's sharded model
        return sharded.store_prompt_kv(c, layer, k, v)
    C = (c["k8"] if "k8" in c else c["k"]).shape[2]
    S = k.shape[1]
    n = min(C, S)
    start = (S - n) % C
    first = min(n, C - start)
    _store_kv(c, layer, slice(start, start + first), k[:, S - n:S - n + first],
              v[:, S - n:S - n + first])
    if first < n:
        _store_kv(c, layer, slice(0, n - first), k[:, S - n + first:],
                  v[:, S - n + first:])


def _put(dst: torch.Tensor, layer: int, t: torch.Tensor):
    """``dst[layer] = t`` (a state into its stacked cache)."""
    if sharded.is_dtensor(t):
        sharded.put_layer(dst, layer, t)
    else:
        dst[layer] = t


def _attn_decode_cached(p, x, c: dict, layer: int, cache_len: int,
                        cfg: ModelConfig, *, local: bool):
    """Decode one token against layer ``layer`` of cache ``c``. An int8
    cache is read back in cfg.dtype, the token's K/V written into that
    copy at full precision (as the JAX package attends to it), and only
    the token's slot quantized into the int8 cache; the JAX package
    re-quantizes every row each step instead."""
    if sharded.is_dtensor(x):         # the dry run's sharded model
        return sharded.attn_decode_cached(p, x, c, layer, cache_len, cfg,
                                          local=local)
    if "k8" not in c:
        out, _, _ = apply_attention_decode(p, x, c["k"][layer], c["v"][layer],
                                           cache_len, cfg, local=local)
        return out
    dt = DTYPES[cfg.dtype]
    k = _dequantize_kv(c["k8"][layer], c["ks"][layer], dt)
    v = _dequantize_kv(c["v8"][layer], c["vs"][layer], dt)
    out, k, v = apply_attention_decode(p, x, k, v, cache_len, cfg,
                                       local=local)
    at = write_slot(cfg, k.shape[1], cache_len, local)
    _store_kv(c, layer, slice(at, at + 1), k[:, at:at + 1], v[:, at:at + 1])
    return out


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


def _shared_mlp(sp, x, cfg: ModelConfig):
    return x + apply_mlp(sp["mlp"], apply_norm(sp["norm2"], x, cfg.norm))


def _embed_inputs(params, batch, cfg: ModelConfig):
    """The first hidden states (B,S,d): audio takes ``batch["frames"]``
    cast to the model dtype; otherwise the token embeddings, a vision
    model's first F replaced by ``batch["patch_embeds"]`` (B,F,d)
    projected through ``vision_proj.w``."""
    if cfg.frontend == "audio":
        return batch["frames"].to(DTYPES[cfg.dtype])
    x = embed(params["embed"], batch["tokens"])
    if cfg.frontend == "vision":
        pe = batch["patch_embeds"].to(x.dtype) @ params["vision_proj"]["w"]
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def _train_sub(p, x, aux, sub: SubLayer, cfg: ModelConfig, positions,
               causal_mode):
    """One sublayer of the training forward: -> (x, aux + its aux loss)."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if sub.kind == "ssm":
        f = (ssm_mod.apply_mamba1 if cfg.ssm.kind == "mamba1"
             else ssm_mod.apply_mamba2)
        return x + f(p["ssm"], h, cfg), aux
    a, _ = apply_attention(p["attn"], h, cfg, local=sub.kind == "attn_local",
                           positions=positions, causal_mode=causal_mode)
    x = x + a
    if sub.moe:
        mo, a = apply_moe(p["moe"], apply_norm(p["norm2"], x, cfg.norm), cfg)
        return x + mo, aux + a
    return _ffn(p, x, sub, cfg), aux


def _train_layer(layer_p, sp, x, aux, *, subs, cfg: ModelConfig, positions,
                 causal_mode):
    """One layer of a stage (its period of sublayers, and the shared block
    after a sublayer marked for it): the body the JAX package scans."""
    for i, sub in enumerate(subs):
        x, aux = _train_sub(layer_p[f"sub{i}"], x, aux, sub, cfg, positions,
                            causal_mode)
        if sub.shared_after:
            h = apply_norm(sp["norm1"], x, cfg.norm)
            a, _ = apply_attention(sp["attn"], h, cfg, local=False,
                                   positions=positions,
                                   causal_mode=causal_mode)
            x = _shared_mlp(sp, x + a, cfg)
    return x, aux


def forward_train(params, batch, cfg: ModelConfig, *,
                  causal_mode: str = "masked_full", remat: bool = True):
    """The full-sequence training forward. -> (hidden (B,S,d) after the
    final norm, the MoE layers' summed aux loss as a float32 scalar).
    ``remat=True`` checkpoints each layer when gradients are on: the
    backward keeps a layer's input and replays its forward, kernels
    included."""
    x = _embed_inputs(params, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sp = params["shared_block"] if cfg.shared_attn_every else None
    for si, (subs, _) in enumerate(stage_plan(cfg)):
        body = functools.partial(_train_layer, subs=subs, cfg=cfg,
                                 positions=positions,
                                 causal_mode=causal_mode)
        for layer_p in layer_views(params["stages"][si]):
            if remat and torch.is_grad_enabled():
                x, aux = checkpoint(body, layer_p, sp, x, aux,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = body(layer_p, sp, x, aux)
    return apply_norm(params["final_norm"], x, cfg.norm), aux


def _prefill_ssm(p, h, x, cfg: ModelConfig):
    """Run an SSM sublayer over the full sequence: -> (x + its output,
    its decode state)."""
    f = (ssm_mod.apply_mamba1_with_state if cfg.ssm.kind == "mamba1"
         else ssm_mod.apply_mamba2_with_state)
    y, st = f(p, h, cfg)
    return x + y, st


def forward_prefill(params, batch, cfg: ModelConfig, *,
                    causal_mode: str = "masked_full",
                    max_len: Optional[int] = None, quantize: bool = False):
    """Full-sequence forward emitting caches. -> (last_hidden (B,1,d),
    caches). The caches hold ``max_len`` positions (default: the prompt's
    S, as the JAX package emits them), ready for ``max_len - S`` decode
    steps: global and shared-block K/V at slots 0 .. S-1, local layers'
    last min(window, S) positions ring-aligned, SSM states after the
    prompt. ``quantize=True`` stores the attention K/V as int8."""
    x = _embed_inputs(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if max_len is not None and max_len < S:
        raise ValueError(f"max_len={max_len} < prompt length {S}")
    if sharded.is_dtensor(x):         # the dry run's sharded model
        caches = sharded.init_caches(cfg, B, max_len or S,
                                     quantize=quantize, like=x)
    else:
        caches = init_caches(cfg, B, max_len or S, quantize=quantize,
                             device=x.device)
    sp = params["shared_block"] if cfg.shared_attn_every else None
    for si, (subs, _) in enumerate(stage_plan(cfg)):
        for layer, layer_p in enumerate(layer_views(params["stages"][si])):
            for i, sub in enumerate(subs):
                p = layer_p[f"sub{i}"]
                c = caches[si][f"sub{i}"]
                h = apply_norm(p["norm1"], x, cfg.norm)
                if sub.kind == "ssm":
                    x, st = _prefill_ssm(p["ssm"], h, x, cfg)
                    for name, t in st.items():
                        _put(c[name], layer, t)
                else:
                    a, (k, v) = apply_attention(
                        p["attn"], h, cfg, local=sub.kind == "attn_local",
                        positions=positions, causal_mode=causal_mode)
                    x = x + a
                    _store_prompt_kv(c, layer, k, v)
                    x = _ffn(p, x, sub, cfg)
                if sub.shared_after:
                    h = apply_norm(sp["norm1"], x, cfg.norm)
                    a, (k, v) = apply_attention(sp["attn"], h, cfg,
                                                local=False,
                                                positions=positions,
                                                causal_mode=causal_mode)
                    x = _shared_mlp(sp, x + a, cfg)
                    _store_prompt_kv(caches[si][f"shared{i}"], layer, k, v)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x[:, -1:], caches


# ---------------------------------------------------------------------------
# Forward: decode (single token)
# ---------------------------------------------------------------------------


def forward_decode(params, tokens, caches, cache_len: int,
                   cfg: ModelConfig):
    """tokens: (B,1) int. Writes the token's K/V at its slot of every
    attention cache and replaces every SSM state IN PLACE. ->
    (logits (B,1,V), caches)."""
    x = embed(params["embed"], tokens)
    sp = params["shared_block"] if cfg.shared_attn_every else None
    for si, (subs, _) in enumerate(stage_plan(cfg)):
        for layer, layer_p in enumerate(layer_views(params["stages"][si])):
            for i, sub in enumerate(subs):
                p = layer_p[f"sub{i}"]
                c = caches[si][f"sub{i}"]
                h = apply_norm(p["norm1"], x, cfg.norm)
                if sub.kind == "ssm":
                    f = (ssm_mod.apply_mamba1_decode
                         if cfg.ssm.kind == "mamba1"
                         else ssm_mod.apply_mamba2_decode)
                    y, st = f(p["ssm"], h, {k: t[layer] for k, t in
                                            c.items()}, cfg)
                    x = x + y
                    for name, t in st.items():
                        _put(c[name], layer, t)
                else:
                    a = _attn_decode_cached(
                        p["attn"], h, c, layer, cache_len, cfg,
                        local=sub.kind == "attn_local")
                    x = _ffn(p, x + a, sub, cfg)
                if sub.shared_after:
                    h = apply_norm(sp["norm1"], x, cfg.norm)
                    a = _attn_decode_cached(sp["attn"], h,
                                            caches[si][f"shared{i}"], layer,
                                            cache_len, cfg, local=False)
                    x = _shared_mlp(sp, x + a, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["embed"], x), caches
