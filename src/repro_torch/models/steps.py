"""Step functions: the training step (forward with each layer
checkpointed, the vocab-chunked cross entropy, backward, clipping, the
cosine schedule and AdamW), prefill (full-sequence forward emitting KV
caches + the first greedy token; an encoder's full forward and loss) and
decode (one token against the caches, greedy).

The vocab-chunked cross entropy bounds the logits' working set to one
(B, chunk, V) float32 block instead of (B, S, V): each chunk is
checkpointed, so the backward recomputes its logits rather than keeping
them (2.5 GB at qwen2-moe's vocab of 151,936, batch 8, chunk 512).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharded
from repro_torch.models.layers import unembed
from repro_torch.models.model import (forward_decode, forward_prefill,
                                      forward_train)
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               cosine_schedule)
from repro_torch.tree import tree_leaves

AUX_LOSS_WEIGHT = 0.01


def _xent_chunk(embed_params, hs, ys):
    if sharded.is_dtensor(hs):        # the dry run's sharded model
        return sharded.xent_chunk(embed_params, hs, ys)
    logits = unembed(embed_params, hs).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ys.clamp(min=0).long()[..., None])[..., 0]
    mask = (ys >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_xent(embed_params, hidden, labels, *, chunk: int = 512):
    """hidden: (B,S,d); labels: (B,S) int (-1 = masked). -> (sum of the
    negative log-likelihoods in float32, the count of unmasked labels).
    S // chunk chunks of min(chunk, S) positions, as the JAX package
    cuts them; each chunk checkpointed when gradients are on."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros_like(tot)
    for c in range(S // chunk):
        cut = slice(c * chunk, (c + 1) * chunk)
        if torch.is_grad_enabled():
            nll, n = checkpoint(_xent_chunk, embed_params, hidden[:, cut],
                                labels[:, cut], use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, n = _xent_chunk(embed_params, hidden[:, cut],
                                 labels[:, cut])
        tot, cnt = tot + nll, cnt + n
    return tot, cnt


def loss_fn(params, batch, cfg: ModelConfig, *,
            causal_mode="masked_full"):
    """-> (cross entropy + AUX_LOSS_WEIGHT * aux, (cross entropy, aux))."""
    hidden, aux = forward_train(params, batch, cfg, causal_mode=causal_mode)
    tot, cnt = chunked_xent(params["embed"], hidden, batch["labels"])
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + AUX_LOSS_WEIGHT * aux, (loss, aux)


def _grads(params, batch, cfg, causal_mode):
    """-> (gradients in leaf order, each in its parameter's dtype and zero
    for a parameter the loss does not reach, ce, aux)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        total, (ce, aux) = loss_fn(params, batch, cfg,
                                   causal_mode=causal_mode)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return grads, ce.detach(), aux.detach()


def make_train_step(cfg: ModelConfig, *, peak_lr=3e-4, warmup=100,
                    total_steps=10000, causal_mode="masked_full",
                    microbatches: int = 1):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "aux", "grad_norm", "lr"} as float32 tensors).
    ``params`` is a ParamTree (its gradients are switched on), updated
    in place with ``opt_state`` (``optim.adamw_init``'s). ``batch``: a
    dict of tensors on the parameters' device, ``labels`` (B,S) beside
    ``tokens`` (B,S), ``frames`` (B,S,d) (audio) or ``patch_embeds``
    (B,F,d) (vision). ``microbatches`` > 1 splits the batch into that many
    sequential microbatches and averages their gradients accumulated in
    float32 (their ce and aux too), as the JAX package's scan does;
    with 1, the gradients stay in the parameters' dtype. Then: clipping
    to a global norm of 1.0, the cosine schedule's rate at the state's
    step, AdamW."""

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        if microbatches == 1:
            grads, ce, aux = _grads(params, batch, cfg, causal_mode)
        else:
            grads, ce, aux = None, 0.0, 0.0
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                g, c, a = _grads(params, mb, cfg, causal_mode)
                if grads is None:
                    grads = [torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device) for x in g]
                for acc, x in zip(grads, g):
                    acc.add_(x.float())
                ce, aux = ce + c, aux + a
                del g
            for acc in grads:
                acc.div_(microbatches)
            ce, aux = ce / microbatches, aux / microbatches
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(opt_state["step"], peak_lr=peak_lr,
                             warmup=warmup, total=total_steps)
        adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": ce, "aux": aux,
                                   "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, causal_mode="masked_full",
                      max_len: Optional[int] = None, quantize: bool = False):
    """-> prefill_step(params, batch) -> (next_tok (B,1) int32, caches,
    logits (B,1,V)). ``max_len``: cache positions, prompt + tokens to come
    (default: the prompt length, as the JAX package emits);
    ``quantize=True``: int8 K/V caches (``model.init_caches``). The JAX
    step returns no logits; the port's callers check them.

    An encoder-only config has no decode: its step is
    ``encode_step(params, batch) -> loss``, the full forward (no
    checkpointing) and the mean cross entropy of its per-position
    classification, as the JAX package's."""
    if cfg.is_encoder:
        @torch.no_grad()
        def encode_step(params, batch):
            hidden, _ = forward_train(params, batch, cfg, remat=False)
            tot, cnt = chunked_xent(params["embed"], hidden,
                                    batch["labels"])
            return tot / torch.clamp(cnt, min=1.0)

        return encode_step

    @torch.no_grad()
    def prefill_step(params, batch):
        last_h, caches = forward_prefill(params, batch, cfg,
                                         causal_mode=causal_mode,
                                         max_len=max_len, quantize=quantize)
        logits = unembed(params["embed"], last_h)
        return logits.argmax(-1).to(torch.int32), caches, logits

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """-> decode_step(params, tokens, caches, cache_len) -> (next_tok
    (B,1) int32, caches, logits (B,1,V)). The caches are updated in
    place."""

    @torch.no_grad()
    def decode_step(params, tokens, caches, cache_len: int):
        logits, caches = forward_decode(params, tokens, caches,
                                        int(cache_len), cfg)
        return logits.argmax(-1).to(torch.int32), caches, logits

    return decode_step
