"""Serving step functions: prefill (full-sequence forward emitting KV
caches + the first greedy token) and decode (one token against the
caches, greedy). The training step arrives with the training slice."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import unembed
from repro_torch.models.model import (check_servable, forward_decode,
                                      forward_prefill)


def make_prefill_step(cfg: ModelConfig, *, causal_mode="masked_full",
                      max_len: Optional[int] = None, quantize: bool = False):
    """-> prefill_step(params, batch) -> (next_tok (B,1) int32, caches,
    logits (B,1,V)). ``max_len``: cache positions, prompt + tokens to come
    (default: the prompt length, as the JAX package emits);
    ``quantize=True``: int8 K/V caches (``model.init_caches``). The JAX
    step returns no logits; the port's callers check them."""
    if cfg.is_encoder:
        raise NotImplementedError(
            "encoder-only archs (no decode) arrive with the hubert slice")
    check_servable(cfg)

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
    check_servable(cfg)

    @torch.no_grad()
    def decode_step(params, tokens, caches, cache_len: int):
        logits, caches = forward_decode(params, tokens, caches,
                                        int(cache_len), cfg)
        return logits.argmax(-1).to(torch.int32), caches, logits

    return decode_step
