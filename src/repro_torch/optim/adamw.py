"""AdamW with global-norm clipping and a cosine schedule, over the
parameter tree's tensors (the port of the JAX package's
``optim/adamw.py``, with its float32 arithmetic in its order).

The moments are nested dicts and lists of tensors shaped like the
parameters (``repro_torch.tree``), in ``moment_dtype``; the step counter
is an int32 tensor. Where the JAX package returns new trees,
``adamw_update`` writes the parameters, the moments and the counter IN
PLACE under ``torch.no_grad()``, a leaf at a time and a large leaf a
leading slice at a time, so its float32 temporaries stay near
``_SLICE_ELEMS`` elements whatever the model's size.
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import tree_leaves, tree_map

# elements of a leaf updated at once: a larger leaf goes by leading slices
_SLICE_ELEMS = 1 << 28


def adamw_init(params, moment_dtype=torch.float32) -> dict:
    """{"step": int32 0, "m": zeros, "v": zeros}, the moments on each
    parameter's device in ``moment_dtype``."""
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / ||grads||) in float32 and cast
    back to each leaf's dtype, the global norm as a float32 tensor)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int,
                    total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from
    ``peak_lr`` down to ``floor * peak_lr`` at ``total``. ``step``: an
    int32 tensor; -> a float32 tensor."""
    warm = peak_lr * (step + 1) / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def _slices(t: torch.Tensor):
    """``t`` cut along its leading axis into views of at most
    _SLICE_ELEMS elements (as many leading rows as fit; a row larger than
    that is cut the same way)."""
    if t.numel() <= _SLICE_ELEMS or t.dim() == 0:
        return [t]
    row = t[0].numel()
    if row > _SLICE_ELEMS:
        return [s for r in t for s in _slices(r)]
    return list(t.split(_SLICE_ELEMS // row))


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """One AdamW step with bias correction and decoupled weight decay,
    in float32, each result cast to its leaf's dtype. Updates
    ``params`` and ``opt_state`` in place and returns them."""
    step = opt_state["step"] + 1
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(g, m, v, p):
        gf = g.float()
        mn = b1 * m.float() + (1 - b1) * gf
        vn = b2 * v.float() + (1 - b2) * torch.square(gf)
        u = (mn / bc1) / (torch.sqrt(vn / bc2) + eps)
        u = u + weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        m.copy_(mn)
        v.copy_(vn)

    for leaves in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                      tree_leaves(opt_state["v"]), tree_leaves(params)):
        for g, m, v, p in zip(*(_slices(x) for x in leaves)):
            upd(g, m, v, p)
    opt_state["step"].copy_(step)
    return params, opt_state
