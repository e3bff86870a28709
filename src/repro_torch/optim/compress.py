"""int8 error-feedback gradient compression (the port of the JAX
package's ``optim/compress.py``): each gradient leaf, plus the residual
fed back from the last step, is quantized to int8 with one float32 scale
(max |g| / 127); the quantization residual is carried to the next step,
which keeps the compression unbiased in the long run."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_gradients(grads, error_fbk):
    """-> (tree of (int8 codes, float32 scale) tuples, new residuals)."""
    def comp(g, e):
        gf = g.float() + e
        scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return (q, scale), gf - q.float() * scale

    out = tree_map(comp, grads, error_fbk)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def decompress_gradients(qs):
    return tree_map(lambda t: t[0].float() * t[1], qs)
