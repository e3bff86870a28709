"""The flash-attention forward behind one wrapper.

On CUDA tensors ``flash_attention`` launches the hand-written Hopper
kernel (``kernels/csrc/flash_attention.cu``; TMA loads and wgmma for
bfloat16, a plain FMA kernel for float32); on CPU tensors it runs the
plain masked softmax (``ref.attention_ref``); ``ref.attention_tiled``
replays the bfloat16 kernel's tile-level numerics. Same semantics as the
JAX package's ``flash_attention_pallas``: scale hd**-0.5 after QK, the
finite -1e30 mask, queries at the last Sq key positions, the denominator
floored at 1e-30, float32 inside, the output in q's dtype.
``counter.launches`` counts kernel launches (forward only).

``FlashAttention`` is the kernel as an autograd Function: its forward
launches the kernel and saves q, k and v; its backward is
``ref.attention_gqa_backward``, plain torch by query block, which
recomputes the scores rather than reading the forward's row
log-sum-exp (the kernel does not write it). The JAX package has no
backward kernel (JAX differentiates its XLA path off the TPU), so a
hand-written backward is performance work for a later PR.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_gqa_backward,
                                                     attention_ref)

# the head dims the kernel is built for; an hd runs at the next of them
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
BLOCK_Q, BLOCK_K = 128, 64     # the bfloat16 kernel's query and key tiles
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])


def _need(cond: bool, what: str):
    if not cond:
        raise ValueError(f"flash_attention_cuda: {what}")


def kernel_head_dim(hd: int) -> int:
    """The head dim the kernel runs ``hd`` at: the next of
    KERNEL_HEAD_DIMS, its columns past hd zero-filled by TMA. hd must be a
    multiple of 8 (TMA's 16-byte strides) in [8, 256]; raises otherwise."""
    _need(hd % 8 == 0 and 8 <= hd <= KERNEL_HEAD_DIMS[-1],
          f"hd={hd} is not a multiple of 8 in [8, {KERNEL_HEAD_DIMS[-1]}]")
    return next(h for h in KERNEL_HEAD_DIMS if h >= hd)


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """x itself if the kernel can read it through its strides (hd
    contiguous; for bf16, TMA's 16-byte aligned base and strides), else a
    contiguous copy."""
    ok = x.stride(-1) == 1
    if x.dtype == torch.bfloat16:
        ok = ok and x.data_ptr() % 16 == 0 and all(
            s % 8 == 0 and s > 0 for s, n in zip(x.stride()[:-1], x.shape)
            if n > 1)
    return x if ok else x.contiguous()


def _strides(x: torch.Tensor):
    """(batch, seq, head) strides; a dimension of size 1 is only ever read
    at 0, so its stride is any valid one (torch may report 1 for it)."""
    return [s if n > 1 else x.numel() for s, n in zip(x.stride()[:3],
                                                      x.shape)]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel. q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with
    H % KV == 0 (query head h reads KV head h // (H // KV)); any strides
    with hd contiguous. -> (B, Sq, H, hd) in q's dtype, on the current
    stream, not synchronised."""
    dev = q.device
    _need(dev.type == "cuda" and k.device == dev and v.device == dev,
          "all tensors on one CUDA device")
    _need(q.dtype in DTYPE_CODES and k.dtype == q.dtype
          and v.dtype == q.dtype, "q, k, v all float32 or all bfloat16")
    _need(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
          "q (B, Sq, H, hd), k and v (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _need(k.shape[0] == B and k.shape[3] == hd, "batch or hd mismatch")
    kernel_head_dim(hd)
    _need(KV >= 1 and H % KV == 0, f"H={H} not a multiple of KV={KV}")
    _need(1 <= Sq <= Sk, f"Sq={Sq} must be in [1, Sk={Sk}]")
    _need(B <= 65535 and H <= 65535, "B and H at most 65535")
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in _strides(t)))
    fn = build.function("flash_attention", "flash_attention_launch",
                        _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), B, H, H // KV, Sq, Sk, hd,
                strides, int(causal), float(hd) ** -0.5, stream)
    build.check("flash_attention", rc)
    counter.launches += 1
    return o


class FlashAttention(torch.autograd.Function):
    """``flash_attention_cuda(q, k, v, causal=causal)`` with a gradient:
    apply(q, k, v, causal) on (B, Sq, H, hd) / (B, Sk, KV, hd) tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_cuda(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_gqa_backward(q, k, v, do, causal=ctx.causal),
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BH, Sk, hd), Sq <= Sk (the queries are the
    last Sq key positions). -> (BH, Sq, hd). The port of
    flash_attention_pallas: the kernel on CUDA tensors (differentiable
    through ``FlashAttention``), the plain attention under autograd on
    CPU tensors."""
    dev = q.device
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    return FlashAttention.apply(q[:, :, None], k[:, :, None], v[:, :, None],
                                causal)[:, :, 0]
