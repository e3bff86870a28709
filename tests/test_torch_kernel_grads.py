"""Gradients through the two kernels of the training path, on the CPU:
each autograd Function's backward against JAX's autodiff of the JAX
package's plain version on the same numpy inputs, and the Functions'
wiring with the CUDA launch replaced by the plain forward (a CPU tensor
never reaches a kernel).

- Flash attention: ``attention_gqa_backward`` (plain torch by query
  block; the JAX package has no backward kernel) against ``jax.vjp`` of
  the JAX ``flash_attention`` wrapper's reference path: causal and not,
  Sq < Sk, a ragged last block, GQA 4 over 2 and 4 over 1, hd 80 (hubert)
  and 128. Float32: relative L2 <= 1e-5 (the same sums in another
  order). bfloat16 inputs: the gradients in bf16 against JAX's f32
  gradients of the same bf16 values, relative L2 <= 2**-7.
- Grouped matmul: dX (which the card computes with the forward kernel
  on transposed weights) and dW (``grouped_matmul_dw``) against
  ``jax.vjp`` of ``grouped_matmul_ref``, with empty groups, a group of
  one row and group sizes summing below and above T; relative L2 <= 1e-6
  (float32, one product per element).
"""
import _torch_threads  # noqa: F401  (first: see the module)
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.moe_gmm.ref import grouped_matmul_ref as j_gmm_ref
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.flash_attention.ref import attention_gqa_backward
from repro_torch.kernels.moe_gmm import moe_gmm as gmm_mod
from repro_torch.kernels.moe_gmm import ops as t_gmm
from repro_torch.kernels.moe_gmm.ref import (grouped_matmul_dw,
                                             grouped_matmul_ref)

# the kernel's module (the package exports a function of the same name)
fa_mod = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")


def rel_l2(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_attention_vjp(q, k, v, do, causal):
    """JAX's gradients of its flash wrapper's reference path. The JAX
    wrapper takes Sq == Sk; for Sq < Sk its attention_ref runs directly
    on K/V repeated to H heads, as the wrapper does."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV

    def f(q, k, v):
        if Sq == Sk:
            return j_fa.flash_attention(q, k, v, causal=causal, impl="ref")
        from repro.kernels.flash_attention.ref import attention_ref
        qf = q.transpose(0, 2, 1, 3).reshape(B * H, Sq, hd)
        kf = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1) \
            .reshape(B * H, Sk, hd)
        vf = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1) \
            .reshape(B * H, Sk, hd)
        return attention_ref(qf, kf, vf, causal=causal) \
            .reshape(B, H, Sq, hd).transpose(0, 2, 1, 3)

    _, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(g, np.float32) for g in vjp(do)]


ATTN_CASES = [  # (B, Sq, Sk, H, KV, hd, causal, block_q)
    (2, 40, 40, 2, 2, 32, True, 16),      # ragged last block
    (2, 40, 40, 2, 2, 32, False, 16),
    (1, 24, 56, 4, 2, 32, True, 8),       # Sq < Sk, GQA 4 over 2
    (1, 24, 56, 4, 1, 16, False, 256),    # one block, GQA 4 over 1
    (2, 32, 32, 2, 2, 80, False, 16),     # hubert's head dim
    (1, 64, 64, 2, 2, 128, True, 32),     # qwen's head dim
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,block_q", ATTN_CASES)
def test_flash_backward_matches_jax_autodiff(B, Sq, Sk, H, KV, hd, causal,
                                             block_q):
    r = np.random.default_rng(Sq + Sk + hd)
    q = r.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k, v = (r.standard_normal((B, Sk, KV, hd)).astype(np.float32)
            for _ in range(2))
    do = r.standard_normal((B, Sq, H, hd)).astype(np.float32)
    want = _jax_attention_vjp(q, k, v, do, causal)
    got = attention_gqa_backward(*(torch.from_numpy(x) for x in
                                   (q, k, v, do)), causal=causal,
                                 block_q=block_q)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert rel_l2(g.numpy(), w) <= 1e-5


def test_flash_backward_in_bfloat16():
    r = np.random.default_rng(9)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    q, do = (r.standard_normal((1, 48, 4, 32)).astype(np.float32)
             for _ in range(2))
    k, v = (r.standard_normal((1, 48, 2, 32)).astype(np.float32)
            for _ in range(2))
    qb, kb, vb, dob = (bf(x) for x in (q, k, v, do))
    want = _jax_attention_vjp(*(x.float().numpy() for x in
                                (qb, kb, vb, dob)), True)
    got = attention_gqa_backward(qb, kb, vb, dob, causal=True, block_q=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert rel_l2(g.float().numpy(), w) <= 2.0 ** -7


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_wiring(monkeypatch, causal):
    """FlashAttention.apply on CPU tensors with its launch replaced by
    the plain forward: the output is the plain forward's and the
    gradients are autograd's of the plain version (relative L2 1e-5)."""
    monkeypatch.setattr(fa_mod, "flash_attention_cuda",
                        t_fa.attention_gqa_ref)
    r = np.random.default_rng(4)
    q = torch.tensor(r.standard_normal((2, 20, 4, 16)), dtype=torch.float32,
                     requires_grad=True)
    k, v = (torch.tensor(r.standard_normal((2, 20, 2, 16)),
                         dtype=torch.float32, requires_grad=True)
            for _ in range(2))
    out = fa_mod.FlashAttention.apply(q, k, v, causal)
    plain = t_fa.attention_gqa_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad((out * w).sum(), [q, k, v])
    want = torch.autograd.grad((plain * w).sum(), [q, k, v])
    for a, b in zip(got, want):
        assert rel_l2(a.numpy(), b.numpy()) <= 1e-5


GMM_CASES = [  # (T, d, f, sizes)
    (40, 16, 24, [10, 0, 1, 29]),        # an empty group, a group of one
    (40, 16, 24, [10, 5, 0, 5]),         # sizes summing below T
    (40, 8, 12, [30, 20, 10, 0]),        # and above it
    (33, 24, 8, [33]),                   # one group
]


def _gmm_inputs(T, d, f, sizes):
    r = np.random.default_rng(T + d + f)
    x = r.standard_normal((T, d)).astype(np.float32)
    w = r.standard_normal((len(sizes), d, f)).astype(np.float32)
    dy = r.standard_normal((T, f)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32), dy


@pytest.mark.parametrize("T,d,f,sizes", GMM_CASES)
def test_grouped_matmul_backward_matches_jax_autodiff(T, d, f, sizes):
    x, w, gs, dy = _gmm_inputs(T, d, f, sizes)
    _, vjp = jax.vjp(lambda x, w: j_gmm_ref(x, w, gs), x, w)
    jdx, jdw = (np.asarray(g) for g in vjp(dy))
    tx, tw, tgs, tdy = (torch.from_numpy(a) for a in (x, w, gs, dy))
    dw = grouped_matmul_dw(tx, tdy, tgs, len(sizes), torch.float32)
    assert rel_l2(dw.numpy(), jdw) <= 1e-6
    # dX as the card computes it: the forward on transposed weights
    dx = grouped_matmul_ref(tdy, tw.transpose(1, 2).contiguous(), tgs)
    assert rel_l2(dx.numpy(), jdx) <= 1e-6
    # and the plain forward's own autograd
    xr, wr = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    gx, gw = torch.autograd.grad(
        (grouped_matmul_ref(xr, wr, tgs) * tdy).sum(), [xr, wr])
    assert rel_l2(gx.numpy(), jdx) <= 1e-6
    assert rel_l2(gw.numpy(), jdw) <= 1e-6


def test_grouped_matmul_function_wiring(monkeypatch):
    """GroupedMatmul.apply on CPU tensors with its launch replaced by the
    plain forward: dX goes through that launch on (E, f, d) weights (the
    counter-bearing call, twice: forward and dX), dW through the plain
    loop."""
    calls = []

    def fake(tokens, w, sizes):
        calls.append(tuple(w.shape))
        assert w.is_contiguous()
        return grouped_matmul_ref(tokens, w, sizes)

    monkeypatch.setattr(t_gmm, "grouped_matmul_cuda", fake)
    x, w, gs, dy = _gmm_inputs(40, 16, 24, [10, 0, 1, 29])
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = t_gmm.GroupedMatmul.apply(tx, tw, torch.from_numpy(gs))
    gx, gw = torch.autograd.grad((out * torch.from_numpy(dy)).sum(),
                                 [tx, tw])
    assert calls == [(4, 16, 24), (4, 24, 16)]
    _, vjp = jax.vjp(lambda x, w: j_gmm_ref(x, w, gs), x, w)
    jdx, jdw = vjp(dy)
    assert rel_l2(gx.numpy(), jdx) <= 1e-6
    assert rel_l2(gw.numpy(), jdw) <= 1e-6
    assert gmm_mod.counter.launches == 0
