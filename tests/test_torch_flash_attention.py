"""The port's attention (its plain version, which the wrapper runs on CPU
tensors) against the JAX package's Pallas flash-attention kernel in
interpret mode and its jnp oracle, on the same numpy inputs.

Tolerances: float32 to atol 1e-5 — the two sides compute the same
float32 softmax and sum in another order (the Pallas side blocked and
online), which moves outputs of magnitude ~1 by ~1e-7. bfloat16 to atol
2e-2 as in tests/test_kernels.py: outputs are rounded to bf16 (8 bits),
so a sum-order difference can flip the last bit of values up to ~4.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as t_ops

ATOL = {np.float32: 1e-5, jnp.bfloat16: 2e-2}
T_DTYPE = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _j(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _t(a, dtype):
    return torch.from_numpy(a).to(T_DTYPE[dtype])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


# the shapes of tests/test_kernels.py::test_flash_attention
@pytest.mark.parametrize("B,Sq,Sk,hd,causal,dtype", [
    (2, 128, 128, 64, True, np.float32),
    (1, 256, 256, 128, True, np.float32),
    (2, 128, 128, 64, False, np.float32),
    (1, 128, 384, 64, True, np.float32),   # decode-suffix layout
    (1, 128, 128, 64, True, jnp.bfloat16),
])
def test_plain_matches_pallas_and_oracle(B, Sq, Sk, hd, causal, dtype):
    q, k, v = _inputs([(B, Sq, hd), (B, Sk, hd), (B, Sk, hd)], seed=Sq + Sk)
    got = flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          causal=causal)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (B, Sq, hd)
    jq, jk, jv = _j(q, dtype), _j(k, dtype), _j(v, dtype)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=128,
                                    block_k=128, interpret=True)
    oracle = j_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=ATOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), atol=ATOL[dtype])


@pytest.mark.parametrize("Sq,Sk,causal", [(37, 37, True), (5, 70, True),
                                          (70, 70, False), (1, 9, True)])
def test_ragged_lengths_match_oracle(Sq, Sk, causal):
    """Lengths off any tile multiple, and one query against a suffix."""
    q, k, v = _inputs([(3, Sq, 32), (3, Sk, 32), (3, Sk, 32)], seed=Sk)
    got = flash_attention(_t(q, np.float32), _t(k, np.float32),
                          _t(v, np.float32), causal=causal)
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("H,KV,dtype", [(4, 2, np.float32), (4, 4, np.float32),
                                         (8, 2, jnp.bfloat16)])
def test_gqa_ops_matches_pallas_ops(H, KV, dtype):
    """(B, S, H, hd) with query head h reading KV head h // (H // KV)."""
    B, S, hd = 2, 128, 64
    q, k, v = _inputs([(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)],
                      seed=H * 10 + KV)
    got = t_ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                causal=True)
    want = j_ops.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                 causal=True, impl="pallas")
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype])


def test_large_scores_stay_finite():
    """Scores ~100 apart: the finite -1e30 mask and the running max keep
    the softmax finite, as in the reference. exp() turns the scores'
    float32 rounding (~1e-5 at this size) into relative error of the
    weights, hence rtol 1e-4."""
    q, k, v = _inputs([(1, 16, 32), (1, 16, 32), (1, 16, 32)], seed=3)
    q *= 30.0
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)


def test_wrapper_raises_off_cpu_and_cuda():
    """The kernel's wrapper has no route off the CPU and CUDA; the model's
    entry point (ops) takes meta tensors, the operator counter's dry run:
    the output's shape, the kernel's 2 matrix products of 2 hd flops a
    visible (query, key) pair charged."""
    from repro_torch.launch import op_cost
    x = torch.empty((1, 8, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(x, x, x)
    q = x[:, :, None]
    cost = op_cost.measure(t_ops.flash_attention, q, q, q)
    assert cost.matmul_flops == 4 * 32 * (8 * 9 // 2)
    assert t_ops.flash_attention(q, q, q).shape == (1, 8, 1, 32)


# (B, Sq, Sk, hd, causal): a full block, ragged lengths, Sq < Sk, a
# non-causal block past one tile, one query
TILED = [(2, 128, 128, 64, True), (1, 200, 200, 128, True),
         (2, 37, 300, 32, True), (1, 130, 130, 64, False),
         (1, 1, 129, 128, True)]


@pytest.mark.parametrize("B,Sq,Sk,hd,causal", TILED)
def test_kernel_tile_replay_matches_oracle(B, Sq, Sk, hd, causal):
    """The bfloat16 kernel's numerics replayed tile by tile in torch
    (BLOCK_Q / BLOCK_K as built, base-2 online softmax, p split hi + lo)
    against the JAX oracle on the same bf16-valued inputs, in float32.
    The split carries p to ~2**-17 of itself, so outputs (weighted means
    of |v| <~ 4) move by <~ 4 * 2**-17 = 3e-5: atol 5e-5. Rounding p to
    bf16 alone (no lo) misses that bound, which the test also checks."""
    from repro_torch.kernels.flash_attention import (BLOCK_K, BLOCK_Q,
                                                     attention_tiled)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs([(B, Sq, hd), (B, Sk, hd), (B, Sk, hd)],
                                seed=Sq * 7 + Sk))
    got = attention_tiled(q, k, v, causal=causal, block_q=BLOCK_Q,
                          block_k=BLOCK_K)
    want = j_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    if Sk > 1 and Sq > 1:
        hi_only = attention_tiled(q, k, v, causal=causal, block_q=BLOCK_Q,
                                  block_k=BLOCK_K, split_p=False)
        assert np.abs(hi_only.numpy() - np.asarray(want)).max() > 5e-5
