"""The port's training forward, loss and gradients against the JAX
package's on the CPU, for the attention decoders at ``reduced()`` size:
qwen2-moe-a2.7b under both MoE dispatches (the scatter plan and the sort
plan, whose grouped matmul runs its plain version under autograd here)
and gemma3-12b (6 layers: 5 local layers of window 8 and the global one).
The weights are carried across by ``params_from_numpy``; the batch is
made with numpy from a seed. Also the vocab-chunked cross entropy and
the recursive-halving attention schedule.

Tolerances are ``_torch_train_common``'s: scalars rtol 1e-5, hidden
states atol 1e-5 (float32 through up to 6 layers summed in another
order), every gradient leaf relative L2 <= 1e-4.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_train_common as common
from repro.models import attention as j_attn
from repro.models import chunked_xent as j_chunked_xent
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.models import chunked_xent
from repro_torch.models import attention as t_attn

NAMES = ("qwen2-moe-einsum", "qwen2-moe-sort", "gemma3")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_forward_train_matches_jax(name, remat):
    common.check_forward(name, remat)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_match_jax(name):
    common.check_grads(name)


@pytest.mark.parametrize("tied", [True, False])
def test_chunked_xent_matches_jax(tied):
    """Four chunks of 8 positions, masked labels (-1) included: the sum
    and the count (rtol 1e-5), and the gradients of the sum with respect
    to the hidden states and the unembedding (relative L2 1e-5)."""
    r = np.random.default_rng(3)
    B, S, d, V = 2, 32, 16, 50
    h = r.standard_normal((B, S, d)).astype(np.float32)
    w = (r.standard_normal((V, d)) / 4).astype(np.float32)
    labels = r.integers(0, V, (B, S)).astype(np.int32)
    labels[0, ::5] = -1
    jp = {"embedding": w} if tied else {"unembed": w.T.copy()}

    def j_sum(p, h):
        return j_chunked_xent(p, h, labels, chunk=8)[0]

    want, (jgp, jgh) = jax.value_and_grad(j_sum, argnums=(0, 1))(jp, h)
    _, jcnt = j_chunked_xent(jp, h, labels, chunk=8)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    th = torch.tensor(h, requires_grad=True)
    tot, cnt = chunked_xent(tp, th, torch.from_numpy(labels), chunk=8)
    gp, gh = torch.autograd.grad(tot, [next(iter(tp.values())), th])
    np.testing.assert_allclose(float(tot.detach()), float(want), rtol=1e-5)
    assert float(cnt) == float(jcnt) == (labels >= 0).sum()
    assert common.rel_l2(gh.numpy(), jgh) <= 1e-5
    assert common.rel_l2(gp.numpy(), next(iter(jgp.values()))) <= 1e-5


@pytest.mark.parametrize("H,KV", [(1, 1), (4, 2)])
def test_recursive_schedule(H, KV):
    """causal_mode="recursive" at S = 32 over tiles of 8 (two halvings):
    equal to the masked softmax (atol 2e-6, float32 summed in another
    order), and to the JAX package's blocked_attention in that mode. With
    H > 1 the JAX package's result is not attention: it reshapes the (B,
    KV, G, S, hd) state to (B, S, H, hd) without a transpose, which
    scrambles the heads (ROADMAP Queue 3); the port holds that state
    transposed, so the JAX output is compared read back in its state's
    layout, and shown to differ from the port's as it stands."""
    r = np.random.default_rng(5)
    q = r.standard_normal((2, 32, H, 16)).astype(np.float32)
    k, v = (r.standard_normal((2, 32, KV, 16)).astype(np.float32)
            for _ in range(2))
    got = t_attn.blocked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_block=8, kv_block=8, causal_mode="recursive")
    plain = t_fa.attention_gqa_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    torch.testing.assert_close(got, plain, rtol=0, atol=2e-6)
    j_out = np.asarray(jax.jit(functools.partial(
        j_attn.blocked_attention, causal=True, q_block=8, kv_block=8,
        causal_mode="recursive"))(q, k, v))
    state = j_out.reshape(2, KV, H // KV, 32, 16).transpose(0, 3, 1, 2, 4) \
        .reshape(2, 32, H, 16)
    np.testing.assert_allclose(got.numpy(), state, rtol=1e-5, atol=1e-6)
    if H > 1:
        assert np.abs(got.numpy() - j_out).max() > 0.1


def test_recursive_schedule_trains():
    """Gradients flow through the recursive schedule and equal the masked
    softmax's (relative L2 1e-5)."""
    r = np.random.default_rng(6)
    q, k, v = (torch.tensor(r.standard_normal((1, 32, 2, 8)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    out = t_attn.blocked_attention(q, k, v, causal=True, q_block=8,
                                   kv_block=8, causal_mode="recursive")
    g = torch.autograd.grad(out.square().sum(), [q, k, v])
    want = torch.autograd.grad(
        t_fa.attention_gqa_ref(q, k, v, causal=True).square().sum(),
        [q, k, v])
    for a, b in zip(g, want):
        assert common.rel_l2(a.numpy(), b.numpy()) <= 1e-5
