"""The port's sliding-window (local) attention against the JAX package's,
on the same numpy inputs: the prefill core (``blocked_attention`` with a
window shorter than the sequence, which the JAX package runs through
``_sliding_window``, and one covering it, plain causal there through
``_scan_attention``), and single-token decode on a local layer's ring
cache of ``window`` slots (before and after it wraps) and on a longer
cache masked to the window. Also the flash wrapper's plain GQA version at
gemma3-12b's head dim 240 against the JAX package's ``attention_ref``,
and the head dims the CUDA kernel runs an hd at.

Tolerances: float32 to atol 2e-6 (outputs of magnitude ~1; the same
float32 softmax summed in another order, blocked and online on the JAX
side), and at head dim 240 to atol 1e-5, as
tests/test_torch_flash_attention.py holds the plain version (scores
summed over 240 terms); bfloat16 to 2**-7 |want| + 2e-3 (both round the
softmax weights and the output to bf16; a sum-order difference can move
an output by one unit in its last place).
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import ops as t_fa
from repro_torch.kernels.flash_attention.flash_attention import \
    kernel_head_dim
from repro_torch.models import attention as t_attn

WINDOW = 8
ATOL = 2e-6


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


def _close_bf16(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 2e-3).all()


# (S, window, port q_block): a window shorter than S over ragged query
# blocks; a window of one; windows equal to and beyond S (plain causal)
@pytest.mark.parametrize("S,window,q_block", [
    (40, 8, 16), (40, 8, 512), (24, 1, 7), (40, 40, 16), (40, 64, 512)])
def test_blocked_attention_with_window_matches_jax(S, window, q_block):
    B, H, KV, hd = 2, 4, 2, 32
    q, k, v = (_rand(s, seed) for seed, s in enumerate(
        [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]))
    want = j_attn.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_block=S // 2 if S % 2 == 0 else S,
        kv_block=S // 2 if S % 2 == 0 else S)
    got = t_attn.local_attention(
        _t(q), _t(k), _t(v), window=window if window < S else None,
        q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    entry = t_attn.blocked_attention(_t(q), _t(k), _t(v), causal=True,
                                     window=window)
    np.testing.assert_allclose(entry.numpy(), np.asarray(want), atol=ATOL)


def test_blocked_attention_with_window_bfloat16():
    B, S, H, KV, hd = 1, 64, 4, 1, 64
    q, k, v = (_rand(s, seed + 10) for seed, s in enumerate(
        [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]))
    j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = j_attn.blocked_attention(j(q), j(k), j(v), causal=True,
                                    window=16, q_block=32, kv_block=32)
    bf = torch.bfloat16
    got = t_attn.blocked_attention(_t(q, bf), _t(k, bf), _t(v, bf),
                                   causal=True, window=16)
    assert got.dtype == bf
    _close_bf16(got, want.astype(jnp.float32))


def test_global_and_recursive_paths():
    """No window: the flash wrapper (its plain version here); the
    recursive-halving schedule on CPU tensors at S > q_block, equal to
    it to atol 2e-6 (float32, online softmax summed in another order),
    and the flash wrapper again at S <= q_block."""
    q = _t(_rand((1, 16, 2, 32), 3))
    got = t_attn.blocked_attention(q, q, q, causal=True)
    torch.testing.assert_close(got, t_fa.attention_gqa_ref(q, q, q),
                               rtol=0, atol=0)
    rec = t_attn.blocked_attention(q, q, q, causal=True, q_block=4,
                                   kv_block=4, causal_mode="recursive")
    torch.testing.assert_close(rec, got, rtol=0, atol=2e-6)
    assert not torch.equal(rec, got)           # it took the schedule
    same = t_attn.blocked_attention(q, q, q, causal=True,
                                    causal_mode="recursive")
    torch.testing.assert_close(same, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="causal_mode"):
        t_attn.blocked_attention(q, q, q, causal=True, causal_mode="x")


@pytest.fixture(scope="module")
def layer():
    """A reduced gemma3 config with window 8 and one attention layer's
    weights, on both sides."""
    jcfg = j_get_config("gemma3-12b").reduced()
    jcfg = dataclasses.replace(jcfg, attn=dataclasses.replace(
        jcfg.attn, window=WINDOW))
    d, H, KV, hd = jcfg.d_model, jcfg.num_heads, jcfg.num_kv_heads, 32
    p = {"wq": _rand((d, H, hd), 20) / d ** 0.5,
         "wk": _rand((d, KV, hd), 21) / d ** 0.5,
         "wv": _rand((d, KV, hd), 22) / d ** 0.5,
         "wo": _rand((H, hd, d), 23) / (H * hd) ** 0.5}
    from repro_torch.configs import get_config as t_get_config
    tcfg = dataclasses.replace(t_get_config("gemma3-12b").reduced(),
                               attn=dataclasses.replace(jcfg.attn))
    return jcfg, tcfg, p


# (cache slots, cache_len): a ring of window slots before it fills, as
# it fills and wrapped twice; a longer cache masked to the window
@pytest.mark.parametrize("slots,cache_len", [
    (WINDOW, 5), (WINDOW, WINDOW), (WINDOW, 21), (20, 3), (20, 13)])
def test_local_decode_matches_jax(layer, slots, cache_len):
    jcfg, tcfg, p = layer
    B, KV, hd = 2, jcfg.num_kv_heads, 32
    x = _rand((B, 1, jcfg.d_model), 30 + cache_len)
    ck, cv = (_rand((B, slots, KV, hd), s + cache_len) for s in (31, 32))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jo, jk, jv = j_attn.apply_attention_decode(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(cache_len), jcfg, local=True)
    tk, tv = _t(ck), _t(cv)
    to, tk2, tv2 = t_attn.apply_attention_decode(
        {k: _t(v) for k, v in p.items()}, _t(x), tk, tv, cache_len, tcfg,
        local=True)
    assert tk2 is tk and tv2 is tv          # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    assert t_attn.is_ring(tcfg, slots, True) == (slots == WINDOW)


def test_write_slot():
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-12b")
    assert t_attn.write_slot(cfg, 1024, 2500, local=True) == 2500 % 1024
    assert t_attn.write_slot(cfg, 3000, 2500, local=True) == 2500
    with pytest.raises(ValueError, match="outside"):
        t_attn.write_slot(cfg, 2500, 2500, local=False)


def test_plain_gqa_at_head_dim_240_matches_jax_ref():
    """gemma3-12b's global layers: 16 heads over 8 KV heads of 240."""
    B, S, H, KV, hd = 1, 48, 16, 8, 240
    q, k, v = (_rand(s, 40 + i) for i, s in enumerate(
        [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]))
    got = t_fa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    rep = lambda a: jnp.repeat(jnp.asarray(a).transpose(0, 2, 1, 3), 2,
                               axis=1).reshape(B * H, S, hd)
    want = j_ref(jnp.asarray(q).transpose(0, 2, 1, 3).reshape(B * H, S, hd),
                 rep(k), rep(v), causal=True)
    want = np.asarray(want).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("hd,runs_at", [
    (8, 32), (32, 32), (64, 64), (80, 128), (120, 128), (128, 128),
    (160, 256), (240, 256), (256, 256)])
def test_kernel_head_dims(hd, runs_at):
    assert kernel_head_dim(hd) == runs_at


@pytest.mark.parametrize("hd", [0, 12, 100, 264])
def test_kernel_refuses_other_head_dims(hd):
    with pytest.raises(ValueError, match="multiple of 8"):
        kernel_head_dim(hd)
