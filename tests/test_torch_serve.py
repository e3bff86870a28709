"""The port's serving path against the JAX package's on the reduced
qwen2-moe config (4 layers, d 128, 4 heads over 2 KV heads, 8 experts
padded to 16, float32), with the weights carried across by
``params_from_numpy``: prefill's next token and caches, then 4 greedy
decode steps, for both MoE dispatch plans.

The JAX serve loop hands prefill's prompt-length caches to decode,
whose writes past the end are clamped onto the last slot; the port sizes
its caches to prompt + new tokens. So the JAX caches are padded here, in
the test, to the same length before JAX's decode step: both sides then
compute the intended function. Tokens must be equal; logits and caches
agree to atol 1e-4 (float32 through 4 layers of products summed in
another order; logits have magnitude ~1). A teacher-forcing test holds
the decode path to a prefill over the prompt plus the tokens generated
so far — the property the clamped writes break.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import make_decode_step as j_make_decode
from repro.models import make_prefill_step as j_make_prefill
from repro.models.model import forward_decode as j_forward_decode
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.serve import serve
from repro_torch.models import (forward_prefill, make_decode_step,
                                make_prefill_step, params_from_numpy)
from repro_torch.models.layers import unembed

ARCH = "qwen2-moe-a2.7b"
B, S, NEW = 2, 16, 5          # prompt of 16, 4 decode steps after prefill
ATOL = 1e-4


def _cfgs(dispatch):
    j = j_get_config(ARCH).reduced()
    t = t_get_config(ARCH).reduced()
    rep = lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, dispatch=dispatch))
    return rep(j), rep(t)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs("sort")
    jp = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(1)))
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jp, params_from_numpy(tcfg, jp, device="cpu"), prompts


def _pad(caches, max_len):
    """JAX caches (L, B, S, KV, hd) padded with zeros to max_len slots."""
    return jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, max_len - a.shape[2]),
                              (0, 0), (0, 0))), caches)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
def test_prefill_and_decode_match_jax(weights, dispatch):
    jp, tp, prompts = weights
    jcfg, tcfg = _cfgs(dispatch)
    jtok, jc = jax.jit(j_make_prefill(jcfg))(jp, {"tokens": prompts})
    ttok, tc, _ = make_prefill_step(tcfg, max_len=S + NEW)(
        tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert ttok.dtype == torch.int32 and ttok.shape == (B, 1)
    for name in ("k", "v"):
        got = tc[0]["sub0"][name]
        assert got.shape == (4, B, S + NEW, 2, 32)
        np.testing.assert_allclose(got[:, :, :S].numpy(),
                                   np.asarray(jc[0]["sub0"][name]),
                                   atol=ATOL)
        assert not got[:, :, S:].any()
    jc = _pad(jc, S + NEW)
    j_decode = jax.jit(j_make_decode(jcfg))
    j_logits = jax.jit(lambda p, t, c, n: j_forward_decode(p, t, c, n,
                                                           jcfg)[0])
    t_decode = make_decode_step(tcfg)
    for i in range(NEW - 1):
        n = S + i
        jl = j_logits(jp, jtok, jc, jnp.int32(n))
        jtok, jc = j_decode(jp, jtok, jc, jnp.int32(n))
        ttok, tc, tl = t_decode(tp, ttok, tc, n)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[0]["sub0"][name].numpy(),
                                   np.asarray(jc[0]["sub0"][name]),
                                   atol=ATOL)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
def test_decode_equals_teacher_forced_prefill(weights, dispatch):
    """Greedy decode's logits at step i equal the last-position logits of
    a prefill over prompt + generated[:i]."""
    _, tp, prompts = weights
    _, tcfg = _cfgs(dispatch)
    if dispatch == "einsum":      # capacity drops depend on S: none here
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=8.0))
    prefill = make_prefill_step(tcfg, max_len=S + NEW)
    decode = make_decode_step(tcfg)
    seq = torch.from_numpy(prompts)
    tok, caches, _ = prefill(tp, {"tokens": seq})
    for i in range(NEW - 1):
        seq = torch.cat([seq, tok], dim=1)
        tok, caches, logits = decode(tp, tok, caches, S + i)
        h, _ = forward_prefill(tp, {"tokens": seq}, tcfg)
        forced = unembed(tp["embed"], h)
        torch.testing.assert_close(logits, forced, rtol=0, atol=ATOL)


def test_serve_on_cpu_runs_the_sort_plan():
    _, tcfg = _cfgs("sort")
    res = serve(tcfg, batch=2, prompt_len=12, max_new=3, seed=4,
                device="cpu")
    assert res.tokens.shape == (2, 3) and res.tokens.dtype == np.int32
    assert ((res.tokens >= 0) & (res.tokens < tcfg.vocab_size)).all()
    assert res.logits.shape == (2, 3, tcfg.vocab_size)
    np.testing.assert_array_equal(res.logits.argmax(-1).numpy(), res.tokens)
    k = res.caches[0]["sub0"]["k"]          # (L, B, prompt + new, KV, hd)
    assert k.shape[2] == 12 + 3
    # every decode step wrote a slot of its own; the last token's is free
    assert k[:, :, :14].abs().amax(dim=(0, 1, 3, 4)).gt(0).all()
    assert not k[:, :, 14:].any()
    again = serve(tcfg, batch=2, prompt_len=12, max_new=3, seed=4,
                  device="cpu")
    np.testing.assert_array_equal(again.tokens, res.tokens)


def test_entry_points_default_to_the_card():
    import inspect
    from repro_torch.models import init_caches, init_params
    for fn in (serve, init_params, init_caches, params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_params_from_numpy_checks_shapes(weights):
    jp, _, _ = weights
    _, tcfg = _cfgs("sort")
    bad = jax.tree.map(lambda a: a, jp)
    bad["final_norm"] = {"scale": np.ones(7, np.float32)}
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_numpy(tcfg, bad, device="cpu")


def test_later_slices_raise():
    """What used to raise runs: the recursive-halving schedule (on CPU
    tensors) and a vision frontend's caches and steps. The configs that
    were absent until the last slice, yi-34b, stablelm-12b and
    llama4-maverick, are registered: the port's registry holds the JAX
    package's ten."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches
    from repro_torch.models.attention import blocked_attention
    _, tcfg = _cfgs("sort")
    x = torch.randn(1, 16, 2, 32, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        blocked_attention(x, x, x, causal=True, q_block=4, kv_block=4,
                          causal_mode="recursive"),
        blocked_attention(x, x, x, causal=True), rtol=0, atol=2e-6)
    vlm_like = dataclasses.replace(tcfg, frontend="vision", frontend_len=4)
    for fn in (make_prefill_step, make_decode_step):
        assert callable(fn(vlm_like))
    assert init_caches(vlm_like, 1, 8, device="cpu")[0]["sub0"]["k"] \
        .shape == (4, 1, 8, 2, 32)
    from repro.configs import ALL_ARCHS as J_ALL_ARCHS
    from repro_torch.configs import ALL_ARCHS
    for name in ("yi-34b", "stablelm-12b", "llama4-maverick-400b-a17b"):
        assert get_config(name).name == name
    assert ALL_ARCHS == J_ALL_ARCHS


def test_params_from_numpy_carries_bfloat16():
    """The full configs' dtype: bf16 leaves arrive bit for bit, norms and
    the router stay float32."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _cfgs("sort"))
    jp = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(5)))
    tp = params_from_numpy(tcfg, jp, device="cpu")
    wq = tp.stages[0].sub0.attn.wq
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        jp["stages"][0]["sub0"]["attn"]["wq"].astype(np.float32))
    assert tp.stages[0].sub0.moe.router.dtype == torch.float32
    assert tp.final_norm.scale.dtype == torch.float32
