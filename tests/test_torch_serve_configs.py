"""The last three configs, stablelm-12b (LayerNorm with bias, tied
embeddings), yi-34b (56 heads over 8: untied embeddings) and
llama4-maverick-400b-a17b (MoE every other layer, 128 experts top-1 and a
shared expert), against the JAX package's on the CPU at ``reduced()``
size (d 128, 4 heads over 2, 4 layers, float32), the weights carried
across by ``params_from_numpy`` and the prompts made with numpy from a
seed.

- Prefill's logits and next token, then 4 greedy decode steps' logits
  and tokens, as ``tests/test_torch_serve.py`` runs them (the JAX caches
  padded to prompt + new slots): tokens equal, logits atol 1e-4 (float32
  through 4 layers summed in another order; logits of magnitude ~1).
  llama4 under both MoE dispatch plans.
- One train step of reduced llama4 against the JAX package's, as
  ``tests/test_torch_train_step.py`` runs it: metrics rtol 1e-5, every
  parameter and moment leaf to relative L2 1e-5.
- Teacher forcing: each decode step's logits equal a prefill's over the
  prompt and the tokens generated so far, atol 1e-4.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_common as common
from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import make_train_step as j_make_train_step
from repro.models.layers import unembed as j_unembed
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.optim import adamw_init as j_adamw_init
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import (forward_prefill, make_decode_step,
                                make_prefill_step, make_train_step,
                                opt_state_from_numpy, params_from_numpy)
from repro_torch.models.layers import unembed
from repro_torch.tree import tree_leaves

B, S, NEW = 2, 16, 5          # prompt of 16, 4 decode steps after prefill
ATOL = 1e-4
LLAMA4 = "llama4-maverick-400b-a17b"
CASES = [("stablelm-12b", None), ("yi-34b", None), (LLAMA4, "einsum"),
         (LLAMA4, "sort")]


def _cfgs(arch, dispatch=None):
    out = []
    for get in (j_get_config, t_get_config):
        c = get(arch).reduced()
        if dispatch:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, dispatch=dispatch))
        out.append(c)
    return out


_WEIGHTS = {}


def _weights(arch):
    """The JAX package's weights (numpy) for ``arch``'s reduced config and
    seeded prompts, once a process."""
    if arch not in _WEIGHTS:
        jcfg, _ = _cfgs(arch)
        jp = jax.tree.map(np.asarray, jax.jit(
            j_init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(3)))
        prompts = np.random.default_rng(4).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        _WEIGHTS[arch] = (jp, prompts)
    return _WEIGHTS[arch]


def _pad(caches, max_len):
    """JAX caches (L, B, S, KV, hd) padded with zeros to max_len slots."""
    return jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, max_len - a.shape[2]),
                              (0, 0), (0, 0))), caches)


@pytest.mark.parametrize("arch,dispatch", CASES)
def test_prefill_and_decode_match_jax(arch, dispatch):
    jcfg, tcfg = _cfgs(arch, dispatch)
    jp, prompts = _weights(arch)
    tp = params_from_numpy(tcfg, jp, device="cpu")
    jh, jc = jax.jit(lambda p, b: j_forward_prefill(p, b, jcfg))(
        jp, {"tokens": prompts})
    jl = np.asarray(j_unembed(jp["embed"], jh))
    ttok, tc, tl = make_prefill_step(tcfg, max_len=S + NEW)(
        tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL)
    jtok = jl.argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    jc = _pad(jc, S + NEW)
    j_step = jax.jit(lambda p, t, c, n: j_forward_decode(p, t, c, n, jcfg))
    t_decode = make_decode_step(tcfg)
    for i in range(NEW - 1):
        n = S + i
        jl, jc = j_step(jp, jnp.asarray(jtok), jc, jnp.int32(n))
        jl = np.asarray(jl)
        jtok = jl.argmax(-1).astype(np.int32)
        ttok, tc, tl = t_decode(tp, ttok, tc, n)
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL)
        np.testing.assert_array_equal(ttok.numpy(), jtok)


@pytest.mark.parametrize("arch,dispatch", CASES)
def test_decode_equals_teacher_forced_prefill(arch, dispatch):
    jcfg, tcfg = _cfgs(arch, dispatch)
    if dispatch == "einsum":      # capacity drops depend on S: none here
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=8.0))
    jp, prompts = _weights(arch)
    tp = params_from_numpy(tcfg, jp, device="cpu")
    decode = make_decode_step(tcfg)
    seq = torch.from_numpy(prompts)
    tok, caches, _ = make_prefill_step(tcfg, max_len=S + NEW)(
        tp, {"tokens": seq})
    for i in range(NEW - 1):
        seq = torch.cat([seq, tok], dim=1)
        tok, caches, logits = decode(tp, tok, caches, S + i)
        h, _ = forward_prefill(tp, {"tokens": seq}, tcfg)
        torch.testing.assert_close(logits, unembed(tp["embed"], h), rtol=0,
                                   atol=ATOL)


def test_llama4_train_step_matches_jax():
    jcfg, tcfg = _cfgs(LLAMA4)
    jp, _ = _weights(LLAMA4)
    kw = dict(warmup=2, total_steps=10)
    js = j_adamw_init(jp)
    tp = params_from_numpy(tcfg, jp, device="cpu")
    ts = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, js), "cpu")
    batch = common.batch_np(jcfg, seed=12)
    jp, js, jm = jax.jit(j_make_train_step(jcfg, **kw))(jp, js, batch)
    tp, ts, tm = make_train_step(tcfg, **kw)(tp, ts, common.to_torch(batch))
    for k in ("loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=common.RTOL)
    assert int(ts["step"]) == int(js["step"]) == 1
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        g, w = tree_leaves(got), jax.tree.leaves(want)
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            assert common.rel_l2(a.detach().float().numpy(),
                                 np.asarray(b)) <= 1e-5, (i, b.shape)
