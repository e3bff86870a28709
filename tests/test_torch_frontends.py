"""The frontend stubs against the JAX package's on the CPU, at
``reduced()`` size (d 128, float32): hubert-xlarge (audio: frame
embeddings in, its own unembedding; encoder-only, non-causal attention
without RoPE) and internvl2-76b (vision: patch embeddings projected
through ``vision_proj.w`` in place of the first 8 token embeddings; GQA
4 heads over 2). The training forward, the loss and every gradient; the
hubert encode step; internvl2's prefill and greedy decode with the same
patch embeddings; and ``serve`` refusing the encoder.

Tolerances are ``_torch_train_common``'s (scalars rtol 1e-5, hidden
states atol 1e-5, gradients relative L2 1e-4); served ids equal and
logits and caches to atol 1e-4, as tests/test_torch_serve.py holds them.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_common as common
from repro.models import make_decode_step as j_make_decode
from repro.models import make_prefill_step as j_make_prefill
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.layers import unembed as j_unembed
from repro_torch.launch.serve import serve
from repro_torch.models import make_decode_step, make_prefill_step

NAMES = ("hubert", "internvl2")
NEW = 4
ATOL = 1e-4


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_forward_train_matches_jax(name, remat):
    common.check_forward(name, remat)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_match_jax(name):
    common.check_grads(name)


def test_hubert_encode_step_matches_jax():
    """The encoder's prefill is its full forward and mean cross entropy:
    the same loss as JAX's encode step (rtol 1e-5), under no_grad."""
    run = common.jax_run("hubert")
    want = jax.jit(j_make_prefill(run["jcfg"]))(run["params"], run["batch"])
    step = make_prefill_step(run["tcfg"])
    got = step(common.port_params(run), common.to_torch(run["batch"]))
    assert got.shape == () and not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=common.RTOL)


def test_internvl2_prefill_and_decode_match_jax():
    """Prefill over 8 patch positions + 24 text tokens, then 3 greedy
    decode steps: ids equal, logits and the global K/V to atol 1e-4. The
    JAX caches (prompt-length) are padded to the port's prompt + new
    slots before its decode, as tests/test_torch_serve.py does."""
    run = common.jax_run("internvl2")
    jcfg, tcfg, jp = run["jcfg"], run["tcfg"], run["params"]
    batch = {k: run["batch"][k] for k in ("tokens", "patch_embeds")}
    S = batch["tokens"].shape[1]
    jtok, jc = jax.jit(j_make_prefill(jcfg))(jp, batch)
    jh, _ = jax.jit(functools.partial(j_forward_prefill, cfg=jcfg))(jp,
                                                                     batch)
    tp = common.port_params(run)
    ttok, tc, tl = make_prefill_step(tcfg, max_len=S + NEW)(
        tp, common.to_torch(batch))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tl.numpy(),
                               np.asarray(j_unembed(jp["embed"], jh)),
                               atol=ATOL)
    np.testing.assert_allclose(tc[0]["sub0"]["k"][:, :, :S].numpy(),
                               np.asarray(jc[0]["sub0"]["k"]), atol=ATOL)
    jc = jax.tree.map(lambda a: jnp.pad(
        a, ((0, 0), (0, 0), (0, NEW), (0, 0), (0, 0))), jc)
    j_decode = jax.jit(j_make_decode(jcfg))
    j_logits = jax.jit(lambda p, t, c, n: j_forward_decode(p, t, c, n,
                                                           jcfg)[0])
    t_decode = make_decode_step(tcfg)
    for i in range(NEW - 1):
        jl = j_logits(jp, jtok, jc, jnp.int32(S + i))
        jtok, jc = j_decode(jp, jtok, jc, jnp.int32(S + i))
        ttok, tc, tl = t_decode(tp, ttok, tc, S + i)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_serve_vision_and_refuse_the_encoder():
    """serve() feeds internvl2 zero patch embeddings (as the JAX serve
    loop does) and refuses hubert: encoder-only, no decode."""
    tcfg = common.cfg(common.t_get_config, "internvl2")
    res = serve(tcfg, batch=2, prompt_len=12, max_new=3, seed=1,
                device="cpu")
    assert res.tokens.shape == (2, 3)
    assert ((res.tokens >= 0) & (res.tokens < tcfg.vocab_size)).all()
    assert torch.isfinite(res.logits).all()
    with pytest.raises(SystemExit, match="encoder-only"):
        serve("hubert-xlarge", device="cpu")
