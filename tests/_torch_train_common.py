"""Shared set-up of the training tests: each architecture's reduced
config in both packages, one JAX run of it (weights, batch, training
forward, loss and every gradient) cached for the test process, and the
comparisons the tests state their tolerances with.

Configs are ``reduced()`` (d 128, float32, 2-4 layers of 4 heads), with
gemma3-12b cut to 6 layers (one period: 5 local layers of window 8 and
the global one). Batches are B 2, S 32, made with numpy from a seed;
an audio model gets frames, a vision model patch embeddings.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import forward_train as j_forward_train
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import params_from_numpy

B, S = 2, 32
WINDOW = 8

# the variants: (architecture, MoE dispatch or None)
ARCHS = {"qwen2-moe-einsum": ("qwen2-moe-a2.7b", "einsum"),
         "qwen2-moe-sort": ("qwen2-moe-a2.7b", "sort"),
         "gemma3": ("gemma3-12b", None),
         "zamba2": ("zamba2-1.2b", None),
         "falcon-mamba": ("falcon-mamba-7b", None),
         "hubert": ("hubert-xlarge", None),
         "internvl2": ("internvl2-76b", None)}


def cfg(get, name: str):
    arch, dispatch = ARCHS[name]
    c = get(arch).reduced()
    if dispatch:
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, dispatch=dispatch))
    if "local" in c.attn.pattern:
        c = dataclasses.replace(c, attn=dataclasses.replace(
            c.attn, window=WINDOW))
    if arch == "gemma3-12b":
        c = dataclasses.replace(c, num_layers=6)
    return c


def batch_np(c, seed: int = 0, batch: int = B, seq: int = S) -> dict:
    r = np.random.default_rng(seed)
    toks = r.integers(0, c.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1,
                                                  np.int32)], 1)
    out = {"tokens": toks, "labels": labels}
    if c.frontend == "audio":
        out = {"frames": r.standard_normal((batch, seq, c.d_model))
               .astype(np.float32), "labels": labels}
    if c.frontend == "vision":
        out["patch_embeds"] = r.standard_normal(
            (batch, c.frontend_len, c.d_model)).astype(np.float32)
    return out


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_WEIGHTS, _RUNS = {}, {}


def jax_weights(name: str):
    """(JAX config, port config, the JAX package's weights as numpy) for
    variant ``name``, once a process."""
    if name not in _WEIGHTS:
        jc, tc = cfg(j_get_config, name), cfg(t_get_config, name)
        _WEIGHTS[name] = (jc, tc, jax.tree.map(np.asarray, jax.jit(
            j_init_params, static_argnums=0)(jc, jax.random.PRNGKey(1))))
    return _WEIGHTS[name]


def jax_run(name: str) -> dict:
    """The JAX package's weights (numpy), batch, training forward and
    value_and_grad of loss_fn for variant ``name`` (each jitted: one
    compile instead of one a scan), once a process."""
    if name not in _RUNS:
        jc, tc, jp = jax_weights(name)
        batch = batch_np(jc)
        hidden, aux = jax.jit(functools.partial(j_forward_train, cfg=jc))(
            jp, batch)
        (total, (ce, _)), grads = jax.jit(jax.value_and_grad(
            functools.partial(j_loss_fn, cfg=jc), has_aux=True))(jp, batch)
        _RUNS[name] = dict(
            jcfg=jc, tcfg=tc, params=jp, batch=batch,
            hidden=np.asarray(hidden), aux=float(aux), total=float(total),
            ce=float(ce), grads=[np.asarray(g) for g in
                                 jax.tree.leaves(grads)])
    return _RUNS[name]


def port_params(run: dict):
    return params_from_numpy(run["tcfg"], run["params"], device="cpu")


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return float(num / den) if den else float(num)


# Tolerances, float32 on both sides (the same functions summed in
# another order, softmax and logsumexp included): scalars (loss, aux) and
# single operations rtol 1e-5, atol 1e-6; hidden states after 4-6 layers
# (magnitude ~1; measured differences up to 4.7e-6) rtol 1e-5, atol
# HIDDEN_ATOL; every gradient leaf to relative L2 GRAD_RTOL (measured
# below 1e-5).
RTOL, ATOL = 1e-5, 1e-6
HIDDEN_ATOL = 1e-5
GRAD_RTOL = 1e-4


def check_forward(name: str, remat: bool):
    """forward_train's hidden and aux against the JAX package's, with
    gradients on so that ``remat`` takes effect."""
    from repro_torch.models import forward_train
    run = jax_run(name)
    tp = port_params(run)
    tp.requires_grad_(True)
    with torch.enable_grad():
        hidden, aux = forward_train(tp, to_torch(run["batch"]), run["tcfg"],
                                    remat=remat)
    np.testing.assert_allclose(hidden.detach().numpy(), run["hidden"],
                               rtol=RTOL, atol=HIDDEN_ATOL)
    np.testing.assert_allclose(float(aux.detach()), run["aux"], rtol=RTOL,
                               atol=ATOL)


def check_grads(name: str):
    """loss_fn's value and every gradient leaf (JAX's flatten order)
    against jax.value_and_grad."""
    from repro_torch.models import loss_fn
    from repro_torch.tree import tree_leaves
    run = jax_run(name)
    tp = port_params(run)
    tp.requires_grad_(True)
    leaves = tree_leaves(tp)
    with torch.enable_grad():
        total, (ce, _) = loss_fn(tp, to_torch(run["batch"]), run["tcfg"])
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    np.testing.assert_allclose(float(total.detach()), run["total"],
                               rtol=RTOL)
    np.testing.assert_allclose(float(ce.detach()), run["ce"], rtol=RTOL)
    assert len(grads) == len(run["grads"])
    for i, (g, want) in enumerate(zip(grads, run["grads"])):
        got = np.zeros_like(want) if g is None else g.numpy()
        assert got.shape == want.shape, i
        assert rel_l2(got, want) <= GRAD_RTOL, (i, got.shape,
                                                rel_l2(got, want))
