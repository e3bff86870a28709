"""The port's serving path for the decoders this slice brings, against the
JAX package's, at ``reduced()`` size (d 128, float32) with a window of 8:
gemma3-12b (cut to 6 layers, one whole period: 5 local layers and the
global one, so the flash wrapper runs too), h2o-danube-3-4b (4 local
layers), falcon-mamba-7b (4 Mamba1 layers) and zamba2-1.2b (4 Mamba2
layers and the shared attention block after every second), the weights
carried across by ``params_from_numpy``: prefill's next token, then 4
greedy decode steps through ``make_prefill_step`` / ``make_decode_step``.

The JAX serve loop hands prefill's caches to decode as they are: S slots
for global layers (ROADMAP Queue 3, as in tests/test_torch_serve.py) and
min(window, S) for local ones. Here they are padded, in the test, to the
port's: S + 5 slots global, min(window, S + 5) local. Local caches agree
with the JAX package only when the prompt's positions past the window are
a multiple of it ((S - window) % window == 0): its prefill stores the
last window positions at slots 0 .. window-1, and its ring decode reads
slot p % window as position p. So the prompts are 16 (aligned) and 6
(shorter than the window, wrapping during decode) for the local models,
and 12 and 16 for the SSM models; at 12 a test shows the JAX decode
differs from a prefill over the same tokens, and holds the port's decode
to that prefill instead.

Tolerance: ids equal; logits and caches to atol 1e-4 (float32 through up
to 6 layers summed in another order; logits of magnitude ~4; measured
differences ~5e-6), int8 caches one code (see the int8 test).
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
from repro.models import make_prefill_step as j_make_prefill
from repro.models import model as j_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.serve import serve
from repro_torch.models import (forward_prefill, make_decode_step,
                                make_prefill_step, params_from_numpy)
from repro_torch.models.layers import unembed

WINDOW = 8
B, NEW = 2, 5
ATOL = 1e-4
LOCAL = ("gemma3-12b", "h2o-danube-3-4b")
SSM = ("falcon-mamba-7b", "zamba2-1.2b")


def _cfg(get, arch):
    c = get(arch).reduced()
    if "local" in c.attn.pattern:
        c = dataclasses.replace(c, attn=dataclasses.replace(c.attn,
                                                            window=WINDOW))
    if arch == "gemma3-12b":
        c = dataclasses.replace(c, num_layers=6)
    return c


_WEIGHTS = {}


def weights(arch):
    """(jax cfg, port cfg, jax params as numpy, port params), once per
    arch and test process."""
    if arch not in _WEIGHTS:
        jcfg, tcfg = _cfg(j_get_config, arch), _cfg(t_get_config, arch)
        jp = jax.tree.map(np.asarray,
                          j_init_params(jcfg, jax.random.PRNGKey(1)))
        _WEIGHTS[arch] = (jcfg, tcfg, jp,
                          params_from_numpy(tcfg, jp, device="cpu"))
    return _WEIGHTS[arch]


def _prompts(vocab, S):
    return np.random.default_rng(2 + S).integers(
        0, vocab, (B, S)).astype(np.int32)


def _pad(caches, cfg, total):
    """JAX prefill caches padded with zeros to the port's slots."""
    out = []
    for (subs, _), stage in zip(j_model.stage_plan(cfg), caches):
        st = {}
        for name, c in stage.items():
            kind = "shared" if name.startswith("shared") else \
                subs[int(name[3:])].kind
            if kind == "ssm":
                st[name] = c
                continue
            n = min(cfg.attn.window, total) if kind == "attn_local" \
                else total
            st[name] = {k: jnp.pad(a, ((0, 0), (0, 0),
                                       (0, n - a.shape[2]), (0, 0), (0, 0)))
                        for k, a in c.items()}
        out.append(st)
    return out


def _quantize(caches, cfg):
    """The JAX package's int8 layout for every attention sublayer's cache
    (the shared block's stays unquantized, as in its init_caches)."""
    out = []
    for stage in caches:
        st = {}
        for name, c in stage.items():
            if "k" in c and name.startswith("sub"):
                k8, ks = j_model._quantize_kv(c["k"])
                v8, vs = j_model._quantize_kv(c["v"])
                c = {"k8": k8, "v8": v8, "ks": ks, "vs": vs}
            st[name] = c
        out.append(st)
    return out


_JAX_RUNS = {}


def jax_run(arch, S, quantize=False):
    """The JAX package's prefill and NEW - 1 decode steps: (prefill ids,
    per-step ids, per-step logits, final caches), once per case."""
    key = (arch, S, quantize)
    if key not in _JAX_RUNS:
        jcfg, _, jp, _ = weights(arch)
        tok, jc = jax.jit(j_make_prefill(jcfg))(
            jp, {"tokens": _prompts(jcfg.vocab_size, S)})
        jc = _pad(jc, jcfg, S + NEW)
        if quantize:
            jc = _quantize(jc, jcfg)
        step = jax.jit(lambda p, t, c, n: j_model.forward_decode(
            p, t, c, n, jcfg))
        ids, logits = [np.asarray(tok)], []
        for i in range(NEW - 1):
            lg, jc = step(jp, tok, jc, jnp.int32(S + i))
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            ids.append(np.asarray(tok))
            logits.append(np.asarray(lg))
        _JAX_RUNS[key] = (ids, logits, jax.tree.map(np.asarray, jc))
    return _JAX_RUNS[key]


def port_run(arch, S, quantize=False):
    _, tcfg, _, tp = weights(arch)
    tok, tc, _ = make_prefill_step(tcfg, max_len=S + NEW,
                                   quantize=quantize)(
        tp, {"tokens": torch.from_numpy(_prompts(tcfg.vocab_size, S))})
    decode = make_decode_step(tcfg)
    ids, logits = [tok.numpy()], []
    for i in range(NEW - 1):
        tok, tc, lg = decode(tp, tok, tc, S + i)
        ids.append(tok.numpy())
        logits.append(lg.numpy())
    return ids, logits, tc


CASES = [(a, 16) for a in LOCAL] + [(a, 6) for a in LOCAL] + \
    [(a, S) for a in SSM for S in (12, 16)]


@pytest.mark.parametrize("arch,S", CASES)
def test_prefill_and_decode_match_jax(arch, S):
    j_ids, j_logits, jc = jax_run(arch, S)
    t_ids, t_logits, tc = port_run(arch, S)
    for a, b in zip(t_ids, j_ids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_logits, j_logits):
        np.testing.assert_allclose(a, b, atol=ATOL)
    # the caches after the last step, leaf for leaf (both sides hold the
    # same slots: the prompt is aligned, or shorter than the window)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tc))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jc))
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_allclose(a, flat_j[path], atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", LOCAL + SSM)
def test_decode_equals_teacher_forced_prefill(arch):
    """Prompt 12 (the ring wraps misaligned on local layers): each decode
    step's logits equal the last-position logits of a prefill over the
    prompt and the tokens generated so far."""
    _, tcfg, _, tp = weights(arch)
    S = 12
    seq = torch.from_numpy(_prompts(tcfg.vocab_size, S))
    tok, caches, _ = make_prefill_step(tcfg, max_len=S + NEW)(
        tp, {"tokens": seq})
    decode = make_decode_step(tcfg)
    for i in range(NEW - 1):
        seq = torch.cat([seq, tok], dim=1)
        tok, caches, logits = decode(tp, tok, caches, S + i)
        h, _ = forward_prefill(tp, {"tokens": seq}, tcfg)
        torch.testing.assert_close(logits, unembed(tp["embed"], h), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", LOCAL)
def test_jax_ring_cache_is_misaligned_past_the_window(arch):
    """Prompt 12, window 8: the JAX package's decode differs from its own
    prefill over the same tokens (by ~3.4-3.9 in the logits here), while
    the port's decode equals that prefill. Its prefill cache holds
    positions 4 .. 11 at slots 0 .. 7; the port's holds position p at
    slot p % 8."""
    jcfg, tcfg, jp, _ = weights(arch)
    S = 12
    j_ids, j_logits, _ = jax_run(arch, S)
    t_ids, t_logits, _ = port_run(arch, S)
    seq = np.concatenate([_prompts(jcfg.vocab_size, S), t_ids[0]], axis=1)
    h, _ = jax.jit(lambda p, b: j_model.forward_prefill(p, b, jcfg))(
        jp, {"tokens": seq})
    forced = np.asarray(j_model.unembed(jp["embed"], h))
    np.testing.assert_allclose(t_logits[0], forced, atol=ATOL)
    assert np.abs(j_logits[0] - forced).max() > 0.5
    # the caches' layouts, on a local layer after the JAX prefill
    _, jc = jax.jit(j_make_prefill(jcfg))(
        jp, {"tokens": _prompts(jcfg.vocab_size, S)})
    _, tc, _ = make_prefill_step(tcfg, max_len=S + NEW)(
        weights(arch)[3],
        {"tokens": torch.from_numpy(_prompts(jcfg.vocab_size, S))})
    jk = np.asarray(jc[0]["sub0"]["k"])        # (L, B, 8, KV, hd)
    tk = tc[0]["sub0"]["k"].numpy()
    for p in range(S - WINDOW, S):
        np.testing.assert_allclose(tk[:, :, p % WINDOW],
                                   jk[:, :, p - (S - WINDOW)], atol=ATOL)


@pytest.mark.parametrize("arch", LOCAL)
def test_int8_cache_decode_matches_jax(arch):
    """Prompt 16 with int8 K/V on every attention layer (the ring and the
    global cache), against the JAX package's int8 branch of the cached
    decode. It re-quantizes every row each step, the port only the row it
    writes; in float32 the re-quantized codes stay put (the dequantized
    row's max is 127 scale again). The two sides quantize K/V that differ
    by float32 rounding, so a value within rounding of a half-code
    boundary may round either way: codes within one, and dequantized rows
    within one code of each other."""
    _, tcfg, _, _ = weights(arch)
    S = 16
    j_ids, j_logits, jc = jax_run(arch, S, quantize=True)
    t_ids, t_logits, tc = port_run(arch, S, quantize=True)
    for a, b in zip(t_ids, j_ids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_logits, j_logits):
        np.testing.assert_allclose(a, b, atol=ATOL)
    written = S + NEW - 1                   # the last token is not fed
    for name, c in tc[0].items():
        assert c["k8"].dtype == torch.int8 and c["ks"].dtype == torch.float32
        n = min(written, c["k8"].shape[2])
        for q, s in (("k8", "ks"), ("v8", "vs")):
            got, want = c[q][:, :, :n].numpy().astype(int), \
                jc[0][name][q][:, :, :n].astype(int)
            assert np.abs(got - want).max() <= 1, name
            np.testing.assert_allclose(c[s][:, :, :n].numpy(),
                                       jc[0][name][s][:, :, :n], rtol=1e-5)


@pytest.mark.parametrize("arch", LOCAL + SSM)
def test_serve_on_cpu(arch):
    """The entry point by name (reduced preset, the config's own window)."""
    res = serve(arch, preset="smoke", batch=2, prompt_len=12, max_new=3,
                seed=4, device="cpu")
    cfg = t_get_config(arch).reduced()
    assert res.tokens.shape == (2, 3) and res.tokens.dtype == np.int32
    assert res.logits.shape == (2, 3, cfg.vocab_size)
    assert bool(torch.isfinite(res.logits).all())
    np.testing.assert_array_equal(res.logits.argmax(-1).numpy(), res.tokens)
