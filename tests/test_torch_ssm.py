"""The port's state-space layers (``repro_torch.models.ssm``) and its int8
KV quantizer against the JAX package's, on the same numpy inputs and
weights (drawn by the JAX package's initializers), at the reduced
falcon-mamba-7b (Mamba1) and zamba2-1.2b (Mamba2) widths, float32.

Tolerances: float32 throughout. The convolutions are the same shifted
adds in the same order: rtol 1e-6. The Mamba1 scan and the SSD chunk
einsums sum in an order the port cannot replay (XLA's einsums against
torch's; a fused multiply-add a token): rtol 1e-5 with atol 1e-6 on
outputs of magnitude ~1 (``SCAN_RTOL``), and so do the projections
ahead of them. The int8 quantizer on the same inputs: codes equal,
scales to rtol 1e-7.
"""
import _torch_threads  # noqa: F401  (first: see the module)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as j_model
from repro.models import ssm as j_ssm
from repro.models.param import materialize as j_materialize
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as t_model
from repro_torch.models import ssm as t_ssm

SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=SCAN_RTOL, atol=SCAN_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _layer(arch, spec_fn, seed):
    """(jax cfg, port cfg, weights as numpy) of one SSM layer."""
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    p = jax.tree.map(np.asarray, j_materialize(
        spec_fn(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    return jcfg, tcfg, p


@pytest.fixture(scope="module")
def mamba1():
    return _layer("falcon-mamba-7b", j_ssm.mamba1_specs, 3)


@pytest.fixture(scope="module")
def mamba2():
    return _layer("zamba2-1.2b", j_ssm.mamba2_specs, 4)


@pytest.mark.parametrize("S,k", [(10, 4), (2, 4), (7, 2)])
def test_causal_conv1d_and_step(S, k):
    B, C = 2, 6
    x, w, b = _rand((B, S, C), 1), _rand((C, k), 2), _rand((C,), 3)
    want = j_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b))
    got = t_ssm.causal_conv1d(_t(x), _t(w), _t(b))
    _close(got, want, rtol=1e-6, atol=0)
    state = _rand((B, k - 1, C), 4)
    jy, js = j_ssm.conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                               jnp.asarray(w), jnp.asarray(b))
    ty, ts = t_ssm.conv1d_step(_t(x[:, 0]), _t(state), _t(w), _t(b))
    _close(ty, jy, rtol=1e-6, atol=1e-7)
    _close(ts, js, rtol=0, atol=0)


def test_mamba1_specs_match(mamba1):
    jcfg, tcfg, p = mamba1
    assert {k: s.shape for k, s in t_ssm.mamba1_specs(tcfg).items()} == \
        {k: s.shape for k, s in j_ssm.mamba1_specs(jcfg).items()}


# S = 12 and 16: one chunk of the JAX scan (min(128, S)); S = 300: the
# port's chunks of 128 with a ragged last one (the JAX scan needs S % 128
# == 0, so its reference runs over 384 tokens and is cut to 300, which a
# causal scan's first 300 outputs allow, but not its final state)
@pytest.mark.parametrize("S", [12, 16, 300])
def test_mamba1_with_state_matches_jax(mamba1, S):
    jcfg, tcfg, p = mamba1
    B = 2
    S_j = S if S <= 128 else -(-S // 128) * 128
    x = _rand((B, S_j, jcfg.d_model), 10 + S)
    jp = jax.tree.map(jnp.asarray, p)
    jy, jst = jax.jit(lambda p, x: j_ssm.apply_mamba1_with_state(
        p, x, jcfg))(jp, jnp.asarray(x))
    tp = {k: _t(v) for k, v in p.items()}
    ty, tst = t_ssm.apply_mamba1_with_state(tp, _t(x[:, :S]), tcfg)
    _close(ty, np.asarray(jy)[:, :S])
    if S == S_j:
        _close(tst["ssm"], jst["ssm"])
        _close(tst["conv"], jst["conv"])     # in_proj's sums: another order
    torch.testing.assert_close(t_ssm.apply_mamba1(tp, _t(x[:, :S]), tcfg),
                               ty, rtol=0, atol=0)


def test_mamba1_decode_matches_jax(mamba1):
    jcfg, tcfg, p = mamba1
    B, d = 2, jcfg.d_model
    st = t_ssm.mamba1_init_state(tcfg, B, torch.float32, "cpu")
    st = {"conv": _t(_rand(st["conv"].shape, 5)),
          "ssm": _t(_rand(st["ssm"].shape, 6, 0.1))}
    jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    for i in range(3):
        x = _rand((B, 1, d), 20 + i)
        jy, jst = j_ssm.apply_mamba1_decode(jp, jnp.asarray(x), jst, jcfg)
        ty, st = t_ssm.apply_mamba1_decode(tp, _t(x), st, tcfg)
        _close(ty, jy)
        for k in st:
            _close(st[k], jst[k])


def test_mamba1_prefill_then_decode_equals_longer_prefill(mamba1):
    """The state prefill hands over carries on: decode of token S after a
    prefill of S tokens equals the last output of a prefill of S+1."""
    _, tcfg, p = mamba1
    tp = {k: _t(v) for k, v in p.items()}
    x = _t(_rand((2, 9, tcfg.d_model), 30))
    _, st = t_ssm.apply_mamba1_with_state(tp, x[:, :8], tcfg)
    y_dec, _ = t_ssm.apply_mamba1_decode(tp, x[:, 8:], st, tcfg)
    y_all = t_ssm.apply_mamba1(tp, x, tcfg)
    torch.testing.assert_close(y_dec, y_all[:, 8:], rtol=SCAN_RTOL,
                               atol=SCAN_ATOL)


def test_segsum_matches_jax():
    x = _rand((2, 3, 7), 40)
    _close(t_ssm._segsum(_t(x)), j_ssm._segsum(jnp.asarray(x)), rtol=1e-6,
           atol=1e-6)


# (S, chunk, initial state)
@pytest.mark.parametrize("S,chunk,init", [
    (32, 16, False), (16, 16, True), (48, 8, True)])
def test_ssd_chunked_matches_jax(S, chunk, init):
    B, H, Ph, N = 2, 3, 4, 5
    xh = _rand((B, S, H, Ph), 50)
    dt = np.abs(_rand((B, S, H), 51, 0.1))
    A = -np.exp(_rand((H,), 52, 0.5))
    Bc, Cc = _rand((B, S, N), 53), _rand((B, S, N), 54)
    s0 = _rand((B, H, Ph, N), 55) if init else None
    jy, jf = j_ssm.ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, Bc,
                                                           Cc)), chunk,
                               None if s0 is None else jnp.asarray(s0))
    ty, tf = t_ssm.ssd_chunked(*(_t(a) for a in (xh, dt, A, Bc, Cc)), chunk,
                               None if s0 is None else _t(s0))
    _close(ty, jy)
    _close(tf, jf)


def test_ssd_chunked_pads_a_ragged_tail():
    """S not a multiple of the chunk (the JAX form needs one): the first
    S outputs and the final state equal a run over a tail padded with
    dt = 0 by hand, and a run with a chunk that divides S."""
    B, S, H, Ph, N = 1, 21, 2, 4, 3
    xh, Bc, Cc = _rand((B, S, H, Ph), 60), _rand((B, S, N), 61), \
        _rand((B, S, N), 62)
    dt = np.abs(_rand((B, S, H), 63, 0.1))
    A = -np.exp(_rand((H,), 64, 0.5))
    ty, tf = t_ssm.ssd_chunked(*(_t(a) for a in (xh, dt, A, Bc, Cc)), 8)
    assert ty.shape == (B, S, H, Ph)
    pad = lambda a: np.concatenate(
        [a, np.zeros((B, 3) + a.shape[2:], np.float32)], axis=1)
    jy, jf = j_ssm.ssd_chunked(jnp.asarray(pad(xh)), jnp.asarray(pad(dt)),
                               jnp.asarray(A), jnp.asarray(pad(Bc)),
                               jnp.asarray(pad(Cc)), 8)
    _close(ty, np.asarray(jy)[:, :S])
    _close(tf, jf)
    y7, f7 = t_ssm.ssd_chunked(*(_t(a) for a in (xh, dt, A, Bc, Cc)), 7)
    _close(ty, y7.numpy())
    _close(tf, f7.numpy())


@pytest.mark.parametrize("S", [12, 16, 32])
def test_mamba2_with_state_matches_jax(mamba2, S):
    jcfg, tcfg, p = mamba2
    x = _rand((2, S, jcfg.d_model), 70 + S)
    jp = jax.tree.map(jnp.asarray, p)
    jy, jst = jax.jit(lambda p, x: j_ssm.apply_mamba2_with_state(
        p, x, jcfg))(jp, jnp.asarray(x))
    tp = {k: _t(v) for k, v in p.items()}
    ty, tst = t_ssm.apply_mamba2_with_state(tp, _t(x), tcfg)
    _close(ty, jy)
    assert set(tst) == set(jst)
    for k in tst:
        _close(tst[k], jst[k])
    torch.testing.assert_close(t_ssm.apply_mamba2(tp, _t(x), tcfg), ty,
                               rtol=0, atol=0)


def test_mamba2_decode_matches_jax(mamba2):
    jcfg, tcfg, p = mamba2
    B = 2
    st0 = t_ssm.mamba2_init_state(tcfg, B, torch.float32, "cpu")
    st = {k: _t(_rand(v.shape, 80 + i, 0.1 if k == "ssm" else 1.0))
          for i, (k, v) in enumerate(st0.items())}
    jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    for i in range(3):
        x = _rand((B, 1, jcfg.d_model), 90 + i)
        jy, jst = j_ssm.apply_mamba2_decode(jp, jnp.asarray(x), jst, jcfg)
        ty, st = t_ssm.apply_mamba2_decode(tp, _t(x), st, tcfg)
        _close(ty, jy)
        for k in st:
            _close(st[k], jst[k])


def test_init_states_match_jax():
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        jcfg, tcfg = j_get_config(arch).reduced(), \
            t_get_config(arch).reduced()
        jf = (j_ssm.mamba1_init_state if jcfg.ssm.kind == "mamba1"
              else j_ssm.mamba2_init_state)
        tf = (t_ssm.mamba1_init_state if tcfg.ssm.kind == "mamba1"
              else t_ssm.mamba2_init_state)
        want = jf(jcfg, 3, jnp.float32)
        got = tf(tcfg, 3, torch.float32, "cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}


def test_ssm_initializers():
    """A_log = log(1 .. N) along the last axis; dt bias through softplus
    lands dt in [1e-3, 1e-1], as the JAX package draws them."""
    from repro_torch.models.param import Spec, materialize
    g = torch.Generator().manual_seed(0)
    tree = materialize({"a": Spec((5, 4), "ssm_a_log", dtype=torch.float32),
                        "b": Spec((1000,), "ssm_dt_bias",
                                  dtype=torch.float32)},
                       g, "cpu", torch.float32)
    np.testing.assert_allclose(tree.a.numpy(), np.log(np.broadcast_to(
        np.arange(1, 5, dtype=np.float32), (5, 4))), rtol=1e-7)
    dt = torch.nn.functional.softplus(tree.b)
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1001


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_quantize_dequantize_match_jax(dtype):
    k = _rand((2, 5, 3, 32), 100) * np.linspace(0.01, 3, 32)
    k[0, 0, 0] = 0.0                       # an all-zero row: scale 1e-8
    jk = jnp.asarray(k).astype(dtype)
    tk = _t(k).to(torch.bfloat16 if dtype is jnp.bfloat16
                  else torch.float32)
    j8, js = j_model._quantize_kv(jk)
    t8, ts = t_model._quantize_kv(tk)
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(float(ts[0, 0, 0]), 1e-8, rtol=1e-7)
    jd = j_model._dequantize_kv(j8, js, jk.dtype)
    td = t_model._dequantize_kv(t8, ts, tk.dtype)
    assert td.dtype == tk.dtype
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))
    # the round trip is within half a code of each row's scale, plus, in
    # bf16, the rounding of the dequantized value (2**-8 of up to 127
    # codes)
    err = (td.float() - tk.float()).abs() / ts[..., None]
    assert float(err.max()) <= 0.5 + (0.5 if dtype is jnp.bfloat16
                                      else 1e-4)
