"""The port's common layers against the JAX package's on the same numpy
inputs: norms, RoPE, the SwiGLU MLP, embedding and the tied unembedding.
Float32 throughout; atol 1e-5 covers the two libraries' different
summation orders in the matrix products (values of magnitude ~1, d
<= 256 terms), elementwise ops agree to a few ulp."""
import _torch_threads  # noqa: F401  (first: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as J
from repro_torch.models import layers as T

RNG = np.random.default_rng(11)


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    x = RNG.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"scale": RNG.normal(size=64).astype(np.float32),
         "bias": RNG.normal(size=64).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(T.apply_norm(tp, torch.from_numpy(x), kind),
           J.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), kind))


def test_norm_casts_back_to_input_dtype():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    y = T.apply_norm({"scale": torch.ones(16)}, x, "rmsnorm")
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("hd,theta", [(32, 10000.0), (64, 1e6), (6, 10.0)])
def test_rope_half_split(hd, theta):
    x = RNG.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = np.arange(9)[None, :] + np.array([[0], [100]])
    _close(T.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           J.rope(jnp.asarray(x), jnp.asarray(pos), theta), atol=2e-5)


def test_mlp():
    d, f = 64, 96
    p = {k: (RNG.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    x = RNG.normal(size=(2, 7, d)).astype(np.float32)
    _close(T.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x)),
           J.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x)))


def test_embed_and_tied_unembed():
    V, d = 50, 32
    emb = RNG.normal(size=(V, d)).astype(np.float32)
    tok = RNG.integers(0, V, (3, 4)).astype(np.int32)
    x = RNG.normal(size=(3, 4, d)).astype(np.float32)
    tp, jp = {"embedding": torch.from_numpy(emb)}, \
        {"embedding": jnp.asarray(emb)}
    _close(T.embed(tp, torch.from_numpy(tok)), J.embed(jp, jnp.asarray(tok)))
    _close(T.unembed(tp, torch.from_numpy(x)),
           J.unembed(jp, jnp.asarray(x)))
