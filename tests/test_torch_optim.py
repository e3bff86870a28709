"""The port's optimizer against the JAX package's on the same numpy
trees: AdamW with the cosine schedule and global-norm clipping over
three steps (moments in float32 and in bfloat16; parameters in float32
and one leaf in bfloat16), and the int8 error-feedback gradient
compression over two steps.

Tolerances: float32 results rtol 1e-6 (the same float32 arithmetic;
XLA may fuse or reorder it); a bfloat16 result one unit in its last
place (rtol 2**-8: a float32 value within 1e-6 of a rounding boundary
may round either way). int8 codes equal; scales and residuals atol 1e-7.
"""
import _torch_threads  # noqa: F401  (first: see the module)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as j_init
from repro.optim import adamw_update as j_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import compress_gradients as j_compress
from repro.optim import cosine_schedule as j_cosine
from repro.optim import decompress_gradients as j_decompress
from repro.optim import init_error_feedback as j_init_ef
from repro_torch.models.param import tree_from_numpy
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, compress_gradients,
                               cosine_schedule, decompress_gradients,
                               init_error_feedback)
from repro_torch.tree import tree_leaves, tree_map


def _tree(r, scale=1.0):
    """Nested dicts and a list, as a model's tree: float32 leaves and
    one bfloat16 leaf (as numpy float32, cast on each side)."""
    f = lambda *s: (r.standard_normal(s) * scale).astype(np.float32)
    return {"w": f(8, 16), "stages": [{"a": f(5)}, {"a": f(5)}],
            "norm": {"scale": f(3, 4, 2)}, "bf": f(16)}


def _jax(tree):
    return {k: (jax.tree.map(jnp.asarray, v) if k != "bf"
                else jnp.asarray(v, jnp.bfloat16)) for k, v in tree.items()}


def _torch(tree):
    out = tree_from_numpy({k: v for k, v in tree.items()}, "cpu")
    out["bf"] = out["bf"].bfloat16()
    return out


def _close(got: torch.Tensor, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol = 2.0 ** -8 if got.dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-7)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(moments):
    r = np.random.default_rng(0)
    params = _tree(r)
    jp, tp = _jax(params), _torch(params)
    js = j_init(jp, moment_dtype=jnp.dtype(moments))
    ts = adamw_init(tp, moment_dtype=getattr(torch, moments))
    assert ts["step"].dtype == torch.int32
    for i in range(3):
        grads = _tree(r, scale=3.0)
        jg, tg = _jax(grads), _torch(grads)
        jg, jn = j_clip(jg, 1.0)
        tg, tn = clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        kw = dict(peak_lr=1e-2, warmup=2, total=10)
        jlr = j_cosine(js["step"], **kw)
        tlr = cosine_schedule(ts["step"], **kw)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
        jp, js = j_update(jg, js, jp, lr=jlr)
        out_p, out_s = adamw_update(tg, ts, tp, lr=tlr)
        assert out_p is tp and out_s is ts             # in place
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            _close(got, want)
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            _close(got, want)
        for k in ("m", "v"):
            for got, want in zip(tree_leaves(ts[k]),
                                 jax.tree.leaves(js[k])):
                assert str(got.dtype).endswith(moments)
                _close(got, want)


def test_cosine_schedule_over_its_range():
    for step in (0, 1, 4, 5, 6, 50, 99, 100, 140):
        want = j_cosine(jnp.int32(step), peak_lr=3e-4, warmup=5, total=100)
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                              peak_lr=3e-4, warmup=5, total=100)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_compression_matches_jax():
    r = np.random.default_rng(1)
    params = _tree(r)
    jp, tp = _jax(params), _torch(params)
    je, te = j_init_ef(jp), init_error_feedback(tp)
    for _ in range(2):
        grads = _tree(r, scale=2.0)
        jq, je = j_compress(_jax(grads), je)
        tq, te = compress_gradients(_torch(grads), te)
        jleaves = jax.tree.leaves(jq)          # q, scale, q, scale, ...
        tleaves = [x for t in tree_leaves(tq) for x in t]
        assert len(jleaves) == len(tleaves)
        for got, want in zip(tleaves, jleaves):
            want = np.asarray(want)
            if want.dtype == np.int8:
                assert got.dtype == torch.int8
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-7)
        for got, want in zip(tree_leaves(te), jax.tree.leaves(je)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-7)
    jd = j_decompress(jq)
    td = decompress_gradients(tq)
    for got, want in zip(tree_leaves(td), jax.tree.leaves(jd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)


def test_tree_order_is_jax_flatten_order():
    tree = {"b": [{"y": 1, "x": 2}, 3], "a": {"z": 4}, "c": 5}
    assert tree_leaves(tree) == jax.tree.leaves(tree) == [4, 2, 1, 3, 5]
    assert tree_map(lambda v: v * 10, tree)["b"][0] == {"y": 10, "x": 20}


def test_update_by_slices_equals_the_whole(monkeypatch):
    """A leaf above the slice size is updated a block of leading rows at
    a time (rows above it a slice of a row at a time): the same values as
    one update over the whole leaf."""
    from repro_torch.optim import adamw
    r = np.random.default_rng(2)
    params = {"w": r.standard_normal((7, 30)).astype(np.float32),
              "x": r.standard_normal((3, 5, 40)).astype(np.float32)}
    grads = {k: r.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    out = []
    for elems in (1 << 28, 100):
        monkeypatch.setattr(adamw, "_SLICE_ELEMS", elems)
        tp = tree_from_numpy(params, "cpu")
        st = adamw_init(tp)
        for _ in range(2):
            adamw_update(tree_from_numpy(grads, "cpu"), st, tp, lr=1e-2)
        out.append(tree_leaves(tp) + tree_leaves(st["m"])
                   + tree_leaves(st["v"]))
    assert [tuple(s.shape) for s in adamw._slices(torch.zeros(7, 30))] == \
        [(3, 30), (3, 30), (1, 30)]
    for a, b in zip(*out):
        assert torch.equal(a, b)
