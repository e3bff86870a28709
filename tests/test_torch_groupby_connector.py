"""The port's group-by and connector operators against the JAX operators
on the same inputs, on the CPU. The JAX operators work on one partition
and are vmapped; the port's take the partition axis directly.

Integers, bools and min/max results must match exactly; float sums to
rtol 1e-6, atol 1e-7, since XLA's scatter-add and ``associative_scan``
order them in a way the port cannot replay. Payloads are positive, as
the engine's sums (PageRank contributions) are, so that the bound holds
without cancellation.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import connector as jc
from repro.core import groupby as jg
from repro.core.superstep import compact_combined as j_compact_combined
from repro_torch.core import connector as tc
from repro_torch.core import groupby as tg
from repro_torch.core.superstep import compact_combined as t_compact_combined

P, M, D, NP = 3, 257, 2, 40


def _stream(seed, *, n_keys=NP, invalid=0.2):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, n_keys, (P, M)).astype(np.int32)
    pay = rng.random((P, M, D)).astype(np.float32)
    valid = rng.random((P, M)) >= invalid
    return slot, pay, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same(got, want, *, float_sum=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if float_sum:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("cap", [1, 50, 300])
def test_compact(cap):
    mask = np.random.default_rng(cap).random((P, M)) < 0.3
    got = tg.compact(*_t(mask), cap)
    want = jax.vmap(lambda m: jg.compact(m, cap))(*_j(mask))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_scatter_combine_dense(op):
    slot, pay, valid = _stream(1)
    got = tg.scatter_combine_dense(*_t(slot, pay, valid), NP, op)
    want = jax.vmap(lambda s, p, v: jg.scatter_combine_dense(
        s, p, v, NP, op))(*_j(slot, pay, valid))
    _same(got[0], want[0], float_sum=(op == "sum"))
    _same(got[1], want[1])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_sort_combine_dense(op):
    slot, pay, valid = _stream(2)
    fn, ident = jg.MONOIDS[op]
    got = tg.sort_combine_dense(*_t(slot, pay, valid), NP, op)
    want = jax.vmap(lambda s, p, v: jg.sort_combine_dense(
        s, p, v, NP, fn, jnp.full((D,), ident, jnp.float32)))(
            *_j(slot, pay, valid))
    _same(got[0], want[0], float_sum=(op == "sum"))
    _same(got[1], want[1])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_sort_combine(op):
    slot, pay, valid = _stream(3)
    fn, _ = jg.MONOIDS[op]
    got = tg.sort_combine(*_t(slot, pay, valid), tg.MONOIDS[op][0])
    want = jax.vmap(lambda s, p, v: jg.sort_combine(s, p, v, fn, None))(
        *_j(slot, pay, valid))
    _same(got[0], want[0])
    _same(got[1], want[1], float_sum=(op == "sum"))
    _same(got[2], want[2])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_run_combine_dense(op):
    R, C = 4, 64
    rng = np.random.default_rng(4)
    slot = np.sort(rng.integers(0, NP, (P, R, C)), axis=-1).astype(np.int32)
    pay = rng.random((P, R, C, D)).astype(np.float32)
    valid = np.arange(C)[None, None, :] < rng.integers(0, C, (P, R, 1))
    slot = np.where(valid, slot, -1).astype(np.int32)
    got = tg.run_combine_dense(*_t(slot, pay, valid), NP, op)
    want = jax.vmap(lambda s, p, v: jg.run_combine_dense(
        s, p, v, NP, op))(*_j(slot, pay, valid))
    _same(got[0], want[0], float_sum=(op == "sum"))
    _same(got[1], want[1])


@pytest.mark.parametrize("partition,sort_by_dst,presorted", [
    ("hash", False, False), ("hash", True, False), ("range", False, False),
    ("range", True, False), ("range", False, True), ("hash", False, True)])
@pytest.mark.parametrize("cap", [5, 200])
def test_bucket_by_owner_and_exchange(partition, sort_by_dst, presorted,
                                      cap):
    n_parts, capacity = 4, 30
    dst, pay, valid = _stream(5, n_keys=n_parts * capacity)
    if presorted:
        key = np.where(valid, dst, np.iinfo(np.int32).max)
        order = np.argsort(key, axis=1, kind="stable")
        dst = np.take_along_axis(dst, order, 1)
        pay = np.take_along_axis(pay, order[..., None], 1)
        valid = np.take_along_axis(valid, order, 1)
    dst = np.where(valid, dst, -1).astype(np.int32)
    kw = dict(sort_by_dst=sort_by_dst, partition=partition,
              capacity=capacity, presorted=presorted)
    got = tc.bucket_by_owner(*_t(dst, pay, valid), n_parts, cap, **kw)
    want = jax.vmap(lambda d, p, v: jc.bucket_by_owner(
        d, p, v, n_parts, cap, **kw))(*_j(dst, pay, valid))
    for g, w in zip(got, want):
        _same(g, np.asarray(w).astype(np.int32) if w.ndim == 1 else w)
    gx = tc.exchange_emulated(*got[:3])
    wx = jc.exchange_emulated(*want[:3])
    for g, w in zip(gx, wx):
        _same(g.contiguous(), w)


@pytest.mark.parametrize("capc", [8, 100, 400])
def test_compact_combined(capc):
    dst, pay, valid = _stream(6)
    dst = np.where(valid, dst, -1).astype(np.int32)
    got = t_compact_combined(*_t(dst, pay, valid), capc)
    want = j_compact_combined(*_j(dst, pay, valid), capc)
    for g, w in zip(got, want):
        _same(g.to(torch.int32) if g.dim() == 0 else g,
              np.asarray(w).astype(np.int32) if np.ndim(w) == 0 else w)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segmented_fold(op):
    rng = np.random.default_rng(7)
    flags = rng.random((2, 300)) < 0.1
    flags[:, 0] = True
    vals = rng.random((2, 300, 2)).astype(np.float32)
    got = tg.segmented_fold(*_t(flags, vals), tg.MONOIDS[op][0])
    fn = jg.MONOIDS[op][0]
    want = jax.vmap(lambda f, v: jg._segmented_fold(f, v, fn))(
        *_j(flags, vals))
    _same(got, want, float_sum=(op == "sum"))


@pytest.mark.parametrize("shape", [(1, 5), (4, 1000), (3, 0)])
def test_row_cumsum_equals_per_row_cumsum(shape):
    mask = torch.from_numpy(np.random.default_rng(8).random(shape) < 0.4)
    assert torch.equal(tg.row_cumsum(mask), torch.cumsum(mask, dim=1))
