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


def _scatter_case(case: str, seed: int):
    """Inboxes for the scatter group-by: the first superstep's (every row
    invalid), valid rows at the sink slot Np (dropped), D = 1, 3 and 4,
    and +-inf payloads (min/max only: a sum of both is NaN)."""
    if case == "stream":
        return _stream(1)
    rng = np.random.default_rng(seed)
    d = {"d1": 1, "d3": 3, "d4": 4}.get(case, D)
    slot = rng.integers(0, NP + (case == "slot_np"), (P, M)).astype(np.int32)
    pay = rng.random((P, M, d)).astype(np.float32)
    valid = rng.random((P, M)) >= 0.2
    if case == "all_invalid":
        valid[:] = False
    if case == "slot_np":
        slot[:, ::7] = NP
    if case == "inf":
        pick = rng.random((P, M, d))
        pay[pick < 0.1] = np.inf
        pay[(pick >= 0.1) & (pick < 0.2)] = -np.inf
        slot[:, :8] = 3              # a slot that sees both infinities
    return slot, pay, valid


SCATTER_CASES = (
    [pytest.param(op, "stream", id=op) for op in ("sum", "min", "max")]
    + [pytest.param(op, case, id=f"{op}-{case}")
       for case in ("all_invalid", "slot_np", "d1", "d3", "d4", "inf")
       for op in ("sum", "min", "max") if not (case == "inf" and op == "sum")])


@pytest.mark.parametrize("op,case", SCATTER_CASES)
def test_scatter_combine_dense(op, case):
    slot, pay, valid = _scatter_case(case, 11)
    got = tg.scatter_combine_dense(*_t(slot, pay, valid), NP, op)
    want = jax.vmap(lambda s, p, v: jg.scatter_combine_dense(
        s, p, v, NP, op))(*_j(slot, pay, valid))
    _same(got[0], want[0], float_sum=(op == "sum"))
    _same(got[1], want[1])
    if case == "all_invalid":
        assert not got[1].any()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_scatter_combine_shapes_on_meta_tensors(op):
    """The operator counter's probe: the wrapper and the engine's entry
    point take the plain chain on meta tensors and return outputs of the
    plain version's shapes and dtypes, without a launch."""
    from repro_torch.kernels.scatter_combine import counter, scatter_combine
    slot = torch.empty((P, M), dtype=torch.int32, device="meta")
    pay = torch.empty((P, M, 3), dtype=torch.float32, device="meta")
    valid = torch.empty((P, M), dtype=torch.bool, device="meta")
    before = counter.launches
    for fn in (scatter_combine, tg.scatter_combine_dense):
        dense, has = fn(slot, pay, valid, NP, op)
        assert dense.device.type == "meta" and has.device.type == "meta"
        assert dense.shape == (P, NP, 3) and dense.dtype == torch.float32
        assert has.shape == (P, NP) and has.dtype == torch.bool
    assert counter.launches == before


def test_scatter_combine_kernel_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors, and a superstep of a
    scatter group-by plan on CPU tensors under kernel_impl='cuda' raises
    before anything runs: no silent plain path."""
    from repro_torch.core import PhysicalPlan, load_graph, run_host
    from repro_torch.graph import PageRank
    from repro_torch.kernels.scatter_combine import scatter_combine_cuda
    slot, pay, valid = _t(*_stream(1))
    with pytest.raises(ValueError, match="CUDA"):
        scatter_combine_cuda(slot, pay, valid, NP, "sum")
    edges = np.array([[0, 1], [1, 2], [2, 0], [2, 3]], dtype=np.int64)
    vert = load_graph(edges, 4, 2, value_dims=2, device="cpu")
    for connector in ("partitioning", "partitioning_merging"):
        plan = PhysicalPlan(groupby="scatter", connector=connector,
                            kernel_impl="cuda")
        with pytest.raises(ValueError, match="kernel_impl='cuda'"):
            run_host(vert, PageRank(4), plan, max_supersteps=2)


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
