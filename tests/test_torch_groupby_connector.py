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
    """The kernel's own launcher raises on CPU tensors: only the
    wrapper's device dispatch reaches it."""
    from repro_torch.kernels.scatter_combine import scatter_combine_cuda
    slot, pay, valid = _t(*_stream(1))
    with pytest.raises(ValueError, match="CUDA"):
        scatter_combine_cuda(slot, pay, valid, NP, "sum")


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


def _sort_fold_case(case: str, seed: int):
    """Inboxes for the sort group-by's fold: P = 4 streams of 1500 rows, a
    third valid, slots repeated; D = 1 to 4; no row valid and every row
    valid; runs across the 512-row tiles (every row at one of 3 slots); a
    run of 70,000 rows (137 tiles, past the look-back's 128-tile window);
    valid rows at slot Np and past it (dropped); one stream all tail;
    integer-valued payloads (sums exact in any order)."""
    rng = np.random.default_rng(seed)
    M_, d, n_keys, share = 1500, 2, NP, 1 / 3
    if case in ("d1", "d2", "d3", "d4"):
        d = int(case[1])
    if case == "cross_tile":
        M_, n_keys, share = 3000, 3, 0.9
    if case == "long_run":
        M_ = 72_000
    slot = rng.integers(0, n_keys + 3 * (case == "key_ge_np"),
                        (4, M_)).astype(np.int32)
    valid = rng.random((4, M_)) < {"none_valid": 0.0,
                                   "all_valid": 1.0}.get(case, share)
    pay = rng.random((4, M_, d)).astype(np.float32)
    if case == "long_run":
        slot[0, :70_000], valid[0, :70_000] = 7, True
    if case == "key_ge_np":
        slot[:, ::11], valid[:, ::11] = 2 ** 31 - 2, True
    if case == "all_tail":
        valid[2] = False
    if case == "ints":
        pay = rng.integers(0, 5, (4, M_, d)).astype(np.float32)
    return slot, pay, valid


def _blocked_dense(ks, ps, vs, Np, op):
    """The kernel's schedule written out: segment_combine_blocked on each
    stream, then each kept run's last row into its slot."""
    from repro_torch.kernels.segment_combine import segment_combine_blocked
    from repro_torch.kernels.segment_combine.ref import IDENT
    dense = torch.full((ps.shape[0], Np, ps.shape[2]), IDENT[op])
    has = torch.zeros((ps.shape[0], Np), dtype=torch.bool)
    for p in range(ps.shape[0]):
        folded, is_last = segment_combine_blocked(ks[p], ps[p], vs[p], op)
        last = is_last & (ks[p] < Np)
        dense[p, ks[p][last].long()] = folded[last]
        has[p, ks[p][last].long()] = True
    return dense, has


SORT_FOLD_CASES = [
    pytest.param(op, case, id=f"{op}-{case}")
    for case in ("d1", "d2", "d3", "d4", "none_valid", "all_valid",
                 "cross_tile", "long_run", "key_ge_np", "all_tail", "ints")
    for op in ("sum", "min", "max")]


@pytest.mark.parametrize("op,case", SORT_FOLD_CASES)
def test_sort_fold_dense_plain_version(op, case):
    """The sort_fold_dense kernel's plain version (its wrapper on CPU
    tensors) on ``_sort_rows``' streams: bit for bit the blocked schedule
    the kernel runs; against the port's plain chain and the JAX package's
    sort_combine_dense, has, min and max exactly, sums to rounding
    (exactly where the payloads are integers)."""
    from repro_torch.kernels.sort_fold_dense import sort_fold_dense
    slot, pay, valid = _sort_fold_case(case, 12)
    ks, ps, vs = tg._sort_rows(*_t(slot, pay, valid))
    got = sort_fold_dense(ks, ps, vs, NP, op)
    want = _blocked_dense(ks, ps, vs, NP, op)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    float_sum = op == "sum" and case != "ints"
    plain = tg.scan_fold_dense(ks, ps, vs, NP, *tg.MONOIDS[op])
    _same(got[0], plain[0], float_sum=float_sum)
    _same(got[1], plain[1])
    fn, ident = jg.MONOIDS[op]
    jx = jax.jit(jax.vmap(lambda s, p, v: jg.sort_combine_dense(
        s, p, v, NP, fn, jnp.full((pay.shape[2],), ident, jnp.float32))))(
            *_j(slot, pay, valid))
    _same(got[0], jx[0], float_sum=float_sum)
    _same(got[1], jx[1])
    if case in ("none_valid", "all_tail"):
        assert not got[1][2].any()


class _OnCuda(torch.Tensor):
    """A CPU tensor that tells Python code it lives on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def test_sort_combine_dense_dispatch(monkeypatch):
    """A monoid name on CUDA tensors folds in the sort_fold_dense kernel
    (its backend entry gets ``_sort_rows``' streams); CPU tensors, and a
    custom UDF on any device, take the plain chain. The kernel's wrapper
    refuses CPU tensors."""
    from repro_torch.kernels.sort_fold_dense import sort_fold_dense_cuda
    slot, pay, valid = _t(*_stream(2))
    calls = []

    def kernel(ks, ps, vs, Np, op):
        calls.append((ks, ps, vs, Np, op))
        return "kernel"

    monkeypatch.setattr(tg.kbackend, "sorted_fold_dense", kernel)
    plain = tg.sort_combine_dense(slot, pay, valid, NP, "min")
    assert not calls and isinstance(plain[0], torch.Tensor)
    on_card = pay.as_subclass(_OnCuda)
    assert tg.sort_combine_dense(slot, on_card, valid, NP, "min") == \
        "kernel"
    (ks, ps, vs, Np, op), = calls
    assert (Np, op) == (NP, "min")
    for got, want in zip((ks, ps, vs), tg._sort_rows(slot, pay, valid)):
        assert torch.equal(got, want)
    # the plain chain allocates on the payload's device: hand it the CPU
    # tensor underneath
    scan = tg.scan_fold_dense
    monkeypatch.setattr(tg, "scan_fold_dense", lambda ks, ps, *rest: scan(
        ks, ps.as_subclass(torch.Tensor), *rest))
    udf = tg.sort_combine_dense(slot, on_card, valid, NP,
                                (torch.minimum, torch.full((D,), np.inf)))
    assert len(calls) == 1
    _same(udf[0], plain[0])
    _same(udf[1], plain[1])
    with pytest.raises(ValueError, match="CUDA"):
        sort_fold_dense_cuda(ks, ps, vs, NP, "sum")


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


MODES = [("hash", False, False), ("hash", True, False),
         ("range", False, False), ("range", True, False),
         ("range", False, True), ("hash", False, True)]
# the streams the bucket pack must take besides the base one (4 owners,
# D = 2, 20 % of the rows invalid): 1 and 16 owners, D = 1, no row valid,
# every valid row on one owner (past cap 200), every other row invalid
# with every valid row on one owner (past cap 5)
CASES = ["P1", "P16", "D1", "none_valid", "one_owner", "interleaved"]


@pytest.mark.parametrize(
    "partition,sort_by_dst,presorted,case",
    [pytest.param(*m, "base", id="-".join(map(str, m))) for m in MODES]
    + [pytest.param(*m, c, id="-".join(map(str, m + (c,))))
       for m in MODES for c in CASES])
@pytest.mark.parametrize("cap", [5, 200, 300])     # 300 >= K = 257
def test_bucket_by_owner_and_exchange(partition, sort_by_dst, presorted,
                                      case, cap):
    n_parts = {"P1": 1, "P16": 16}.get(case, 4)
    capacity = 30
    dst, pay, valid = _stream(5, n_keys=n_parts * capacity)
    if case == "D1":
        pay = pay[..., :1]
    elif case == "none_valid":
        valid = np.zeros_like(valid)
    elif case in ("one_owner", "interleaved"):
        # a multiple of n_parts below capacity: owner 0 either way
        dst = (dst % (capacity // n_parts)) * n_parts
        if case == "interleaved":
            valid = np.broadcast_to(np.arange(M) % 2 == 0, (P, M)).copy()
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


def test_bucket_pack_launches_no_kernel_on_cpu_or_meta():
    """CPU and meta tensors take the plain chain: the kernel's launch
    counter stays at 0, and a meta stream gives the buckets' shapes."""
    from repro_torch.kernels import COUNTERS
    from repro_torch.kernels.bucket_pack import bucket_pack
    assert COUNTERS["bucket_pack"].launches == 0
    dst, pay, valid = _stream(9, n_keys=4 * 30)
    got = tc.bucket_by_owner(*_t(dst, pay, valid), 4, 50,
                             sort_by_dst=False)
    assert [tuple(g.shape) for g in got] == [(P, 4, 50), (P, 4, 50, D),
                                             (P, 4, 50), (P,)]
    meta = [t.to("meta") for t in _t(dst, pay, valid)]
    got = bucket_pack(*meta, 4, 50)
    assert all(g.device.type == "meta" for g in got)
    assert [tuple(g.shape) for g in got] == [(P, 4, 50), (P, 4, 50, D),
                                             (P, 4, 50), (P,)]
    assert COUNTERS["bucket_pack"].launches == 0


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
