"""The CUDA fold's schedule, replayed in plain torch on the CPU.

The kernel (``kernels/csrc/segment_combine.cu``) replaces the sequential
carry between tiles by a decoupled look-back: a tile whose first segment
continues its predecessor walks back to the newest predecessor whose
carry out is known, which may be any tile from the newest one that ends
a segment up to its own predecessor, depending on timing, and folds the
last values after it forward, oldest first. The replay below draws that
stop from a seeded generator for every tile and must give the bits of
the port's ``segment_combine_blocked`` and of the JAX reference's blocked
fold and Pallas kernel (interpret mode), for every stop. A newest-first
fold of the same window (CUB's order) must not, on a case built for it.
Also the batched (P, M) engine fold against the reference engine's,
partition by partition.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backend as j_backend
from repro.kernels.segment_combine.ref import (segment_combine_blocked as
                                               j_blocked)
from repro.kernels.segment_combine.segment_combine import \
    segment_combine_pallas
from repro_torch.kernels import backend as t_backend
from repro_torch.kernels.segment_combine import (segment_combine,
                                                 segment_combine_blocked)
from repro_torch.kernels.segment_combine.ref import (IDENT, INT32_MAX,
                                                     _tile_network,
                                                     combine_fn,
                                                     segment_lasts)

BM = 512


def lookback_replay(keys, pay, valid, op, block_m, pick_stop,
                    newest_first=False):
    """The kernel's schedule in plain torch. ``pick_stop(k0, t)`` returns
    the tile whose carry out the look-back of tile t starts from, in
    [k0, t - 1]: k0 is the newest tile before t whose carry out is its
    own last value (-1: none, the identity), so every tile after it is
    PARTIAL until its own look-back ends."""
    fn = combine_fn(op)
    M, D = pay.shape
    bm = min(block_m, M)
    seg2 = torch.where(valid, keys, INT32_MAX)
    x = torch.where(valid[:, None], pay, IDENT[op]).float()
    T = -(-M // bm)
    pad = T * bm - M
    segp = torch.cat([seg2, torch.full((pad,), INT32_MAX,
                                       dtype=seg2.dtype)]).reshape(T, bm)
    xp = torch.cat([x, torch.full((pad, D), IDENT[op])]).reshape(T, bm, D)
    v, boundary = _tile_network(segp, xp, op)
    first = torch.cumsum(boundary, dim=1) == 1
    last = v[:, -1, :].clone()       # before any splice
    # the id of row t*BM - 1 (masked), -2 before the first tile
    prev = torch.cat([torch.full((1,), -2, dtype=segp.dtype),
                      segp[:-1, -1]])
    cont_in = segp[:, 0] == prev
    cont_out = cont_in & first[:, -1]
    ident = torch.full((D,), IDENT[op])
    X, k0 = [], -1
    for t in range(T):
        carry = None
        if cont_in[t]:
            stop = pick_stop(k0, t)
            assert k0 <= stop <= t - 1
            carry = X[stop] if stop >= 0 else ident
            window = [last[k] for k in range(stop + 1, t)]
            if newest_first and window:
                agg = window[-1]
                for L in reversed(window[:-1]):
                    agg = fn(L, agg)
                carry = fn(carry, agg)
            else:
                for L in window:
                    carry = fn(carry, L)
            rows = first[t]
            v[t, rows] = fn(carry[None, :], v[t, rows])
        X.append(fn(carry, last[t]) if cont_out[t] else last[t])
        if not cont_out[t]:
            k0 = t
    return v.reshape(T * bm, D)[:M], segment_lasts(seg2, valid)


def _random_stops(seed):
    rng = np.random.default_rng(seed)
    return lambda k0, t: int(rng.integers(k0, t))


def lookback_case(kind, D, seed):
    """(keys, payload, valid) built so that ``kind`` shows: a segment
    over more than 64 tiles, segments of exactly BM rows, M = k*BM +- 1,
    an all-invalid stream, NaN and +-inf payloads."""
    rng = np.random.default_rng(seed)
    if kind == "span_over_64_tiles":
        lens = [37, 1200, 66 * BM + 5, 300, 811]
    elif kind == "span_exactly_bm":
        lens = [BM, BM, 100, BM, BM, 412, BM, 3]   # aligned, then not
    elif kind == "k_bm_minus_1":
        lens = list(rng.integers(1, 10, 200)) + [2 * BM]
        lens[-1] += 7 * BM - 1 - sum(lens)
    elif kind == "k_bm_plus_1":
        lens = [3 * BM + 1] + list(rng.integers(1, 30, 100))
        lens[-1] += 10 * BM + 1 - sum(lens)
    else:                          # all_invalid, nonfinite: R-MAT-like
        lens = list(rng.geometric(0.05, 300)) + [4 * BM]
    M = int(sum(lens))
    keys = np.repeat(np.arange(len(lens)) * 3 + 1, lens).astype(np.int32)
    n_valid = 0 if kind == "all_invalid" else M - int(rng.integers(0, 40))
    keys[n_valid:] = INT32_MAX
    valid = np.arange(M) < n_valid
    pay = rng.normal(size=(M, D)).astype(np.float32)
    if kind == "nonfinite":
        pick = rng.random((M, D))
        pay[pick < 0.01] = np.inf
        pay[(pick >= 0.01) & (pick < 0.02)] = -np.inf
        pay[(pick >= 0.02) & (pick < 0.025)] = np.nan
    return keys, pay, valid


KINDS = ("span_over_64_tiles", "span_exactly_bm", "k_bm_minus_1",
         "k_bm_plus_1", "all_invalid", "nonfinite")


def _same_bits(a, b) -> bool:
    """Equal bit for bit (so -0.0 != +0.0), NaN where the other has NaN:
    torch's ops pick a NaN's payload by code path, not by value."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and np.array_equal(
        a.view(np.int32)[~na], b.view(np.int32)[~nb])


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_lookback_replay_bit_equal_to_blocked_and_pallas(kind, D, op):
    keys, pay, valid = lookback_case(kind, D, seed=KINDS.index(kind) * 7 + D)
    tk, tp, tv = (torch.from_numpy(a) for a in (keys, pay, valid))
    want, wlast = segment_combine_blocked(tk, tp, tv, op, block_m=BM)
    for seed in range(3):
        got, last = lookback_replay(tk, tp, tv, op, BM, _random_stops(seed))
        assert _same_bits(got, want), seed
        assert torch.equal(last, wlast)
    # the oldest and the newest stop every time
    for pick in (lambda k0, t: k0, lambda k0, t: t - 1):
        got, _ = lookback_replay(tk, tp, tv, op, BM, pick)
        assert _same_bits(got, want)
    args = (jnp.asarray(keys), jnp.asarray(pay), jnp.asarray(valid), op)
    for name, (ref, rlast) in (
            ("blocked", j_blocked(*args, block_m=BM)),
            ("pallas", segment_combine_pallas(*args, block_m=BM,
                                              interpret=True))):
        assert np.array_equal(got.numpy(), np.asarray(ref),
                              equal_nan=True), name
        assert np.array_equal(last.numpy(), np.asarray(rlast)), name


def test_lookback_case_has_a_segment_over_64_tiles():
    keys, _, valid = lookback_case("span_over_64_tiles", 1, seed=0)
    _, counts = np.unique(keys[valid], return_counts=True)
    assert counts.max() > 64 * BM


def test_newest_first_fold_breaks_the_bits():
    """Negative control. Tile 0 ends with 1.0 in a segment that two
    whole tiles (last values 2**-24 each) continue into tile 3. The
    sequential carry is (1 + 2**-24) + 2**-24 = 1.0 (each add rounds to
    even); a newest-first fold of the window gives 1 + (2**-24 + 2**-24)
    = 1 + 2**-23."""
    bm = 4
    keys = np.array([0] * 13 + [1, 1, 1], np.int32)
    pay = np.zeros((16, 1), np.float32)
    pay[0, 0] = 1.0
    pay[4, 0] = pay[8, 0] = 2.0 ** -24
    valid = np.ones(16, bool)
    tk, tp, tv = (torch.from_numpy(a) for a in (keys, pay, valid))
    want, _ = segment_combine_blocked(tk, tp, tv, "sum", block_m=bm)
    oldest = lambda k0, t: k0
    good, _ = lookback_replay(tk, tp, tv, "sum", bm, oldest)
    bad, _ = lookback_replay(tk, tp, tv, "sum", bm, oldest,
                             newest_first=True)
    assert _same_bits(good, want)
    assert float(want[12, 0]) == 1.0
    assert float(bad[12, 0]) == 1.0 + 2.0 ** -23
    assert not _same_bits(bad, want)
    jwant, _ = j_blocked(jnp.asarray(keys), jnp.asarray(pay),
                         jnp.asarray(valid), "sum", block_m=bm)
    assert _same_bits(jwant, want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("M", [7, 512, 1500, 3 * BM + 1])
def test_batched_fold_equals_reference_engine_per_partition(op, M):
    """The engine's batched (P, M) fold on CPU tensors, each partition a
    stream of its own (one of them all invalid, one with non-finite
    payloads), against the reference engine's sorted_segment_fold one
    partition at a time."""
    rng = np.random.default_rng(M)
    P, D = 4, 2
    keys = np.full((P, M), INT32_MAX, np.int32)
    valid = np.zeros((P, M), bool)
    for p in range(P):
        n_valid = 0 if p == 2 else M - int(rng.integers(0, max(M // 5, 1)))
        keys[p, :n_valid] = np.sort(rng.integers(0, max(M // 4, 2),
                                                 n_valid))
        valid[p, :n_valid] = True
    pay = rng.normal(size=(P, M, D)).astype(np.float32)
    pay[3, rng.random(M) < 0.1] = np.inf
    pay[3, rng.random(M) < 0.05] = np.nan
    got, last = t_backend.sorted_segment_fold(
        torch.from_numpy(keys), torch.from_numpy(pay),
        torch.from_numpy(valid), op)
    assert got.shape == (P, M, D) and last.shape == (P, M)
    for p in range(P):
        for impl in ("ref", "pallas"):
            want, wlast = j_backend.sorted_segment_fold(
                jnp.asarray(keys[p]), jnp.asarray(pay[p]),
                jnp.asarray(valid[p]), op, impl_r=impl)
            assert np.array_equal(got[p].numpy(), np.asarray(want),
                                  equal_nan=True), (p, impl)
            assert np.array_equal(last[p].numpy(), np.asarray(wlast)), \
                (p, impl)


def test_one_dimensional_call_is_one_partition():
    keys, pay, valid = lookback_case("k_bm_plus_1", 1, seed=5)
    tk, tp, tv = (torch.from_numpy(a) for a in (keys, pay, valid))
    f1, l1 = segment_combine(tk, tp, tv, "sum")
    f2, l2 = segment_combine(tk[None], tp[None], tv[None], "sum")
    assert f1.shape == tp.shape and l1.shape == tk.shape
    assert torch.equal(f1, f2[0]) and torch.equal(l1, l2[0])
