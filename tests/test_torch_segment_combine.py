"""The port's segmented combine (the D7 sender fold) against the JAX
reference on the CPU.

The port's fold on CPU tensors is the plain replay of the CUDA kernel's
schedule; it must give the bits of the reference's blocked fold
(``segment_combine_blocked``) and of its Pallas kernel in interpret mode,
float sums included — np.array_equal, NaN positions matched. The readable
oracles agree exactly for min/max and to rtol 1e-6 for sums, which
``associative_scan`` brackets differently.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backend as j_backend
from repro.kernels.segment_combine.ref import (segment_combine_blocked as
                                               j_blocked)
from repro.kernels.segment_combine.ref import segment_combine_ref as j_ref
from repro.kernels.segment_combine.segment_combine import \
    segment_combine_pallas
from repro_torch.kernels import backend as t_backend
from repro_torch.kernels.segment_combine import (segment_combine,
                                                 segment_combine_ref)

KINDS = ("plain", "all_invalid", "int32max", "nonfinite")


def _case(M, D, kind, seed):
    """A key-sorted stream with its invalid rows at the tail."""
    rng = np.random.default_rng(seed)
    n_valid = 0 if kind == "all_invalid" else max(int(M * 0.9), 1)
    keys = np.sort(rng.integers(0, max(M // 6, 2), n_valid))
    if kind == "int32max":
        keys[-max(n_valid // 10, 1):] = 2 ** 31 - 1
    keys = np.concatenate([keys, np.full(M - n_valid, 2 ** 31 - 1)]) \
        .astype(np.int32)
    pay = rng.normal(size=(M, D)).astype(np.float32)
    if kind == "nonfinite":
        pick = rng.random((M, D))
        pay[pick < 0.05] = np.inf
        pay[(pick >= 0.05) & (pick < 0.1)] = -np.inf
        pay[(pick >= 0.1) & (pick < 0.15)] = np.nan
    valid = np.arange(M) < n_valid
    return keys, pay, valid


def _port(keys, pay, valid, op):
    folded, is_last = segment_combine(torch.from_numpy(keys),
                                      torch.from_numpy(pay),
                                      torch.from_numpy(valid), op,
                                      block_m=512)
    return folded.numpy(), is_last.numpy()


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("M", [1, 300, 512, 1500])
def test_fold_bit_equal_to_blocked_and_pallas(op, D, M):
    for i, kind in enumerate(KINDS):
        keys, pay, valid = _case(M, D, kind, seed=M * 10 + D + i)
        got, last = _port(keys, pay, valid, op)
        args = (jnp.asarray(keys), jnp.asarray(pay), jnp.asarray(valid), op)
        for name, (want, wlast) in (
                ("blocked", j_blocked(*args, block_m=512)),
                ("pallas", segment_combine_pallas(*args, block_m=512,
                                                  interpret=True))):
            assert np.array_equal(got, np.asarray(want), equal_nan=True), \
                (kind, name)
            assert np.array_equal(last, np.asarray(wlast)), (kind, name)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("M", [7, 1500])
def test_engine_fold_matches_reference_backend(op, M):
    """sorted_segment_fold (padding to a tile multiple, then the fold)
    against the reference engine's, kernel_impl="ref"."""
    keys, pay, valid = _case(M, 1, "plain", seed=M)
    got, last = t_backend.sorted_segment_fold(
        torch.from_numpy(keys), torch.from_numpy(pay),
        torch.from_numpy(valid), op)
    want, wlast = j_backend.sorted_segment_fold(
        jnp.asarray(keys), jnp.asarray(pay), jnp.asarray(valid), op,
        impl_r="ref")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(last.numpy(), np.asarray(wlast))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_readable_oracle_matches_reference_oracle(op):
    keys, pay, valid = _case(600, 2, "plain", seed=3)
    got, last = segment_combine_ref(torch.from_numpy(keys),
                                    torch.from_numpy(pay),
                                    torch.from_numpy(valid), op)
    want, wlast = j_ref(jnp.asarray(keys), jnp.asarray(pay),
                        jnp.asarray(valid), op)
    assert np.array_equal(last.numpy(), np.asarray(wlast))
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_wrapper_takes_the_kernel_only_on_cuda():
    """CPU tensors run the plain replay; the raw kernel wrapper refuses
    them instead of falling back."""
    from repro_torch.kernels.segment_combine import (counter,
                                                     segment_combine_cuda)
    keys, pay, valid = _case(40, 1, "plain", seed=0)
    before = counter.launches
    _port(keys, pay, valid, "sum")
    assert counter.launches == before
    with pytest.raises(ValueError):
        segment_combine_cuda(torch.from_numpy(keys)[None],
                             torch.from_numpy(pay)[None],
                             torch.from_numpy(valid)[None], "sum", 512)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("D", [1, 3])
def test_ragged_stream_ending_in_int32_max_row(op, D):
    """A ragged stream (M = 1000, two tiles of 512) whose last row is
    valid and keyed int32 max: the reference pads the stream with
    int32-max keys, so is_last there reads False. Batched (P, M) with
    only one partition ending in such a row."""
    M, P = 1000, 4
    parts = [_case(M, D, kind, seed=70 + p) for p, kind in
             enumerate(("plain", "int32max", "all_invalid", "nonfinite"))]
    rng = np.random.default_rng(99)
    keys = np.sort(rng.integers(0, M // 6, M)).astype(np.int32)
    keys[-5:] = 2 ** 31 - 1                 # every row valid, last int32 max
    pay = rng.normal(size=(M, D)).astype(np.float32)
    parts[1] = (keys, pay, np.ones(M, bool))
    stack = lambda i: torch.from_numpy(np.stack([c[i] for c in parts]))
    got, last = t_backend.sorted_segment_fold(stack(0), stack(1), stack(2),
                                              op)
    assert got.shape == (P, M, D) and last.shape == (P, M)
    for p, (k, y, v) in enumerate(parts):
        want, wlast = j_backend.sorted_segment_fold(
            jnp.asarray(k), jnp.asarray(y), jnp.asarray(v), op,
            impl_r="ref")
        assert np.array_equal(got[p].numpy(), np.asarray(want),
                              equal_nan=True), p
        assert np.array_equal(last[p].numpy(), np.asarray(wlast)), p
    assert not bool(last[1, -1]) and bool(last[1, -6])
