"""The port's grouped matmul (its plain version, which the wrapper runs
on CPU tensors) and its tile map against the JAX package's Pallas grouped
matmul in interpret mode, its jnp oracle and its ``_group_pad``.

Tolerance: atol 1e-5 in float32 (tests/test_kernels.py holds Pallas to
the oracle at 1e-4): both sides accumulate the same float32 products of
magnitude ~1 over d <= 128 terms in another order. The tile map is
integer and must agree exactly.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import ops as j_ops
from repro.kernels.moe_gmm.ref import grouped_matmul_ref as j_ref
from repro_torch.kernels.moe_gmm import (grouped_matmul, grouped_matmul_ref,
                                         tile_map, tile_n, work_tiles)

# tests/test_kernels.py::test_moe_gmm's shapes, an expert with no tokens,
# T smaller than one tile, and every token in one expert
CASES = [
    ("multinomial", 300, 64, 128, 4, 64), ("multinomial", 1024, 128, 256, 8, 128),
    ("multinomial", 50, 32, 64, 8, 16), ("multinomial", 17, 16, 32, 3, 8),
    ("empty", 200, 32, 64, 6, 32), ("tiny", 5, 16, 32, 4, 64),
    ("one_group", 130, 16, 32, 5, 64),
]


def _case(kind, T, d, f, E, seed):
    rng = np.random.default_rng(seed)
    if kind == "empty":              # experts 1 and E-1 get no token
        p = np.ones(E)
        p[[1, E - 1]] = 0
        sizes = rng.multinomial(T, p / p.sum())
    elif kind == "one_group":
        sizes = np.zeros(E, np.int64)
        sizes[2] = T
    else:
        sizes = rng.multinomial(T, np.ones(E) / E)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(E, d, f)) / np.sqrt(d)).astype(np.float32)
    return sizes.astype(np.int32), x, w


@pytest.mark.parametrize("kind,T,d,f,E,bm", CASES)
def test_plain_matches_pallas_and_oracle(kind, T, d, f, E, bm):
    sizes, x, w = _case(kind, T, d, f, E, seed=T + E)
    got = grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(sizes)).numpy()
    pallas = j_ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(sizes), impl="pallas",
                                  block_m=bm)
    oracle = j_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=1e-5)


@pytest.mark.parametrize("kind,T,d,f,E,bm", CASES)
def test_tile_map_is_group_pad_without_the_padding(kind, T, d, f, E, bm):
    """Entry i of the map is the i-th tile of ``_group_pad``'s padded
    layout that holds a row: the same expert (its tile_eid), and its
    rows are the ones ``pos`` scatters into that tile, in order."""
    sizes, x, _ = _case(kind, T, d, f, E, seed=T + E)
    bm = min(bm, max(T, 8))               # as the JAX wrapper clips it
    _, tile_eid, pos = j_ops._group_pad(jnp.asarray(x), jnp.asarray(sizes),
                                        bm)
    tile_eid, pos = np.asarray(tile_eid), np.asarray(pos)
    tiles = tile_map(torch.from_numpy(sizes), T, block_m=bm).numpy()
    assert tiles.dtype == np.int32
    assert tiles.shape == (-(-T // bm) + E, 3)
    live = np.unique(pos // bm)           # padded tiles that hold a row
    used = tiles[tiles[:, 2] > 0]
    assert len(used) == len(live)
    np.testing.assert_array_equal(used[:, 0], tile_eid[live])
    for (e, r0, n), ti in zip(used, live):
        np.testing.assert_array_equal(pos[r0:r0 + n], ti * bm + np.arange(n))
    assert used[:, 2].sum() == T and (tiles[:, 2] <= bm).all()
    assert (tiles[tiles[:, 2] == 0, 2] == 0).all()


@pytest.mark.parametrize("total", [37, 90])
def test_sizes_off_the_row_count_clip_as_the_oracle(total):
    """Sizes summing below T (rows past the sum go to expert E - 1) or
    above T (trailing groups cut)."""
    T, d, f, E = 64, 16, 24, 4
    rng = np.random.default_rng(total)
    sizes = rng.multinomial(total, np.ones(E) / E).astype(np.int32)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = rng.normal(size=(E, d, f)).astype(np.float32)
    got = grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(sizes)).numpy()
    want = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(sizes)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    tiles = tile_map(torch.from_numpy(sizes), T, block_m=16).numpy()
    covered = np.zeros(T, int)
    for e, r0, n in tiles[tiles[:, 2] > 0]:
        covered[r0:r0 + n] += 1
    assert (covered == 1).all()


def _walk_covers_once(sizes, T, f, block_m, block_n):
    """The kernel's work list, walked by persistent grids of several
    sizes (block b takes tiles b, b + G, ...): every (tile of tile_map,
    column tile) once, and so every (row, column tile) once."""
    s = torch.from_numpy(sizes)
    tiles = tile_map(s, T, block_m=block_m).numpy()
    used = tiles[tiles[:, 2] > 0]
    work = work_tiles(s, T, f, block_m, block_n).numpy()
    block_n = block_n or tile_n(f)
    n_col = -(-f // block_n)
    want = sorted((int(e), int(r0), int(n), c * block_n)
                  for e, r0, n in used for c in range(n_col))
    for grid in (1, 3, 7, 132):
        walked = [tuple(int(x) for x in work[i])
                  for b in range(grid) for i in range(b, len(work), grid)]
        assert sorted(walked) == want
        cover = np.zeros((T, n_col), int)
        for e, r0, n, c0 in walked:
            cover[r0:r0 + n, c0 // block_n] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("block_m,block_n", [(128, 128), (128, 256),
                                             (64, 64)])
@pytest.mark.parametrize("kind,T,d,f,E,bm", CASES)
def test_persistent_walk_covers_every_tile_once(kind, T, d, f, E, bm,
                                                block_m, block_n):
    sizes, _, _ = _case(kind, T, d, f, E, seed=T + E)
    _walk_covers_once(sizes, T, f, block_m, block_n)


@pytest.mark.parametrize("total", [37, 90, 300])
def test_persistent_walk_with_sizes_off_the_row_count(total):
    """Sizes summing below T (the tail goes to expert E - 1) or above it
    (trailing groups cut), with ragged column tiles."""
    T, f, E = 200, 200, 5
    rng = np.random.default_rng(total)
    sizes = rng.multinomial(total, np.ones(E) / E).astype(np.int64)
    _walk_covers_once(sizes, T, f, 128, 0)     # the kernel's own width
    _walk_covers_once(sizes, T, f, 128, 256)
    _walk_covers_once(sizes, T, f, 64, 64)


def test_wrapper_raises_off_cpu_and_cuda():
    """The kernel's wrapper takes CUDA tensors alone; the entry point
    takes meta tensors, the operator counter's dry run: the output's
    shape, 2 d f flops a row charged."""
    from repro_torch.kernels.moe_gmm import grouped_matmul_cuda
    from repro_torch.launch import op_cost
    x = torch.empty((4, 8), device="meta")
    w = torch.empty((2, 8, 8), device="meta")
    sizes = torch.tensor([2, 2], device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_cuda(x, w, sizes)
    cost = op_cost.measure(grouped_matmul, x, w, sizes)
    assert cost.matmul_flops == 2 * 4 * 8 * 8
    assert grouped_matmul(x, w, sizes).shape == (4, 8)
