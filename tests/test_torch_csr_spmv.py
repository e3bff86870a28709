"""The port's edge-order gather (the D3 send gather) against the JAX
reference on the CPU: the engine gather exactly, +-inf, NaN and -1 lanes
included, with no layout on the port's side."""
import _torch_threads  # noqa: F401  (first: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backend as j_backend
from repro.kernels.csr_spmv import ops as j_ops
from repro.kernels.csr_spmv import ref as j_ref
from repro_torch.kernels import backend as t_backend
from repro_torch.kernels.csr_spmv import (edge_gather, edge_gather_cuda,
                                          edge_gather_ref)


def _edges(n_rows, E, seed, invalid=0.1):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_rows, E).astype(np.int32)
    src[rng.random(E) < invalid] = -1
    return src


@pytest.mark.parametrize("P,Np,Ep,V", [(4, 73, 400, 1), (4, 73, 400, 2),
                                       (2, 300, 2000, 3)])
def test_engine_gather_equals_reference_kernel_path(P, Np, Ep, V):
    """The port's edge_gather_values (plain on CPU) == the reference's
    kernel path (Pallas in interpret mode, class channel for the
    non-finite values), exactly."""
    rng = np.random.default_rng(P * Np + V)
    values = rng.normal(size=(P, Np, V)).astype(np.float32)
    pick = rng.random((P, Np, V))
    values[pick < 0.05] = np.inf
    values[(pick >= 0.05) & (pick < 0.1)] = -np.inf
    values[(pick >= 0.1) & (pick < 0.15)] = np.nan
    edge_src = rng.integers(0, Np, (P, Ep)).astype(np.int32)
    edge_src[rng.random((P, Ep)) < 0.1] = -1
    perm, tile_row = j_backend.plan_edge_layout(edge_src, Np)
    got = t_backend.edge_gather_values(
        torch.from_numpy(values), torch.from_numpy(edge_src)).numpy()
    want = j_backend.edge_gather_values(
        jnp.asarray(values), jnp.asarray(edge_src),
        (jnp.asarray(perm), jnp.asarray(tile_row)), impl_r="pallas")
    assert np.array_equal(got, np.asarray(want), equal_nan=True)
    assert (got[np.broadcast_to((edge_src < 0)[..., None],
                                got.shape)] == 0).all()


@pytest.mark.parametrize("V", [1, 2, 3])
@pytest.mark.parametrize("E", [1, 5, 1003])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_weighted_gather_equals_reference(V, E, order):
    """edge_gather(values, flat_src, edge_val), no layout, against the
    reference's csr_spmv gather: its plain jnp version exactly (+-inf and
    NaN included), and its Pallas kernel over its host layout (interpret
    mode) on finite values, E not a multiple of 4, sources sorted as the
    engine stores them or shuffled."""
    rng = np.random.default_rng(E * 10 + V)
    N = 97
    values = rng.normal(size=(N, V)).astype(np.float32)
    src = _edges(N, E, seed=E + V)
    if order == "sorted":
        src = np.sort(src)
    ev = rng.normal(size=E).astype(np.float32)
    got = edge_gather(torch.from_numpy(values), torch.from_numpy(src),
                      torch.from_numpy(ev)).numpy()
    layout = tuple(jnp.asarray(a) for a in j_ops.plan_layout_fixed(src, N))
    want = j_ops.edge_gather(jnp.asarray(values), jnp.asarray(src),
                             jnp.asarray(ev), layout=layout, impl="pallas")
    assert np.array_equal(got, np.asarray(want))
    pick = rng.random((N, V))
    values[pick < 0.1] = np.inf
    values[(pick >= 0.1) & (pick < 0.2)] = -np.inf
    values[(pick >= 0.2) & (pick < 0.3)] = np.nan
    got = edge_gather(torch.from_numpy(values), torch.from_numpy(src),
                      torch.from_numpy(ev)).numpy()
    want = j_ref.edge_gather_ref(jnp.asarray(values), jnp.asarray(src),
                                 jnp.asarray(ev))
    assert np.array_equal(got, np.asarray(want), equal_nan=True)
    assert (got[src < 0] == 0).all()


def test_plain_gather_scales_and_masks():
    values = torch.tensor([[1.0, -2.0], [float("inf"), float("nan")]])
    src = torch.tensor([1, -1, 0], dtype=torch.int32)
    ev = torch.tensor([1.0, 5.0, 3.0])
    out = edge_gather_ref(values, src, ev)
    assert out[0, 0] == float("inf") and torch.isnan(out[0, 1])
    assert torch.equal(out[1], torch.zeros(2))
    assert torch.equal(out[2], torch.tensor([3.0, -6.0]))
    torch.testing.assert_close(edge_gather(values, src, ev), out,
                               rtol=0, atol=0, equal_nan=True)


def test_raw_kernel_wrapper_refuses_cpu_tensors():
    values = torch.zeros((4, 1))
    src = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        edge_gather_cuda(values, src, None)


def test_wrapper_off_the_cpu_needs_the_layout():
    """The gather takes no layout any more: edge_gather(values, flat_src,
    edge_val) and edge_gather_values(values, edge_src) refuse one. Off
    the CPU the gather is the kernel; ``meta`` tensors hold no data and
    take the plain gather's shapes (the operator counter's probe)."""
    values = torch.zeros((4, 1), device="meta")
    src = torch.zeros(4, dtype=torch.int32, device="meta")
    layout = (torch.zeros(512, dtype=torch.int32),
              torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        edge_gather(values, src, None, layout)
    with pytest.raises(TypeError):
        t_backend.edge_gather_values(values[None], src[None], layout)
    out = edge_gather(values, src, None)
    assert out.device.type == "meta" and out.shape == (4, 1)
    out = t_backend.edge_gather_values(values[None], src[None])
    assert out.device.type == "meta" and out.shape == (1, 4, 1)
