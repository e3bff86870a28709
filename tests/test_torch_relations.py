"""The port's relations against the JAX reference on the CPU: load_graph
element for element (hash and range partitioning), out_degrees,
gather_values, and the state-transfer functions."""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.graph import rmat_graph

N = 220
EDGES = rmat_graph(N, 1200, seed=7)


@pytest.mark.parametrize("partition", ["hash", "range"])
@pytest.mark.parametrize("P,vd", [(4, 1), (3, 2)])
def test_load_graph_identical(partition, P, vd):
    ev = np.random.default_rng(P).random(len(EDGES)).astype(np.float32)
    for kw in ({}, {"edge_values": ev}):
        jv = J.load_graph(EDGES, N, P, value_dims=vd, partition=partition,
                          **kw)
        tv = T.load_graph(EDGES, N, P, value_dims=vd, partition=partition,
                          device="cpu", **kw)
        for f in dataclasses.fields(jv):
            a = np.asarray(getattr(jv, f.name))
            b = getattr(tv, f.name).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@pytest.mark.parametrize("partition", ["hash", "range"])
def test_out_degrees_and_gather_values(partition):
    jv = J.load_graph(EDGES, N, 4, value_dims=2, partition=partition)
    tv = T.load_graph(EDGES, N, 4, value_dims=2, partition=partition,
                      device="cpu")
    assert np.array_equal(T.out_degrees(tv).numpy(),
                          np.asarray(J.out_degrees(jv)))
    vals = np.random.default_rng(1).normal(
        size=tv.value.shape).astype(np.float32)
    jv = dataclasses.replace(jv, value=jnp.asarray(vals))
    tv = dataclasses.replace(tv, value=torch.from_numpy(vals))
    assert np.array_equal(T.gather_values(tv, N), J.gather_values(jv, N))


def test_state_round_trip_preserves_every_field():
    """JAX state -> numpy -> port -> numpy is the identity, dtypes kept."""
    jv = J.load_graph(EDGES, N, 4, value_dims=2)
    msg = J.empty_msgs(4, 64, 1)
    gs = J.init_gs(3)
    pairs = ((jv, T.vertex_from_numpy, T.vertex_to_numpy),
             (msg, T.msgs_from_numpy, T.msgs_to_numpy),
             (gs, T.gs_from_numpy, T.gs_to_numpy))
    for rel, to_t, to_np in pairs:
        arrays = {f.name: np.asarray(getattr(rel, f.name))
                  for f in dataclasses.fields(rel)}
        back = to_np(to_t(arrays, "cpu"))
        assert back.keys() == arrays.keys()
        for k in arrays:
            assert back[k].dtype == arrays[k].dtype, k
            assert back[k].shape == arrays[k].shape, k
            assert np.array_equal(back[k], arrays[k]), k


def test_state_transfer_refuses_missing_fields_and_wrong_dtypes():
    arrays = T.gs_to_numpy(T.init_gs(1, "cpu"))
    with pytest.raises(KeyError):
        T.gs_from_numpy({k: v for k, v in arrays.items() if k != "halt"},
                        "cpu")
    with pytest.raises(TypeError):
        T.gs_from_numpy({**arrays, "superstep": np.int64(0)}, "cpu")


def test_fresh_state_matches_reference():
    for a, b in ((J.init_gs(2), T.init_gs(2, "cpu")),
                 (J.empty_msgs(4, 24, 2), T.empty_msgs(4, 24, 2, "cpu"))):
        for f in dataclasses.fields(a):
            x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name).numpy()
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
