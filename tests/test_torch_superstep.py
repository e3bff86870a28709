"""One superstep of the PyTorch port against the JAX reference from the
same state (vertex, message and global relations), across join x
group-by x connector x sender_combine x partition, on the CPU. This file
holds the PageRank matrix and the shared helpers; the SSSP and CC
matrices import them (test_torch_superstep_sssp.py, _cc.py), so that the
three run on separate workers.

Integer and bool fields must match exactly, and so must the values of
min programs. PageRank values and aggregates may differ by rounding
(rtol 1e-5, atol 1e-7): the port's scatter-add and segmented fold order
float sums differently from XLA's scatter and ``associative_scan``.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from repro.core.superstep import make_superstep as j_make_superstep
from repro.kernels import backend as j_backend
from repro_torch.core.driver import prepare_run
from repro_torch.core.superstep import make_superstep as t_make_superstep

N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
ALGOS = {
    "pagerank": (lambda: JG.PageRank(N, iterations=6),
                 lambda: TG.PageRank(N, iterations=6), 2),
    "sssp": (lambda: JG.SSSP(source=3), lambda: TG.SSSP(source=3), 1),
    "cc": (JG.ConnectedComponents, TG.ConnectedComponents, 1),
}
PLANS = list(itertools.product(
    ("full_outer", "left_outer"), ("scatter", "sort"),
    ("partitioning", "partitioning_merging"), (True, False),
    ("hash", "range")))


def _np(tree) -> dict:
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _j_layout(jplan, jvert):
    if not j_backend.wants_edge_layout(jplan):
        return None
    perm, tile_row = j_backend.plan_edge_layout(np.asarray(jvert.edge_src),
                                                jvert.capacity)
    return jax.numpy.asarray(perm), jax.numpy.asarray(tile_row)


def _compare(jstate, tstate, algo):
    exact_float = algo != "pagerank"
    for name, jrel, trel in zip(("vertex", "msg", "gs"), jstate, tstate):
        to_np = {"vertex": T.vertex_to_numpy, "msg": T.msgs_to_numpy,
                 "gs": T.gs_to_numpy}[name]
        a, b = _np(jrel), to_np(trel)
        for k in a:
            assert a[k].shape == b[k].shape, (name, k)
            assert a[k].dtype == b[k].dtype, (name, k)
            if a[k].dtype.kind == "f" and not exact_float:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"{name}.{k}")
            else:
                assert np.array_equal(a[k], b[k]), f"{name}.{k}"


def _run_pair(algo, plan_t, *, impl_j="ref", bucket_cap=None, steps=2):
    mk_j, mk_t, vd = ALGOS[algo]
    prog_j, prog_t = mk_j(), mk_t()
    plan_j = J.PhysicalPlan(**{**dataclasses.asdict(plan_t),
                               "kernel_impl": impl_j})
    jvert = J.load_graph(EDGES, N, 4, value_dims=vd,
                         partition=plan_t.partition)
    ec_j = J.default_engine_config(jvert, prog_j, plan_j)
    if bucket_cap is not None:
        ec_j = dataclasses.replace(ec_j, bucket_cap=bucket_cap)
    ec_t = T.EngineConfig(n_parts=ec_j.n_parts, bucket_cap=ec_j.bucket_cap,
                          frontier_cap=ec_j.frontier_cap)
    from repro.core.driver import init_vertex_values
    gs = J.init_gs(prog_j.agg_dims)
    jvert = init_vertex_values(jvert, prog_j, gs)
    msg = J.empty_msgs(4, ec_j.n_parts * ec_j.bucket_cap, prog_j.msg_dims)
    jstep = jax.jit(j_make_superstep(prog_j, plan_j, ec_j))
    tstep = t_make_superstep(prog_t, plan_t, ec_t)
    jlayout = _j_layout(plan_j, jvert)
    state = (jvert, msg, gs)
    for _ in range(steps):
        tin = (T.vertex_from_numpy(_np(state[0]), "cpu"),
               T.msgs_from_numpy(_np(state[1]), "cpu"),
               T.gs_from_numpy(_np(state[2]), "cpu"))
        jout = jstep(state[0], state[1], state[2], None, jlayout)
        tout = tstep(*tin)
        _compare(jout, tout, algo)
        state = jout
    return state


def _check_plan(algo, join, groupby, connector, sender_combine,
                partition):
    """Two supersteps from the initial state: the first sends on every
    edge, the second consumes a full inbox."""
    plan = T.PhysicalPlan(join=join, groupby=groupby, connector=connector,
                          sender_combine=sender_combine, partition=partition)
    _run_pair(algo, plan)


@pytest.mark.parametrize("join,groupby,connector,sender_combine,partition",
                         PLANS)
def test_superstep_matches_reference(join, groupby, connector,
                                     sender_combine, partition):
    _check_plan("pagerank", join, groupby, connector, sender_combine,
                partition)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_fused_pack_with_overflow_matches_kernel_path(algo):
    """A small bucket capacity turns the fused combine -> pack on
    (n_parts * bucket_cap < edge slots) and overflows: the port's state,
    overflow counters included, equals the JAX kernel path's (Pallas in
    interpret mode), which runs the same fused leg."""
    plan = TG.PageRank.suggested_plan if algo == "pagerank" else \
        T.PhysicalPlan(join="full_outer", sender_combine=True)
    jgs = _run_pair(algo, plan, impl_j="pallas", bucket_cap=12)[2]
    assert int(np.asarray(jgs.overflow)[J.OVF_BUCKET]) > 0


def test_superstep_refuses_what_later_slices_bring():
    """ooc_collect (the out-of-core slice) builds and hands back the (P,
    n_parts, C) buckets, their occupancy counts and no mutation buckets;
    exchange_apart (the sharded driver) hands back the same buckets as
    its message output; a shard axis outside a process group raises."""
    prog = TG.SSSP(source=0)
    ec = T.EngineConfig(n_parts=4, bucket_cap=8)
    step = t_make_superstep(prog, T.PhysicalPlan(),
                            dataclasses.replace(ec, ooc_collect=True))
    vert = T.load_graph(EDGES, N, 4, value_dims=1, device="cpu")
    _, vert, msg, gs = prepare_run(vert, prog, T.PhysicalPlan(), ec)
    v2, buckets, g2, counts, mut = step(vert, msg, gs)
    assert buckets.dst.shape == (4, 4, 8) and counts.shape == (4, 4)
    assert torch.equal(counts, buckets.valid.sum(2, dtype=torch.int32))
    assert mut is None and int(g2.msg_count) == int(counts.sum())
    apart = t_make_superstep(prog, T.PhysicalPlan(),
                             dataclasses.replace(ec, exchange_apart=True))
    v3, b3, g3 = apart(vert, msg, gs)
    for f in ("dst", "payload", "valid"):
        assert torch.equal(getattr(b3, f), getattr(buckets, f))
    assert int(g3.msg_count) == int(g2.msg_count)
    from repro_torch.core.connector import ShardAxis
    sharded = t_make_superstep(
        prog, T.PhysicalPlan(),
        dataclasses.replace(ec, axis_name=ShardAxis(0, 1)))
    with pytest.raises(ValueError, match="process group"):
        sharded(vert, msg, gs)


@pytest.mark.parametrize("plan", [
    T.PhysicalPlan(join="full_outer", groupby="scatter"),
    T.PhysicalPlan(join="full_outer", groupby="sort"),
    T.PhysicalPlan(connector="partitioning_merging"),
    T.PhysicalPlan(join="left_outer")],
    ids=["scatter", "sort", "merging", "left_outer"])
def test_superstep_device_picks_the_kernel(plan):
    """The device of the tensors alone picks the implementation: on CPU
    tensors ``run_host`` runs every stage's plain version and launches
    none of the four graph kernels."""
    from repro_torch.kernels import (csr_spmv, scatter_combine,
                                     segment_combine, sort_fold_dense)
    counters = [m.counter for m in (csr_spmv, segment_combine,
                                    scatter_combine, sort_fold_dense)]
    before = [c.launches for c in counters]
    prog = TG.SSSP(source=0)
    vert = T.load_graph(EDGES, N, 4, value_dims=1, device="cpu")
    res = T.run_host(vert, prog, plan, max_supersteps=2)
    assert res.supersteps == 2 and res.plan == plan
    assert res.vertex.value.device.type == "cpu"
    assert [c.launches for c in counters] == before
