"""The library programs of the port's slice 5 (BFS, k-core peeling), a
custom combine UDF and the random-walk sampler against the JAX
reference on the CPU. Each program runs end to end through ``run_host``
on both engines under every plan of join x group-by x connector x
sender combine, and every field must be equal: min/max folds are exact,
and every sum here is a sum of small integers. Reachability's matrix
lives in test_torch_algorithms_reach.py, so the two run on separate
workers.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from repro.graph.algorithms import KCore as JKCore
from repro.graph.generators import random_walk_sample as j_random_walk

# small enough that the left-outer frontier (Np + 8 = 48) stays under
# the refit floor, so neither engine recompiles a superstep mid-run
N = 120
EDGES = TG.rmat_graph(N, 700, seed=9)
SYM = np.concatenate([EDGES, EDGES[:, ::-1]])   # KCore needs both ways
K = 13                       # 21 of 120 vertices survive after 5 rounds
PLANS = [T.PhysicalPlan(join=j, groupby=g, connector=c, sender_combine=s)
         for j, g, c, s in itertools.product(
             ("full_outer", "left_outer"), ("scatter", "sort"),
             ("partitioning", "partitioning_merging"), (True, False))]
PLAN_IDS = ["-".join((p.join[:4], p.groupby, p.connector[13:] or "plain",
                      "sc" if p.sender_combine else "nosc")) for p in PLANS]


def run_both(prog_j, prog_t, plan, edges, vd, n=N, P=4, max_supersteps=40):
    jplan = J.PhysicalPlan(**dataclasses.asdict(plan))
    rj = J.run_host(J.load_graph(edges, n, P=P, value_dims=vd), prog_j,
                    jplan, max_supersteps=max_supersteps)
    rt = T.run_host(T.load_graph(edges, n, P, value_dims=vd, device="cpu"),
                    prog_t, plan, max_supersteps=max_supersteps)
    assert rt.supersteps == rj.supersteps
    for jrel, trel in ((rj.vertex, rt.vertex), (rj.gs, rt.gs)):
        for f in dataclasses.fields(trel):
            a, b = np.asarray(getattr(jrel, f.name)), \
                getattr(trel, f.name).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    ev = lambda r: [s["event"] for s in r.stats if "event" in s]
    assert ev(rt) == ev(rj)
    return rt


def kcore_oracle(edges, n, k):
    """Synchronous peeling to a fixed point: alive &= A @ alive >= k."""
    A = csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n))
    alive = np.ones(n, bool)
    while True:
        nxt = alive & (A @ alive.astype(np.float64) >= k)
        if np.array_equal(nxt, alive):
            return alive
        alive = nxt


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_bfs_equals_jax(plan):
    rt = run_both(JG.BFS(3), TG.BFS(3), plan, EDGES, 1)
    from scipy.sparse.csgraph import shortest_path
    A = csr_matrix((np.ones(len(EDGES)), (EDGES[:, 0], EDGES[:, 1])),
                   shape=(N, N))
    hops = shortest_path(A, unweighted=True, indices=3)
    lv = T.gather_values(rt.vertex, N)[:, 0]
    reached = np.isfinite(hops)
    assert np.array_equal(lv[reached], hops[reached].astype(np.float32))
    assert (lv[~reached] == np.float32(3.4e38)).all()


@pytest.mark.parametrize("plan", PLANS, ids=PLAN_IDS)
def test_kcore_equals_jax(plan):
    rt = run_both(JKCore(K), TG.KCore(K), plan, SYM, 2)
    alive = T.gather_values(rt.vertex, N)[:, 1] > 0
    want = kcore_oracle(SYM, N, K)
    assert 0 < want.sum() < N
    assert np.array_equal(alive, want)


# ------------------------------------------------------------- custom UDF

def _min_label(xp, base):
    """Label propagation that carries a witness: value = [label, the vid
    that sent it]; a message is (label, sender). The combine is a
    selection — keep the row with the smaller label, the earlier row on
    a tie — so it is exact however it is bracketed."""
    inf = float(np.float32(3.4e38))
    where = xp.where

    class MinLabel(base.VertexProgram):
        value_dims = 2
        msg_dims = 2
        agg_dims = 1
        combine_op = "custom"

        def combine_identity(self):
            return xp.full((2,), float("inf"), dtype=xp.float32)

        def combine(self, a, b):
            return where(a[..., 0:1] <= b[..., 0:1], a, b)

        def init_value(self, vid, out_degree, gs):
            lab = where(vid >= 0, vid, 0)
            lab = lab.astype(xp.float32) if xp is jnp else lab.float()
            return xp.stack([lab, lab], -1)

        def compute(self, vid, value, msg, has_msg, active, gs):
            cur = value[..., 0]
            inc = where(has_msg, msg[..., 0], inf)
            better = inc < cur
            new = xp.stack([where(better, inc, cur),
                            where(better, msg[..., 1], value[..., 1])], -1)
            send = better | (gs.superstep == 0)
            z = xp.zeros(vid.shape + (1,))
            return base.ComputeOut(value=new, halt=xp.ones_like(send),
                                   send_gate=send, aggregate=z)

        def send(self, src_vid, src_value, edge_val, dst_vid, gs):
            sv = src_vid.astype(xp.float32) if xp is jnp else \
                src_vid.float()
            return xp.stack([src_value[..., 0], sv], -1)

    return MinLabel()


CUSTOM_PLANS = [T.PhysicalPlan(join="full_outer", groupby="sort",
                               connector=c, sender_combine=s)
                for c, s in itertools.product(
                    ("partitioning", "partitioning_merging"), (True, False))]
CUSTOM_PLANS.append(T.PhysicalPlan(join="left_outer", groupby="sort",
                                   sender_combine=True))


@pytest.mark.parametrize("plan", CUSTOM_PLANS,
                         ids=lambda p: f"{p.join[:4]}-{p.connector}-"
                                       f"{p.sender_combine}")
def test_custom_combine_equals_jax(plan):
    rt = run_both(_min_label(jnp, J), _min_label(torch, T), plan, EDGES, 2)
    val = T.gather_values(rt.vertex, N)
    assert (val[:, 0] <= np.arange(N)).all()


def test_custom_combine_refuses_the_scatter_group_by():
    vert = T.load_graph(EDGES, N, 4, value_dims=2, device="cpu")
    with pytest.raises(ValueError):
        T.run_host(vert, _min_label(torch, T), T.PhysicalPlan())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_walk_sample_equals_jax(seed):
    got = TG.random_walk_sample(EDGES, N, 60, seed=seed)
    want = j_random_walk(EDGES, N, 60, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.max() < 60 and len(got) > 0
