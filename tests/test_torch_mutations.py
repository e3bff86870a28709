"""Graph mutations of the port (paper Figure 5, dataflow D6, and the
Genomix use case) against the JAX reference on the CPU: deletion with
tombstones, inserts routed at ``mutation_cap`` and resolved, resurrection
of a messaged dead vertex, and own-edge rewrites. Every payload is
integer-valued, so float sums are exact and every field must be equal.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from repro.core.superstep import make_superstep as j_make_superstep
from repro_torch.core.superstep import make_superstep as t_make_superstep

N = 60
EDGES = TG.rmat_graph(N, 300, seed=11)


def _assert_same(jrel, trel):
    for f in dataclasses.fields(trel):
        a = np.asarray(getattr(jrel, f.name))
        b = getattr(trel, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a, b, equal_nan=True), f.name


# ------------------------------------------------------------- programs

def _cross_insert(xp, base):
    """CrossInsert (tests/test_storage.py) for either package: at
    superstep 0 every vertex proposes (vid + shift) % n with value
    vid + 1000."""
    where = xp.where

    class CrossInsert(base.VertexProgram):
        value_dims = 1
        msg_dims = 1
        agg_dims = 1
        combine_op = "sum"
        mutates = True
        suggested_plan = base.PhysicalPlan(join="full_outer",
                                           groupby="scatter")

        def __init__(self, n, shift=3):
            self.n, self.shift = n, shift

        def init_value(self, vid, out_degree, gs):
            return where(vid >= 0, vid, 0).astype(xp.float32)[..., None] \
                if xp is jnp else where(vid >= 0, vid, 0).float()[..., None]

        def compute(self, vid, value, msg, has_msg, active, gs):
            first = gs.superstep == 0
            tgt = where(first & (vid >= 0), (vid + self.shift) % self.n, -1)
            ins = where(vid >= 0, vid, 0)
            ins = (ins.astype(xp.float32) if xp is jnp else ins.float())
            halt = (gs.superstep >= 1) | ~first
            z = xp.zeros(vid.shape + (1,))
            return base.ComputeOut(
                value=value, halt=(xp.broadcast_to(halt, vid.shape)
                                   if xp is jnp else halt.expand(vid.shape)),
                send_gate=xp.zeros(vid.shape, dtype=bool),
                aggregate=z, insert_vid=tgt,
                insert_value=ins[..., None] + 1000.0)

        def send(self, src_vid, src_value, edge_val, dst_vid, gs):
            return xp.zeros_like(src_value[..., 0:1])

    return CrossInsert


def _lazarus(xp, base):
    """Lazarus (tests/test_storage.py): deletes every odd vertex at
    superstep 0, then messages the dead, which re-creates them."""
    where = xp.where

    class Lazarus(base.VertexProgram):
        value_dims = 1
        msg_dims = 1
        agg_dims = 1
        combine_op = "sum"
        mutates = True

        def compute(self, vid, value, msg, has_msg, active, gs):
            new_val = where(has_msg, msg[..., 0], value[..., 0])
            halt = gs.superstep >= 2
            return base.ComputeOut(
                value=new_val[..., None],
                halt=(xp.broadcast_to(halt, vid.shape) if xp is jnp
                      else halt.expand(vid.shape)),
                send_gate=(gs.superstep == 1) & (vid % 2 == 0) & (vid >= 0),
                aggregate=xp.zeros(vid.shape + (1,)),
                delete_self=(gs.superstep == 0) & (vid % 2 == 1))

        def send(self, src_vid, src_value, edge_val, dst_vid, gs):
            return (src_vid + 100.0)[..., None]

    return Lazarus


def _rewire(xp, base, edge_dst_np):
    """Rewrites its own edges at superstep 0 from the loaded (P, Ep)
    destinations: dst % 3 == 0 moves to dst + 1, dst % 3 == 1 deletes
    the edge (-1), the rest keep (-2); even destinations get weight
    dst + 5, odd ones keep theirs (NaN). Every superstep each vertex
    sends its edges' weights, summed on arrival."""
    e = xp.asarray(edge_dst_np) if xp is jnp else torch.from_numpy(
        np.array(edge_dst_np))
    where = xp.where
    n_max = int(edge_dst_np.max()) + 1

    class Rewire(base.VertexProgram):
        value_dims = 1
        msg_dims = 1
        agg_dims = 1
        combine_op = "sum"

        def compute(self, vid, value, msg, has_msg, active, gs):
            first = gs.superstep == 0
            nd = where(e % 3 == 0, (e + 1) % n_max, where(e % 3 == 1, -1,
                                                            -2))
            nd = where(first, nd, -2)
            nv = where(first & (e % 2 == 0), e + 5.0, float("nan"))
            acc = value[..., 0] + where(has_msg, msg[..., 0], 0.0)
            halt = gs.superstep >= 3
            return base.ComputeOut(
                value=acc[..., None],
                halt=(xp.broadcast_to(halt, vid.shape) if xp is jnp
                      else halt.expand(vid.shape)),
                send_gate=~halt & (vid >= 0) if xp is jnp else
                (~halt).expand(vid.shape) & (vid >= 0),
                aggregate=xp.zeros(vid.shape + (1,)),
                new_edge_dst=(nd.astype(xp.int32) if xp is jnp
                              else nd.to(torch.int32)),
                new_edge_val=(nv.astype(xp.float32) if xp is jnp
                              else nv.float()))

        def send(self, src_vid, src_value, edge_val, dst_vid, gs):
            return edge_val[..., None]

    return Rewire


# ------------------------------------------------------------- the mirror
# of tests/test_mutations.py

def test_path_merge_compacts_chain():
    n = 32
    pm = TG.PathMerge(rounds=10)
    vert = T.load_graph(TG.chain_graph(n), n, 2, value_dims=2, device="cpu")
    res = T.run_host(vert, pm, pm.suggested_plan, max_supersteps=12)
    vid = res.vertex.vid.reshape(-1).numpy()
    assert (vid >= 0).sum() < n
    acc = res.vertex.value.reshape(-1, 2).numpy()[vid >= 0, 0]
    assert acc.astype(np.float64).sum() == n


def test_delete_tombstones_do_not_resurrect():
    n = 16
    pm = TG.PathMerge(rounds=6)
    vert = T.load_graph(TG.chain_graph(n), n, 2, value_dims=2, device="cpu")
    res = T.run_host(vert, pm, pm.suggested_plan, max_supersteps=8)
    vid, halt = res.vertex.vid.numpy(), res.vertex.halt.numpy()
    assert (vid < 0).any() and halt[vid < 0].all()


# ------------------------------------------------------------- vs JAX

@pytest.mark.parametrize("n,P", [(32, 2), (101, 4)])
def test_path_merge_equals_jax(n, P):
    edges = TG.chain_graph(n)
    jp, tp = JG.PathMerge(rounds=10), TG.PathMerge(rounds=10)
    rj = J.run_host(J.load_graph(edges, n, P=P, value_dims=2), jp,
                    jp.suggested_plan, max_supersteps=12)
    rt = T.run_host(T.load_graph(edges, n, P, value_dims=2, device="cpu"),
                    tp, tp.suggested_plan, max_supersteps=12)
    assert rt.supersteps == rj.supersteps
    _assert_same(rj.vertex, rt.vertex)
    _assert_same(rj.gs, rt.gs)


def _step_pair(mk, plan, partition="hash", steps=1, edges=EDGES, n=N, P=4,
               **ec_kw):
    """``steps`` supersteps of both engines from the same loaded state,
    with fixed capacities (no regrow), compared field for field after
    each."""
    prog_j, prog_t = mk(jnp, J), mk(torch, T)
    jplan = J.PhysicalPlan(**{**dataclasses.asdict(plan),
                              "partition": partition})
    tplan = dataclasses.replace(plan, partition=partition)
    jv = J.load_graph(edges, n, P=P, value_dims=1, partition=partition)
    ec_j = dataclasses.replace(J.default_engine_config(jv, prog_j, jplan),
                               **ec_kw)
    ec_t = T.EngineConfig(n_parts=ec_j.n_parts, bucket_cap=ec_j.bucket_cap,
                          mutation_cap=ec_j.mutation_cap,
                          frontier_cap=ec_j.frontier_cap)
    gs = J.init_gs(1)
    jv = J.driver.init_vertex_values(jv, prog_j, gs)
    jm = J.empty_msgs(P, ec_j.n_parts * ec_j.bucket_cap, 1)
    tv = T.vertex_from_numpy({f.name: np.asarray(getattr(jv, f.name))
                              for f in dataclasses.fields(jv)}, "cpu")
    tm = T.msgs_from_numpy({f.name: np.asarray(getattr(jm, f.name))
                            for f in dataclasses.fields(jm)}, "cpu")
    tg = T.gs_from_numpy({f.name: np.asarray(getattr(gs, f.name))
                          for f in dataclasses.fields(gs)}, "cpu")
    js = jax.jit(j_make_superstep(prog_j, jplan, ec_j))
    ts = t_make_superstep(prog_t, tplan, ec_t)
    jstate, tstate = (jv, jm, gs), (tv, tm, tg)
    for _ in range(steps):
        jstate, tstate = js(*jstate), ts(*tstate)
        for a, b in zip(jstate, tstate):
            _assert_same(a, b)
    return jstate, tstate


def test_cross_insert_overflow_equals_jax():
    """Insert proposals at a mutation_cap too small for them: the same
    proposals are dropped, and the overflow vectors are equal."""
    plan = T.PhysicalPlan(join="full_outer", groupby="scatter")
    jstate, _ = _step_pair(lambda xp, b: _cross_insert(xp, b)(N), plan,
                           mutation_cap=2)
    assert int(np.asarray(jstate[2].overflow)[J.OVF_MUTATION]) > 0


@pytest.mark.parametrize("P", [2, 4])
def test_cross_insert_regrows_and_equals_jax(P):
    jp, tp = _cross_insert(jnp, J)(N), _cross_insert(torch, T)(N)
    jv = J.load_graph(EDGES, N, P=P, value_dims=1)
    tv = T.load_graph(EDGES, N, P, value_dims=1, device="cpu")
    ec_j = dataclasses.replace(
        J.default_engine_config(jv, jp, jp.suggested_plan), mutation_cap=2)
    ec_t = dataclasses.replace(
        T.default_engine_config(tv, tp, tp.suggested_plan), mutation_cap=2)
    rj = J.run_host(jv, jp, jp.suggested_plan, ec=ec_j, max_supersteps=5)
    rt = T.run_host(tv, tp, tp.suggested_plan, ec=ec_t, max_supersteps=5)
    ev = lambda r: [(s["superstep"], s["mutation_cap"], s["sources"])
                    for s in r.stats if s.get("event") == "regrow"]
    assert ev(rt) == ev(rj) and ev(rt)
    _assert_same(rj.vertex, rt.vertex)
    _assert_same(rj.gs, rt.gs)
    vals = T.gather_values(rt.vertex, N)[:, 0]
    assert np.array_equal(vals, (np.arange(N) - 3) % N + 1000.0)


@pytest.mark.parametrize("partition", ["hash", "range"])
def test_lazarus_resurrects_like_jax(partition):
    n = 16
    plan = T.PhysicalPlan(join="full_outer", groupby="scatter")
    _, tstate = _step_pair(lambda xp, b: _lazarus(xp, b)(), plan,
                           partition, steps=3,
                           edges=TG.chain_graph(n), n=n, P=2)
    vals = T.gather_values(tstate[0], n)[:, 0]
    assert vals[3] == 2 + 100 and vals[7] == 6 + 100
    assert (tstate[0].vid >= 0).sum() == n


@pytest.mark.parametrize("groupby", ["scatter", "sort"])
def test_edge_rewrites_equal_jax(groupby):
    jv = J.load_graph(EDGES, N, P=4, value_dims=1)
    e = np.asarray(jv.edge_dst)
    plan = T.PhysicalPlan(join="full_outer", groupby=groupby)
    jstate, _ = _step_pair(lambda xp, b: _rewire(xp, b, e)(), plan,
                           steps=3)
    # the rewrites took: some edges moved or were cut, some weights set
    ed = np.asarray(jstate[0].edge_dst)
    assert not np.array_equal(ed, e) and (ed[e >= 0] == -1).any()
