"""The port's out-of-core executor modes and mutations on the CPU.

The synchronous loop, the streaming pipeline and the barrier-free
pipeline must agree bit for bit (values, superstep count, the float
aggregate), as the reference's do (tests/test_ooc.py,
tests/test_pipeline.py); so must regrows landing mid-pipeline and while
the rolling frontier spans two generations. Mutations travel through the
host mutation inbox: inserts across super-partitions, resurrection in a
later super-partition (which must mint the GLOBAL vid: the ``part0``
offset), delete-only programs, and mutations proposed on the last
superstep. ``plan="auto"`` makes the reference's initial plan and
switches, storage included. On the CPU torch runs synchronously, so
these tests check parity, not overlap.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from repro.core.ooc import run_out_of_core as j_ooc
from repro_torch.core.ooc import run_out_of_core
from tests.test_torch_mutations import _cross_insert, _lazarus

N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
ALGOS = {
    "pagerank": (lambda: TG.PageRank(N, iterations=6), 2),
    "sssp": (lambda: TG.SSSP(source=3), 1),
    "cc": (lambda: TG.ConnectedComponents(), 1),
}
CrossInsert = _cross_insert(torch, T)
Lazarus = _lazarus(torch, T)


def _vert(vd, edges=EDGES, n=N, P=4):
    return T.load_graph(edges, n, P, value_dims=vd, device="cpu")


def _run(algo, **kw):
    mk, vd = ALGOS[algo]
    kw.setdefault("max_supersteps", 30)
    return run_out_of_core(_vert(vd), mk(), mk().suggested_plan,
                           device="cpu", **kw)


def _same(a, b):
    assert np.array_equal(T.gather_values(a.vertex, N),
                          T.gather_values(b.vertex, N))
    assert a.supersteps == b.supersteps
    assert np.array_equal(a.gs.aggregate.numpy(), b.gs.aggregate.numpy())


@pytest.mark.parametrize("algo", list(ALGOS))
def test_sync_stream_and_barrier_free_are_bit_equal(algo):
    sync = _run(algo, budget_partitions=1, stream=False)
    for bf in (False, True):
        res = _run(algo, budget_partitions=1, stream=True,
                   barrier_free=bf, prefetch_depth=3)
        _same(res, sync)
    recs = [s for s in res.stats if "wall_s" in s]
    assert recs and all(s["barrier_free"] and s["streaming"]
                        for s in recs)
    assert all(s["super_partitions"] == 4 for s in recs)
    for f in ("readiness_stall_s", "dispatch_s", "collect_wait_s",
              "commit_s"):
        assert all(s[f] >= 0.0 for s in recs)
    assert not any(s["streaming"] for s in sync.stats if "wall_s" in s)


def test_regrow_while_rolling_frontier_spans_supersteps():
    """A bucket overflow while later destinations of the in-flight
    generation are still unprepared (window 2 < 4 super-partitions): the
    deferred regrow pads the committed blocks, redoes, and stays bit
    equal to the synchronous run."""
    ec = T.EngineConfig(n_parts=4, bucket_cap=2, frontier_cap=0)
    outs = {}
    for bf in (False, True):
        res = _run("sssp", budget_partitions=1, ec=ec, stream=True,
                   barrier_free=bf, prefetch_depth=2)
        regrows = [s for s in res.stats if s.get("event") == "regrow"]
        assert regrows and regrows[-1]["bucket_cap"] > 2
        outs[bf] = res
    _same(outs[True], outs[False])
    _same(outs[True], _run("sssp", budget_partitions=1, stream=False))


# ------------------------------------------------------------ mutations

@pytest.mark.parametrize("mode", ["sync", "stream", "barrier_free"])
def test_cross_super_partition_inserts_equal_reference(mode):
    """Every vertex inserts (vid + 3) % n at superstep 0: under hash
    partitioning always another partition, often another
    super-partition. Integer payloads, so the sums are exact: equal to
    the JAX package's out-of-core run and to run_host."""
    kw = dict(sync=dict(stream=False), stream=dict(barrier_free=False),
              barrier_free=dict(barrier_free=True))[mode]
    res = run_out_of_core(_vert(1), CrossInsert(N, 3),
                          CrossInsert.suggested_plan, budget_partitions=2,
                          max_supersteps=5, device="cpu", **kw)
    host = T.run_host(_vert(1), CrossInsert(N, 3),
                      CrossInsert.suggested_plan, max_supersteps=5)
    got = T.gather_values(res.vertex, N)
    assert np.array_equal(got, T.gather_values(host.vertex, N))
    assert not np.array_equal(got[:, 0], np.arange(N, dtype=np.float32))
    recs = [s for s in res.stats if "mutation_rate" in s]
    assert recs and recs[0]["mutation_rate"] > 0
    if mode == "barrier_free":
        JCross = _cross_insert(jnp, J)
        jres = j_ooc(J.load_graph(EDGES, N, P=4, value_dims=1),
                     JCross(N, 3), JCross.suggested_plan,
                     budget_partitions=2, max_supersteps=5)
        assert np.array_equal(got, J.gather_values(jres.vertex, N))
        assert np.array_equal(res.vertex.vid.numpy(),
                              np.asarray(jres.vertex.vid))


def test_mutations_applied_at_max_supersteps_cutoff():
    """Stop on the superstep that PROPOSES the inserts: the exit path
    applies them, as run_host's in-step apply does."""
    host = T.run_host(_vert(1), CrossInsert(N, 3),
                      CrossInsert.suggested_plan, max_supersteps=1)
    res = run_out_of_core(_vert(1), CrossInsert(N, 3),
                          CrossInsert.suggested_plan, budget_partitions=2,
                          max_supersteps=1, device="cpu")
    assert np.array_equal(T.gather_values(res.vertex, N),
                          T.gather_values(host.vertex, N))


@pytest.mark.parametrize("partition", ["hash", "range"])
@pytest.mark.parametrize("stream", [False, True])
def test_resurrect_in_later_super_partition_gets_global_vid(stream,
                                                            partition):
    """Odd vids are deleted, then messaged back to life: those in the
    second super-partition (partition 1 of 2: every odd vid under hash,
    vids 9.. under range) must come back with their GLOBAL vid — the
    block's partitions are part0.., not 0.. — under both vid formulas."""
    n = 16
    edges = TG.chain_graph(n)
    prog = Lazarus()
    plan = T.PhysicalPlan(join="full_outer", groupby="scatter",
                          partition=partition)

    def vert():
        return T.load_graph(edges, n, 2, value_dims=1,
                            partition=partition, device="cpu")

    host = T.run_host(vert(), prog, plan, max_supersteps=6)
    res = run_out_of_core(vert(), prog, plan, budget_partitions=1,
                          max_supersteps=6, stream=stream, device="cpu")
    assert np.array_equal(res.vertex.vid.numpy(), host.vertex.vid.numpy())
    vals = T.gather_values(res.vertex, n)[:, 0]
    assert np.array_equal(vals, T.gather_values(host.vertex, n)[:, 0])
    assert vals[3] == 2 + 100 and vals[11] == 10 + 100
    back = set(res.vertex.vid.numpy()[1].tolist()) - {-1}
    assert {11, 13, 15} <= back


def test_delete_only_mutations_match_in_memory():
    n = 32
    edges = TG.chain_graph(n)
    pm = TG.PathMerge(rounds=10)
    host = T.run_host(_vert(2, edges, n, P=2), pm, pm.suggested_plan,
                      max_supersteps=12)
    res = run_out_of_core(_vert(2, edges, n, P=2), pm, pm.suggested_plan,
                          budget_partitions=1, max_supersteps=12,
                          device="cpu")
    assert np.array_equal(T.gather_values(res.vertex, n),
                          T.gather_values(host.vertex, n))
    assert np.array_equal(res.vertex.vid.numpy(), host.vertex.vid.numpy())


# ------------------------------------------------------------ plan="auto"

def _switches(res):
    return [(s["superstep"], s["join"], s["groupby"], s["connector"],
             s["sender_combine"], s["storage"])
            for s in res.stats if s.get("event") == "plan-switch"]


def test_auto_plan_switches_like_the_reference():
    """SSSP on the 40 x 40 lattice, synchronous (the storage dimension
    prices write-backs additively only without overlap): the port picks
    the reference's initial plan and makes its switches at the same
    supersteps — onto left-outer with storage='delta' — and lands on
    the static run's distances."""
    side = 40
    n = side * side
    edges = TG.grid_graph(side)
    jres = j_ooc(J.load_graph(edges, n, P=4, value_dims=1),
                 JG.SSSP(source=0), "auto", budget_partitions=2,
                 max_supersteps=100, stream=False)
    res = run_out_of_core(_vert(1, edges, n), TG.SSSP(source=0), "auto",
                          budget_partitions=2, max_supersteps=100,
                          stream=False, device="cpu")
    assert _switches(res) == _switches(jres) and _switches(res)
    assert res.plan.storage == "delta" and res.plan.join == "left_outer"
    from repro.core.driver import _resolve_plan as j_resolve
    jplan0, _ = j_resolve(J.load_graph(edges, n, P=4, value_dims=1),
                          JG.SSSP(source=0), "auto", adaptive=False,
                          auto_space={"storages": J.STORAGES})
    fields = ("join", "groupby", "connector", "sender_combine", "storage")
    assert [getattr(res.initial_plan, f) for f in fields] == \
        [getattr(jplan0, f) for f in fields]
    assert res.supersteps == jres.supersteps
    assert np.array_equal(T.gather_values(res.vertex, n),
                          J.gather_values(jres.vertex, n))
    static = T.run_host(_vert(1, edges, n), TG.SSSP(source=0),
                        TG.SSSP.suggested_plan, max_supersteps=100)
    assert np.array_equal(T.gather_values(res.vertex, n),
                          T.gather_values(static.vertex, n))
    recs = [s for s in res.stats if "change_density" in s]
    assert recs and all(s["ooc"] and not s["streaming"] for s in recs)


def test_switch_to_merging_sorts_unsorted_inbox_runs(monkeypatch):
    """A switch forced at superstep 2 from (partitioning, no sender
    combine) onto the merging connector, whose receiver reads dst-sorted
    runs: the run records the switch and PageRank's ranks survive it, as
    the reference's tests/test_ooc.py checks (the port's sum receiver
    tolerates unsorted runs, so the sort itself is held to the
    reference by test_host_helpers_match_reference)."""
    from repro_torch.planner.adaptive import AdaptiveController

    def force_merging(self, rec, *, bucket_cap=0):
        if rec.superstep == 2:
            self.plan = T.PhysicalPlan(**{
                **self.plan.__dict__, "connector": "partitioning_merging"})
            return self.plan
        return None

    monkeypatch.setattr(AdaptiveController, "observe", force_merging)
    prog = TG.PageRank(N, iterations=6)
    res = run_out_of_core(
        _vert(2), prog, "auto", budget_partitions=2, max_supersteps=10,
        auto_space={"connectors": ("partitioning",),
                    "sender_combines": (False,), "storages": ("inplace",)},
        device="cpu")
    assert res.plan.connector == "partitioning_merging"
    assert [s[0] for s in _switches(res)] == [2]
    host = T.run_host(_vert(2), prog, prog.suggested_plan,
                      max_supersteps=10)
    np.testing.assert_allclose(T.gather_values(res.vertex, N),
                               T.gather_values(host.vertex, N),
                               rtol=1e-5, atol=1e-7)


def test_auto_space_with_merging_connector():
    prog = TG.PageRank(N, iterations=6)
    res = run_out_of_core(
        _vert(2), prog, "auto", budget_partitions=2, max_supersteps=10,
        auto_space={"connectors": ("partitioning_merging",),
                    "storages": ("inplace", "delta")}, device="cpu")
    assert res.plan.connector == "partitioning_merging"
    assert not _switches(res)
    host = T.run_host(_vert(2), prog, res.plan, max_supersteps=10)
    assert np.array_equal(T.gather_values(res.vertex, N),
                          T.gather_values(host.vertex, N))
