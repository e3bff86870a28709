"""plan="auto" through the port's drivers against the JAX package's on
the CPU: the same initial plan, the same plan switches at the same
supersteps, the same superstep counts and statistics, and the same
results; with calibration, kernel pinning, checkpoints and recovery."""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro.graph as JG
import repro.planner as JP
import repro_torch.core as T
import repro_torch.graph as TG
import repro_torch.planner as TP
from repro_torch.runtime import faults

SIDE = 40
GRID = TG.grid_graph(SIDE)
N_GRID = SIDE * SIDE
N_RMAT = 600
RMAT = TG.rmat_graph(N_RMAT, 4800, seed=3)
_JAX = {}


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    yield
    faults.clear()


def _jax_auto(name):
    if name not in _JAX:
        if name == "sssp":
            vert = J.load_graph(GRID, N_GRID, 4, value_dims=1)
            prog = JG.SSSP(source=0)
        else:
            vert = J.load_graph(RMAT, N_RMAT, 4, value_dims=2)
            prog = JG.PageRank(N_RMAT, iterations=8)
        first, _ = JP.resolve_auto_plan(vert, prog, adaptive=False,
                                        machine=JP.EMULATED_MACHINE)
        _JAX[name] = (first, J.run_host(vert, prog, "auto",
                                        max_supersteps=100))
    return _JAX[name]


def _stat_keys(stats):
    keep = ("superstep", "event", "active", "messages", "recompiled",
            "frontier_density", "bytes_exchanged", "bucket_cap",
            "frontier_cap", "sources", "join", "groupby", "connector",
            "sender_combine", "storage")
    return [{k: s[k] for k in keep if k in s} for s in stats]


def _same_plan(t, j):
    """The port's plan equals the reference's in every field the port
    has: the reference's kernel_impl has no counterpart (the device
    picks the kernel)."""
    return t == T.PhysicalPlan.from_dict(dataclasses.asdict(j))


def test_auto_sssp_on_the_lattice_switches_as_the_reference():
    jfirst, jr = _jax_auto("sssp")
    vert = T.load_graph(GRID, N_GRID, 4, value_dims=1, device="cpu")
    prog = TG.SSSP(source=0)
    tfirst, _ = TP.resolve_auto_plan(vert, prog, adaptive=False,
                                     machine=TP.CPU_MACHINE)
    assert _same_plan(tfirst, jfirst)
    tr = T.run_host(vert, prog, "auto", max_supersteps=100)
    assert _same_plan(tr.initial_plan, jfirst)
    switches = [s for s in tr.stats if s.get("event") == "plan-switch"]
    assert switches and tr.plan.join == "left_outer"
    assert _stat_keys(tr.stats) == _stat_keys(jr.stats)
    assert tr.supersteps == jr.supersteps
    assert _same_plan(tr.plan, jr.plan)
    d = T.gather_values(tr.vertex, N_GRID)
    assert np.array_equal(d, np.asarray(J.gather_values(jr.vertex, N_GRID)))
    static = T.run_host(T.load_graph(GRID, N_GRID, 4, value_dims=1,
                                     device="cpu"), prog,
                        prog.suggested_plan, max_supersteps=100)
    assert np.array_equal(d, T.gather_values(static.vertex, N_GRID))
    assert static.supersteps == tr.supersteps


def test_auto_pagerank_picks_the_reference_plan():
    jfirst, jr = _jax_auto("pagerank")
    vert = T.load_graph(RMAT, N_RMAT, 4, value_dims=2, device="cpu")
    prog = TG.PageRank(N_RMAT, iterations=8)
    tfirst, _ = TP.resolve_auto_plan(vert, prog, adaptive=False,
                                     machine=TP.CPU_MACHINE)
    assert _same_plan(tfirst, jfirst)
    tr = T.run_host(vert, prog, "auto", max_supersteps=100)
    assert _same_plan(tr.initial_plan, jfirst)
    assert _stat_keys(tr.stats) == _stat_keys(jr.stats)
    assert _same_plan(tr.plan, jr.plan)
    np.testing.assert_allclose(T.gather_values(tr.vertex, N_RMAT),
                               np.asarray(J.gather_values(jr.vertex,
                                                          N_RMAT)),
                               rtol=1e-5, atol=1e-7)


def test_run_jit_auto_resolves_to_the_reference_plan():
    side = 16
    edges, n = TG.grid_graph(side), side * side
    jr = J.run_jit(J.load_graph(edges, n, 4, value_dims=1),
                   JG.SSSP(source=0), "auto", max_supersteps=40)
    tr = T.run_jit(T.load_graph(edges, n, 4, value_dims=1, device="cpu"),
                   TG.SSSP(source=0), "auto", max_supersteps=40)
    assert _same_plan(tr.plan, jr.plan)
    assert _same_plan(tr.initial_plan, jr.plan)
    assert tr.supersteps == jr.supersteps
    assert np.array_equal(T.gather_values(tr.vertex, n),
                          np.asarray(J.gather_values(jr.vertex, n)))


def test_unknown_plan_string_raises():
    vert = T.load_graph(TG.grid_graph(8), 64, 2, value_dims=1,
                        device="cpu")
    with pytest.raises(ValueError):
        T.run_host(vert, TG.SSSP(source=0), "fastest")
    with pytest.raises(ValueError):
        T.run_jit(vert, TG.SSSP(source=0), "fastest")


def test_auto_with_calibration_is_exact_against_static():
    """AdaptiveConfig(calibrate=True) refits the model first; with
    recalibrate_every the plan switch's shape change triggers a refit
    (a ``recalibrate`` event). Distances stay exact."""
    edges, n = GRID, N_GRID
    prog = TG.SSSP(source=0)
    static = T.run_host(T.load_graph(edges, n, 4, value_dims=1,
                                     device="cpu"), prog,
                        prog.suggested_plan, max_supersteps=100)
    auto = T.run_host(T.load_graph(edges, n, 4, value_dims=1, device="cpu"),
                      prog, "auto", max_supersteps=100,
                      auto_config=TP.AdaptiveConfig(calibrate=True,
                                                    recalibrate_every=2))
    assert np.array_equal(T.gather_values(auto.vertex, n),
                          T.gather_values(static.vertex, n))
    events = [s["event"] for s in auto.stats if "event" in s]
    assert "plan-switch" in events and "recalibrate" in events
    for s in auto.stats:
        if s.get("event") == "recalibrate":
            assert 0.5 <= s["k_compute"] <= 128.0
            assert 1.0 <= s["k_scatter"] <= 64.0
            assert 0.02 <= s["sort_pass_frac"] <= 4.0


def test_auto_space_restricts_the_search():
    vert = T.load_graph(GRID, N_GRID, 4, value_dims=1, device="cpu")
    res = T.run_host(vert, TG.SSSP(source=0), "auto", max_supersteps=100,
                     auto_space={"joins": ("full_outer",)})
    assert res.plan.join == "full_outer"
    assert not any(s.get("event") == "plan-switch" and
                   s["join"] != "full_outer" for s in res.stats)


def test_auto_recovers_and_resumes_like_a_fixed_plan(tmp_path):
    """recover=True with a one-shot worker failure after superstep 20
    (restore of the superstep-15 snapshot onto 3 partitions), and a
    resume from a snapshot, both under plan="auto": distances equal the
    uninterrupted auto run's."""
    from repro_torch.runtime.failure import WorkerFailure
    prog = TG.SSSP(source=0)
    load = lambda: T.load_graph(GRID, N_GRID, 4, value_dims=1,
                                device="cpu")
    full = T.run_host(load(), prog, "auto", max_supersteps=100)
    want = T.gather_values(full.vertex, N_GRID)
    fired = []

    def inject(i, v, m, g):
        if i == 20 and not fired:
            fired.append(i)
            raise WorkerFailure(1, "injected")

    rec = T.run_host(load(), prog, "auto", max_supersteps=100,
                     checkpoint_every=5, checkpoint_dir=str(tmp_path / "a"),
                     recover=True, failure_injector=inject)
    assert len(rec.recovery) == 1 and rec.vertex.num_partitions == 3
    assert np.array_equal(T.gather_values(rec.vertex, N_GRID), want)
    T.run_host(load(), prog, "auto", max_supersteps=30,
               checkpoint_every=10, checkpoint_dir=str(tmp_path / "b"))
    res = T.run_host(load(), prog, "auto", max_supersteps=100,
                     resume_from=str(tmp_path / "b" / "ckpt_000020.npz"))
    assert np.array_equal(T.gather_values(res.vertex, N_GRID), want)
    assert res.supersteps == full.supersteps
