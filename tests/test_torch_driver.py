"""End-to-end runs of the PyTorch port against the JAX reference on the
CPU: run_host over PageRank/SSSP/CC x full_outer|left_outer x both
connectors, run_jit for the suggested plans, and a forced capacity
regrow.

Superstep counts, vids, halt flags, overflow counters, the statistics'
active/messages sequences and events, and SSSP/CC values must match
exactly; PageRank values to rtol 1e-5, atol 1e-7 (float sums are ordered
differently).
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG

N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
ALGOS = {
    "pagerank": (lambda: JG.PageRank(N, iterations=6),
                 lambda: TG.PageRank(N, iterations=6), 2),
    "sssp": (lambda: JG.SSSP(source=3), lambda: TG.SSSP(source=3), 1),
    "cc": (JG.ConnectedComponents, TG.ConnectedComponents, 1),
}
_JAX = {}     # (driver, algo, join, connector, bucket_cap) -> result


def _plans(algo, join=None, connector=None):
    mk_j, mk_t, _ = ALGOS[algo]
    kw = {k: v for k, v in (("join", join), ("connector", connector))
          if v is not None}
    return (dataclasses.replace(mk_j().suggested_plan, kernel_impl="ref",
                                **kw),
            dataclasses.replace(mk_t().suggested_plan, **kw))


def _jax_run(driver, algo, join=None, connector=None, bucket_cap=None):
    key = (driver, algo, join, connector, bucket_cap)
    if key not in _JAX:
        mk_j, _, vd = ALGOS[algo]
        plan, _ = _plans(algo, join, connector)
        vert = J.load_graph(EDGES, N, 4, value_dims=vd)
        ec = None
        if bucket_cap is not None:
            ec = dataclasses.replace(
                J.default_engine_config(vert, mk_j(), plan),
                bucket_cap=bucket_cap)
        run = J.run_host if driver == "host" else J.run_jit
        _JAX[key] = run(vert, mk_j(), plan, max_supersteps=30, ec=ec)
    return _JAX[key]


def _torch_run(driver, algo, join=None, connector=None, bucket_cap=None):
    mk_j, mk_t, vd = ALGOS[algo]
    _, plan = _plans(algo, join, connector)
    vert = T.load_graph(EDGES, N, 4, value_dims=vd, device="cpu")
    ec = None
    if bucket_cap is not None:
        ec = dataclasses.replace(T.default_engine_config(vert, mk_t(), plan),
                                 bucket_cap=bucket_cap)
    run = T.run_host if driver == "host" else T.run_jit
    return run(vert, mk_t(), plan, max_supersteps=30, ec=ec)


def _stat_keys(stats):
    keep = ("superstep", "event", "active", "messages", "bucket_cap",
            "frontier_cap", "sources")
    return [{k: s[k] for k in keep if k in s} for s in stats]


def _compare(jr, tr, algo):
    assert tr.supersteps == jr.supersteps
    assert bool(tr.gs.halt) == bool(np.asarray(jr.gs.halt))
    for f in ("superstep", "overflow", "active_count", "msg_count"):
        assert np.array_equal(getattr(tr.gs, f).numpy(),
                              np.asarray(getattr(jr.gs, f))), f
    for f in ("vid", "halt"):
        assert np.array_equal(getattr(tr.vertex, f).numpy(),
                              np.asarray(getattr(jr.vertex, f))), f
    got = T.gather_values(tr.vertex, N)
    want = J.gather_values(jr.vertex, N)
    if algo == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert np.array_equal(got, want)
    assert _stat_keys(tr.stats) == _stat_keys(jr.stats)


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("join", ["full_outer", "left_outer"])
@pytest.mark.parametrize("connector", ["partitioning",
                                       "partitioning_merging"])
def test_run_host_matches_reference(algo, join, connector):
    _compare(_jax_run("host", algo, join, connector),
             _torch_run("host", algo, join, connector), algo)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_run_jit_matches_reference(algo):
    jr, tr = _jax_run("jit", algo), _torch_run("jit", algo)
    _compare(jr, tr, algo)


@pytest.mark.parametrize("algo", ["pagerank", "sssp"])
def test_forced_regrow_matches_reference(algo):
    """A tiny bucket capacity overflows: both drivers double it the same
    number of times, at the same supersteps, and end in the same state."""
    jr = _jax_run("host", algo, bucket_cap=4)
    tr = _torch_run("host", algo, bucket_cap=4)
    assert any(s.get("event") == "regrow" for s in tr.stats)
    _compare(jr, tr, algo)


def test_run_jit_raises_on_overflow():
    with pytest.raises(RuntimeError, match="overflow"):
        _torch_run("jit", "cc", bucket_cap=4)


def test_regrow_keeps_run_layout():
    from repro_torch.core.driver import _regrow_msgs
    import torch
    ec = T.EngineConfig(n_parts=2, bucket_cap=3)
    msg = T.MsgRel(dst=torch.arange(8, dtype=torch.int32).reshape(2, 4),
                   payload=torch.ones((2, 4, 1)),
                   valid=torch.ones((2, 4), dtype=torch.bool))
    out = _regrow_msgs(msg, ec)
    assert out.dst.tolist() == [[0, 1, -1, 2, 3, -1], [4, 5, -1, 6, 7, -1]]
    assert out.valid.sum() == 8 and out.payload.sum() == 8


def test_entry_points_refuse_later_slices():
    _, mk_t, vd = ALGOS["sssp"]
    vert = T.load_graph(EDGES, N, 4, value_dims=vd, device="cpu")
    # checkpoints came with slice 5: a missing snapshot is a missing file
    with pytest.raises(FileNotFoundError):
        T.run_host(vert, mk_t(), T.SPARSE_PLAN, resume_from="x")
    # plan="auto" is the planner's; any other string is no plan
    with pytest.raises(ValueError):
        T.run_host(vert, mk_t(), "fastest")
    with pytest.raises(ValueError):
        T.run_jit(vert, mk_t(), "fastest")
    # a shard axis is run_sharded's: outside a process group its
    # collectives refuse to run
    from repro_torch.core.connector import ShardAxis
    with pytest.raises(ValueError, match="process group"):
        T.run_host(vert, mk_t(), T.SPARSE_PLAN,
                   ec=T.EngineConfig(n_parts=4, bucket_cap=64,
                                     axis_name=ShardAxis(0, 1)))


def test_regrow_attempt_seconds_reach_the_event_and_counter():
    """A bucket capacity of 1 on SSSP overflows: each regrow event
    carries its discarded attempt's seconds (up to the readback) as
    ``attempt_s``, ``host.redo_s`` counts the same seconds, and with the
    tracer on each such attempt is a ``superstep`` span tagged redo."""
    from repro_torch.obs import trace
    tracer = trace.start()
    try:
        tr = _torch_run("host", "sssp", bucket_cap=1)
    finally:
        trace.stop()
    regrows = [s for s in tr.stats if s.get("event") == "regrow"]
    assert regrows and all(s["attempt_s"] > 0 for s in regrows)
    redo_s = sum(s["metrics"]["host.redo_s"] for s in tr.stats
                 if "wall_s" in s)
    assert redo_s == pytest.approx(sum(s["attempt_s"] for s in regrows),
                                   rel=1e-9)
    steps = [ev for _, _, evs in tracer.drain() for ev in evs
             if ev[0] == "X" and ev[1] == "superstep"]
    assert sum(1 for ev in steps if ev[5].get("redo")) == len(regrows)
    assert len(steps) == tr.supersteps + len(regrows)
