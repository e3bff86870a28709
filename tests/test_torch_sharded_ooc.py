"""The port's sharded out-of-core mode (``run_sharded(...,
budget_partitions=)``) on the CPU, over gloo ranks spawned once for the
module: P = 8 over 2 ranks, 2 partitions resident a rank, each rank's
own tiered store with a 16-KiB DRAM budget spilling under
``disk_dir/worker{w}``.

* PageRank / SSSP / CC x both connectors equal the port's ``run_host``
  bit for bit (``tests/test_torch_sharded.py`` holds the in-memory mode,
  and ``tests/test_torch_driver.py`` ``run_host``, to the JAX package);
* a capacity regrow spanning the exchange (bucket_cap = 2), in memory and
  out of core, equals the uninterrupted run;
* a traced run with the plan audit and the memory watch on: spans from
  every rank's main thread and its stores' I/O threads, one exchange span
  a rank and round, the exchange counters in every record, an audit row
  and a memory sample a superstep, both ranks' DRAM summed;
* a mutating program is refused.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import pathlib

import numpy as np
import pytest

import repro_torch.core as T
import repro_torch.graph as TG
from repro_torch.core.sharded import RankPool, run_sharded
from repro_torch.obs import (chrome_trace, explain, memwatch, trace,
                             validate_chrome_trace)

N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
ALGOS = {
    "pagerank": (lambda: TG.PageRank(N, iterations=6), 2),
    "sssp": (lambda: TG.SSSP(source=3), 1),
    "cc": (TG.ConnectedComponents, 1),
}
CONNECTORS = ("partitioning", "partitioning_merging")
OOC = dict(devices=2, budget_partitions=2, memory_budget_bytes=16 * 1024,
           max_supersteps=30)


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, "cpu") as p:
        yield p


def _vert(vd):
    return T.load_graph(EDGES, N, 8, value_dims=vd, device="cpu")


def _host(prog, plan, vd):
    res = T.run_host(_vert(vd), prog, plan, max_supersteps=30)
    return T.gather_values(res.vertex, N), res.supersteps


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("connector_", CONNECTORS)
def test_sharded_ooc_matches_host(algo, connector_, pool, tmp_path):
    mk, vd = ALGOS[algo]
    plan = dataclasses.replace(mk().suggested_plan, connector=connector_)
    want, steps = _host(mk(), plan, vd)
    res = run_sharded(_vert(vd), mk(), plan, disk_dir=str(tmp_path),
                      pool=pool, **OOC)
    assert np.array_equal(T.gather_values(res.vertex, N), want)
    assert res.supersteps == steps
    # each rank spilled into ITS OWN tier directory
    for w in range(2):
        assert pathlib.Path(tmp_path, f"worker{w}").is_dir()
    recs = [s for s in res.stats if "exchange_stall_s" in s]
    assert len(recs) == res.supersteps
    assert all(s["spill"] and s["n_workers"] == 2 and s["ooc"] and
               s["transport"] == "gloo" for s in recs)
    assert all(s["exchange_bytes"] > 0 for s in recs)


def test_sharded_regrow_spans_exchange(pool, tmp_path):
    """bucket_cap = 2 overflows on superstep 0 in both modes; out of core
    the redo end-pads the pages that already landed to the grown run
    width, and both still equal run_host bit for bit."""
    prog = TG.SSSP(source=3)
    want, _ = _host(prog, prog.suggested_plan, 1)
    vert = _vert(1)
    ec = T.EngineConfig(n_parts=8, bucket_cap=2,
                        frontier_cap=vert.capacity + 8)
    mem = run_sharded(vert, prog, prog.suggested_plan, devices=2, ec=ec,
                      max_supersteps=30, pool=pool)
    ooc = run_sharded(_vert(1), prog, prog.suggested_plan, ec=ec,
                      disk_dir=str(tmp_path), pool=pool, **OOC)
    for res in (mem, ooc):
        assert [s for s in res.stats if s.get("event") == "regrow"]
        assert np.array_equal(T.gather_values(res.vertex, N), want)
    # out of core a regrow names the round it redid; a later round's
    # regrow happens after earlier rounds landed their runs
    rounds = [s["round"] for s in ooc.stats if s.get("event") == "regrow"]
    assert any(r > 0 for r in rounds)


def test_sharded_ooc_traced_observability(pool, tmp_path):
    """A traced run: spans from both ranks' main threads and their
    stores' I/O threads (names carry the worker), the all-to-all as
    ``exchange`` spans tagged with their worker (2 rounds a superstep in
    each rank), the exchange counters in every record's metrics, one
    audit row and one memory sample a superstep."""
    prog = TG.PageRank(N, iterations=6)
    trace.start()
    explain.start()
    memwatch.start()
    try:
        res = run_sharded(_vert(2), prog, prog.suggested_plan,
                          disk_dir=str(tmp_path), io_threads=2, pool=pool,
                          **OOC)
    finally:
        tracer, led, mw = trace.stop(), explain.stop(), memwatch.stop()
    obj = chrome_trace(tracer)
    summary = validate_chrome_trace(obj, min_threads=3)
    names = summary["thread_names"]
    for w in range(2):
        assert any(t.startswith("pregelix-io-") and t.endswith(
            f"[worker {w}]") for t in names)
        assert f"MainThread [worker {w}]" in names
    ex = [e for e in obj["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "exchange"]
    for w in range(2):
        mine = [e for e in ex if e["args"]["worker"] == w]
        assert len(mine) == 2 * res.supersteps
        assert all(e["dur"] >= 0 for e in mine)
    recs = [s for s in res.stats if "exchange_stall_s" in s]
    assert recs and len(recs) == res.supersteps
    for s in recs:
        assert s["metrics"]["exchange.bytes"] > 0
        assert s["metrics"]["exchange.stall_s"] >= 0
    assert len(led.rows) == res.supersteps
    assert not [r for r in led.rows if "error" in r]
    assert len(mw.samples) == res.supersteps
    # both ranks' budgets: the DRAM tier's budget is the sum of the two
    assert mw.samples[-1]["dram"]["budget_bytes"] == 2 * 16 * 1024
    assert mw.peaks["ssd_spill_bytes"] > 0


def test_sharded_ooc_rejects_mutations():
    prog = TG.PathMerge()
    vert = T.load_graph(EDGES, N, 8, value_dims=prog.value_dims,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="mutat"):
        run_sharded(vert, prog, devices=1, budget_partitions=2)
