"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the same inputs, on the CPU: the progress
line and plan tag are the same strings, the memory ledger's samples and
peaks the same numbers, the plan audit's predicted terms the same prices
(``CPU_MACHINE`` is the reference's emulated machine, rel 1e-12), and a
port Chrome trace passes both packages' validators. Then the
counterparts of the reference's own tracing tests (``tests/test_obs.py``)
on the port: the disabled path, export and its schema check, the export
CLI, and a traced disk-tier run of ``run_out_of_core``."""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import json
import math
import threading

import numpy as np
import pytest

import repro.core as J
import repro.core.superstep as JS
import repro.graph as JG
import repro.obs.explain as Jexplain
import repro.obs.export as Jexport
import repro.obs.memwatch as Jmemwatch
import repro.obs.progress as Jprogress
import repro.planner as JP
import repro.planner.cost as JC
import repro.planner.stats as JST
import repro.storage as JSTORE
import repro_torch.core as T
import repro_torch.core.superstep as TS
import repro_torch.graph as TG
import repro_torch.planner as TP
import repro_torch.planner.stats as TST
import repro_torch.storage as TSTORE
from repro_torch.core import PhysicalPlan, load_graph
from repro_torch.core.ooc import run_out_of_core
from repro_torch.graph import PageRank, rmat_graph
from repro_torch.obs import explain, memwatch, trace
from repro_torch.obs.export import (chrome_trace, trace_violations,
                                    validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.progress import fmt_plan, progress_line

REL = 1e-12


@pytest.fixture(autouse=True)
def _no_leaked_recorders():
    """Every test starts and ends with the port's tracer and ledgers off
    — a recorder leaked across tests would defeat the overhead guards."""
    for m in (trace, explain, memwatch):
        m.stop()
    yield
    for m in (trace, explain, memwatch):
        m.stop()


def _jplan(p):
    return J.PhysicalPlan(**dataclasses.asdict(p))


PLANS = [PhysicalPlan(),
         PhysicalPlan(join="left_outer"),
         PhysicalPlan(groupby="sort", connector="partitioning_merging",
                      storage="delta"),
         PhysicalPlan(sender_combine=False)]

# stats records as the drivers write them: in memory, out of core (the
# pipeline's split, stall, paging and combinability extras), sharded
RECORDS = [
    dict(superstep=0, active=20_000, messages=160_000,
         frontier_density=1.0, wall_s=0.25, recompiled=True),
    dict(superstep=1, active=9_000, messages=71_000, frontier_density=0.45,
         wall_s=0.031),
    dict(superstep=2, active=120, messages=900, frontier_density=0.006,
         wall_s=0.004,
         extra=dict(ooc=True, streaming=True, barrier_free=True,
                    super_partitions=4, readiness_stall_s=0.0021,
                    dispatch_s=0.012, collect_wait_s=0.0008,
                    commit_s=0.004, change_density=0.2,
                    combinability=2.5, mutation_rate=0.01, spill=True,
                    cache_hit_rate=0.83, spill_read_bytes=1_200_000,
                    spill_write_bytes=300_000, io_queue_depth=3,
                    readahead_depth=4)),
    dict(superstep=3, active=80, messages=600, frontier_density=0.004,
         wall_s=0.003,
         extra=dict(ooc=True, streaming=True, barrier_free=True,
                    super_partitions=4, readiness_stall_s=0.0017,
                    dispatch_s=0.010, collect_wait_s=0.0006,
                    commit_s=0.003, cache_hit_rate=1.0)),
    dict(superstep=4, active=2_000, messages=9_000, frontier_density=0.1,
         wall_s=0.02,
         extra=dict(sharded=True, n_workers=2, exchange_bytes=1_300_000,
                    exchange_stall_s=0.0042)),
]


def _rec(pkg, d):
    return pkg.SuperstepStats(**{k: (dict(v) if k == "extra" else v)
                                 for k, v in d.items()})


# ------------------------------------------------ progress (parity)

@pytest.mark.parametrize("plan", PLANS + [None])
def test_progress_line_and_plan_tag_equal_reference(plan):
    jplan = _jplan(plan) if plan is not None else None
    assert fmt_plan(plan) == Jprogress.fmt_plan(jplan)
    for d in RECORDS + [{"superstep": 3, "event": "plan-switch"},
                        {"superstep": 0, "active": 5, "wall_s": 0.1}]:
        rec = _rec(TST, d).as_dict() if "event" not in d else dict(d)
        jrec = _rec(JST, d).as_dict() if "event" not in d else dict(d)
        for kw in ({}, {"n_vertices": 20_000}):
            assert progress_line(rec, plan, **kw) == \
                Jprogress.progress_line(jrec, jplan, **kw)


# ------------------------------------------------ memwatch (parity)

class _Store:
    def __init__(self, k=1):
        self.k = k

    def occupancy(self):
        return {"resident_bytes": 60 * self.k, "dirty_bytes": 10,
                "pinned_bytes": 4, "peak_resident_bytes": 80 * self.k,
                "budget_bytes": 100 * self.k, "spill_bytes": 7,
                "spill_read_bytes": 3, "spill_write_bytes": 9}


@pytest.mark.parametrize("budget", [None, 4096])
def test_memwatch_samples_and_peaks_equal_reference(budget):
    caps = dict(n_parts=4, bucket_cap=1_234, frontier_cap=567,
                mutation_cap=64)
    shapes = dict(Np=5_003, Ep=60_001, value_dims=2, msg_dims=1,
                  budget_bytes=budget)
    got = memwatch.MemWatch().configure(ec=TS.EngineConfig(**caps),
                                        **shapes)
    want = Jmemwatch.MemWatch().configure(ec=JS.EngineConfig(**caps),
                                          **shapes)
    for i, kw in enumerate(({}, {"resident_parts": 2},
                            {"store": _Store()},
                            {"stores": [_Store(), _Store(3)],
                             "resident_parts": 1})):
        assert got.sample(i, **kw) == want.sample(i, **kw)
    assert got.peaks == want.peaks
    assert got.as_dict() == want.as_dict()


def test_memwatch_reads_the_same_tier_occupancy_as_reference(tmp_path):
    """A port store and a reference store holding the same pages under the
    same DRAM budget report the same occupancy, so the ledger's DRAM and
    SSD samples agree too."""
    rng = np.random.default_rng(3)
    pages = {f"rel{k}": rng.standard_normal((2, 512)).astype(np.float32)
             for k in range(6)}
    stores = []
    for pkg, tag in ((TSTORE, "t"), (JSTORE, "j")):
        st = pkg.TieredStore(n_sp=2, budget_bytes=12_000,
                             disk_dir=str(tmp_path / tag), policy="lru")
        for name, arr in pages.items():
            st.register(name, arr)
        for name in pages:
            st.read(name, 0)
        stores.append(st)
    try:
        occ = [st.occupancy() for st in stores]
        keys = ("resident_bytes", "dirty_bytes", "pinned_bytes",
                "peak_resident_bytes", "budget_bytes", "spill_bytes")
        assert [occ[0][k] for k in keys] == [occ[1][k] for k in keys]
        assert occ[0]["spill_bytes"] > 0
        samples = [mw.sample(0, store=st) for mw, st in
                   zip((memwatch.MemWatch(), Jmemwatch.MemWatch()),
                       stores)]
        assert samples[0]["dram"] == samples[1]["dram"]
        assert samples[0]["ssd"]["spill_bytes"] == \
            samples[1]["ssd"]["spill_bytes"]
    finally:
        for st in stores:
            st.close()


# ------------------------------------------------ explain (parity)

@pytest.mark.parametrize("plan", PLANS)
def test_audit_prices_equal_reference_on_the_cpu_machine(plan):
    """An ExplainLedger fed the same records prices the same terms and
    legs as the reference's (CPU_MACHINE = the emulated machine)."""
    g = dict(n_vertices=20_000, n_edges=240_000, n_partitions=4,
             vertex_capacity=6_508, edge_capacity=72_001, value_dims=2,
             msg_dims=1)
    got = explain.ExplainLedger().attach(
        TG.PageRank(20_000), g=TP.GraphStats(**g), plan=plan,
        machine=TP.CPU_MACHINE)
    want = Jexplain.ExplainLedger().attach(
        JG.PageRank(20_000), g=JP.GraphStats(**g), plan=_jplan(plan),
        machine=JC.EMULATED_MACHINE)
    for d in RECORDS:
        a = got.superstep(_rec(TST, d), bucket_cap=2_000)
        b = want.superstep(_rec(JST, d), bucket_cap=2_000)
        assert "error" not in a and "error" not in b
        assert a["plan"] == b["plan"] and a["recompiled"] == b["recompiled"]
        assert sorted(a["predicted"]) == sorted(b["predicted"])
        for term, pa in a["predicted"].items():
            pb = b["predicted"][term]
            assert pa["leg"] == pb["leg"] and sorted(pa) == sorted(pb)
            for k, v in pa.items():
                if k != "leg":
                    assert v == pytest.approx(pb[k], rel=REL, abs=0.0), \
                        (term, k)
        assert a["predicted_total_s"] == pytest.approx(
            b["predicted_total_s"], rel=REL, abs=0.0)
        assert sorted(a["legs"]) == sorted(b["legs"])
        for leg, la in a["legs"].items():
            for k in ("predicted_s", "measured_s", "drift"):
                assert la[k] == pytest.approx(b["legs"][leg][k], rel=REL,
                                              abs=1e-15), (leg, k)
        assert a["drift_score"] == pytest.approx(b["drift_score"], rel=REL)
    assert got.superstep(_rec(TST, {"superstep": 5,
                                    "event": "regrow"})) is None


def test_drift_and_measured_legs_equal_reference():
    for p, m in ((1.0, 1.0), (1.0, 2.0), (0.0, 0.0), (0.0, 1e9),
                 (3e-7, 0.25)):
        assert explain.drift(p, m) == Jexplain.drift(p, m)
    for d in RECORDS:
        assert explain.measured_legs(_rec(TST, d), TP.CPU_MACHINE) == \
            Jexplain.measured_legs(_rec(JST, d), JC.EMULATED_MACHINE)
    assert explain.TERM_LEG == Jexplain.TERM_LEG
    assert explain.LEGS == Jexplain.LEGS


# ------------------------------------------------ export (parity)

def test_port_trace_passes_both_validators(tmp_path):
    trace.start()
    with trace.span("outer", "commit", q=2):
        with trace.span("inner", "fault"):
            pass
    trace.instant("regrow", "replan", superstep=3)
    trace.counter("active", 7)

    def worker():
        with trace.span("fault_bg", "readahead"):
            pass

    th = threading.Thread(target=worker, name="pregelix-io-0")
    th.start()
    th.join()
    tracer = trace.stop()
    obj = chrome_trace(tracer)
    got = validate_chrome_trace(obj, min_threads=2)
    assert got == Jexport.validate_chrome_trace(obj, min_threads=2)
    assert Jexport.trace_violations(obj)[0] == []
    assert got["spans"] == 3 and "pregelix-io-0" in got["thread_names"]
    p = tmp_path / "t.json"
    trace.start()
    with trace.span("w", "compute"):
        pass
    write_chrome_trace(str(p), trace.stop())
    assert Jexport.main([str(p)]) == 0


# ----------------------- counterparts of tests/test_obs.py on the port

def test_disabled_tracing_allocates_nothing():
    assert not trace.enabled()
    s1 = trace.span("a", "compute")
    s2 = trace.span("b", "dispatch")
    assert s1 is s2
    assert trace.annotate("c") is s1
    with s1:
        pass
    assert trace.complete("x", "commit", 0.0, 1.0) is None
    assert trace.instant("y", "replan") is None
    assert trace.counter("z", 3) is None
    assert trace.get() is None


def test_stop_detaches_and_disables():
    t = trace.start()
    with trace.span("work", "compute"):
        pass
    assert trace.stop() is t
    assert not trace.enabled()
    assert trace.span("late", "compute") is trace.span("later", "commit")
    assert t.n_events() == 1


def test_span_events_round_trip_to_chrome_json(tmp_path):
    tr = trace.start()
    with trace.span("outer", "commit", q=2):
        with trace.span("inner", "fault"):
            pass
    trace.instant("mark", "replan", superstep=3)
    trace.counter("depth", 5)
    tracer = trace.stop()
    assert tracer is tr
    obj = chrome_trace(tracer)
    summary = validate_chrome_trace(obj)
    assert summary["spans"] == 2
    assert summary["span_threads"] == 1
    assert set(summary["categories"]) == {"commit", "fault"}
    by_name = {e["name"]: e for e in obj["traceEvents"]}
    assert by_name["outer"]["ph"] == "X"
    # the caller's arguments, and the span tree: own id, parent
    outer = by_name["outer"]["args"]
    assert outer == {"q": 2, "span": outer["span"]}
    assert by_name["inner"]["args"] == {"span": outer["span"] + 1,
                                        "parent": outer["span"]}
    assert by_name["inner"]["dur"] <= by_name["outer"]["dur"]
    assert by_name["mark"]["ph"] == "i"
    assert by_name["depth"]["ph"] == "C"
    assert by_name["depth"]["args"]["value"] == 5
    assert all(e.get("ts", 0) >= 0 for e in obj["traceEvents"])
    p = tmp_path / "trace.json"
    trace.start()
    with trace.span("w", "compute"):
        pass
    write_chrome_trace(str(p))
    reloaded = json.loads(p.read_text())
    assert validate_chrome_trace(reloaded)["spans"] == 1
    from repro_torch.obs.export import main as export_main
    assert export_main([str(p), "--min-threads", "1"]) == 0


def test_schema_validation_rejects_malformed_traces():
    with pytest.raises(ValueError, match="top level"):
        validate_chrome_trace([])
    with pytest.raises(ValueError, match="must be a list"):
        validate_chrome_trace({"traceEvents": {}})
    ok = {"ph": "X", "name": "s", "cat": "compute", "pid": 1, "tid": 1,
          "ts": 0.0, "dur": 1.0}
    with pytest.raises(ValueError, match="unknown phase"):
        validate_chrome_trace({"traceEvents": [{**ok, "ph": "Z"}]})
    bad = dict(ok)
    del bad["tid"]
    with pytest.raises(ValueError, match="missing name/pid/tid"):
        validate_chrome_trace({"traceEvents": [bad]})
    with pytest.raises(ValueError, match="unknown category"):
        validate_chrome_trace({"traceEvents": [{**ok, "cat": "nonsense"}]})
    with pytest.raises(ValueError, match="bad ts"):
        validate_chrome_trace({"traceEvents": [{**ok, "ts": -1.0}]})
    with pytest.raises(ValueError, match="bad dur"):
        validate_chrome_trace({"traceEvents": [{**ok, "dur": None}]})
    with pytest.raises(ValueError, match="need >= 2"):
        validate_chrome_trace({"traceEvents": [ok]}, min_threads=2)
    assert validate_chrome_trace({"traceEvents": [ok]})["spans"] == 1


def test_export_cli_lists_every_violation(tmp_path, capsys):
    from repro_torch.obs.export import main as export_main
    ok = {"ph": "X", "name": "s", "cat": "compute", "pid": 1, "tid": 1,
          "ts": 0.0, "dur": 1.0}
    broken = {"traceEvents": [
        {**ok, "ph": "Z"},
        {k: v for k, v in ok.items() if k != "tid"},
        {**ok, "cat": "nonsense"},
        {**ok, "ts": -1.0},
        {**ok, "dur": None},
    ]}
    errs, summary = trace_violations(broken)
    assert len(errs) == 5
    assert errs == Jexport.trace_violations(broken)[0]
    with pytest.raises(ValueError, match="unknown phase"):
        validate_chrome_trace(broken)
    assert "unknown phase" in errs[0]
    assert summary["events"] == 5
    p = tmp_path / "broken.json"
    p.write_text(json.dumps(broken))
    assert export_main([str(p)]) == 1
    out = capsys.readouterr().out
    assert "INVALID" in out and "5 violation(s)" in out
    for needle in ("unknown phase", "missing name/pid/tid",
                   "unknown category", "bad ts", "bad dur"):
        assert needle in out


def test_progress_line_formats_the_record():
    rec = {"superstep": 7, "active": 12_400, "frontier_density": 0.19,
           "messages": 48_200, "wall_s": 0.031, "cache_hit_rate": 0.97,
           "readiness_stall_s": 0.0021, "readahead_depth": 4}
    line = progress_line(rec, PhysicalPlan(join="left_outer"))
    assert "superstep   7" in line
    assert "active 12.4k (19.0%)" in line
    assert "msgs 48.2k" in line and "wall 0.031s" in line
    assert "hit 0.97" in line and "stall 2.1ms" in line
    assert "ra 4" in line
    assert "plan left_outer/" in line
    assert "recompile" not in line
    assert "hit" not in progress_line({"superstep": 0, "active": 5,
                                       "wall_s": 0.1})
    assert "[recompile]" in progress_line({"superstep": 0, "active": 5,
                                           "wall_s": 0.1,
                                           "recompiled": True})
    assert "[plan-switch]" in progress_line({"superstep": 3,
                                             "event": "plan-switch"})
    assert fmt_plan(None) == ""


def test_traced_disk_tier_run_shows_all_pipeline_threads(tmp_path):
    """A barrier-free disk-tier run of the port with tracing on: a valid
    Chrome trace with spans from the driver thread and both I/O-engine
    workers, the pipeline's spans (the readiness stall among them), the
    page faults, the counter tracks, and queue-depth percentiles and
    registry metrics in the records, which render as progress lines."""
    n = 220
    edges = rmat_graph(n, 1200, seed=7)
    prog = PageRank(n, iterations=6)
    vert = load_graph(edges, n, P=4, value_dims=2, device="cpu")
    progress = []
    trace.start()
    try:
        res = run_out_of_core(
            vert, prog, prog.suggested_plan, budget_partitions=1,
            max_supersteps=8, stream=True, barrier_free=True,
            memory_budget_bytes=16 * 1024, disk_dir=str(tmp_path / "sp"),
            eviction="mru", io_threads=2, device="cpu",
            on_superstep=lambda i, rec: progress.append((i, rec)))
    finally:
        tracer = trace.stop()
    obj = chrome_trace(tracer)
    summary = validate_chrome_trace(obj, min_threads=3)
    assert Jexport.validate_chrome_trace(obj, min_threads=3) == summary
    assert any("pregelix-io" in nm for nm in summary["thread_names"])
    names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
    assert {"dispatch", "commit", "collect_wait", "prepare", "fold",
            "superstep", "readiness_stall"} <= names
    assert "fault_bg" in names or "page_fault" in names
    assert {"dispatch", "compute", "collect", "commit"} <= \
        set(summary["categories"])
    counters = {e["name"] for e in obj["traceEvents"] if e["ph"] == "C"}
    assert {"active", "messages", "io_queue_depth"} <= counters
    recs = [s for s in res.stats if "wall_s" in s]
    assert recs
    for s in recs:
        assert s["io_queue_depth_p90"] >= s["io_queue_depth_p50"] >= 0
        assert s["io_queue_depth_max"] >= s["io_queue_depth_p90"]
        assert 1 <= s["readahead_depth"] <= 8
        assert s["metrics"]["io.queue_depth"]["count"] >= 0
    assert any(s["metrics"]["io.queue_depth"]["count"] > 0 for s in recs)
    assert [i for i, _ in progress] == [s["superstep"] for s in recs]
    for i, rec in progress:
        assert f"superstep {i:>3}" in progress_line(rec, res.plan)


def test_tracing_overhead_free_run_records_nothing():
    n = 120
    edges = rmat_graph(n, 600, seed=3)
    prog = PageRank(n, iterations=4)
    vert = load_graph(edges, n, P=4, value_dims=2, device="cpu")
    assert not trace.enabled()
    res = run_out_of_core(vert, prog, prog.suggested_plan,
                          budget_partitions=2, max_supersteps=6,
                          device="cpu")
    assert res.supersteps > 0
    assert trace.get() is None
    with pytest.raises(ValueError):
        chrome_trace()


# --------------------------------------------- run_host's instrumentation

def _traced(fn):
    trace.start()
    try:
        res = fn()
    finally:
        tracer = trace.stop()
    by = {}
    for e in chrome_trace(tracer)["traceEvents"]:
        if e["ph"] in ("X", "i"):
            by.setdefault(e["name"], []).append(e)
    recs = [s for s in res.stats if "wall_s" in s]
    return res, recs, by


def _events(res, kind):
    return [s for s in res.stats if s.get("event") == kind]


def test_run_host_records_the_reference_spans_and_counters(tmp_path):
    """run_host with the tracer on: a superstep span a superstep and a
    redo, a regrow instant and a host.regrows count per capacity redo,
    replan spans and a host.plan_switches count under plan="auto", and
    checkpoint spans around each save."""
    edges = TG.grid_graph(40)
    vert = load_graph(edges, 1600, P=4, value_dims=1, device="cpu")
    res, recs, by = _traced(lambda: T.run_host(
        vert, TG.SSSP(source=0), "auto", max_supersteps=200,
        checkpoint_every=10, checkpoint_dir=str(tmp_path)))
    switches = _events(res, "plan-switch")
    assert switches
    assert len(by["superstep"]) == len(recs)
    assert len(by["replan"]) == len(recs) - 1    # not after the halt
    assert len(by["checkpoint"]) == len(by["save_checkpoint"]) == \
        res.supersteps // 10
    assert sum(s["metrics"]["host.plan_switches"] for s in recs) == \
        len(switches)
    assert all(math.isfinite(e["dur"]) for e in by["superstep"])
    # buckets of 2 slots: the first superstep overflows and regrows
    edges = rmat_graph(300, 2_400, seed=5)
    vert = load_graph(edges, 300, P=4, value_dims=2, device="cpu")
    res, recs, by = _traced(lambda: T.run_host(
        vert, PageRank(300, iterations=5), PhysicalPlan(),
        ec=TS.EngineConfig(n_parts=4, bucket_cap=2)))
    regrows = _events(res, "regrow")
    assert regrows
    assert len(by["superstep"]) == len(recs) + len(regrows)
    assert len(by["regrow"]) == len(regrows)
    assert "replan" not in by and "checkpoint" not in by
    assert sum(s["metrics"]["host.regrows"] for s in recs) == len(regrows)


# --------------------- run_host's span tree and the profiler's clock

def _pagerank_job():
    n = 300
    vert = load_graph(rmat_graph(n, 2_400, seed=5), n, P=4, value_dims=2,
                      device="cpu")
    prog = PageRank(n, iterations=4)
    return T.run_host(vert, prog, prog.suggested_plan)


def _stage_names(plan):
    return ["superstep.groupby", "superstep.compute", "superstep.gather"] \
        + (["superstep.combine"] if plan.sender_combine else []) \
        + ["superstep.route", "superstep.reduce"]


def test_run_host_records_the_span_tree():
    """Two PageRank jobs with the tracer on: each is a root ``job`` span
    with its own job id, holding ``job.prepare`` and then a
    ``superstep`` and a ``boundary`` a superstep; each superstep holds
    the stage spans in stage order and then ``superstep.readback``. Every
    span carries its parent and its job, and lies inside its parent."""
    tr = trace.start()
    try:
        results = [_pagerank_job(), _pagerank_job()]
    finally:
        trace.stop()
    spans = sorted((ev for _, _, evs in tr.drain() for ev in evs
                    if ev[0] == "X"), key=lambda ev: (ev[3], ev[6]))
    by_id = {ev[6]: ev for ev in spans}
    kids = {}
    for ev in spans:
        kids.setdefault(ev[7], []).append(ev)
    jobs = kids[0]
    assert [ev[1] for ev in jobs] == ["job", "job"]
    assert [ev[8] for ev in jobs] == [1, 2]
    for job, res in zip(jobs, results):
        steps = res.supersteps
        assert steps > 0
        assert [ev[1] for ev in kids[job[6]]] == \
            ["job.prepare"] + ["superstep", "boundary"] * steps
        supersteps = [ev for ev in kids[job[6]] if ev[1] == "superstep"]
        assert [ev[5] for ev in supersteps] == \
            [{"superstep": i} for i in range(steps)]
        for ev in supersteps:
            assert [c[1] for c in kids[ev[6]]] == \
                _stage_names(res.plan) + ["superstep.readback"]
    for ev in spans:
        if ev[7]:
            parent = by_id[ev[7]]
            assert parent[3] <= ev[3]
            assert ev[3] + ev[4] <= parent[3] + parent[4]
            assert ev[8] == parent[8]
    assert {ev[8] for ev in spans} == {1, 2}


def test_disabled_tracing_records_no_job():
    """With the tracer off, ``job`` is the same cached no-op as ``span``
    and ``annotate``, and a run records nothing."""
    assert trace.job() is trace.span("a", "compute") is trace.annotate("b")
    t = trace.start()
    trace.stop()
    assert _pagerank_job().supersteps > 0
    assert t.n_events() == 0 and trace.get() is None


def test_spans_share_the_profilers_clock(tmp_path):
    """Under a CPU ``torch.profiler`` with ``torch_annotations=True``,
    each span of the port's export starts and ends where the profiler's
    range of the same name does, both read on the epoch clock (base +
    ts). The profiler's range opens first and closes last: measured on a
    CPU host, the port's span started 5-105 us after it and ended 7-220
    us before it, with 12 processes spinning on the host's 8 cores too.
    (The first range of a process used to import torch's CUPTI monitor
    module between the two stamps, which started the first span 1.6-2.1
    ms late on an idle host and up to 5.6 ms late on that loaded one;
    ``trace.start`` now does that import.) The bounds allow 10 ms for a
    loaded host and 0.2 ms of clock error the other way."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    trace.start(torch_annotations=True)
    try:
        _pagerank_job()
    finally:
        tracer = trace.stop()
        prof.stop()
    prof.export_chrome_trace(str(tmp_path / "profile.json"))
    theirs = json.loads((tmp_path / "profile.json").read_text())
    mine = chrome_trace(tracer)

    def spans(obj, keep):
        base = obj["baseTimeNanoseconds"]
        return sorted((base + round(e["ts"] * 1000), e["name"],
                       base + round((e["ts"] + e["dur"]) * 1000))
                      for e in obj["traceEvents"] if keep(e))
    a = spans(mine, lambda e: e["ph"] == "X")
    b = spans(theirs, lambda e: e.get("cat") == "user_annotation")
    assert [x[1] for x in a] == [x[1] for x in b]
    assert "superstep.gather" in {x[1] for x in a}
    for (s0, _, e0), (s1, _, e1) in zip(a, b):
        assert -200_000 <= s0 - s1 <= 10_000_000
        assert -10_000_000 <= e0 - e1 <= 200_000


# ------------------------- the sort group-by's and mutations' spans

SORT_AND_MUTATION_SPANS = {"superstep.groupby.sort", "superstep.groupby.fold",
                           "superstep.resurrect"}
MUTATION_COUNTERS = {"mutate.deleted", "mutate.resurrected"}


def _events_of(tr, kind):
    return [ev for _, _, evs in tr.drain() for ev in evs if ev[0] == kind]


def test_sort_group_by_and_mutations_have_spans_and_counters():
    """PathMerge on its own plan (``groupby="sort"``, a program that
    mutates): each superstep holds ``superstep.resurrect`` right after
    ``superstep.groupby``, which holds ``superstep.groupby.sort`` and then
    ``.fold``; run_host samples ``mutate.deleted`` and
    ``mutate.resurrected`` once a superstep, the counts that its stats
    records carry."""
    edges = np.array([[i, i + 1] for i in range(59)] + [[7, 70], [70, 71]])
    vert = load_graph(edges, 72, P=4, value_dims=2, device="cpu")
    prog = TG.PathMerge()
    assert prog.suggested_plan.groupby == "sort" and prog.mutates
    tr = trace.start()
    try:
        res = T.run_host(vert, prog, prog.suggested_plan)
    finally:
        trace.stop()
    spans = _events_of(tr, "X")
    by_id = {ev[6]: ev for ev in spans}
    kids = {}
    for ev in sorted(spans, key=lambda ev: (ev[3], ev[6])):
        kids.setdefault(ev[7], []).append(ev[1])
    steps = [ev for ev in spans if ev[1] == "superstep"]
    assert len(steps) == res.supersteps == prog.rounds + 1
    for ev in steps:
        names = kids[ev[6]]
        assert names[:2] == ["superstep.groupby", "superstep.resurrect"]
    for ev in spans:
        if ev[1] == "superstep.groupby":
            assert kids[ev[6]] == ["superstep.groupby.sort",
                                   "superstep.groupby.fold"]
        if ev[1] in SORT_AND_MUTATION_SPANS - {"superstep.resurrect"}:
            assert by_id[ev[7]][1] == "superstep.groupby"
    samples = {}
    for ev in _events_of(tr, "C"):
        samples.setdefault(ev[1], []).append(ev[3])
    assert set(samples) == MUTATION_COUNTERS
    recs = [s["metrics"] for s in res.stats if "wall_s" in s]
    for name in MUTATION_COUNTERS:
        assert samples[name] == [m[name] for m in recs]
    assert sum(samples["mutate.deleted"]) > 0
    assert sum(samples["mutate.resurrected"]) > 0


def test_pagerank_runs_no_new_span_or_counter():
    """The sort group-by's and the mutations' spans and counters never
    run on a PageRank job (scatter group-by, no mutation): the
    benchmark's PageRank cells read as before."""
    tr = trace.start()
    try:
        res = _pagerank_job()
    finally:
        trace.stop()
    names = {ev[1] for ev in _events_of(tr, "X")}
    assert "superstep.groupby" in names
    assert not names & SORT_AND_MUTATION_SPANS
    assert _events_of(tr, "C") == []
    for s in res.stats:
        if "wall_s" in s:
            assert set(s["metrics"]) == {"host.regrows", "host.redo_s",
                                         "host.plan_switches"}
