"""The port's plan audit, memory ledger and run reports
(``repro_torch.obs.{explain,memwatch,report}``) against the JAX
package's, on the CPU. The same run through both packages' ``run_host``
gives the same audit prices row by row, the same replan decision with the
same candidate table, and the same memory samples; a port report passes
the reference's validator and a reference report the port's. Then the
counterparts of the reference's report tests (``tests/test_report.py``)
on the port: the disabled path, a disk-tier out-of-core report that
meets the acceptance criteria, ``compare``, the decision log, the
validator, the report CLI, the budget gauge, ``attach`` and the writer.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import json
import math

import pytest

import repro.core as J
import repro.graph as JG
import repro.obs.explain as Jexplain
import repro.obs.memwatch as Jmemwatch
import repro.obs.report as Jreport
import repro_torch.core as T
import repro_torch.graph as TG
from repro_torch.core import PhysicalPlan, load_graph
from repro_torch.core.ooc import run_out_of_core
from repro_torch.graph import PageRank, rmat_graph
from repro_torch.obs import explain, memwatch, report
from repro_torch.obs.explain import TERM_LEG, drift
from repro_torch.obs.report import (build_report, compare, to_markdown,
                                    validate_report, write_report)
from repro_torch.planner import (CPU_MACHINE, AdaptiveConfig,
                                 AdaptiveController, GraphStats,
                                 Observation, choose)
from repro_torch.planner.stats import SuperstepStats

REL = 1e-12


@pytest.fixture(autouse=True)
def _no_leaked_ledgers():
    """Every test starts and ends with both packages' ledgers off."""
    for m in (explain, memwatch, Jexplain, Jmemwatch):
        m.stop()
    yield
    for m in (explain, memwatch, Jexplain, Jmemwatch):
        m.stop()


N = 220
EDGES = rmat_graph(N, 1200, seed=7)
BUDGET = 16 * 1024
GRID = 40


def _audited(core, ex, mw, vert, prog, plan, **kw):
    """One run_host of either package with both ledgers recording ->
    (RunResult, report document)."""
    ex.start()
    mw.start()
    try:
        res = core.run_host(vert, prog, plan, **kw)
    finally:
        led, mem = ex.stop(), mw.stop()
    rep = (build_report if core is T else Jreport.build_report)(
        stats=res.stats, explain=led, memwatch=mem, meta={"algo": "x"})
    return res, rep


@pytest.fixture(scope="module")
def twin_runs():
    """PageRank on the rmat graph and SSSP under plan="auto" on a
    40 x 40 lattice (a switch to left-outer at superstep 3), through both
    packages' run_host with the ledgers on: the JAX runs, shared by the
    parity tests below."""
    out = {}
    grid = TG.grid_graph(GRID)
    for name, edges, n, tprog, jprog, plan in (
            ("pagerank", EDGES, N, TG.PageRank(N, iterations=6),
             JG.PageRank(N, iterations=6), PhysicalPlan()),
            ("sssp_auto", grid, GRID * GRID, TG.SSSP(source=0),
             JG.SSSP(source=0), "auto")):
        jplan = plan if plan == "auto" else \
            J.PhysicalPlan(**dataclasses.asdict(plan))
        out[name] = (
            _audited(T, explain, memwatch,
                     load_graph(edges, n, P=4, value_dims=tprog.value_dims,
                                device="cpu"), tprog, plan,
                     max_supersteps=200),
            _audited(J, Jexplain, Jmemwatch,
                     J.load_graph(edges, n, P=4,
                                  value_dims=jprog.value_dims),
                     jprog, jplan, max_supersteps=200))
    return out


def _close(a, b):
    return a == pytest.approx(b, rel=REL, abs=0.0)


# ------------------------------------------------- parity with the JAX run

@pytest.mark.parametrize("name", ["pagerank", "sssp_auto"])
def test_run_host_audit_and_memory_equal_reference(twin_runs, name):
    (tres, trep), (jres, jrep) = twin_runs[name]
    assert tres.supersteps == jres.supersteps
    assert len(trep["supersteps"]) == len(jrep["supersteps"])
    for a, b in zip(trep["supersteps"], jrep["supersteps"]):
        assert a["superstep"] == b["superstep"]
        assert a["active"] == b["active"]
        assert a["messages"] == b["messages"]
        ta, ja = a["audit"], b["audit"]
        assert "error" not in ta and "error" not in ja
        assert ta["plan"] == ja["plan"]
        assert sorted(ta["predicted"]) == sorted(ja["predicted"])
        for term, d in ta["predicted"].items():
            for k, v in d.items():
                want = ja["predicted"][term][k]
                assert v == want if k == "leg" else _close(v, want)
        assert _close(ta["predicted_total_s"], ja["predicted_total_s"])
        assert _close(ta["legs"]["device"]["predicted_s"],
                      ja["legs"]["device"]["predicted_s"])
        assert a["memory"] == b["memory"]
        # the counters the reference's run_host records, and the port's
        # own host.redo_s (no regrow here)
        got = dict(a["extra"]["metrics"])
        assert got.pop("host.redo_s") == 0.0
        assert got == b["extra"]["metrics"]
    assert trep["memory_peaks"] == jrep["memory_peaks"]


def test_replan_decision_equals_reference(twin_runs):
    (tres, trep), (jres, jrep) = twin_runs["sssp_auto"]
    (t,) = trep["decisions"]
    (j,) = jrep["decisions"]
    assert t["kind"] == j["kind"] == "replan"
    assert t["superstep"] == j["superstep"] == 3
    assert (t["from"], t["to"]) == (j["from"], j["to"])
    assert _close(t["current_s"], j["current_s"])
    assert [c["plan"] for c in t["candidates"]] == \
        [c["plan"] for c in j["candidates"]]
    for a, b in zip(t["candidates"], j["candidates"]):
        assert _close(a["seconds"], b["seconds"])
    assert trep["summary"]["replans"] == jrep["summary"]["replans"] == 1


def test_reports_cross_validate(twin_runs):
    """Either package's validator accepts the other's report (the schema
    is the reference's, pregelix-run-report/v1)."""
    for (tres, trep), (jres, jrep) in twin_runs.values():
        doc_t = json.loads(json.dumps(trep))
        doc_j = json.loads(json.dumps(jrep))
        assert validate_report(doc_t) == [] == Jreport.validate_report(doc_t)
        assert validate_report(doc_j) == [] == Jreport.validate_report(doc_j)
        assert compare(doc_j, doc_t)["base"]["supersteps"] == \
            Jreport.compare(doc_j, doc_t)["other"]["supersteps"]
        assert to_markdown(doc_t).splitlines()[0] == \
            Jreport.to_markdown(doc_t).splitlines()[0]
    assert report.SCHEMA == Jreport.SCHEMA


# ----------------------- counterparts of tests/test_report.py on the port

def _disk_tier_run(tmp_path, tag):
    prog = PageRank(N, iterations=6)
    vert = load_graph(EDGES, N, P=4, value_dims=2, device="cpu")
    explain.start()
    memwatch.start()
    try:
        res = run_out_of_core(
            vert, prog, "auto", budget_partitions=1, max_supersteps=8,
            stream=True, barrier_free=True, memory_budget_bytes=BUDGET,
            disk_dir=str(tmp_path / f"spill-{tag}"), eviction="mru",
            io_threads=2, device="cpu")
    finally:
        led = explain.stop()
        mw = memwatch.stop()
    return build_report(stats=res.stats, explain=led, memwatch=mw,
                        meta={"tag": tag, "algo": "pagerank"})


def test_disabled_audit_records_nothing():
    assert not explain.enabled() and not memwatch.enabled()
    assert explain.get() is None and memwatch.get() is None
    prog = PageRank(N, iterations=4)
    assert explain.attach(prog, plan=PhysicalPlan()) is None
    assert explain.superstep(SuperstepStats(superstep=0)) is None
    assert explain.decision(0, "replan") is None
    assert memwatch.configure(budget_bytes=1) is None
    assert memwatch.sample(0) is None
    vert = load_graph(EDGES, N, P=4, value_dims=2, device="cpu")
    res = run_out_of_core(vert, prog, prog.suggested_plan,
                          budget_partitions=2, max_supersteps=6,
                          device="cpu")
    assert res.supersteps > 0
    res = T.run_host(vert, prog, prog.suggested_plan, max_supersteps=6)
    assert res.supersteps > 0
    assert explain.get() is None and memwatch.get() is None


def test_stop_detaches_the_ledgers():
    led = explain.start()
    mw = memwatch.start()
    assert explain.enabled() and memwatch.enabled()
    assert explain.stop() is led and memwatch.stop() is mw
    assert not explain.enabled() and not memwatch.enabled()


def test_disk_tier_report_meets_acceptance(tmp_path):
    rep = _disk_tier_run(tmp_path, "accept")
    assert validate_report(rep) == []
    assert Jreport.validate_report(rep) == []
    rows = rep["supersteps"]
    assert rows
    for r in rows:
        a = r["audit"]
        assert "error" not in a
        assert math.isfinite(a["drift_score"])
        assert a["predicted"]
        for term, d in a["predicted"].items():
            assert d["leg"] == TERM_LEG.get(term, "device")
            assert math.isfinite(d["seconds"])
        assert {"device", "host_io", "serial"} <= set(a["legs"])
        for leg in a["legs"].values():
            assert math.isfinite(leg["drift"])
            assert leg["measured_s"] >= 0.0
            assert leg["drift"] == pytest.approx(
                drift(leg["predicted_s"], leg["measured_s"]))
        m = r["memory"]
        assert m["hbm"]["total_bytes"] > 0
        assert m["hbm"]["resident_parts"] == 1
        assert m["dram"]["budget_bytes"] == BUDGET
        assert 0 <= m["dram"]["peak_resident_bytes"] <= BUDGET
        assert m["dram"]["occupancy"] == pytest.approx(
            m["dram"]["resident_bytes"] / BUDGET)
        assert m["ssd"]["spill_bytes"] >= 0
    assert rep["memory_peaks"]["ssd_spill_bytes"] > 0
    assert 0 < rep["memory_peaks"]["dram_occupancy"] <= 1.0 + 1e-9
    for d in rep["decisions"]:
        assert d["kind"] in ("replan", "recalibrate")
        if d["kind"] == "replan":
            assert d["candidates"]
            for c in d["candidates"]:
                assert c["plan"] and math.isfinite(c["seconds"])
    s = rep["summary"]
    assert s["supersteps"] == len(rows)
    assert math.isfinite(s["mean_drift"]) and math.isfinite(s["max_drift"])
    assert s["replans"] == sum(1 for d in rep["decisions"]
                               if d["kind"] == "replan")
    md = to_markdown(rep)
    assert "Run report" in md and "supersteps" in md


def test_same_workload_compares_clean(tmp_path):
    a = _disk_tier_run(tmp_path, "a")
    b = _disk_tier_run(tmp_path, "b")
    diff = compare(a, b)
    assert diff["ok"] and diff["regressions"] == []
    assert diff["base"]["supersteps"] == diff["other"]["supersteps"]
    worse = json.loads(json.dumps(b))
    worse["summary"]["mean_drift"] = a["summary"]["mean_drift"] + 2.0
    worse["memory_peaks"]["dram_occupancy"] = min(
        a["memory_peaks"]["dram_occupancy"] + 0.5, 2.0)
    diff = compare(a, worse)
    assert not diff["ok"]
    assert {r["kind"] for r in diff["regressions"]} == \
        {"drift", "occupancy"}


_G = GraphStats(n_vertices=100_000, n_edges=800_000, n_partitions=8,
                vertex_capacity=16_250, edge_capacity=100_000,
                value_dims=2, msg_dims=1)


def test_replan_decision_carries_the_losing_candidates():
    prog = PageRank(_G.n_vertices, iterations=5)
    dense, _ = choose(prog, _G, Observation(frontier_density=1.0),
                      machine=CPU_MACHINE)
    explain.start()
    ctrl = AdaptiveController(
        prog, _G, dense,
        config=AdaptiveConfig(margin=0.05, patience=1, cooldown=0,
                              min_superstep=0), machine=CPU_MACHINE)
    rec = SuperstepStats(superstep=3, active=100, messages=800,
                         frontier_density=0.001, wall_s=0.01)
    new = ctrl.observe(rec)
    led = explain.stop()
    assert new is not None and new != dense
    (d,) = led.decisions
    assert d["kind"] == "replan" and d["superstep"] == 3
    assert d["from"] != d["to"]
    assert math.isfinite(d["current_s"])
    secs = [c["seconds"] for c in d["candidates"]]
    assert secs == sorted(secs)
    assert d["candidates"][0]["plan"] == d["to"]
    rep = build_report(stats=[rec.as_dict()], explain=led)
    assert validate_report(rep) == []
    assert rep["summary"]["replans"] == 1


def test_recalibration_is_a_decision():
    """A refit of the cost model's constants lands in the decision log
    with the constants, as the reference's controller logs it."""
    prog = PageRank(_G.n_vertices, iterations=5)
    explain.start()
    ctrl = AdaptiveController(
        prog, _G, PhysicalPlan(),
        config=AdaptiveConfig(calibrate=True, recalibrate_every=1),
        machine=CPU_MACHINE)
    ctrl.note_shape_change()
    consts = ctrl.maybe_recalibrate(prog, 4)
    led = explain.stop()
    (d,) = led.decisions
    assert d == dict(consts, superstep=4, kind="recalibrate")
    assert validate_report(build_report(
        stats=[SuperstepStats(superstep=4).as_dict()], explain=led)) == []


def test_decision_validation_rejects_bad_entries():
    base = {"schema": report.SCHEMA, "meta": {},
            "supersteps": [{"superstep": 0, "wall_s": 0.1}],
            "summary": {}}
    ok = dict(base, decisions=[
        {"superstep": 1, "kind": "replan",
         "candidates": [{"plan": "a/b", "seconds": 0.5}]},
        {"superstep": 2, "kind": "recalibrate", "k_compute": 1.0}])
    assert validate_report(ok) == []
    bad = dict(base, decisions=[
        {"superstep": 1, "kind": "mystery"},
        {"superstep": 2, "kind": "replan"},
        {"superstep": 3, "kind": "replan",
         "candidates": [{"plan": "a/b"}]}])
    errs = validate_report(bad)
    assert len(errs) == 3
    assert errs == Jreport.validate_report(bad)
    assert any("unknown kind" in e for e in errs)
    assert any("candidate price table" in e for e in errs)
    assert any("bad candidate" in e for e in errs)


def test_validator_collects_every_violation():
    assert validate_report([]) == ["top level must be a dict"]
    errs = validate_report({"schema": "nope", "meta": None,
                            "supersteps": [], "decisions": None,
                            "summary": None})
    assert len(errs) == 5
    doc = {"schema": report.SCHEMA,
           "meta": {"memory_budget_bytes": 100},
           "supersteps": [
               {"superstep": 0, "wall_s": 0.1,
                "audit": {"drift_score": float("nan"), "legs": {},
                          "predicted": {"send": {"seconds": 1.0}}},
                "memory": {"dram": {"resident_bytes": 50,
                                    "dirty_bytes": 0, "pinned_bytes": 0,
                                    "peak_resident_bytes": 150}}}],
           "decisions": [], "summary": {}}
    errs = validate_report(doc)
    assert any("drift_score" in e for e in errs)
    assert any("exceeds budget" in e for e in errs)
    assert errs == Jreport.validate_report(doc)


def test_report_cli_validate_and_compare(tmp_path, capsys):
    good = tmp_path / "good.json"
    bad = tmp_path / "bad.json"
    gdoc = {"schema": report.SCHEMA, "meta": {},
            "supersteps": [{"superstep": 0, "wall_s": 0.1}],
            "decisions": [], "summary": {"mean_drift": 0.5}}
    good.write_text(json.dumps(gdoc))
    bad.write_text(json.dumps({"schema": "wrong", "meta": {},
                               "supersteps": [], "decisions": [],
                               "summary": {}}))
    assert report.main(["--validate", str(good)]) == 0
    assert "OK" in capsys.readouterr().out
    assert report.main(["--validate", str(good), str(bad)]) == 1
    out = capsys.readouterr().out
    assert "INVALID" in out and "schema must be" in out
    assert "supersteps must be a non-empty list" in out
    assert report.main(["--validate", str(tmp_path / "missing.json")]) == 1
    assert "unreadable" in capsys.readouterr().out
    worse = tmp_path / "worse.json"
    wdoc = json.loads(json.dumps(gdoc))
    wdoc["summary"]["mean_drift"] = 9.0
    worse.write_text(json.dumps(wdoc))
    assert report.main(["--compare", str(good), str(good)]) == 0
    assert report.main(["--compare", str(good), str(worse)]) == 0
    assert report.main(["--compare", str(good), str(worse),
                        "--strict"]) == 1
    assert "mean drift rose" in capsys.readouterr().out


def test_drift_is_finite_and_symmetric():
    assert drift(1.0, 1.0) == 0.0
    assert drift(1.0, 2.0) == pytest.approx(math.log(2), abs=1e-5)
    assert drift(2.0, 1.0) == pytest.approx(drift(1.0, 2.0), abs=1e-5)
    assert math.isfinite(drift(0.0, 0.0))
    assert math.isfinite(drift(0.0, 1e9))


def test_memwatch_budget_gauge_and_peaks():
    class _Store:
        def occupancy(self):
            return {"resident_bytes": 60, "dirty_bytes": 10,
                    "pinned_bytes": 4, "peak_resident_bytes": 80,
                    "budget_bytes": 100, "spill_bytes": 7,
                    "spill_read_bytes": 3, "spill_write_bytes": 9}
    mw = memwatch.start()
    s = memwatch.sample(0, store=_Store())
    assert s["dram"]["occupancy"] == pytest.approx(0.6)
    assert s["dram"]["headroom_bytes"] == 40
    assert s["ssd"]["spill_bytes"] == 7
    s2 = memwatch.sample(1, stores=[_Store(), _Store()])
    assert s2["dram"]["resident_bytes"] == 120
    assert s2["dram"]["budget_bytes"] == 200
    assert memwatch.stop() is mw
    assert mw.peaks["dram_resident_bytes"] == 120
    assert mw.peaks["ssd_spill_bytes"] == 14
    assert mw.peaks["dram_occupancy"] == pytest.approx(0.6)


def test_explain_attach_requires_context():
    led = explain.start()
    prog = PageRank(N, iterations=4)
    assert explain.attach(prog) is None
    assert explain.attach(prog, plan=PhysicalPlan()) is None
    assert led.superstep(SuperstepStats(superstep=0)) is None
    vert = load_graph(EDGES, N, P=4, value_dims=2, device="cpu")
    assert explain.attach(prog, vert=vert, plan=PhysicalPlan()) is led
    # the machine follows the graph's device
    assert led._auditor.machine is CPU_MACHINE
    row = led.superstep(SuperstepStats(
        superstep=0, active=N, messages=1200, frontier_density=1.0,
        wall_s=0.01))
    assert row is not None and math.isfinite(row["drift_score"])
    assert row["legs"]["device"]["measured_s"] == pytest.approx(0.01)
    assert led.superstep(SuperstepStats(superstep=1,
                                        event="plan-switch")) is None
    explain.stop()


def test_write_report_emits_json_and_markdown(tmp_path):
    doc = {"schema": report.SCHEMA, "meta": {"algo": "pagerank"},
           "supersteps": [{"superstep": 0, "wall_s": 0.1}],
           "decisions": [], "summary": {"supersteps": 1, "wall_s": 0.1,
                                        "mean_drift": None,
                                        "replans": 0,
                                        "recalibrations": 0}}
    p = tmp_path / "rep.json"
    m = tmp_path / "rep.md"
    write_report(str(p), doc, markdown=str(m))
    assert json.loads(p.read_text())["schema"] == report.SCHEMA
    assert "Run report" in m.read_text()
    assert m.read_text() == Jreport.to_markdown(doc)
