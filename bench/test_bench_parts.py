"""CPU tests of the benchmark's parts: the generators, the plain
references and their controls, the metric arithmetic, the trace
reduction, the manifest and the import guard. No card needed."""
import math
import re

import numpy as np
import pytest
import torch

from bench import graphs, jobs as jobgen, manifest as mf, roofline, timeline
from bench.algorithms import pagerank, sssp
from bench.control import control_readings
from bench.harness import JobRecord, Reservoir, RunContext
from bench.run import banned_modules

SMALL = {"graph500-22": {"scale": 9}, "btc-14m": {"vertices": 512,
                                                  "pairs": 2300}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ------------------------------------------------------------ generators

def cell_of(workload: str) -> dict:
    """A cell of ``workload`` = <config>.<mix>, whether or not
    BENCHMARK.json runs it."""
    config, mix = workload.rsplit(".", 1)
    return {"name": workload, "config": config, "traffic": mix, "chips": 1}


@pytest.mark.parametrize("config", ["graph500-22", "btc-14m"])
def test_generators_repeat_from_a_seed(config):
    cfg = {**mf.config(config), **SMALL[config]}
    a = graphs.make_graph(cfg, 2 ** 31 + 5, "cpu")
    b = graphs.make_graph(cfg, 2 ** 31 + 5, "cpu")
    c = graphs.make_graph(cfg, 2 ** 31 + 6, "cpu")
    assert torch.equal(a.edges, b.edges)
    assert not torch.equal(a.edges[:100], c.edges[:100])
    e = a.edges
    assert e.dtype == graphs.id_dtype(a.n) and e.shape[1] == 2
    assert bool((e[:, 0] != e[:, 1]).all())
    assert int(e.min()) >= 0 and int(e.max()) < a.n


@pytest.mark.parametrize("config", ["graph500-22", "btc-14m"])
def test_graphs_take_graphalytics_form(config):
    """Simple and undirected: no self-loop, no pair twice, each pair stored
    both ways, no isolated vertex, the list sorted by (src, dst)."""
    g = graphs.make_graph({**mf.config(config), **SMALL[config]}, 3, "cpu")
    e = g.edges
    key = e[:, 0] * g.n + e[:, 1]
    assert bool((key[1:] > key[:-1]).all())          # sorted, distinct
    back = torch.sort(e[:, 1] * g.n + e[:, 0]).values
    assert torch.equal(back, key)                    # both directions
    assert g.num_edges == 2 * g.listed_edges
    assert torch.equal(torch.unique(e), torch.arange(g.n))


def test_generator_sizes():
    g = graphs.make_graph({**mf.config("graph500-22"), "scale": 9}, 1, "cpu")
    assert 0.5 * 512 < g.n <= 512
    assert 0.8 * 16 * 512 < 2 * g.listed_edges <= 2 * 16 * 512
    cfg = {**mf.config("btc-14m"), "vertices": 512, "pairs": 2300}
    u = graphs.make_graph(cfg, 1, "cpu")
    assert 0.99 * 512 < u.n <= 512
    assert 0.97 * 2300 < u.listed_edges <= 2300


def test_rmat_ids_are_permuted():
    """Graph500 relabels its ids at random: hash partitions (vid % 4) then
    hold near equal shares of the edges, where R-MAT's own ids put 58 %
    in partition 0."""
    g = graphs.make_graph({**mf.config("graph500-22"), "scale": 14}, 5,
                          "cpu")
    share = torch.bincount(g.edges[:, 0] % 4, minlength=4) / g.num_edges
    assert float(share.max()) < 0.30
    hub = int(torch.bincount(g.edges[:, 0]).argmax())
    assert hub not in (0, 1)


def test_dataset_relabelled_by_the_seed():
    """A configuration with a dataset seed is one graph: each run's seed
    gives it new ids, shuffled inside each hash partition, so every
    partition keeps its counts and the degrees stay the same."""
    cfg = {**mf.config("graph500-22"), "scale": 10}
    assert "dataset_seed" in cfg
    a = graphs.make_graph(cfg, 2 ** 31 + 1, "cpu")
    b = graphs.make_graph(cfg, 2 ** 31 + 2, "cpu")
    assert not torch.equal(a.edges, b.edges)
    assert (a.n, a.listed_edges) == (b.n, b.listed_edges)

    def by_part(g, col):
        return torch.bincount(g.edges[:, col] % 4, minlength=4)
    for col in (0, 1):
        assert torch.equal(by_part(a, col), by_part(b, col))

    def degrees(g):
        return torch.sort(torch.bincount(g.edges[:, 0], minlength=g.n)).values
    assert torch.equal(degrees(a), degrees(b))


def test_configs_match_their_sizes():
    g5 = mf.config("graph500-22")
    assert g5["directed"] is False and g5["edge_factor"] == 16
    assert g5["listed_edges"] < g5["edge_factor"] * 2 ** g5["scale"]
    btc = mf.config("btc-14m")
    assert btc["vertices"] == btc["sample_vertices"] // btc["cut"]
    assert btc["pairs"] == btc["sample_edges"] // btc["cut"] // 2
    assert round(2 * btc["pairs"] / btc["vertices"], 2) == btc["mean_degree"]
    assert round(btc["sample_edges"] / btc["sample_vertices"], 2) == \
        btc["mean_degree"]


def test_job_stream_draws_sources_with_out_edges():
    # out-degrees 1, 1, 2: the quantiles cut [0, 1, 5] in thirds
    edges = torch.tensor([[0, 1], [1, 2], [5, 2], [5, 0]])
    t = mf.traffic("sssp")
    a = jobgen.JobStream(t, edges, 8, 11)
    b = jobgen.JobStream(t, edges, 8, 11)
    c = jobgen.JobStream(t, edges, 8, 12)
    q = t["source_quantiles"]
    srcs = [a.job(i)["source"] for i in range(300)]
    assert srcs == [b.job(i)["source"] for i in range(300)]
    assert srcs != [c.job(i)["source"] for i in range(300)]
    assert srcs[:q] == srcs[q:2 * q]
    assert sorted(srcs[:q]) == sorted(c.job(i)["source"] for i in range(q))
    assert sorted(srcs[:q]) == [0] * 11 + [1] * 10 + [5] * 11
    pr = jobgen.JobStream(mf.traffic("pagerank"), edges, 8, 11).job(3)
    assert pr == {"damping": 0.85, "iterations": 15, "num_vertices": 8}


# ------------------------------------------------------------ references

def test_pagerank_reference_hand_checked():
    # a 3-cycle keeps 1/3 everywhere; a star: r0 = 0.05 + 0.85 * 2/3
    cyc = torch.tensor([[0, 1], [1, 2], [2, 0]])
    r = pagerank.reference(cyc, 3, {"damping": 0.85, "iterations": 15})
    assert torch.allclose(r, torch.full((3,), 1 / 3, dtype=torch.float64))
    star = torch.tensor([[1, 0], [2, 0]])
    r = pagerank.reference(star, 3, {"damping": 0.85, "iterations": 2})
    want = [0.05 + 0.85 * 2 / 3, 0.05, 0.05]
    assert np.allclose(r.numpy(), want, rtol=1e-12, atol=0)
    got = np.array([[want[0] * (1 + 2e-4), 0], [0.05, 0], [0.05, 0]])
    assert pagerank.compare(got, r)["max_rel_err"] == pytest.approx(2e-4)


def test_sssp_reference_hand_checked():
    # 0 -> 1 -> 2 -> 3, 0 -> 2 (a shortcut), 4 -> 0; 5 isolated
    e = torch.tensor([[0, 1], [1, 2], [2, 3], [0, 2], [4, 0]])
    lv = sssp.reference(e, 6, {"source": 0})
    assert lv.tolist() == [0, 1, 1, 2, -1, -1]
    inf = np.float32(3.4e38)
    good = np.array([[0], [1], [1], [2], [inf], [inf]], np.float32)
    assert sssp.compare(good, lv) == {"wrong_vertices": 0}
    bad = good.copy()
    bad[3] = 3
    bad[5] = 7
    assert sssp.compare(bad, lv) == {"wrong_vertices": 2}
    masks = sssp.sending_edges(e, 6, {"source": 0})
    assert [m.nonzero().squeeze(1).tolist() for m in masks] == \
        [[0, 3], [1, 2], []]


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
@pytest.mark.parametrize("workload", ["graph500-22.pagerank",
                                      "btc-14m.pagerank", "graph500-22.sssp",
                                      "btc-14m.sssp"])
def test_control_comes_out_not_correct(workload, seed):
    """The control (bfloat16 PageRank; SSSP with a frontier that drops
    what outgrows its capacity) fails the cell's limits."""
    cell = cell_of(workload)
    small = {"graph500-22": {"scale": 12},
             "btc-14m": {"vertices": 4096, "pairs": 18300}}[cell["config"]]
    r = control_readings(workload, seed, "cpu", small, cell)
    assert r["correct"] is False
    for c in r["checks"].values():
        assert c["value"] > c["limit"]


# ------------------------------------------------------------ metrics

def _ctx(**kw):
    base = dict(workload="w", config={}, traffic={}, algorithm=pagerank,
                n=10, num_edges=40, listed_edges=20, parts=2, value_dims=2, msg_dims=1,
                plan=None, device=torch.device("cpu"))
    base.update(kw)
    return RunContext(**base)


def _read(name, ctx):
    return mf.metric_reader(name).read(ctx)


def test_end_to_end_arithmetic():
    jobs = [JobRecord(args={}, stats=[], latencies=[0.01 * k for k in
                                                    range(1, 11)],
                      supersteps=10, traced=False) for _ in range(2)]
    ctx = _ctx(jobs=jobs, window_s=4.0, window_peak_bytes=4000,
               setup_s=12.5)
    assert _read("evps", ctx) == pytest.approx((10 + 20) * 2 / 4.0)
    # nearest rank over 20 latencies: the 19th smallest, 0.10 s
    assert _read("superstep_p95_ms", ctx) == pytest.approx(100.0)
    assert _read("device_bytes_per_edge", ctx) == pytest.approx(100.0)
    assert _read("setup_s", ctx) == 12.5
    assert _read("device_bytes_per_edge", _ctx(jobs=jobs)) is None


def test_per_layer_arithmetic():
    stats = [{"event": "regrow"}, {"wall_s": 0.5}, {"event": "regrow"},
             {"event": "frontier-refit"}, {"wall_s": 1.5}]
    jobs = [JobRecord({}, stats, [], 2, False),
            JobRecord({}, [{"wall_s": 9.0}], [], 1, True)]
    ctx = _ctx(jobs=jobs, load_s=3.0, n=1000, num_edges=10 ** 6)
    assert _read("load_s", ctx) == 3.0
    assert _read("regrows_per_job", ctx) == 1.0
    need = (8 * 10 ** 6 + 12 * 1000) * 2          # untraced supersteps
    assert _read("superstep_hbm_pct", ctx) == pytest.approx(
        100 * need / 3.35e12 / 2.0)
    tr = timeline.TraceReading(window_s=2.0, busy_s=1.5)
    assert _read("device_idle_pct", _ctx(trace=tr)) == pytest.approx(25.0)
    assert _read("device_idle_pct", ctx) is None


def test_kernel_roofline_bytes():
    # partition 0 sends 0->1, 2->1, 2->3; partition 1 sends 1->3, 3->3
    e = torch.tensor([[0, 1], [2, 1], [2, 3], [1, 3], [3, 3]])
    assert roofline.distinct_owner_dst(e[:, 0], e[:, 1], 4, 2) == 3
    # 2 supersteps of every edge: 5 rows + 3 folded rows, 8 B each
    assert roofline.fold_bytes(e, 4, 2, [None, None], 1) == 2 * 8 * (5 + 3)
    m = torch.tensor([True, True, False, False, False])
    assert roofline.fold_bytes(e, 4, 2, [m], 1) == 8 * (2 + 1)
    # ids + one value an edge, value rows (V = 2) of 4 distinct sources
    assert roofline.gather_bytes(e, [None], 2) == 8 * 5 + 8 * 4
    assert roofline.share_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert roofline.share_pct(1.0, 0.0) is None
    tr = timeline.TraceReading(window_s=1.0, busy_s=1.0, kernel_s={
        "void fold_tiles<0>(int const*)": 1e-9, "gather_quads<2>": 2e-9})
    ctx = _ctx(trace=tr, edges=e, n=4, parts=2,
               jobs=[JobRecord({"damping": 0.85, "iterations": 2}, [], [], 2,
                               True)])
    assert _read("segment_combine_roofline", ctx) == pytest.approx(
        100 * 64 / 3.35e12 / 1e-9)
    assert _read("csr_spmv_roofline", ctx) == pytest.approx(
        100 * 72 / 3.35e12 / 2e-9)


def test_trace_reduction():
    W = timeline.WINDOW_SPAN
    ev = [
        dict(ph="X", cat="user_annotation", name=W, ts=100.0, dur=100.0),
        dict(ph="X", cat="user_annotation", name="bench.job", ts=100.0,
             dur=100.0),
        dict(ph="X", cat="cpu_op", name="aten::sort", ts=125.0, dur=10.0),
        dict(ph="X", cat="cpu_op", name="aten::item", ts=160.0, dur=30.0),
        dict(ph="X", cat="kernel", name="fold_tiles", ts=90.0, dur=30.0),
        dict(ph="X", cat="kernel", name="gather_quads", ts=110.0, dur=15.0),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=140.0,
             dur=20.0),
        dict(ph="X", cat="kernel", name="fold_tiles", ts=195.0, dur=10.0),
    ]
    r = timeline.reduce_events(ev)
    assert r.window_s == pytest.approx(100e-6)
    # busy: [100, 125] + [140, 160] + [195, 200] inside the window
    assert r.busy_s == pytest.approx(50e-6)
    assert r.kernel_seconds("fold_tiles") == pytest.approx(25e-6)
    assert r.kernel_seconds("gather_quads") == pytest.approx(15e-6)
    gaps = dict((n, s) for n, s in r.gaps)
    assert gaps == pytest.approx({"aten::sort": 15e-6, "aten::item": 35e-6})
    assert r.top_gaps()[0] == ["aten::item", pytest.approx(35e-6)]
    assert r.top_ops()[0][0] == "fold_tiles"
    with pytest.raises(ValueError):
        timeline.reduce_events(ev[1:])


def test_reservoir_keeps_a_seeded_sample():
    def run(seed):
        s = Reservoir(3, seed)
        for i in range(40):
            s.offer(i)
        return sorted(s.items)
    assert run(7) == run(7)
    assert len(run(7)) == 3 and len(set(run(7))) == 3
    assert any(run(7) != run(s) for s in range(8, 12))


# ------------------------------------------------------------ manifest

def test_manifest_follows_the_contract():
    m = mf.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and m["command"][1] == "bench/run.py"
    rs = m["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in m["configs"]]
    cells = {w["name"]: w for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert len(set(names)) == len(names) and len(cells) == len(m["workloads"])
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert mf.config(c["name"])["name"] == c["name"]
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
        assert any(w["config"] == c["name"] for w in cells.values())
    for c in names:
        assert callable(mf.generator(mf.config(c)["generator"]).make)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        t = mf.traffic(w["traffic"])
        mf.algorithm(t["algorithm"])
        for kind in t.get("bind", {}).values():
            assert callable(mf.draw(kind).make)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(mf.metric_reader(x["name"]).read)
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e
        for w in x["workloads"]:
            assert mf.applies(e2e[x["moves"]], w), (x["name"], w)
    for w in cells:
        got = [x["name"] for x in mf.metrics_of(m, w, False)]
        assert "setup_s" in got and len(got) >= 2
        assert mf.metrics_of(m, w, True)
    assert len(str(m)) < 64 * 1024


def test_import_guard_compares_whole_top_level_names():
    mods = ["jax.numpy", "jaxlib", "flax.linen", "repro.core", "repro",
            "repro_torch.core", "jaxtyping", "reproducible", "torch"]
    assert banned_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib",
                                    "repro", "repro.core"]
    assert banned_modules(["repro_torch", "bench.harness"]) == []


def test_percentile_is_nearest_rank():
    p95 = mf.metric_reader("superstep_p95_ms").p95
    assert p95([5.0]) == 5.0
    assert p95(list(range(1, 101))) == 95
    assert p95(list(range(1, 21))) == 19
    assert math.isclose(p95([0.1, 0.2]), 0.2)
