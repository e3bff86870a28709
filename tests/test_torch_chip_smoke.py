"""chip_smoke.py's phases 10 (mutations and the library programs), 11
(checkpoints and recovery), 12 (the planner) and 13 (out-of-core),
rehearsed on the CPU at a small graph500 scale through the port's plain
path: the same runs and the same checks against scipy and closed forms
as on the card, so a fault in the phases' own logic shows here and not
first on the card."""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import gather_values  # noqa: E402
from repro_torch.graph import SSSP, PageRank, graph500  # noqa: E402

SCALE = 10


def test_phases_10_and_11_on_the_cpu():
    edges, n = graph500(SCALE)
    values = {}
    for name, prog, vd in (("pagerank", PageRank(n, iterations=15), 2),
                           ("sssp", SSSP(source=0), 1)):
        res, _ = cs.drive(prog, edges, n, vd, "cpu", max_supersteps=60)
        values[name] = gather_values(res.vertex, n)
    pr_ref, hops = cs.check_main_path(values, edges, n)
    p10 = cs.mutations_and_programs(edges, n, hops, device="cpu", k=16,
                                    chain_scale=12)
    assert 0 < p10["kcore"]["core"] < n
    assert p10["path_merge"]["survivors"] < 2 ** 12
    assert p10["insert"]["regrows"]
    p11 = cs.checkpoints_and_recovery(edges, n, values, pr_ref, hops,
                                      device="cpu")
    assert p11["sssp_recovery"]["recovery"]["healthy_workers"] == 3
    kinds = [e["what"] for e in p11["checkpoint_io"]]
    assert kinds.count("savez_compressed") >= 2 and "repartition" in kinds
    assert np.isfinite(p11["pagerank_resume"]["max_abs_err_vs_uninterrupted"])


def test_phase_12_on_the_cpu():
    """Phase 12 (plan="auto") on the CPU: graph500-10 with its scipy
    references from graph_and_references (phase 11's set-up), and the
    lattice at side 32 instead of 1024 — the planner prices the CPU
    machine here, so the plans are the reference's CPU choices."""
    edges, n, values, pr_ref, hops = cs.graph_and_references(SCALE, "cpu")
    out = cs.planner_phase(edges, n, pr_ref, hops, device="cpu",
                           grid_side=32)
    assert "machine" not in out          # measured on the card only
    for prog in ("pagerank", "sssp"):
        c = out["calibrated"][prog]
        for k, (lo, hi) in cs.CLAMPS.items():
            assert lo <= c[k] <= hi
    grid = out["grid_auto"]
    assert grid["switches"] and grid["final_plan"].startswith("left_outer")
    assert grid["supersteps"] == out["grid_static"]["supersteps"]
    assert out["grid_static"]["initial_plan"] == \
        out["grid_static"]["final_plan"]
    assert out["grid_auto_calibrated"]["supersteps"] == grid["supersteps"]
    assert out["sssp"]["supersteps"] >= 1 and out["pagerank"]["supersteps"]


def test_phase_13_on_the_cpu():
    """Phase 13 (out-of-core) on the CPU at graph500-10 for both graphs:
    the same runs and checks as on the card (PageRank against scipy and
    run_host, SSSP against scipy, synchronous / disk tier / resumed
    against the streamed run, auto SSSP), without the card's launches,
    memory peak and profile."""
    big = cs.graph_and_references(SCALE, "cpu")
    out = cs.out_of_core_phase(big, big, device="cpu")
    assert out["pagerank_big"]["supersteps"] == 15
    assert out["pagerank_big"]["partitions"] == cs.OOC_P
    for label in ("pagerank_sync", "pagerank_disk", "pagerank_resumed"):
        assert out[label]["bit_equal_streamed"], label
    assert out["pagerank_disk"]["spill_write_bytes"] > 0
    assert 0.0 <= out["pagerank_disk"]["cache_hit_rate_median"] <= 1.0
    assert out["pagerank_resumed"]["resumed_supersteps"] == 5
    auto = out["sssp_auto"]
    assert auto["switches"] and auto["final_plan"].startswith("left_outer")
    assert "busy" not in out and "peak_allocated_bytes" not in \
        out["pagerank_big"]
