"""chip_smoke.py's phases 10 (mutations and the library programs), 11
(checkpoints and recovery), 12 (the planner), 13 (out-of-core), 14 (the
CLI), 15 (the sharded driver) and 16 (the production dry run and the
examples), rehearsed on the CPU at a small graph500 scale through the
port's plain path: the same runs and the same checks against scipy and closed forms
as on the card, so a fault in the phases' own logic shows here and not
first on the card. Phase 17 (the reduced decoders) runs as it does on the
card, with the CPU in the card's place."""
import _torch_threads  # noqa: F401  (first: see the module)
import sys
from pathlib import Path

import numpy as np
import pytest

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


def test_phase_14_on_the_cpu():
    """Phase 14 (the port's CLI in this process) on the CPU at
    graph500-10 for both graphs, with what its card run takes from phases
    3, 12 and 13 made here: phase 3's run_host stats, the switch
    supersteps of phase 12's auto SSSP and phase 13's streamed
    out-of-core PageRank with its peak pager bytes."""
    from repro_torch.core import load_graph
    edges, n = graph500(SCALE)
    phase3 = {}
    values = cs.run_main_path(edges, n, "cpu", phase3)
    pr_ref, hops = cs.check_main_path(values, edges, n)
    big = (edges, n, values, pr_ref, hops)
    _, auto = cs.planned_run(SSSP(source=0), edges, n, 1, "cpu")
    vert = load_graph(edges, n, cs.OOC_P, value_dims=2, device="cpu")
    res, _ = cs.ooc_run(PageRank(n, iterations=15), vert, "cpu")
    streamed = gather_values(res.vertex, n)[:, 0]
    peak = max(s["pager_peak_bytes"] for s in res.stats
               if "pager_peak_bytes" in s)
    out = cs.cli_phase(big, big, phase3=phase3,
                       sssp_switches=[sw[0] for sw in auto["switches"]],
                       ooc_streamed=streamed, pager_peak=peak,
                       device="cpu", scale=SCALE, small_scale=SCALE)
    pr = out["pagerank"]
    assert pr["supersteps"] == 15 and pr["superstep_spans"] >= 15
    assert pr["summary"]["supersteps"] == 15
    assert "max_memory_allocated" not in pr
    assert out["sssp"]["plan_switches_metric"] == len(auto["switches"])
    assert out["ooc_pagerank"]["fault_spans"] > 0
    assert out["recover_sssp"]["healthy_workers"] == 3
    assert out["recover_sssp"]["injected_fired"] == 1


def test_phase_15_on_the_cpu():
    """Phase 15 (run_sharded on one pool of 2 ranks) on the CPU at
    graph500-10 for every graph: one rank, two ranks, two ranks out of
    core, recovery 2 -> 1, and the CLI with --devices 2 on webmap-tiny (gloo
    throughout on the CPU; the card's NCCL runs are (a) and the
    replay of (d))."""
    big = cs.graph_and_references(SCALE, device="cpu")
    # SSSP takes 5 supersteps at graph500-10: the failure comes at 3
    out = cs.sharded_phase(big, big, device="cpu", fail_at=3,
                           dataset="webmap-tiny")
    assert set(out) == {"a_pagerank", "a_sssp", "b_pagerank", "b_sssp",
                        "c_pagerank_ooc", "d_sssp_recovered", "e_cli"}
    assert out["a_pagerank"]["bit_equal_phase3"]
    assert out["a_pagerank"]["n_workers"] == 1
    assert out["b_pagerank"]["bit_equal_run_host"]
    assert out["b_sssp"]["n_workers"] == 2
    assert all(st["transport"] == "gloo" for st in out.values())
    assert out["c_pagerank_ooc"]["exchange_bytes_per_superstep"] > 0
    rec = out["d_sssp_recovered"]
    assert rec["injected_fired"] == 1 and rec["n_workers"] == 1
    assert rec["recovery"][0]["healthy_workers"] == 1
    assert out["e_cli"]["exchange_line"].endswith(
        "supersteps on 2 workers (gloo)")


def test_phase_16_on_the_cpu():
    """Phase 16 on the CPU: the three dry-run subprocesses with each
    record held to the analytic figures, and the examples on --device
    cpu held to scipy; (b)'s reading needs phase 3's card peak, so it is
    left out (no max_memory_allocated in the CPU's phase-3 stats)."""
    out = cs.production_phase({}, device="cpu")
    assert "memory" not in out
    assert set(out["dryrun"]) == {f"{a}_{m}" for a in cs.DRYRUN_ALGOS
                                  for m in ("single", "multi")}
    assert out["dryrun"]["pagerank_single"]["collectives"][
        "all-to-all"] == 507_456_630
    assert out["examples"]["quickstart"]["reached"] > 0
    assert out["examples"]["pagerank_webmap"]["recovered_superstep"] == 10
    assert out["examples"]["path_merge_genomix"]["survivors"] == 100


def test_phase_17_on_the_cpu():
    """Phase 17 with the CPU against itself: the four reduced decoders,
    prompts 12 and 16 (and 6, within the window, where layers are
    local), teacher-forced decode, the int8 caches."""
    out = cs.decoders_card_vs_cpu(device="cpu")
    assert set(out) == set(cs.DECODERS)
    for arch, row in out.items():
        assert row["prompt_12"]["card_vs_cpu_max_abs_err"] == 0.0
        assert row["prompt_16"]["teacher_forced_max_abs_err"] <= 1e-4
    assert out["gemma3-12b"]["prompt_12"]["flash_launches"] == 0
    assert out["gemma3-12b"]["int8_prompt_12"]["codes_apart"] == 0
    assert "int8_prompt_12" not in out["zamba2-1.2b"]
    for arch in ("gemma3-12b", "h2o-danube-3-4b"):
        assert out[arch]["prompt_6"]["teacher_forced_max_abs_err"] <= 1e-4
    assert "prompt_6" not in out["falcon-mamba-7b"]


def test_phase_2_gradients_on_the_cpu(monkeypatch):
    """Phase 2's gradient parity walks its cases (here small ones; the
    plain version on both sides)."""
    monkeypatch.setattr(cs, "FLASH_GRAD_CASES", [
        (dict(B=2, S=40, H=4, KV=2, hd=32), True, "float32"),
        (dict(B=1, S=24, H=2, KV=2, hd=80), False, "float32")])
    monkeypatch.setattr(cs, "GMM_GRAD_CASES", [
        (300, 32, 48, 4, 4, "float32", [1, 150, 0, 149]),
        (200, 16, 24, 8, 5, "float32", False)])
    assert cs.flash_grad_parity("cpu") == 0.0
    assert cs.gmm_grad_parity("cpu") == 0.0


def test_phase_2_scatter_parity_on_the_cpu():
    """Phase 2's scatter group-by parity walks its cases at a small inbox
    (P = 4, Np = 5000; the plain chain on both sides), NaN rows
    included; the card's PageRank and SSSP runs of phase 3 each need a
    scatter_combine launch, which the CPU path never makes."""
    assert cs.scatter_parity("cpu", dict(P=4, Np=5000)) == 0.0
    cs.need_launches("pagerank", {"launches": {"scatter_combine": 0}},
                     ("scatter_combine",), "cpu")
    with pytest.raises(AssertionError, match="scatter_combine"):
        cs.need_launches("pagerank", {"launches": {"scatter_combine": 0}},
                         ("scatter_combine",), "cuda")


def test_phases_20_and_21_on_the_cpu():
    """Phases 20-21 at reduced size on the CPU: the trainer (4 steps of
    the reduced qwen2-moe, sort dispatch), the float32 step against the
    CPU (itself here), the resume check, hubert's encode and train steps,
    its float32 step, and internvl2 served with zero patch embeddings."""
    import dataclasses
    from repro_torch.configs import get_config
    qwen = cs.qwen_config().reduced()
    tr = cs.trainer_phase(qwen, steps=4, batch=2, seq=32, device="cpu")
    assert tr["loss"][-1] < tr["loss"][0] and len(tr["step_ms"]) == 4
    assert tr["launches"] == {"flash_attention": 0, "moe_gmm": 0}
    assert "profile" not in tr
    for cfg in (dataclasses.replace(qwen, num_layers=2),
                get_config("hubert-xlarge").reduced()):
        cmp = cs.train_card_vs_cpu(cfg, batch=2, seq=32, device="cpu")
        assert (cmp["params_rel_l2_max"] == cmp["update_rel_l2_max"]
                == cmp["loss_rel"] == 0.0)
    res = cs.resume_check(seq=32, device="cpu")
    assert res["resumed_steps"] == [3, 4]
    hub = cs.hubert_phase(get_config("hubert-xlarge").reduced(), batch=2,
                          seq=32, device="cpu")
    assert len(hub["train_loss"]) == 2 and hub["encode_flash_launches"] == 0
    vl = cs.internvl_phase(get_config("internvl2-76b").reduced(), batch=2,
                           prompt_len=16, max_new=3, device="cpu")
    assert len(vl["ids"]) == 3


def test_phase_22_on_the_cpu():
    """Phase 22 (c): the three configs at reduced size, the CPU in the
    card's place (CPU against CPU: ids equal, logits equal)."""
    out = cs.llm_card_vs_cpu("cpu")
    assert set(out) == set(cs.LLM_ARCHS)
    for row in out.values():
        assert row["card_vs_cpu_max_abs_err"] == 0.0


def test_phase_23_on_the_cpu(tmp_path):
    """Phase 23 as on the card (it needs none): the three decode_32k dry
    runs on 256 ranks, their argument bytes the JAX package's, and the
    one-rank count, here of a 2-layer stablelm-12b prefill at batch 2 x
    256 beside a stand-in card reading."""
    procs = cs.start_llm_dryruns(tmp_path)
    procs["one_rank"].communicate(timeout=300)
    cs.llm_count(str(tmp_path / "one_rank.json"), batch=2, seq=256)
    out = cs.finish_llm_dryruns(procs, tmp_path, card_gb=1.0)
    for arch in cs.LLM_ARCHS:
        assert out[arch]["flops_vs_jax"] > 0
        assert out[arch]["collective_vs_jax"] > 0
    one = out["one_rank_prefill"]
    assert one["batch"] == 2 and one["card_max_memory_allocated_gb"] == 1.0
    assert one["total_bytes"] > one["argument_bytes"] > 0
