"""Out-of-core checkpoints of the port on the CPU: the directory snapshot
(pages with their CRC trailer, ``gs.npz``, ``meta.json``, ``COMMIT.json``)
is the reference's format, so a snapshot written by either package
resumes in the other and ends on the uninterrupted run (exact for SSSP,
rtol 1e-5 for PageRank). Resume, crash mid-checkpoint, recovery from a
WorkerFailure and from corrupt pages, and the planner's hysteresis state
carried in the meta."""
import json

import numpy as np
import pytest

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from repro.core.ooc import run_out_of_core as j_ooc
from repro_torch.core.ooc import run_out_of_core
from repro_torch.runtime import faults
from repro_torch.runtime.checkpoint import (latest_ooc_checkpoint,
                                            ooc_checkpoints,
                                            verify_ooc_checkpoint)

N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
PROGS = {
    "sssp": (lambda: JG.SSSP(source=3), lambda: TG.SSSP(source=3), 1),
    "pagerank": (lambda: JG.PageRank(N, iterations=8),
                 lambda: TG.PageRank(N, iterations=8), 2),
}


@pytest.fixture(autouse=True)
def _disarm():
    faults.clear()
    yield
    faults.clear()


def _vert(vd):
    return T.load_graph(EDGES, N, 4, value_dims=vd, device="cpu")


def _vals(res):
    return T.gather_values(res.vertex, N)


def _run(algo, **kw):
    _, mk, vd = PROGS[algo]
    kw.setdefault("max_supersteps", 30)
    vert = kw.pop("vert", "new")
    return run_out_of_core(_vert(vd) if vert == "new" else vert, mk(),
                           mk().suggested_plan, budget_partitions=2,
                           device="cpu", **kw)


def _close(algo, got, want):
    if algo == "sssp":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("disk", [False, True])
def test_resume_matches_uninterrupted(disk, tmp_path):
    kw = dict(disk_dir=str(tmp_path / "spill1")) if disk else {}
    full = _run("sssp", checkpoint_every=2,
                checkpoint_dir=str(tmp_path / "ckpt"), **kw)
    ck = tmp_path / "ckpt" / "ooc_000002"
    assert (ck / "vid_0.npy").exists() and (ck / "inbox_dst_1.npy").exists()
    assert verify_ooc_checkpoint(ck) == []
    kw = dict(disk_dir=str(tmp_path / "spill2")) if disk else {}
    res = _run("sssp", vert=None, resume_from=str(ck), **kw)
    assert res.supersteps == full.supersteps
    assert np.array_equal(_vals(res), _vals(full))


@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(algo, writer, tmp_path):
    """A snapshot written by one package resumes in the other; both end
    on the writer's uninterrupted run."""
    mk_j, mk_t, vd = PROGS[algo]
    ck = tmp_path / "ckpt"
    if writer == "jax":
        full = j_ooc(J.load_graph(EDGES, N, P=4, value_dims=vd), mk_j(),
                     mk_j().suggested_plan, budget_partitions=2,
                     max_supersteps=30, checkpoint_every=3,
                     checkpoint_dir=str(ck))
        want, steps = J.gather_values(full.vertex, N), full.supersteps
        res = run_out_of_core(None, mk_t(), mk_t().suggested_plan,
                              budget_partitions=2, max_supersteps=30,
                              resume_from=str(ck / "ooc_000003"),
                              device="cpu")
        got = _vals(res)
    else:
        full = _run(algo, checkpoint_every=3, checkpoint_dir=str(ck))
        want, steps = _vals(full), full.supersteps
        res = j_ooc(None, mk_j(), mk_j().suggested_plan,
                    budget_partitions=2, max_supersteps=30,
                    resume_from=str(ck / "ooc_000003"))
        got = J.gather_values(res.vertex, N)
    assert res.supersteps == steps
    _close(algo, got, want)


def test_crash_mid_checkpoint_is_skipped(tmp_path):
    """The writer dies between the pages and the manifest at superstep
    4: the partial directory is never selected, and a resume pointed at
    the parent lands on superstep 2's snapshot and the clean result."""
    clean = _run("pagerank", max_supersteps=10)
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="checkpoint.commit", kind="permanent",
                         after=1, times=1)]))
    ck = tmp_path / "ckpt"
    with pytest.raises(faults.InjectedFault):
        _run("pagerank", max_supersteps=10, checkpoint_every=2,
             checkpoint_dir=str(ck))
    faults.clear()
    assert (ck / "ooc_000004").is_dir()
    assert not (ck / "ooc_000004" / "COMMIT.json").exists()
    assert str(ck / "ooc_000004") not in ooc_checkpoints(str(ck))
    assert latest_ooc_checkpoint(str(ck)) == str(ck / "ooc_000002")
    res = _run("pagerank", vert=None, max_supersteps=10,
               resume_from=str(ck))
    assert np.array_equal(_vals(res), _vals(clean))


def test_recover_from_worker_failure_and_corrupt_snapshot(tmp_path):
    """Transient disk reads, one corrupt page in snapshot 4, and worker 1
    failing at superstep 4 under recover=True: the supervisor rejects
    the corrupt snapshot, restores superstep 3's, and the replay ends on
    the unfailed run bit for bit."""
    clean = _run("sssp", max_supersteps=12,
                 disk_dir=str(tmp_path / "clean"))
    faults.install(faults.FaultPlan(seed=42, faults=[
        faults.FaultSpec(site="spill.read", kind="transient", times=2),
        faults.FaultSpec(site="page.corrupt", kind="corrupt", times=1,
                         match="inbox_dst_4"),
        faults.FaultSpec(site="superstep", kind="worker", superstep=4,
                         worker=1, match="ooc", times=1)]))
    res = _run("sssp", max_supersteps=12, disk_dir=str(tmp_path / "chaos"),
               checkpoint_every=1, checkpoint_dir=str(tmp_path / "ckpt"),
               recover=True)
    summ = faults.summary()
    assert [s["fired"] for s in summ["specs"]] == [2, 1, 1]
    assert len(res.recovery) == 1
    assert res.recovery[0]["restored_from"] == \
        str(tmp_path / "ckpt" / "ooc_000003")
    assert np.array_equal(_vals(res), _vals(clean))


def test_resume_budget_partition_mismatch_raises(tmp_path):
    _run("sssp", max_supersteps=4, checkpoint_every=2,
         checkpoint_dir=str(tmp_path))
    _, mk, _ = PROGS["sssp"]
    with pytest.raises(ValueError, match="super-partition"):
        run_out_of_core(None, mk(), mk().suggested_plan,
                        budget_partitions=1, max_supersteps=10,
                        resume_from=str(tmp_path), device="cpu")


# ------------------------------------------- the planner in the checkpoint

def test_auto_checkpoint_carries_plan_and_controller_state(tmp_path):
    """plan='auto': the meta records the plan in effect and the
    controller's hysteresis state; an auto resume restarts from that plan
    and ends on the uninterrupted distances."""
    _, mk, _ = PROGS["sssp"]
    full = run_out_of_core(_vert(1), mk(), "auto", budget_partitions=2,
                           max_supersteps=30, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path), device="cpu")
    meta = json.loads((tmp_path / "ooc_000002" / "meta.json").read_text())
    assert meta["plan"] is not None and "storage" in meta["plan"]
    assert {"want", "streak", "last_switch", "last_recal",
            "stall_ewma"} <= set(meta["controller"])
    res = run_out_of_core(None, mk(), "auto", budget_partitions=2,
                          max_supersteps=30,
                          resume_from=str(tmp_path / "ooc_000002"),
                          device="cpu")
    assert res.initial_plan == T.PhysicalPlan(**meta["plan"])
    assert np.array_equal(_vals(res), _vals(full))


def test_controller_state_roundtrip_mid_patience():
    """state_dict/load_state carry a half-served patience window: the
    restored controller switches after ONE more preferring superstep,
    as the reference's does (tests/test_pipeline.py)."""
    from repro_torch.planner import AdaptiveConfig, GraphStats
    from repro_torch.planner.adaptive import AdaptiveController
    from repro_torch.planner.cost import CPU_MACHINE
    from repro_torch.planner.stats import SuperstepStats
    g = GraphStats(n_vertices=100_000, n_edges=800_000, n_partitions=8,
                   vertex_capacity=16_250, edge_capacity=100_000)
    prog = TG.SSSP(source=0)
    cfg = AdaptiveConfig(patience=2, cooldown=0, min_superstep=0)
    full = T.PhysicalPlan(join="full_outer")
    rec = lambda i: SuperstepStats(superstep=i, active=50,
                                   frontier_density=50 / 100_000)
    mk = lambda: AdaptiveController(prog, g, full, cfg,
                                    machine=CPU_MACHINE)
    c1 = mk()
    assert c1.observe(rec(3)) is None          # streak 1 of 2
    state = json.loads(json.dumps(c1.state_dict()))   # through the meta
    assert state["want"] is not None and state["streak"] == 1
    c2 = mk()
    c2.load_state(state)
    switched = c2.observe(rec(4))
    assert switched is not None and switched.join == "left_outer"
    assert mk().observe(rec(4)) is None        # a fresh one still waits
