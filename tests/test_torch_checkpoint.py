"""Checkpoints, recovery and the chaos harness of the port (paper
Sections 5.5 and 5.7) on the CPU: snapshots that either package reads
from the other, the elastic repartition against the reference's,
resume and supervised recovery against the uninterrupted run, and the
host-driver cases of tests/test_faults.py and test_checkpoint_ft.py with
the port's own ``faults``."""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import os

import numpy as np
import pytest
import torch

import repro.core as J
import repro.graph as JG
import repro.runtime.checkpoint as jck
import repro_torch.core as T
import repro_torch.graph as TG
from repro_torch.runtime import faults
from repro_torch.runtime.checkpoint import (CheckpointCorruption,
                                            checkpoints, latest_checkpoint,
                                            load_checkpoint, repartition,
                                            save_checkpoint)
from repro_torch.runtime.failure import (FailureManager, StragglerMonitor,
                                         WorkerFailure)
from repro_torch.storage.spillfile import PageCorruption

N = 120
EDGES = TG.rmat_graph(N, 700, seed=3)


@pytest.fixture(autouse=True)
def _disarm():
    """Every test starts and ends with the chaos harness off."""
    faults.clear()
    yield
    faults.clear()


def _vert(P=4, vd=2):
    return T.load_graph(EDGES, N, P, value_dims=vd, device="cpu")


def _vals(res):
    return T.gather_values(res.vertex, N)[:, 0]


def _same(a: np.ndarray, b: np.ndarray, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8)), what


def _rels_same(jrels, trels):
    for jrel, trel in zip(jrels, trels):
        for f in dataclasses.fields(trel):
            _same(np.asarray(getattr(jrel, f.name)),
                  getattr(trel, f.name).numpy(), f.name)


# ------------------------------------------------------------- the format

def test_port_snapshot_read_by_jax(tmp_path):
    pr = TG.PageRank(N, iterations=6)
    seen = {}

    def keep(i, v, m, g, rec):
        seen[i] = (v, m, g)

    T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=6,
               checkpoint_every=2, checkpoint_dir=str(tmp_path),
               on_superstep=keep)
    path = str(tmp_path / "ckpt_000004.npz")
    _rels_same(jck.load_checkpoint(path), seen[4])
    assert jck.latest_checkpoint(str(tmp_path), verify=True) == \
        latest_checkpoint(str(tmp_path), verify=True)


def test_jax_snapshot_read_by_port(tmp_path):
    sp = JG.SSSP(source=0)
    J.run_host(J.load_graph(EDGES, N, P=4, value_dims=1), sp,
               sp.suggested_plan, max_supersteps=6, checkpoint_every=2,
               checkpoint_dir=str(tmp_path))
    path = jck.latest_checkpoint(str(tmp_path), verify=True)
    assert latest_checkpoint(str(tmp_path), verify=True) == path
    _rels_same(jck.load_checkpoint(path), load_checkpoint(path, "cpu"))


@pytest.mark.parametrize("new_P", [3, 5])
def test_repartition_equals_jax(tmp_path, new_P):
    pr = JG.PageRank(N, iterations=6)
    J.run_host(J.load_graph(EDGES, N, P=4, value_dims=2), pr,
               pr.suggested_plan, max_supersteps=4, checkpoint_every=3,
               checkpoint_dir=str(tmp_path))
    path = str(tmp_path / "ckpt_000003.npz")
    jv, jm, _ = jck.load_checkpoint(path)
    tv, tm, _ = load_checkpoint(path, "cpu")
    _rels_same(jck.repartition(jv, jm, new_P),
               repartition(tv, tm, new_P))


def test_regrow_end_pads_a_repartitioned_inbox():
    from repro_torch.core.driver import _regrow_msgs
    ec = T.EngineConfig(n_parts=3, bucket_cap=4)
    msg = T.MsgRel(dst=torch.arange(10, dtype=torch.int32).reshape(2, 5),
                   payload=torch.ones((2, 5, 1)),
                   valid=torch.ones((2, 5), dtype=torch.bool))
    out = _regrow_msgs(msg, ec)
    assert out.capacity == 12
    assert out.dst[0].tolist() == [0, 1, 2, 3, 4] + [-1] * 7
    assert out.valid.sum() == 10 and out.payload.sum() == 10


# ------------------------------------------------------------- resume

@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
def test_resume_equals_uninterrupted(tmp_path, algo):
    prog = TG.SSSP(source=0) if algo == "sssp" else \
        TG.PageRank(N, iterations=8)
    vd = 1 if algo == "sssp" else 2
    full = T.run_host(_vert(vd=vd), prog, prog.suggested_plan,
                      max_supersteps=12, checkpoint_every=3,
                      checkpoint_dir=str(tmp_path))
    res = T.run_host(_vert(vd=vd), prog, prog.suggested_plan,
                     max_supersteps=12,
                     resume_from=str(tmp_path / "ckpt_000003.npz"))
    assert res.supersteps == full.supersteps
    if algo == "sssp":
        assert np.array_equal(_vals(res), _vals(full))
    else:
        assert np.allclose(_vals(res), _vals(full), atol=1e-6)


def test_failure_injector_recovers_elastically(tmp_path):
    """A one-shot injector raises WorkerFailure(1) after superstep 5:
    the supervisor restores the superstep-3 snapshot onto 3 partitions
    and the replay converges to the uninterrupted distances."""
    sp = TG.SSSP(source=0)
    clean = T.run_host(_vert(vd=1), sp, sp.suggested_plan,
                       max_supersteps=30)
    fired = []

    def inject(i, v, m, g):
        if i == 5 and not fired:
            fired.append(i)
            raise WorkerFailure(1, "injected")

    res = T.run_host(_vert(vd=1), sp, sp.suggested_plan, max_supersteps=30,
                     checkpoint_every=3, checkpoint_dir=str(tmp_path),
                     recover=True, failure_injector=inject)
    assert len(res.recovery) == 1
    ev = res.recovery[0]
    assert ev["restored_from"] == str(tmp_path / "ckpt_000003.npz")
    assert ev["healthy_workers"] == 3 and ev["blacklist"] == [1]
    assert res.vertex.num_partitions == 3
    assert np.array_equal(_vals(res), _vals(clean))


def test_application_error_forwarded_not_retried(tmp_path):
    pr = TG.PageRank(N, iterations=4)
    calls = []

    def boom(i, v, m, g, rec):
        calls.append(i)
        if i == 2:
            raise ValueError("application bug")

    with pytest.raises(ValueError):
        T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=8,
                   checkpoint_every=1, checkpoint_dir=str(tmp_path),
                   recover=True, on_superstep=boom)
    assert calls == [1, 2]


# ------------------------------------------------------------- failure
# manager (tests/test_checkpoint_ft.py, test_faults.py)

def test_failure_manager_blacklist_and_recovery():
    fm = FailureManager(n_workers=4)
    calls = {"n": 0}

    def run_fn(n_workers):
        calls["n"] += 1
        if calls["n"] == 1:
            raise WorkerFailure(worker=2, msg="powered off")
        assert n_workers == 3
        return "done"

    restored = {}
    assert fm.run_with_recovery(
        run_fn, lambda n: restored.setdefault("n", n)) == "done"
    assert fm.blacklist == {2} and restored["n"] == 3


def test_failure_manager_forwards_application_errors():
    fm = FailureManager(n_workers=2)

    def run_fn(n):
        raise ValueError("user bug")

    with pytest.raises(ValueError):
        fm.run_with_recovery(run_fn, lambda n: None)
    assert not fm.events[0]["recoverable"]


def test_failure_manager_blacklists_repeat_offender():
    fm = FailureManager(n_workers=4, max_retries=3)
    assert fm.record(OSError("EIO"), worker=1)
    assert fm.record(OSError("EIO"), worker=1)
    assert 1 not in fm.blacklist          # two strikes: benefit of doubt
    assert fm.record(PageCorruption("p.npy"), worker=1)
    assert 1 in fm.blacklist              # third recoverable failure
    assert fm.healthy_workers() == 3
    assert fm.record(WorkerFailure(2, "power off"))
    assert 2 in fm.blacklist
    assert not fm.record(ValueError("bug"), worker=3)
    assert 3 not in fm.blacklist
    assert fm.record(CheckpointCorruption("c.npz", "bad"), worker=0)


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0)
    for i in range(5):
        assert mon.observe(i, 0.1) is None
    flag = mon.observe(5, 0.5)
    assert flag and flag["action"] == "flag-straggler"
    assert mon.observe(6, 0.15) is None


# ------------------------------------------------------------- injector

def test_injector_count_determinism():
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="spill.read", kind="transient",
                         after=2, times=2)]))
    outcomes = []
    for _ in range(6):
        try:
            faults.hit("spill.read", "page.npy")
            outcomes.append("ok")
        except faults.InjectedFault:
            outcomes.append("fault")
    assert outcomes == ["ok", "ok", "fault", "fault", "ok", "ok"]
    s = faults.summary()
    assert s["specs"][0]["hits"] == 6 and s["specs"][0]["fired"] == 2
    faults.clear()
    faults.hit("spill.read", "page.npy")   # disarmed: no-op


def test_injector_match_and_sites():
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="spill.write", kind="permanent", times=0,
                         match="value")]))
    faults.hit("spill.write", "edge_src_0.npy")       # no match: passes
    with pytest.raises(faults.InjectedFault):
        faults.hit("spill.write", "value_1.npy")
    with pytest.raises(ValueError):
        faults.FaultSpec(site="not-a-site")
    with pytest.raises(ValueError):
        faults.FaultSpec(site="spill.read", kind="not-a-kind")


def test_worker_failure_at_superstep():
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="superstep", kind="worker", superstep=3,
                         worker=2, match="ooc")]))
    faults.superstep_tick(3, "host")      # wrong driver: passes
    faults.superstep_tick(2, "ooc")       # wrong superstep: passes
    with pytest.raises(WorkerFailure) as ei:
        faults.superstep_tick(3, "ooc")
    assert ei.value.worker == 2
    faults.superstep_tick(3, "ooc")       # times=1: consumed


def test_plan_env_roundtrip(tmp_path, monkeypatch):
    plan = faults.FaultPlan(seed=7, faults=[
        faults.FaultSpec(site="spill.read", kind="transient", times=2),
        faults.FaultSpec(site="superstep", kind="worker", superstep=5,
                         worker=1)])
    assert faults.FaultPlan.from_json(plan.to_json()) == plan
    monkeypatch.setenv(faults.ENV_PLAN, plan.to_json())
    inj = faults.install_from_env()
    assert inj is not None and inj.plan == plan
    p = tmp_path / "plan.json"
    p.write_text(plan.to_json())
    monkeypatch.setenv(faults.ENV_PLAN, str(p))
    assert faults.install_from_env().plan == plan
    monkeypatch.delenv(faults.ENV_PLAN)
    assert faults.install_from_env() is None


# ------------------------------------------------------------- validity

def test_crash_mid_npz_checkpoint(tmp_path):
    """The injector kills the writer between payload and COMMIT sidecar;
    recovery restores the PREVIOUS committed snapshot."""
    pr = TG.PageRank(N, iterations=6)
    clean = T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=10)
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="checkpoint.commit", kind="permanent",
                         times=1, match="ckpt_000004")]))
    res = T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=10,
                     checkpoint_every=2, checkpoint_dir=str(tmp_path),
                     recover=True)
    assert res.recovery and res.recovery[0]["restored_from"] \
        == str(tmp_path / "ckpt_000002.npz")
    assert np.allclose(_vals(res), _vals(clean), atol=1e-6)


def test_partial_npz_never_selected(tmp_path):
    pr = TG.PageRank(N, iterations=6)
    res = T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=6,
                     checkpoint_every=2, checkpoint_dir=str(tmp_path))
    assert res.supersteps >= 4
    good = latest_checkpoint(str(tmp_path))
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="checkpoint.commit", kind="permanent")]))
    gv, gm, ggs = load_checkpoint(good, "cpu")
    with pytest.raises(faults.InjectedFault):
        save_checkpoint(str(tmp_path), 99, gv, gm, ggs)
    faults.clear()
    assert (tmp_path / "ckpt_000099.npz").exists()
    assert latest_checkpoint(str(tmp_path)) == good
    assert all("000099" not in c for c in checkpoints(str(tmp_path)))


def test_corrupt_npz_fails_over_to_previous(tmp_path):
    pr = TG.PageRank(N, iterations=6)
    T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=6,
               checkpoint_every=2, checkpoint_dir=str(tmp_path))
    newest = latest_checkpoint(str(tmp_path))
    raw = bytearray((tmp_path / os.path.basename(newest)).read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (tmp_path / os.path.basename(newest)).write_bytes(bytes(raw))
    assert latest_checkpoint(str(tmp_path), verify=True) != newest
    with pytest.raises(CheckpointCorruption):
        load_checkpoint(newest, "cpu")


def test_host_recovery_elastic(tmp_path):
    """WorkerFailure blacklists a worker; the host driver re-partitions
    the latest checkpoint onto the survivors (P=4 -> P=3) and
    converges."""
    pr = TG.PageRank(N, iterations=8)
    clean = T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=12)
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="superstep", kind="worker", superstep=5,
                         worker=2, match="host", times=1)]))
    res = T.run_host(_vert(), pr, pr.suggested_plan, max_supersteps=12,
                     checkpoint_every=2, checkpoint_dir=str(tmp_path),
                     recover=True)
    assert len(res.recovery) == 1
    assert res.recovery[0]["blacklist"] == [2]
    assert res.vertex.num_partitions == 3
    assert np.allclose(_vals(res), _vals(clean), atol=1e-6)
