"""The port's sharded driver (``repro_torch.core.sharded.run_sharded``)
on the CPU: gloo ranks spawned once for the module (a ``RankPool`` of 4)
and the plain kernel versions.

* PageRank / SSSP / CC x both connectors, P = 8 over 2 ranks, and SSSP
  over 4 ranks: vertex values equal the port's ``run_host`` bit for bit
  (the all-to-all plus the destination-major reorder is the emulated
  transpose, element for element), and JAX's ``run_host`` to the port's
  contract: integers, booleans, min and max exact; sums rtol 1e-5, atol
  1e-7. The all-reduced aggregate (which no program's values read)
  agrees with run_host's to rtol 1e-6, atol 1e-6.
* JAX's own ``run_sharded`` (in a subprocess with two host devices, the
  only way to give JAX two devices beside this process's one): PageRank
  on the merging connector over 2 devices, values within rtol 1e-5,
  atol 1e-7 and the same superstep count; SSSP on a 40x40 lattice under
  plan="auto": the same plan and plan switches (none: both
  sharded drivers price the network axis, and JAX's ``run_host``, which
  does not, switches at superstep 3) and equal distances.
* ``exchange_all_to_all(dst_major=True)`` equals ``exchange_emulated``
  element for element; the raw worker-major layout is its permutation.
* mutating programs in memory (resurrection under hash and range
  partitioning, inserts across ranks with a regrow, PathMerge's
  deletions): every field bit for bit run_host's.
* recovery: a worker failure after superstep 5 re-meshes 2 -> 1 ranks
  and equals the uninterrupted run; an indivisible P is refused; inside
  an initialized process group it runs in place as each rank;
  ``pregel_run --devices 2 --device cpu`` prints the exchange line and
  equals the single-device run.
"""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.graph as JG
import repro_torch.core as T
import repro_torch.graph as TG
from repro_torch.core import connector
from repro_torch.core.sharded import RankPool, run_sharded
from repro_torch.runtime import faults

ROOT = Path(__file__).resolve().parents[1]
N = 220
EDGES = TG.rmat_graph(N, 1200, seed=7)
ALGOS = {
    "pagerank": (lambda: JG.PageRank(N, iterations=6),
                 lambda: TG.PageRank(N, iterations=6), 2),
    "sssp": (lambda: JG.SSSP(source=3), lambda: TG.SSSP(source=3), 1),
    "cc": (JG.ConnectedComponents, TG.ConnectedComponents, 1),
}
CONNECTORS = ("partitioning", "partitioning_merging")
SIDE = 40
_REF = {}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu") as p:
        yield p


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    yield
    faults.clear()


def _plan(algo, connector_, jax=False):
    mk_j, mk_t, _ = ALGOS[algo]
    prog = mk_j() if jax else mk_t()
    kw = dict(kernel_impl="ref") if jax else {}
    return dataclasses.replace(prog.suggested_plan, connector=connector_,
                               **kw)


def _vert(algo, P=8):
    return T.load_graph(EDGES, N, P, value_dims=ALGOS[algo][2],
                        device="cpu")


def _refs(algo, connector_):
    """(port run_host values, JAX run_host values), P = 8."""
    key = (algo, connector_)
    if key not in _REF:
        mk_j, mk_t, vd = ALGOS[algo]
        t = T.run_host(_vert(algo), mk_t(), _plan(algo, connector_),
                       max_supersteps=30)
        j = J.run_host(J.load_graph(EDGES, N, 8, value_dims=vd), mk_j(),
                       _plan(algo, connector_, jax=True),
                       max_supersteps=30)
        _REF[key] = (T.gather_values(t.vertex, N), t.supersteps,
                     np.asarray(J.gather_values(j.vertex, N)),
                     j.supersteps, t.gs.aggregate.numpy())
    return _REF[key]


def _hold_to_jax(algo, got, want):
    if algo == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("connector_", CONNECTORS)
def test_sharded_matches_host(algo, connector_, pool):
    """P = 8 over 2 ranks: bit for bit the port's run_host, and JAX's
    run_host to the contract."""
    t_vals, t_steps, j_vals, j_steps, t_agg = _refs(algo, connector_)
    res = run_sharded(_vert(algo), ALGOS[algo][1](),
                      _plan(algo, connector_), devices=2,
                      max_supersteps=30, pool=pool)
    got = T.gather_values(res.vertex, N)
    assert np.array_equal(got, t_vals)
    assert res.supersteps == t_steps == j_steps > 1
    _hold_to_jax(algo, got, j_vals)
    # the aggregate is all-reduced: the ranks' partial sums add in
    # another order than run_host's one sum, so it agrees to rounding
    np.testing.assert_allclose(res.gs.aggregate.numpy(), t_agg, rtol=1e-6,
                               atol=1e-6)
    recs = [s for s in res.stats if "exchange_stall_s" in s]
    assert len(recs) == res.supersteps
    assert all(s["n_workers"] == 2 and s["sharded"] and
               s["transport"] == "gloo" for s in recs)
    assert all(s["exchange_bytes"] > 0 for s in recs)
    assert all(s["metrics"]["exchange.stall_s"] >= 0 for s in recs)
    assert [w["rank"] for w in res.workers] == [0, 1]
    assert all(w["device"] == "cpu" and w["transport"] == "gloo"
               for w in res.workers)


def test_sharded_more_workers(pool):
    """The rank count is a pure execution knob: 4 ranks, same bits."""
    t_vals, _, j_vals, _, _ = _refs("sssp", "partitioning")
    res = run_sharded(_vert("sssp"), TG.SSSP(source=3),
                      TG.SSSP.suggested_plan, devices=4, max_supersteps=30,
                      pool=pool)
    got = T.gather_values(res.vertex, N)
    assert np.array_equal(got, t_vals) and np.array_equal(got, j_vals)
    assert len(res.workers) == 4
    assert all(s["n_workers"] == 4 for s in res.stats if "wall_s" in s)


class Lazarus(T.VertexProgram):
    """Deletes every odd vertex at superstep 0, then messages the dead,
    which re-creates them on their owner rank (resurrection mints the
    vid from the slot address: the rank's partition offset must be in
    it)."""
    value_dims = msg_dims = agg_dims = 1
    combine_op = "sum"
    mutates = True
    suggested_plan = T.PhysicalPlan(join="full_outer", groupby="scatter")

    def compute(self, vid, value, msg, has_msg, active, gs):
        halt = gs.superstep >= 2
        return T.ComputeOut(
            value=torch.where(has_msg, msg[..., 0], value[..., 0])[..., None],
            halt=halt.expand(vid.shape),
            send_gate=(gs.superstep == 1) & (vid % 2 == 0) & (vid >= 0),
            aggregate=torch.zeros(vid.shape + (1,)),
            delete_self=(gs.superstep == 0) & (vid % 2 == 1))

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return (src_vid + 100.0)[..., None]


class CrossInsert(T.VertexProgram):
    """At superstep 0 every vertex proposes an insert of (vid + 3) % n
    with value vid + 1000: proposals cross ranks inside the superstep."""
    value_dims = msg_dims = agg_dims = 1
    combine_op = "sum"
    mutates = True
    suggested_plan = T.PhysicalPlan(join="full_outer", groupby="scatter")

    def __init__(self, n):
        self.n = n

    def init_value(self, vid, out_degree, gs):
        return torch.where(vid >= 0, vid, 0).float()[..., None]

    def compute(self, vid, value, msg, has_msg, active, gs):
        first = gs.superstep == 0
        return T.ComputeOut(
            value=value, halt=(~first).expand(vid.shape),
            send_gate=torch.zeros(vid.shape, dtype=torch.bool),
            aggregate=torch.zeros(vid.shape + (1,)),
            insert_vid=torch.where(first & (vid >= 0), (vid + 3) % self.n,
                                   -1),
            insert_value=torch.where(vid >= 0, vid, 0).float()[..., None]
            + 1000.0)

    def send(self, src_vid, src_value, edge_val, dst_vid, gs):
        return torch.zeros_like(src_value[..., 0:1])


@pytest.mark.parametrize("case", ["lazarus-hash", "lazarus-range",
                                  "cross-insert", "path-merge"])
def test_sharded_mutations_match_host(case, pool):
    """Mutating programs in memory over 2 ranks (P = 8), every field of
    the relation bit for bit run_host's: resurrection under hash and
    range partitioning, inserts routed between ranks at a mutation_cap
    of 2 (so both drivers regrow it), and PathMerge's deletions."""
    n = 64
    edges, kw, ec_kw = TG.chain_graph(n), {}, {}
    if case.startswith("lazarus"):
        prog = Lazarus()
        kw = dict(partition=case.split("-")[1])
    elif case == "cross-insert":
        prog, edges = CrossInsert(N), EDGES
        n, ec_kw = N, dict(mutation_cap=2)
    else:
        prog = TG.PathMerge(rounds=10)
    vd = prog.value_dims
    plan = dataclasses.replace(prog.suggested_plan, **kw)
    load = lambda: T.load_graph(edges, n, 8, value_dims=vd, device="cpu",
                                **kw)
    ec = (dataclasses.replace(T.default_engine_config(load(), prog, plan),
                              **ec_kw) if ec_kw else None)
    want = T.run_host(load(), prog, plan, ec=ec, max_supersteps=30)
    got = run_sharded(load(), prog, plan, ec=ec, devices=2,
                      max_supersteps=30, pool=pool)
    assert got.supersteps == want.supersteps
    for f in ("vid", "halt", "value", "edge_src", "edge_dst", "edge_val"):
        assert torch.equal(getattr(got.vertex, f), getattr(want.vertex, f))
    ev = lambda r: [(s["event"], s.get("mutation_cap")) for s in r.stats
                    if "event" in s]
    assert ev(got) == ev(want)
    if case == "cross-insert":
        assert ev(got)
        assert np.array_equal(T.gather_values(got.vertex, N)[:, 0],
                              (np.arange(N) - 3) % N + 1000.0)


@pytest.mark.parametrize("dst_major", [True, False])
def test_exchange_all_to_all_is_the_emulated_transpose(dst_major, pool):
    """Random buckets (P = 8, C = 3, D = 2) over 4 ranks: the
    destination-major result is exchange_emulated's transpose element for
    element; the raw result holds (src rank j, row p) -> (local dst q) at
    [p, j*2 + q], the same runs reordered."""
    rng = np.random.default_rng(0)
    P, C, D, n = 8, 3, 2, 4
    d = torch.from_numpy(rng.integers(-1, 100, (P, P, C)).astype(np.int32))
    p = torch.from_numpy(rng.standard_normal((P, P, C, D))
                         .astype(np.float32))
    v = torch.from_numpy(rng.random((P, P, C)) < 0.5)
    want = connector.exchange_emulated(d, p, v)
    Pl = P // n
    outs = pool.map(functools.partial(connector.exchange_all_to_all,
                                      dst_major=dst_major),
                    [(d[w * Pl:(w + 1) * Pl], p[w * Pl:(w + 1) * Pl],
                      v[w * Pl:(w + 1) * Pl]) for w in range(n)])
    for k in range(3):
        parts = [o[k] for o in outs]
        if not dst_major:     # [p, j, q] -> [q, j, p]
            parts = [o.reshape((Pl, n, Pl) + o.shape[2:]).transpose(0, 2)
                     .reshape((Pl, P) + o.shape[2:]) for o in parts]
        got = torch.cat(parts)
        assert got.dtype == want[k].dtype
        assert torch.equal(got, want[k])


def test_sharded_rejects_indivisible():
    with pytest.raises(ValueError, match="divide"):
        run_sharded(_vert("sssp", P=6), TG.SSSP(source=3), devices=4)


def test_sharded_recovery_remeshes_two_to_one(pool, tmp_path):
    """A WorkerFailure(1) raised in both ranks at superstep 5 reaches the
    supervisor as itself: worker 1 is blacklisted, the superstep-3
    snapshot is restored onto one rank, and the replay equals the
    uninterrupted run bit for bit. The injector fires once."""
    inj = faults.install(faults.FaultPlan(faults=[faults.FaultSpec(
        site="superstep", kind="worker", superstep=5, worker=1,
        match="sharded")]))
    res = run_sharded(_vert("sssp"), TG.SSSP(source=3),
                      TG.SSSP.suggested_plan, devices=2, max_supersteps=30,
                      checkpoint_every=3, checkpoint_dir=str(tmp_path),
                      recover=True, pool=pool)
    t_vals, t_steps, _, _, _ = _refs("sssp", "partitioning")
    assert np.array_equal(T.gather_values(res.vertex, N), t_vals)
    assert res.supersteps == t_steps
    (ev,) = res.recovery
    assert "WorkerFailure" in ev["error"]
    assert ev["healthy_workers"] == 1 and ev["blacklist"] == [1]
    assert ev["restored_from"].endswith("ckpt_000003.npz")
    assert len(res.workers) == 1
    assert inj.summary()["specs"][0]["fired"] == 1
    # the snapshot is the reference's npz format: the JAX package reads it
    from repro.runtime.checkpoint import load_checkpoint
    jv, _, jg = load_checkpoint(ev["restored_from"])
    assert jv.num_partitions == 8 and int(jg.superstep) == 3


def test_sharded_snapshot_is_every_ranks_boundary(pool, tmp_path):
    """Rank 0 writes the snapshot; rank 1 must not run on and fail before
    it commits. The commit is held 2 s (a planned delay) against a pool
    that waits only 0.5 s for the other ranks after a failure: the
    failure at superstep 3 still restores the superstep-3 snapshot."""
    faults.install(faults.FaultPlan(faults=[
        faults.FaultSpec(site="checkpoint.commit", kind="delay",
                         delay_s=2.0),
        faults.FaultSpec(site="superstep", kind="worker", superstep=3,
                         worker=1, match="sharded")]))
    grace, pool.error_grace_s = pool.error_grace_s, 0.5
    try:
        res = run_sharded(_vert("sssp"), TG.SSSP(source=3),
                          TG.SSSP.suggested_plan, devices=2,
                          max_supersteps=30, checkpoint_every=3,
                          checkpoint_dir=str(tmp_path), recover=True,
                          pool=pool)
    finally:
        pool.error_grace_s = grace
    (ev,) = res.recovery
    assert ev["restored_from"].endswith("ckpt_000003.npz")
    t_vals, _, _, _, _ = _refs("sssp", "partitioning")
    assert np.array_equal(T.gather_values(res.vertex, N), t_vals)


def _in_place_rank(rank, init, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    try:
        res = run_sharded(_vert("sssp"), TG.SSSP(source=3),
                          TG.SSSP.suggested_plan, max_supersteps=30)
        np.save(f"{out}/rank{rank}.npy", T.gather_values(res.vertex, N))
        assert res.stats[-1]["n_workers"] == 2
    finally:
        dist.destroy_process_group()


def test_sharded_in_place_under_a_process_group(tmp_path):
    """Called inside an initialized group (two processes joined here as
    torchrun would join them), run_sharded runs in place as each rank,
    on its rows of the rank's own relation, and every rank gets the
    whole result: run_host's, bit for bit."""
    ctx = torch.multiprocessing.get_context("spawn")
    init = f"file://{tmp_path}/store"
    procs = [ctx.Process(target=_in_place_rank,
                         args=(w, init, str(tmp_path))) for w in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert [p.exitcode for p in procs] == [0, 0]
    t_vals, _, _, _, _ = _refs("sssp", "partitioning")
    for w in range(2):
        assert np.array_equal(np.load(tmp_path / f"rank{w}.npy"), t_vals)


def test_pregel_run_devices_prints_the_exchange_line(pool, capsys):
    """``--devices 2 --device cpu``: the reference's exchange line, and
    the single-device run's values."""
    from repro_torch.launch import pregel_run as cli
    argv = ["--algo", "sssp", "--parts", "8", "--device", "cpu"]
    one, _ = cli.run(cli.parse_args(argv), graph=(EDGES, N))
    two, _ = cli.run(cli.parse_args(argv + ["--devices", "2"]),
                     graph=(EDGES, N), pool=pool)
    out = capsys.readouterr().out
    assert "[sharded x2 devices, cpu]" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("exchange:"))
    assert f"over {two.supersteps} supersteps on 2 workers (gloo)" in line
    assert np.array_equal(T.gather_values(two.vertex, N),
                          T.gather_values(one.vertex, N))


# ---- JAX's own run_sharded, in a subprocess with two host devices ----

_JAX_SHARDED = r"""
import json, os, sys
import numpy as np
import repro.core as J, repro.graph as JG
from repro.core.sharded import run_sharded
from repro.graph.generators import grid_graph, rmat_graph
out = sys.argv[1]
N = 220
prog = JG.PageRank(N, iterations=6)
plan = prog.suggested_plan.__class__(**{**prog.suggested_plan.__dict__,
    "connector": "partitioning_merging", "kernel_impl": "ref"})
r = run_sharded(J.load_graph(rmat_graph(N, 1200, seed=7), N, 8,
                             value_dims=2), prog, plan, devices=2,
                max_supersteps=30)
pr = np.asarray(J.gather_values(r.vertex, N))
side = int(sys.argv[2])
a = run_sharded(J.load_graph(grid_graph(side), side * side, 8,
                             value_dims=1), JG.SSSP(source=0), "auto",
                devices=2, max_supersteps=100)
np.savez(out, pagerank=pr, sssp=np.asarray(J.gather_values(a.vertex,
                                                           side * side)))
json.dump({"pagerank_supersteps": r.supersteps,
           "auto_supersteps": a.supersteps,
           "auto_plan": {"join": a.plan.join, "groupby": a.plan.groupby,
                         "connector": a.plan.connector,
                         "sender_combine": a.plan.sender_combine},
           "auto_events": [[s["superstep"], s["event"]] for s in a.stats
                           if "event" in s]},
          open(out + ".json", "w"))
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_sharded") / "ref.npz")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    done = subprocess.run([sys.executable, "-c", _JAX_SHARDED, out,
                           str(SIDE)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    z = np.load(out)
    return dict(z), json.load(open(out + ".json"))


def test_sharded_matches_jax_run_sharded(jax_sharded, pool):
    """PageRank, merging connector, 2 ranks / 2 devices: rtol 1e-5,
    atol 1e-7 and the same superstep count."""
    vals, meta = jax_sharded
    prog = TG.PageRank(N, iterations=6)
    plan = dataclasses.replace(prog.suggested_plan,
                               connector="partitioning_merging")
    res = run_sharded(_vert("pagerank"), prog, plan, devices=2,
                      max_supersteps=30, pool=pool)
    np.testing.assert_allclose(T.gather_values(res.vertex, N),
                               vals["pagerank"], rtol=1e-5, atol=1e-7)
    assert res.supersteps == meta["pagerank_supersteps"]


def test_sharded_auto_plan_decides_as_the_reference(jax_sharded, pool):
    """plan="auto" on the lattice over 2 ranks: the plan and the plan
    events of JAX's run_sharded (the network axis prices both drivers
    the same way, and neither switches where JAX's run_host does), and
    distances equal to JAX's run_sharded and run_host."""
    vals, meta = jax_sharded
    n = SIDE * SIDE
    grid = TG.grid_graph(SIDE)
    res = run_sharded(T.load_graph(grid, n, 8, value_dims=1, device="cpu"),
                      TG.SSSP(source=0), "auto", devices=2,
                      max_supersteps=100, pool=pool)
    events = [[s["superstep"], s["event"]] for s in res.stats
              if "event" in s]
    assert events == meta["auto_events"]
    assert res.supersteps == meta["auto_supersteps"]
    for k, v in meta["auto_plan"].items():
        assert getattr(res.plan, k) == v
    if not any(e == "plan-switch" for _, e in events):
        assert res.initial_plan == res.plan
    d = T.gather_values(res.vertex, n)
    assert np.array_equal(d, vals["sssp"])
    jhost = J.run_host(J.load_graph(grid, n, 8, value_dims=1),
                       JG.SSSP(source=0), "auto", max_supersteps=100)
    assert np.array_equal(d, np.asarray(J.gather_values(jhost.vertex, n)))
