"""The port's production dry run (``repro_torch.launch.pregel_run
--dryrun``) on the CPU, and the pieces it stands on: the meta state and
capacities against the JAX package's (``repro.launch.pregel_run``), the
operator counter's collective and memory figures, c10d's ``fake``
backend, the fold's meta route, the production mesh and the plan-name
check. Every figure is held exactly: these are counts, not speeds.

The JAX dry run itself (a 256-device lowering) is not run here; its
all-to-all bytes at the four (scale, mesh) pairs are the constants of
``A2A_BYTES`` (``hlo_cost`` on the reference's compiled superstep, the
sender-combine plan, D = 1)."""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses
import importlib
import types

import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import repro.core as JC
import repro.launch.pregel_run as jcli
import repro.planner as JP
import repro_torch.launch.pregel_run as tcli
from repro_torch.core import PhysicalPlan
from repro_torch.core.superstep import make_superstep
from repro_torch.launch import mesh, op_cost
from repro_torch.planner import CPU_MACHINE

# the wrapper's module (the package re-exports its function by that name)
SC = importlib.import_module(
    "repro_torch.kernels.segment_combine.segment_combine")

SCALES = ("paper-large", "bigger-4x")
MESHES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
CHIPS = {"single": 256, "multi": 512}
A2A_BYTES = {("paper-large", "single"): 507_456_630,
             ("paper-large", "multi"): 254_264_913,
             ("bigger-4x", "single"): 2_029_750_785,
             ("bigger-4x", "multi"): 1_016_903_286}
DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
          jnp.bool_: torch.bool}
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "kind", "chips",
                  "plan", "compile_s", "memory", "per_device", "roofline"}


@pytest.fixture(autouse=True)
def _no_default_group():
    """Every test starts and ends with no default process group."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _leaves(rel):
    return {k: getattr(rel, k) for k in rel.__dataclass_fields__}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("algo", tcli.ALGOS)
def test_meta_state_matches_the_reference(algo, scale, mesh_kind):
    """dryrun_capacities equal; rank 0's meta state is the reference's
    ShapeDtypeStruct state cut to one partition, leaf for leaf (shape
    and dtype), with the same EngineConfig capacities, for a plan with
    and without the sender combine; the vertex and message relations'
    bytes equal the reference's per-device sizes."""
    n_v, n_e = tcli.GRAPH_SCALES[scale]
    assert tcli.GRAPH_SCALES == jcli.GRAPH_SCALES
    N = CHIPS[mesh_kind]
    assert tcli.dryrun_capacities(n_v, n_e, N) == \
        jcli.dryrun_capacities(n_v, n_e, N)
    stub = types.SimpleNamespace(axis_names=MESHES[mesh_kind])
    pm = mesh.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    for sc in (True, False):
        jv, jm, jg, jec = jcli.abstract_graph_state(
            n_v, n_e, N, jcli.ALGOS[algo](n_v),
            JC.PhysicalPlan(sender_combine=sc), stub)
        tv, tm, tg, tec = tcli.abstract_graph_state(
            n_v, n_e, N, tcli.make_program(algo, n_v),
            PhysicalPlan(sender_combine=sc), pm)
        assert (tec.n_parts, tec.bucket_cap, tec.frontier_cap) == \
            (jec.n_parts, jec.bucket_cap, jec.frontier_cap)
        assert (tec.axis_name.rank, tec.axis_name.world) == (0, N)
        assert not tec.exchange_apart
        ref_bytes = port_bytes = 0
        for j, t in ((jv, tv), (jm, tm), (jg, tg)):
            jl, tl = _leaves(j), _leaves(t)
            assert jl.keys() == tl.keys()
            for k, s in jl.items():
                x = tl[k]
                assert x.device.type == "meta"
                assert x.dtype == DTYPES[s.dtype.type], k
                if j is not jg:     # partitioned: one of N
                    assert s.shape[0] == N and tuple(x.shape) == \
                        (1,) + tuple(s.shape[1:]), k
                else:
                    assert tuple(x.shape) == tuple(s.shape), k
                if j is not jg:
                    port_bytes += x.numel() * x.element_size()
                    ref_bytes += s.size * s.dtype.itemsize
        assert port_bytes * N == ref_bytes


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("scale", SCALES)
def test_collective_bytes_are_the_references(scale, mesh_kind):
    """The counted all-to-all of rank 0's PageRank superstep (sender
    combine, D = 1) equals the reference's hlo_cost figure exactly; the
    all-reduce is the ring formula over the step's all_reduce tensors
    (six int32 tallies, the int32 halt vote, the aggregate)."""
    rec = tcli.pregel_dryrun("pagerank", scale, mesh_kind, PhysicalPlan())
    N = CHIPS[mesh_kind]
    assert rec["status"] == "ok" and rec["chips"] == N
    coll = rec["per_device"]["collectives"]
    assert coll["all-to-all"] == A2A_BYTES[(scale, mesh_kind)]
    agg = tcli.make_program("pagerank", 1).agg_dims
    assert coll["all-reduce"] == 2.0 * (6 * 4 + 4 + 4 * agg) * (N - 1) / N
    assert rec["per_device"]["collective_bytes"] == sum(coll.values())
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(mem["arguments"].values())
    assert mem["total_per_device_bytes"] == \
        mem["argument_bytes"] + mem["temp_bytes"]
    assert 0 < mem["temp_bytes"] and rec["per_device"]["bytes"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("algo", tcli.ALGOS)
def test_auto_choice_is_the_references_under_cpu_machine(algo):
    """plan="auto" of the dry run at superstep-0 statistics: the port's
    choice under CPU_MACHINE (the reference's constants) is the
    reference's choose."""
    n_v, n_e = tcli.GRAPH_SCALES["paper-large"]
    Np, Ep = jcli.dryrun_capacities(n_v, n_e, 256)
    g = JP.GraphStats(n_vertices=n_v, n_edges=n_e, n_partitions=256,
                      vertex_capacity=Np, edge_capacity=Ep,
                      value_dims=jcli.ALGOS[algo](n_v).value_dims,
                      msg_dims=jcli.ALGOS[algo](n_v).msg_dims)
    want, _ = JP.choose(jcli.ALGOS[algo](n_v), g,
                        JP.Observation(frontier_density=1.0))
    got = tcli.dryrun_auto_plan(tcli.make_program(algo, n_v), n_v, n_e,
                                256, CPU_MACHINE)
    for dim in ("join", "groupby", "connector", "sender_combine",
                "storage", "partition"):
        assert getattr(got, dim) == getattr(want, dim), dim


def test_fake_backend_reaches_the_counter():
    """Pins torch.testing._internal.distributed.fake_pg (not a public
    API): the backend registers, and meta all_to_all_single and
    all_reduce over it reach the counter as c10d operators, priced with
    the ring formulas at the group's size."""
    from torch.testing._internal.distributed import fake_pg
    assert hasattr(fake_pg, "FakeStore")
    assert "fake" in dist.Backend.backend_list
    with tcli.fake_group(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0

        def f(x, y):
            recv = torch.empty_like(x)
            dist.all_to_all_single(recv, x)
            dist.all_reduce(y)
            return recv
        x = torch.empty(4, 10, device="meta")          # 160 B sent
        y = torch.empty(3, dtype=torch.int32, device="meta")   # 12 B
        cost = op_cost.measure(f, x, y)
    assert not dist.is_initialized()
    assert cost.by_op["c10d.alltoall_base_.default"][0] == 1
    assert cost.by_op["c10d.allreduce_.default"][0] == 1
    assert cost.coll_detail == {"all-to-all": 160 * 3 / 4,
                                "all-reduce": 2 * 12 * 3 / 4}
    assert cost.coll_bytes == 120 + 18


def test_fake_group_refuses_an_existing_group():
    with tcli.fake_group(2):
        with pytest.raises(RuntimeError, match="already exists"):
            with tcli.fake_group(2):
                pass
        assert dist.get_world_size() == 2
    assert not dist.is_initialized()


def test_counter_memory_figures():
    """argument_bytes are the inputs' (dataclasses included); the peak
    counts each new output storage from its operator until it is freed
    (a storage a view keeps alive stays counted), and views and in-place
    results add nothing."""
    def f(rel):
        a = rel.x + 1.0            # 400 B live
        a.mul_(2.0)                # in place: nothing
        v = a[:50]                 # a view: nothing
        b = v * 3.0                # +200 B
        del a                      # a's storage lives on in v
        t = b * 2.0                # +200 B: 800
        del t                      # freed: 600
        u = b + 1.0                # +200 B: 800 again, not 1000
        return u.sum(), v          # +4 B: the peak, 804

    @dataclasses.dataclass
    class Rel:
        x: torch.Tensor
        k: torch.Tensor

    rel = Rel(x=torch.empty(100, device="meta"),
              k=torch.empty(7, dtype=torch.int32, device="meta"))
    cost = op_cost.measure(f, rel)
    assert cost.argument_bytes == 400 + 28
    assert cost.peak_temp_bytes == 400 + 200 + 200 + 4


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_fold_meta_route(op):
    """On meta tensors the fold returns its outputs' shapes and dtypes
    without running, and charges the counter its own I/O once: keys,
    payload and valid read, folded and is_last written."""
    Pn, M, D = 3, 1000, 2
    k = torch.empty(Pn, M, dtype=torch.int32, device="meta")
    p = torch.empty(Pn, M, D, device="meta")
    v = torch.empty(Pn, M, dtype=torch.bool, device="meta")
    out = {}

    def f():
        out["fold"] = SC.segment_combine(k, p, v, op)
        out["one"] = SC.segment_combine(k[0], p[0], v[0], op)
    cost = op_cost.measure(f)
    folded, is_last = out["fold"]
    assert (folded.shape, folded.dtype, folded.device.type) == \
        ((Pn, M, D), torch.float32, "meta")
    assert (is_last.shape, is_last.dtype) == ((Pn, M), torch.bool)
    assert out["one"][0].shape == (M, D) and out["one"][1].shape == (M,)
    io = lambda P: P * M * (4 + 4 * D + 1) + P * M * (4 * D + 1)
    calls, nbytes = cost.by_op[SC.META_OP]
    assert calls == 2 and nbytes == io(Pn) + io(1)
    assert cost.bytes == nbytes      # nothing else moved a byte
    with pytest.raises(ValueError, match="op="):
        SC.segment_combine(k, p, v, "prod")


def test_superstep_with_sender_combine_runs_on_meta():
    """Every plan with a sender combine reaches the fold; on meta it
    takes the fold's meta route (one call a superstep)."""
    n_v, n_e = 10_000, 80_000
    pm = mesh.make_production_mesh()
    prog = tcli.make_program("pagerank", n_v)
    plan = PhysicalPlan(groupby="sort", connector="partitioning_merging")
    vert, msg, gs, ec = tcli.abstract_graph_state(n_v, n_e, 256, prog, plan,
                                                  pm)
    with tcli.fake_group(256):
        cost = op_cost.measure(make_superstep(prog, plan, ec), vert, msg,
                               gs)
    assert cost.by_op[SC.META_OP][0] == 1
    assert cost.coll_detail["all-to-all"] > 0


def test_cli_writes_the_reference_file_name_and_keys(tmp_path, capsys):
    """--dryrun runs with no CUDA (no --device cpu needed) and writes
    {tag}_pregelix-{algo}_{scale}_{mesh}.json with the reference's keys,
    the machine block naming H100_MACHINE and its placeholder link."""
    rc = tcli.main(["--dryrun", "--algo", "sssp", "--mesh", "single",
                    "--tag", "t", "--out", str(tmp_path)])
    assert rc == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["t_pregelix-sssp_paper-large_single.json"]
    import json
    rec = json.loads((tmp_path / files[0]).read_text())
    assert REFERENCE_KEYS <= rec.keys() and "machine" in rec
    assert rec["memory"].keys() >= {"argument_bytes", "temp_bytes",
                                    "total_per_device_bytes"}
    assert rec["per_device"].keys() >= {"flops", "bytes",
                                        "collective_bytes", "collectives"}
    assert rec["roofline"].keys() >= {"compute_s", "memory_s",
                                      "collective_s", "dominant", "bound_s"}
    from repro_torch.planner.cost import H100_MACHINE as m
    assert rec["machine"]["name"] == "H100_MACHINE"
    assert (rec["machine"]["peak_flops"], rec["machine"]["hbm_bw"],
            rec["machine"]["net_bw"]) == (m.peak_flops, m.hbm_bw, m.net_bw)
    assert "placeholder" in rec["machine"]["net_bw_is"]
    r = rec["roofline"]
    assert r["memory_s"] == rec["per_device"]["bytes"] / m.hbm_bw
    assert r["collective_s"] == rec["per_device"]["collective_bytes"] / \
        m.net_bw
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                               r["collective_s"])
    assert rec["kind"] == "superstep" and rec["arch"] == "pregelix-sssp"
    assert "[pregel-dryrun] sssp x paper-large x single" in \
        capsys.readouterr().out


def test_production_mesh_and_its_world():
    """The (16, 16) and (2, 16, 16) meshes; a real run outside a world of
    exactly that many ranks raises, naming the count."""
    one = mesh.make_production_mesh()
    two = mesh.make_production_mesh(multi_pod=True)
    assert (one.n_ranks, one.shape) == (256, {"data": 16, "model": 16})
    assert (two.n_ranks, two.axis_names) == (512, ("pod", "data", "model"))
    assert mesh.dp_axes(two) == ("pod", "data")
    assert mesh.batch_axis_size(one) == 16 and mesh.batch_axis_size(two) == 32
    with pytest.raises(RuntimeError, match="512-rank"):
        mesh.require_world(two)
    with tcli.fake_group(256):
        assert mesh.require_world(one) == 0
        with pytest.raises(RuntimeError, match="512"):
            mesh.require_world(two)


@pytest.mark.parametrize("dim,bad", [
    ("join", "leftouter"), ("join", "inner"), ("groupby", "hash"),
    ("connector", "merging"), ("storage", "lsm"), ("partition", "round")])
def test_validate_rejects_unknown_names(dim, bad):
    """A name outside its documented set raises and lists the set; the
    documented names pass."""
    plan = PhysicalPlan(**{dim: bad})
    with pytest.raises(ValueError, match=dim) as e:
        plan.validate("sum")
    allowed = {"join": "full_outer | left_outer",
               "groupby": "scatter | sort",
               "connector": "partitioning | partitioning_merging",
               "storage": "inplace | delta",
               "partition": "hash | range"}[dim]
    assert allowed in str(e.value)
    for good in allowed.split(" | "):
        PhysicalPlan(**{dim: good}).validate("sum")


def test_production_cli_joins_a_torchrun_world(monkeypatch):
    """Under torchrun (its environment names the world) --mesh
    production joins that world, then refuses it unless it has 256
    ranks."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in {"TORCHELASTIC_RUN_ID": "t", "RANK": "0", "LOCAL_RANK": "0",
                 "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="1-rank world"):
        tcli.main(["--mesh", "production", "--device", "cpu"])
    assert dist.is_initialized() and dist.get_backend() == "gloo"
