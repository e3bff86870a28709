"""The sharded driver's pure parts on the CPU: ``launch/mesh.py``'s mesh
and transport rule, and the pieces of ``core/sharded.py`` and the
planner that the reference computes the same way — ``ExchangeReadiness``,
``_exchange_wire_bytes``, ``_fit_devices``, the cost model's network
axis and the controller's exchange EWMA — each held to the JAX package's
value at rel 1e-12 (integers and booleans exactly)."""
import _torch_threads  # noqa: F401  (first: see the module)
import pytest
import torch

import repro.core.sharded as JS
import repro.graph as JG
import repro.planner as JP
import repro_torch.core as T
import repro_torch.graph as TG
import repro_torch.planner as TP
from repro.planner.stats import StatsCollector as JStats
from repro_torch.core import sharded as TS
from repro_torch.launch import mesh
from repro_torch.planner.stats import StatsCollector as TStats

N = 220
REL = 1e-12


def test_make_host_mesh_counts():
    m = mesh.make_host_mesh(2, device="cpu")
    assert (m.n_workers, m.backend, m.devices) == (2, "gloo", ("cpu",) * 2)
    assert m.axis_names == ("data",)
    assert mesh.make_host_mesh(device="cpu").n_workers == 1
    assert mesh.dp_axes(m) == ("data",) and mesh.batch_axis_size(m) == 2
    with pytest.raises(RuntimeError, match="core"):
        mesh.make_host_mesh(10 ** 6, device="cpu")
    # the pod mesh is a description; a real run on it needs a world of
    # exactly its 256 ranks
    prod = mesh.make_production_mesh()
    assert (prod.n_ranks, prod.axis_names) == (256, ("data", "model"))
    with pytest.raises(RuntimeError, match="256"):
        mesh.require_world(prod)


def test_the_transport_rule_on_one_card(monkeypatch):
    """One card: a rank a card goes over NCCL; two ranks share the card
    over gloo; more than MAX_RANKS_PER_CARD ranks are refused."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    one = mesh.make_host_mesh(1, device="cuda")
    assert (one.backend, one.devices) == ("nccl", ("cuda:0",))
    two = mesh.make_host_mesh(2, device="cuda")
    assert (two.backend, two.devices) == ("gloo", ("cuda:0", "cuda:0"))
    assert mesh.make_host_mesh(device="cuda").n_workers == 1
    with pytest.raises(RuntimeError, match="a card"):
        mesh.make_host_mesh(mesh.MAX_RANKS_PER_CARD + 1, device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    four = mesh.make_host_mesh(4, device="cuda")
    assert four.backend == "nccl"
    assert four.devices == tuple(f"cuda:{w}" for w in range(4))
    assert mesh.make_host_mesh(8, device="cuda").devices[5] == "cuda:1"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh(1, device="cuda")


def test_exchange_readiness_protocol():
    """The same landing sequence through both packages' bookkeeping."""
    steps = [("land", 0, 0, 0), ("land", 0, 0, 1), ("land", 1, 0, 0),
             ("land", 1, 0, 1), ("land", 0, 1, 1)]
    a, b = JS.ExchangeReadiness(2, 2), TS.ExchangeReadiness(2, 2)
    for op, w, rd, src in [(None, 0, 0, 0)] + steps:
        if op:
            a.land(w, rd, src_round=src)
            b.land(w, rd, src_round=src)
        for ww in range(2):
            for r in range(2):
                assert a.ready(ww, r) == b.ready(ww, r)
                assert a.missing(ww, r) == b.missing(ww, r)
            assert a.ready_round(ww) == b.ready_round(ww)
    assert b.ready_round(0) and not b.ready_round(1)
    assert b.missing(1, 1) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_exchange_wire_bytes_and_fit_devices():
    for P in (1, 4, 8, 16):
        for n_parts in (4, 8):
            for C in (1, 4, 1000):
                for D in (1, 2, 4):
                    for n in (1, 2, 4, 8):
                        assert TS._exchange_wire_bytes(P, n_parts, C, D,
                                                       n) == \
                            JS._exchange_wire_bytes(P, n_parts, C, D, n)
    assert TS._exchange_wire_bytes(8, 8, 4, 2, 2) == 8 * 8 * 4 * 13 // 2
    for P in range(1, 17):
        for healthy in range(0, 18):
            assert TS._fit_devices(P, healthy) == \
                JS._fit_devices(P, healthy)


def _g(mod):
    return mod.GraphStats(n_vertices=N, n_edges=1200, n_partitions=8,
                          vertex_capacity=64, edge_capacity=256,
                          value_dims=2, msg_dims=2)


@pytest.mark.parametrize("n_workers", [1, 2, 4])
@pytest.mark.parametrize("net_scale", [1.0, 2.0])
def test_cost_model_network_axis(n_workers, net_scale):
    """The sharded observation routes (P - P_local)/P of the exchange
    through net_bw plus a stage latency: every term of the estimate, the
    net leg and the total equal the reference's on the CPU machine."""
    from repro.core import PhysicalPlan as JPlan
    from repro.planner.cost import Observation as JObs
    from repro.planner.cost import estimate as jest
    from repro_torch.planner.cost import Observation as TObs
    from repro_torch.planner.cost import estimate as test_
    kw = dict(frontier_density=1.0, sharded=n_workers > 1,
              n_workers=n_workers, net_scale=net_scale)
    for plan_kw in ({}, dict(join="left_outer"),
                    dict(sender_combine=True),
                    dict(connector="partitioning_merging")):
        jc = jest(JPlan(**plan_kw), _g(JP), JObs(**kw),
                  JP.EMULATED_MACHINE)
        tc = test_(T.PhysicalPlan(**plan_kw), _g(TP), TObs(**kw),
                   TP.CPU_MACHINE)
        assert tc.net_seconds == pytest.approx(jc.net_seconds, rel=REL)
        assert tc.net_bytes == pytest.approx(jc.net_bytes, rel=REL)
        assert tc.seconds(TP.CPU_MACHINE) == pytest.approx(
            jc.seconds(JP.EMULATED_MACHINE), rel=REL)
        assert set(tc.terms) == set(jc.terms)
        for k in jc.terms:
            assert tc.terms[k] == pytest.approx(jc.terms[k], rel=REL,
                                                abs=0.0)
        if n_workers > 1:
            assert "exchange_net" in tc.terms
            assert tc.net_seconds >= TP.CPU_MACHINE.net_latency_s
        else:
            assert tc.net_seconds == 0.0


def test_adaptive_exchange_ewma_calibrates_net_scale():
    """Both controllers fed the same sharded records: the same exchange
    EWMA, net_scale and decisions; the EWMA survives state_dict."""
    from repro.core import PhysicalPlan as JPlan
    jctrl = JP.AdaptiveController(JG.PageRank(N, iterations=6), _g(JP),
                                  JPlan(), config=JP.AdaptiveConfig(),
                                  machine=JP.EMULATED_MACHINE)
    tctrl = TP.AdaptiveController(TG.PageRank(N, iterations=6), _g(TP),
                                  T.PhysicalPlan(),
                                  config=TP.AdaptiveConfig(),
                                  machine=TP.CPU_MACHINE)
    jcoll = JStats(n_partitions=8, vertex_capacity=64, msg_dims=2,
                   n_vertices=N)
    tcoll = TStats(n_partitions=8, vertex_capacity=64, msg_dims=2,
                   n_vertices=N)
    for i, stall in enumerate((4e-3, 5e-3, 3e-3, 6e-3, 4.5e-3), start=1):
        kw = dict(active=N, messages=1200, wall_s=0.01,
                  recompiled=(i == 1), sharded=True, n_workers=2,
                  exchange_bytes=1e5, exchange_stall_s=stall)
        jrec, trec = jcoll.record(i, **kw), tcoll.record(i, **kw)
        jd = jctrl.observe(jrec, bucket_cap=0)
        td = tctrl.observe(trec, bucket_cap=0)
        assert (jd is None) == (td is None)
        assert tctrl._exchange_ewma == pytest.approx(jctrl._exchange_ewma,
                                                     rel=REL)
        jobs = jctrl._make_observation(jrec, bucket_cap=0)
        tobs = tctrl._make_observation(trec, bucket_cap=0)
        assert tobs.sharded and tobs.n_workers == 2
        assert tobs.net_scale == pytest.approx(jobs.net_scale, rel=REL)
        assert tobs.exchange_ewma_s == pytest.approx(jobs.exchange_ewma_s,
                                                     rel=REL)
    state = tctrl.state_dict()
    again = TP.AdaptiveController(TG.PageRank(N, iterations=6), _g(TP),
                                  T.PhysicalPlan(), machine=TP.CPU_MACHINE)
    again.load_state(state)
    assert again._exchange_ewma == tctrl._exchange_ewma


def test_sharded_initial_pick_prices_the_network():
    """resolve_auto_plan's obs0: the sharded superstep-0 observation picks
    the plan the reference picks with it."""
    from repro.core import load_graph as jload
    from repro.planner.cost import Observation as JObs
    from repro_torch.planner.cost import Observation as TObs
    edges = TG.grid_graph(16)
    n = 256
    for n_workers in (1, 2, 4):
        kw = dict(frontier_density=1.0, sharded=n_workers > 1,
                  n_workers=n_workers)
        jplan, _ = JP.resolve_auto_plan(
            jload(edges, n, 4, value_dims=1), JG.SSSP(source=0),
            adaptive=False, machine=JP.EMULATED_MACHINE, obs0=JObs(**kw))
        tplan, _ = TP.resolve_auto_plan(
            T.load_graph(edges, n, 4, value_dims=1, device="cpu"),
            TG.SSSP(source=0), adaptive=False, machine=TP.CPU_MACHINE,
            obs0=TObs(**kw))
        for k in ("join", "groupby", "connector", "sender_combine",
                  "storage"):
            assert getattr(tplan, k) == getattr(jplan, k)
