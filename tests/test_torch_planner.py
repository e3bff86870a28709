"""The port's cost model, optimizer and controller against the JAX
package's on the same inputs (CPU): ``estimate`` on the CPU machine
equals the reference's on its emulated machine leg for leg, ``rank``
orders alike, the controllers decide alike superstep by superstep,
``migrate_msgs`` and the calibration fit are exact, and the H100 machine
prices the port's own kernels."""
import _torch_threads  # noqa: F401  (first: see the module)
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
import repro.graph as JG
import repro.planner as JP
import repro.planner.cost as JC
import repro_torch.core as T
import repro_torch.graph as TG
import repro_torch.planner as TP
import repro_torch.planner.cost as TC
from repro_torch.launch import op_cost

WEB = dict(n_vertices=100_000, n_edges=800_000, n_partitions=8,
           vertex_capacity=16_250, edge_capacity=100_000)
SMALL = dict(n_vertices=192, n_edges=960, n_partitions=4,
             vertex_capacity=64, edge_capacity=256)
REL = 1e-12


class _JCustom(JG.SSSP):
    """SSSP with its min as a custom combine UDF."""
    combine_op = "custom"

    def __init__(self):
        super().__init__(source=0)

    def combine(self, a, b):
        import jax.numpy as jnp
        return jnp.minimum(a, b)


class _TCustom(TG.SSSP):
    combine_op = "custom"

    def __init__(self):
        super().__init__(source=0)

    def combine(self, a, b):
        return torch.minimum(a, b)


# (name, reference program, port program)
PROGRAMS = [("pagerank", JG.PageRank(100_000), TG.PageRank(100_000)),
            ("sssp", JG.SSSP(source=0), TG.SSSP(source=0)),
            ("custom", _JCustom(), _TCustom())]


def _stats(prog, **kw):
    d = dict(kw, value_dims=prog.value_dims, msg_dims=prog.msg_dims)
    return JP.GraphStats(**d), TP.GraphStats(**d)


def _jplan(p):
    return J.PhysicalPlan(**dataclasses.asdict(p))


def _tplan(jp):
    """The reference's plan in the port's fields (its kernel_impl has no
    counterpart: the device picks the kernel)."""
    return T.PhysicalPlan.from_dict(dataclasses.asdict(jp))


def _tstate(state):
    """A reference controller's state_dict with its pending plan in the
    port's fields."""
    want = state["want"]
    return dict(state, want=dataclasses.asdict(
        T.PhysicalPlan.from_dict(want)) if want else None)


OBSERVATIONS = {
    "in_memory": {},
    "ooc": dict(ooc=True),
    "streaming": dict(ooc=True, streaming=True, messages=5_000,
                      combinability=3.0),
    "barrier_free": dict(ooc=True, streaming=True, barrier_free=True,
                         super_partitions=4, serial_scale=2.5,
                         messages=700),
    "change_density": dict(ooc=True, change_density=0.05,
                           mutation_rate=0.01, spilling=True,
                           hit_rate=0.7, bucket_cap=20_000),
    "sharded": dict(sharded=True, n_workers=2, net_scale=0.5),
}


def _close(a, b):
    return a == pytest.approx(b, rel=REL, abs=0.0)


@pytest.mark.parametrize("density", [1.0, 0.1, 0.01])
@pytest.mark.parametrize("kind", sorted(OBSERVATIONS))
def test_estimate_and_rank_equal_reference_on_cpu_machine(density, kind):
    """Every plan of the space with both storages, for a sum, a min and a
    custom combine: seconds, flops, bytes and every detail leg equal the
    reference's on EMULATED_MACHINE; rank gives the same order."""
    obs_kw = dict(OBSERVATIONS[kind], frontier_density=density)
    jo, to = JP.Observation(**obs_kw), TP.Observation(**obs_kw)
    for shape in (WEB, SMALL):
        for _, jprog, tprog in PROGRAMS:
            jg, tg = _stats(tprog, **shape)
            plans = list(TP.plan_space(tprog, storages=T.STORAGES))
            assert len(plans) == (16 if tprog.combine_op != "custom"
                                  else 8) * 2
            for p in plans:
                jc = JP.estimate(_jplan(p), jg, jo, JP.EMULATED_MACHINE)
                tc = TP.estimate(p, tg, to, TP.CPU_MACHINE)
                assert _close(tc.seconds(TP.CPU_MACHINE),
                              jc.seconds(JP.EMULATED_MACHINE))
                for f in ("flops", "bytes", "exchange_bytes", "host_bytes",
                          "disk_bytes", "net_bytes", "net_seconds",
                          "serial_seconds"):
                    assert _close(getattr(tc, f), getattr(jc, f)), f
                assert tc.overlap_host == jc.overlap_host
                assert tc.detail.keys() == jc.detail.keys()
                for leg, d in jc.detail.items():
                    for k, v in d.items():
                        assert _close(tc.detail[leg][k], v), (leg, k)
                for leg, v in jc.terms.items():
                    assert _close(tc.terms[leg], v), leg
            jr = JP.rank(jprog, jg, jo, machine=JP.EMULATED_MACHINE,
                         storages=J.STORAGES)
            tr = TP.rank(tprog, tg, to, machine=TP.CPU_MACHINE,
                         storages=T.STORAGES)
            assert [p for p, _ in tr] == [_tplan(p) for p, _ in jr]


def test_cpu_machine_is_the_emulated_machine():
    """Field for field, apart from the kernel flag (mxu there,
    cuda_kernels here, both off)."""
    t = dataclasses.asdict(TP.CPU_MACHINE)
    j = dataclasses.asdict(JP.EMULATED_MACHINE)
    assert t.pop("cuda_kernels") is False and j.pop("mxu") is False
    assert t == j


def test_h100_machine_is_not_a_tpu():
    m = TP.H100_MACHINE
    assert m.cuda_kernels and m.peak_flops == 989e12
    # one card: the exchange is a transpose in HBM
    assert m.link_bw == m.hbm_bw == m.net_bw
    tpu = dataclasses.asdict(JP.DEFAULT_MACHINE)
    for k in ("peak_flops", "hbm_bw", "link_bw", "host_bw", "host_mem_bw",
              "net_bw"):
        assert getattr(m, k) != tpu[k], k
    assert TP.machine_for("cpu") is TP.CPU_MACHINE
    assert TP.machine_for("cuda") is TP.H100_MACHINE


def _web_stats():
    return TP.GraphStats(n_vertices=130_000, n_edges=800_000,
                         n_partitions=8, vertex_capacity=16_250,
                         edge_capacity=100_000)


def test_h100_prices_the_kernel_path_below_the_plain_path():
    """The plan that runs both kernels: the H100 machine prices it below
    the same machine without the kernels (the plain versions)."""
    g, obs = _web_stats(), TP.Observation(frontier_density=1.0)
    base = T.PhysicalPlan(join="full_outer", groupby="sort",
                          connector="partitioning", sender_combine=True)
    m = TP.H100_MACHINE
    plain = dataclasses.replace(m, cuda_kernels=False)
    s = lambda p, mm: TP.estimate(p, g, obs, mm).seconds(mm)
    assert s(base, m) < s(base, plain)


def test_h100_send_leg_is_the_edge_order_stream():
    """Full-outer on the H100: the gather reads and writes each live
    edge's row once (no scatter amplification, no one-hot flops); the
    fold reads the sorted run once and writes it once; the fused pack
    sees at most the bucket capacity."""
    g, obs = _web_stats(), TP.Observation(frontier_density=1.0)
    m = TP.H100_MACHINE
    c = TP.estimate(T.PhysicalPlan(), g, obs, m)
    V, D, W, E = g.value_dims, g.msg_dims, TC.WORD, g.edge_capacity
    assert c.detail["send"]["hbm_bytes"] == E * (V + D + 2) * W
    assert c.detail["send"]["flops"] == m.k_compute * E * D
    msg_w = (1 + D) * W + 1
    assert c.detail["sender_combine"]["hbm_bytes"] == pytest.approx(
        TC._sort_bytes(E, msg_w, m.sort_pass_frac) + 2.0 * E * msg_w)
    M = g.n_partitions * TP.bucket_cap(T.PhysicalPlan(), g)
    assert c.detail["connector"]["flops"] == m.k_compute * min(E, M)
    assert sum(d["flops"] for d in c.detail.values()) == pytest.approx(
        c.flops)
    # left-outer plans never run the gather kernel
    lo = TP.estimate(T.PhysicalPlan(join="left_outer"), g, obs, m)
    plain = TP.estimate(T.PhysicalPlan(join="left_outer"), g, obs,
                        dataclasses.replace(m, cuda_kernels=False))
    assert lo.detail["send"] == plain.detail["send"]


def test_plan_space_has_no_kernel_dimension():
    prog = TG.PageRank(1000)
    assert len(list(TP.plan_space(prog))) == 16
    both = list(TP.plan_space(prog, storages=T.STORAGES))
    assert len(both) == 32
    with pytest.raises(TypeError):
        list(TP.plan_space(prog, kernel_impls=("ref", "cuda")))
    with pytest.raises(ValueError):
        TP.choose(_TCustom(), _web_stats(), TP.Observation(),
                  groupbys=("scatter",))


def _msgs(seed, P=2, n_parts=4, C=8, D=2):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 100, (P, n_parts * C)).astype(np.int32)
    valid = rng.random((P, n_parts * C)) > 0.3
    pay = rng.standard_normal((P, n_parts * C, D)).astype(np.float32)
    dst = np.where(valid, dst, -1)
    pay = np.where(valid[..., None], pay, 0.0).astype(np.float32)
    return dst, pay, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_migrate_msgs_exact_against_reference(seed):
    import jax.numpy as jnp
    dst, pay, valid = _msgs(seed)
    jm = J.MsgRel(dst=jnp.asarray(dst), payload=jnp.asarray(pay),
                  valid=jnp.asarray(valid))
    tm = T.MsgRel(dst=torch.from_numpy(dst), payload=torch.from_numpy(pay),
                  valid=torch.from_numpy(valid))
    old = T.PhysicalPlan(connector="partitioning", sender_combine=False)
    new = T.PhysicalPlan(connector="partitioning_merging")
    jo = JP.migrate_msgs(jm, _jplan(old), _jplan(new), 4)
    to = TP.migrate_msgs(tm, old, new, 4)
    for f in ("dst", "payload", "valid"):
        assert np.array_equal(getattr(to, f).numpy(),
                              np.asarray(getattr(jo, f))), f
    # no-ops: a sender combine already left the runs sorted; a receiver
    # without an order assumption; a capacity that is not n_parts runs
    assert TP.migrate_msgs(tm, T.PhysicalPlan(sender_combine=True), new,
                           4) is tm
    assert TP.migrate_msgs(tm, old, old, 4) is tm
    assert TP.migrate_msgs(tm, old, new, 5) is tm


def _records(coll_j, coll_t, seq, extra=None):
    for step, (active, messages, recompiled) in enumerate(seq, start=1):
        kw = dict(active=active, messages=messages, wall_s=0.0,
                  recompiled=recompiled, **(extra or {}))
        yield coll_j.record(step, **kw), coll_t.record(step, **kw)


@pytest.mark.parametrize("case", ["hysteresis", "dense_then_sparse",
                                  "ooc_storage", "patience_1"])
def test_controllers_decide_alike(case):
    """Two controllers fed the same SuperstepStats sequence make the same
    decision at every superstep, with the same state_dict; the port's
    load_state takes the reference's."""
    total = WEB["n_partitions"] * WEB["vertex_capacity"]
    sparse, dense = (total // 100, 10, False), (total, total, False)
    cfg, space, extra = dict(patience=2, cooldown=1), {}, None
    seq = [sparse, dense, sparse, sparse, sparse, dense, dense, dense,
           sparse, sparse]
    prog_j, prog_t = JG.SSSP(source=0), TG.SSSP(source=0)
    if case == "dense_then_sparse":
        cfg = {}
        seq = [dense] * 3 + [(total // 10, total // 5, True)] + [sparse] * 6
    elif case == "ooc_storage":
        cfg, space = dict(patience=1, cooldown=0), "storages"
        extra = dict(ooc=True, change_density=0.01,
                     readiness_stall_s=0.002)
    elif case == "patience_1":
        cfg = dict(patience=1, cooldown=0)
        prog_j, prog_t = JG.PageRank(100_000), TG.PageRank(100_000)
    jg, tg = _stats(prog_t, **WEB)
    jspace = {"storages": J.STORAGES} if space else {}
    tspace = {"storages": T.STORAGES} if space else {}
    obs0 = dict(frontier_density=1.0, ooc=bool(extra))
    jplan, _ = JP.choose(prog_j, jg, JP.Observation(**obs0),
                         machine=JP.EMULATED_MACHINE, **jspace)
    tplan, _ = TP.choose(prog_t, tg, TP.Observation(**obs0),
                         machine=TP.CPU_MACHINE, **tspace)
    assert tplan == _tplan(jplan)
    jc = JP.AdaptiveController(prog_j, jg, jplan, JP.AdaptiveConfig(**cfg),
                               machine=JP.EMULATED_MACHINE, space_kw=jspace)
    tc = TP.AdaptiveController(prog_t, tg, tplan, TP.AdaptiveConfig(**cfg),
                               machine=TP.CPU_MACHINE, space_kw=tspace)
    mk = lambda m: m(n_partitions=WEB["n_partitions"],
                     vertex_capacity=WEB["vertex_capacity"], msg_dims=1)
    switched = 0
    for jr, tr in _records(mk(JP.StatsCollector), mk(TP.StatsCollector),
                           seq, extra):
        a, b = jc.observe(jr), tc.observe(tr)
        assert (a is None) == (b is None)
        if a is not None:
            switched += 1
            assert b == _tplan(a)
        assert tc.state_dict() == _tstate(jc.state_dict())
        # the reference's decision state loads into a fresh port
        # controller, which then carries the same state
        fresh = TP.AdaptiveController(prog_t, tg, tc.plan,
                                      TP.AdaptiveConfig(**cfg),
                                      machine=TP.CPU_MACHINE,
                                      space_kw=tspace)
        fresh.load_state(jc.state_dict())
        assert fresh.state_dict() == _tstate(jc.state_dict())
    assert switched >= 1
    assert tc.switches == [(s, _tplan(o), _tplan(n))
                           for s, o, n in jc.switches]


class _FakeCost:
    """What a probe measurement returns: flops and bytes, made up from the
    probe plan so that both packages' fits see the same numbers."""

    def __init__(self, plan, g):
        k = 3.0 if plan.groupby == "sort" else 1.0
        self.flops = 17.0 * k * g.edge_capacity * g.n_partitions
        self.bytes = 211.0 * k * g.edge_capacity * g.n_partitions


@pytest.mark.parametrize("name", ["pagerank", "sssp", "custom"])
def test_fit_constants_equal_reference_on_the_same_measurements(
        name, monkeypatch):
    _, jprog, tprog = next(p for p in PROGRAMS if p[0] == name)
    monkeypatch.setattr(JC, "hlo_calibrate",
                        lambda prog, plan, g, obs=None: _FakeCost(plan, g))
    monkeypatch.setattr(TC, "op_calibrate",
                        lambda prog, plan, g, obs=None: _FakeCost(plan, g))
    for shape in (WEB, SMALL):
        jg, tg = _stats(tprog, **shape)
        j = JC._fit_constants(jprog, jg, JP.EMULATED_MACHINE)
        t = TC._fit_constants(tprog, tg, TP.CPU_MACHINE)
        assert t == pytest.approx(j, rel=REL, abs=0.0)


@pytest.mark.parametrize("name", ["pagerank", "sssp", "custom"])
def test_fit_prices_the_probes_on_the_plain_path(name):
    """The probes run the plain superstep on meta tensors, so the fit
    prices them on a machine without the kernels: the H100 machine's
    fitted constants equal, to the bit, those of the same machine with
    ``cuda_kernels=False``."""
    _, _, prog = next(p for p in PROGRAMS if p[0] == name)
    g = TP.GraphStats(**SMALL, value_dims=prog.value_dims,
                      msg_dims=prog.msg_dims)
    plain = dataclasses.replace(TP.H100_MACHINE, cuda_kernels=False)
    assert TC._fit_constants(prog, g, TP.H100_MACHINE) == \
        TC._fit_constants(prog, g, plain)


def test_calibrate_machine_clamps_and_caches_per_device_and_op():
    """The real probes on meta tensors: fitted constants inside their
    clamps, cached per (device type, combine op), and the calibrated
    machine still ranks left-outer first at a sparse frontier."""
    TC._CALIBRATED.clear()
    prog = TG.SSSP(source=0)
    g = TP.GraphStats(**SMALL)
    m = TP.calibrate_machine(prog, g, TP.CPU_MACHINE)
    assert 0.5 <= m.k_compute <= 128.0
    assert 1.0 <= m.k_scatter <= 64.0
    assert 0.02 <= m.sort_pass_frac <= 4.0
    assert not m.cuda_kernels and m.hbm_bw == TP.CPU_MACHINE.hbm_bw
    m2 = TP.calibrate_machine(prog, g, TP.CPU_MACHINE)
    assert m2 == m and list(TC._CALIBRATED) == [("cpu", "min")]
    h = TP.calibrate_machine(prog, g, TP.H100_MACHINE)
    assert h.cuda_kernels and h.hbm_bw == TP.H100_MACHINE.hbm_bw
    TP.calibrate_machine(_TCustom(), g, TP.CPU_MACHINE)
    TP.calibrate_machine(TG.PageRank(192), TP.GraphStats(**SMALL,
                                                         value_dims=2),
                         TP.CPU_MACHINE)
    assert set(TC._CALIBRATED) == {("cpu", "min"), ("cuda", "min"),
                                   ("cpu", "custom"), ("cpu", "sum")}
    sparse, _ = TP.choose(prog, TP.GraphStats(**WEB),
                          TP.Observation(frontier_density=0.01), machine=m)
    assert sparse.join == "left_outer"
    TC._CALIBRATED.clear()


@pytest.mark.parametrize("name", ["pagerank", "sssp", "custom"])
def test_probe_superstep_runs_on_meta(name):
    """Every operator of the plain superstep has a meta kernel: each probe
    plan runs at the capacities the model assumes with no data."""
    _, _, prog = next(p for p in PROGRAMS if p[0] == name)
    g = TP.GraphStats(**WEB, value_dims=prog.value_dims,
                      msg_dims=prog.msg_dims)
    for plan in (T.PhysicalPlan(groupby="scatter" if name != "custom"
                                else "sort", sender_combine=False),
                 T.PhysicalPlan(groupby="sort", sender_combine=False)):
        c = TP.op_calibrate(prog, plan, g)
        # at least every edge slot's payload generation and the vertex
        # relation's read
        assert c.bytes > g.n_partitions * g.edge_capacity * 4
        assert c.flops > 0 and c.by_op


def test_op_cost_counts_scatter_add_and_sort_exactly():
    m = "meta"
    x = torch.zeros(4, 10, device=m)
    idx = torch.empty(4, 6, dtype=torch.int64, device=m)
    src = torch.empty(4, 6, device=m)
    c = op_cost.measure(lambda: x.scatter_add_(1, idx, src))
    # self read + index read + src read + self written
    assert c.bytes == 4 * 10 * 4 + 4 * 6 * 8 + 4 * 6 * 4 + 4 * 10 * 4
    assert c.flops == 40
    assert list(c.by_op) == ["aten.scatter_add_.default"]
    k = torch.empty(4, 100, dtype=torch.int32, device=m)
    c = op_cost.measure(lambda: torch.argsort(k, dim=1, stable=True))
    # keys read; sorted keys and int64 indices written
    assert c.bytes == 400 * 4 + 400 * 4 + 400 * 8 and c.flops == 400
    a, b = torch.empty(3, 5, device=m), torch.empty(5, 7, device=m)
    assert op_cost.measure(lambda: a @ b).flops == 2 * 3 * 5 * 7
    # views move nothing
    assert op_cost.measure(lambda: x.reshape(40).t()).bytes == 0


def test_stats_collector_flags_the_same_straggler():
    walls = [0.01, 0.011, 0.009, 0.5, 0.01, 0.012, 0.01, 0.05, 0.01, 0.2]
    recompiled = [True, False, False, True, False, False, False, False,
                  False, False]
    mk = lambda m: m(n_partitions=4, vertex_capacity=100, msg_dims=1)
    cj, ct = mk(JP.StatsCollector), mk(TP.StatsCollector)
    flagged = 0
    for i, (w, r) in enumerate(zip(walls, recompiled), start=1):
        a = cj.record(i, active=10, messages=5, wall_s=w, recompiled=r)
        b = ct.record(i, active=10, messages=5, wall_s=w, recompiled=r)
        assert b.as_dict() == a.as_dict()
        flagged += "straggler" in b.extra
    assert flagged >= 1
    for c in (cj, ct):
        c.event(3, "plan-switch", join="left_outer")
    assert [r.as_dict() for r in ct.records] == \
        [r.as_dict() for r in cj.records]
    assert len(ct.records) == len(walls) + 1
