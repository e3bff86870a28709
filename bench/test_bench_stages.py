"""CPU tests of the reduction of a profiler trace to device time and idle
by the port's program spans (``bench/stages.py``) and of the six readers
that read it: the join of a kernel to its launch, the innermost span, the
idle gaps, the arithmetic of each reader, the names the port emits, and
the harness's own reduction of the same events left as it was."""
import copy

import pytest
import torch

from bench import graphs, jobs as jobgen, manifest as mf, stages, timeline
from bench.harness import JobRecord, RunContext

W = timeline.WINDOW_SPAN
READERS = ("groupby_device_ms", "gather_device_ms", "combine_device_ms",
           "route_device_ms", "prepare_device_ms", "driver_idle_ms")


def _ann(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur)


def _launch(ts, corr):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts,
                dur=2.0, args={"correlation": corr})


def _kernel(name, ts, dur, corr):
    return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur,
                args={"correlation": corr})


def _events():
    """One job of one superstep: prepare launches a memset-like kernel,
    the gather stage a kernel, the readback a copy; a launch under
    ``bench.job`` alone counts nowhere; the device idles under the
    boundary and under the readback."""
    return [
        _ann(W, 0.0, 200.0),
        _ann("bench.job", 0.0, 200.0),
        _ann("job", 5.0, 190.0),
        _ann("job.prepare", 5.0, 25.0),
        _launch(10.0, 1), _kernel("out_degrees", 12.0, 10.0, 1),
        _ann("superstep", 40.0, 80.0),
        _ann("superstep.gather", 45.0, 30.0),
        _launch(50.0, 2), _kernel("gather_quads<2>", 52.0, 40.0, 2),
        _ann("superstep.readback", 80.0, 38.0),
        _launch(82.0, 3),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=95.0, dur=5.0,
             args={"correlation": 3}),
        _ann("boundary", 120.0, 70.0),
        _launch(197.0, 4), _kernel("outside", 198.0, 1.0, 4),
    ]


def test_kernels_count_under_the_span_of_their_launch():
    r = stages.reduce_events(_events())
    assert r.has_device
    assert r.spans == {"job", "job.prepare", "superstep",
                       "superstep.gather", "superstep.readback", "boundary"}
    # the gather kernel runs on past its span's end: it counts where it
    # was launched
    assert r.device_s == pytest.approx({"job.prepare": 10e-6,
                                        "superstep.gather": 40e-6,
                                        "superstep.readback": 5e-6})
    # busy [12, 22] [52, 92] [95, 100] [198, 199] in [0, 200]: the gaps'
    # middles at 6 (job.prepare), 37 (job), 93.5 (readback), 149
    # (boundary) and 199.5 (bench.job alone: no program span)
    assert r.idle_s == pytest.approx({"job.prepare": 12e-6, "job": 30e-6,
                                      "superstep.readback": 3e-6,
                                      "boundary": 98e-6})
    r.supersteps, r.jobs = 1, 1
    assert r.idle_ms(stages.DRIVER, 1) == pytest.approx(1e3 * 143e-6)
    assert r.device_ms("superstep.combine", 1) is None      # not emitted
    assert r.device_ms("superstep", 1) == 0.0                # emitted
    with pytest.raises(ValueError):
        stages.reduce_events(_events()[1:])


def test_no_device_event_reads_no_stage():
    ev = [e for e in _events() if e["cat"] not in timeline.DEVICE_CATS]
    r = stages.reduce_events(ev)
    assert not r.has_device and r.idle_s == {} and r.device_s == {}
    assert r.device_ms("superstep.gather", 1) is None
    assert r.idle_ms(stages.DRIVER, 1) is None


def test_harness_reduction_of_the_same_events_is_unchanged():
    """The program's spans fall inside the harness's window: the
    harness's ``TraceReading`` of these events is what its own rules
    give (busy time and kernels as before; a gap is named by the
    innermost host event over it, now a program span), and the stage
    reduction leaves the events as it found them."""
    ev = _events()
    before = copy.deepcopy(ev)
    t = timeline.reduce_events(ev)
    stages.reduce_events(ev)
    assert ev == before
    assert timeline.reduce_events(ev) == t
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(56e-6)
    assert t.kernel_seconds("gather_quads") == pytest.approx(40e-6)
    assert dict((n, s) for n, s in t.gaps) == pytest.approx({
        "job.prepare": 12e-6, "job": 30e-6, "superstep.readback": 3e-6,
        "boundary": 98e-6, "bench.job": 1e-6})


def _ctx(reading, trace=True):
    ctx = RunContext(workload="w", config={}, traffic={}, algorithm=None,
                     n=0, num_edges=0, listed_edges=0, parts=1, value_dims=1,
                     msg_dims=1, plan=None, device="cpu",
                     trace=timeline.TraceReading(1.0, 1.0) if trace else None)
    ctx.stages = reading
    return ctx


def test_readers_divide_by_supersteps_and_jobs():
    r = stages.StageReading(
        spans={"job", "job.prepare", "superstep", "boundary",
               "superstep.readback"} | set(stages.STAGES),
        device_s={"superstep.groupby": 0.5, "superstep.gather": 0.25,
                  "superstep.combine": 0.125, "superstep.route": 0.0625,
                  "job.prepare": 0.03},
        idle_s={"boundary": 0.01, "job": 0.002, "superstep": 0.5},
        has_device=True, jobs=3, supersteps=10)
    got = {m: mf.metric_reader(m).read(_ctx(r)) for m in READERS}
    assert got == pytest.approx({
        "groupby_device_ms": 50.0, "gather_device_ms": 25.0,
        "combine_device_ms": 12.5, "route_device_ms": 6.25,
        "prepare_device_ms": 10.0, "driver_idle_ms": 1.2})
    # a program with only the superstep span (the parent of these spans)
    old = stages.StageReading(spans={"superstep"}, device_s={"superstep": 1},
                              has_device=True, jobs=3, supersteps=10)
    assert all(mf.metric_reader(m).read(_ctx(old)) is None for m in READERS)
    assert all(mf.metric_reader(m).read(_ctx(r, trace=False)) is None
               for m in READERS)


def _cpu_ctx():
    """A traced CPU run's context at graph500-9, as the harness builds it
    after its window: the benchmark's edges, two traced PageRank jobs."""
    cfg = {**mf.config("graph500-22"), "scale": 9}
    traffic = mf.traffic("pagerank")
    g = graphs.make_graph(cfg, 2 ** 31 + 3, "cpu")
    stream = jobgen.JobStream(traffic, g.edges, g.n, 2 ** 31 + 3)
    prog = jobgen.make_program(traffic, stream.job(1))
    jobs = [JobRecord(args=stream.job(i), stats=[], latencies=[],
                      supersteps=0, traced=True) for i in (1, 2)]
    return RunContext(workload="graph500-22.pagerank", config=cfg,
                      traffic=traffic, algorithm=None, n=g.n,
                      num_edges=g.num_edges, listed_edges=g.listed_edges,
                      parts=int(cfg["partitions"]),
                      value_dims=prog.value_dims, msg_dims=prog.msg_dims,
                      plan=jobgen.plan_for(traffic, prog),
                      device=torch.device("cpu"),
                      trace=timeline.TraceReading(1.0, 0.0), jobs=jobs,
                      edges=graphs.to_int64(g.edges, "cpu"))


def test_the_port_emits_every_span_the_readers_read():
    """A replay of the traced jobs on the CPU records every span name
    that ``stages`` and the six readers look for (a renamed span fails
    here instead of reading nothing on the card); with no device event in
    a CPU trace, every reader reads None."""
    ctx = _cpu_ctx()
    r = stages.replay(ctx)
    wanted = set(stages.DRIVER)
    for m in READERS:
        wanted |= set(mf.metric_reader(m).SPANS)
    assert wanted <= r.spans, wanted - r.spans
    assert set(stages.STAGES) - {"superstep.mutate"} <= r.spans
    assert r.jobs == 2
    # PageRank runs its iterations as supersteps
    assert r.supersteps == 2 * int(ctx.traffic["args"]["iterations"])
    assert not r.has_device
    ctx.stages = r
    assert all(mf.metric_reader(m).read(ctx) is None for m in READERS)
