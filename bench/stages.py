"""Device time and device idle by the port's program spans, from a
``torch.profiler`` trace of the traced jobs.

The port names each stage of its superstep and each stretch of its driver
with a span (``repro_torch.obs.trace``: ``job``, ``job.prepare``,
``superstep``, ``superstep.<stage>``, ``superstep.readback``,
``boundary``), which a traced run bridges to the profiler as
``record_function`` ranges, ``user_annotation`` events. A program span is
such a range whose name does not start with ``bench.``. The events reduce
to two tables:

- device seconds by program span: each kernel, copy and memset is joined
  to the runtime call that launched it through the ``correlation``
  argument both carry, and given to the innermost program span open over
  that call on the host; a launch outside every program span counts
  nowhere;
- idle seconds by program span: each gap of the device's timeline
  (``timeline.idle_gaps``) is given to the innermost program span over
  its middle.

The harness keeps no event past its own reduction (``timeline``), so
``of(ctx)`` takes the events from a replay: after the window it loads the
cell's graph again, runs the traced jobs again back to back under a
profiler of its own, with the port's spans bridged as the harness bridges
them, and keeps the reading on ``ctx.stages`` for every reader of the
run. A program without these spans reads no stage: the readers return
None.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from dataclasses import dataclass, field

import torch

from bench import jobs as jobgen, timeline

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "host (no op)"     # what timeline.name_gaps gives an uncovered time
# the port's spans that the readers read
STAGES = ("superstep.groupby", "superstep.compute", "superstep.gather",
          "superstep.combine", "superstep.route", "superstep.mutate",
          "superstep.reduce")
PREPARE = "job.prepare"
# the driver's own stretches: where the device idles, the host is in the
# driver's code and not in a stage
DRIVER = ("job", PREPARE, "superstep.readback", "boundary")


@dataclass
class StageReading:
    spans: set = field(default_factory=set)       # program span names seen
    device_s: dict = field(default_factory=dict)  # innermost span -> s
    idle_s: dict = field(default_factory=dict)    # innermost span -> s
    has_device: bool = False    # any kernel, copy or memset in the window
    jobs: int = 0
    supersteps: int = 0         # completed, of the jobs read

    def device_ms(self, name: str, per: int) -> float | None:
        """Device ms launched under ``name`` over ``per``, or None where
        the trace has no device event, no such span or nothing to divide
        by."""
        if not self.has_device or name not in self.spans or per <= 0:
            return None
        return 1e3 * self.device_s.get(name, 0.0) / per

    def idle_ms(self, names, per: int) -> float | None:
        """Device idle ms under any of ``names`` over ``per``, or None
        where the trace has no device event or none of these spans."""
        if not self.has_device or not self.spans.intersection(names) \
                or per <= 0:
            return None
        return 1e3 * sum(self.idle_s.get(n, 0.0) for n in names) / per


def _innermost(spans, times) -> list:
    """The innermost program span's name over each time (sorted), or
    None: ``timeline.name_gaps`` over zero-length gaps."""
    return [None if name == NO_SPAN else name
            for name, _ in timeline.name_gaps(spans, [(t, t) for t in times])]


def reduce_events(events: list) -> StageReading:
    """The two tables of a profiler trace's events (Chrome trace-event
    dicts, times in us) over its ``bench.traced_window`` span."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == timeline.WINDOW_SPAN]
    if not win:
        raise ValueError(f"no {timeline.WINDOW_SPAN} span in the trace")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    spans = sorted((dict(name=e["name"], ts=float(e["ts"]),
                         dur=float(e.get("dur", 0.0)))
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and not e["name"].startswith("bench.")),
                   key=lambda e: e["ts"])
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    busy, launched = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in timeline.DEVICE_CATS:
            continue
        a, d = float(e["ts"]), float(e.get("dur", 0.0))
        if a + d <= t0 or a >= t1:
            continue
        busy.append((a, a + d))
        corr = e.get("args", {}).get("correlation")
        if corr in launch_ts:
            launched.append((launch_ts[corr], min(a + d, t1) - max(a, t0)))
    out = StageReading(spans={e["name"] for e in spans},
                       has_device=bool(busy))
    launched.sort()
    for name, (_, us) in zip(_innermost(spans, [t for t, _ in launched]),
                             launched):
        if name is not None:
            out.device_s[name] = out.device_s.get(name, 0.0) + us * 1e-6
    if busy:
        gaps = timeline.idle_gaps(timeline.clip(timeline.merge(busy), t0, t1),
                                  t0, t1)
        for name, s in timeline.name_gaps(spans, gaps):
            if name != NO_SPAN:
                out.idle_s[name] = out.idle_s.get(name, 0.0) + s
    return out


def replay(ctx) -> StageReading:
    """Run the traced jobs of ``ctx`` again, on a graph loaded again from
    its edges, back to back under a profiler with the port's spans
    bridged to it (as ``harness._start_trace`` does), and reduce the
    trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import load_graph, run_host
    from repro_torch.obs import trace as ptrace

    dev = ctx.device
    cuda = dev.type == "cuda"
    vert = load_graph(ctx.edges.cpu().numpy(), ctx.n, ctx.parts,
                      value_dims=ctx.value_dims, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    jobs = supersteps = 0
    prof.start()
    ptrace.start(torch_annotations=True)
    try:
        with record_function(timeline.WINDOW_SPAN):
            for rec in ctx.traced_jobs:
                prog = jobgen.make_program(ctx.traffic, rec.args)
                with record_function("bench.job"):
                    res = run_host(vert, prog, ctx.plan, max_supersteps=int(
                        ctx.traffic["max_supersteps"]))
                    if cuda:
                        torch.cuda.synchronize(dev)
                jobs += 1
                supersteps += res.supersteps
                del res
    finally:
        ptrace.stop()
        prof.stop()
    del vert
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    out = reduce_events(doc["traceEvents"] if isinstance(doc, dict)
                        else doc)
    out.jobs, out.supersteps = jobs, supersteps
    return out


def of(ctx) -> StageReading | None:
    """The run's reading, made once (``replay``) and kept on
    ``ctx.stages``; None for an untraced run, and for a run on several
    chips, whose ranks' spans reach no profiler and whose graph one card
    need not hold whole."""
    if ctx.trace is None or ctx.chips > 1:
        return None
    reading = getattr(ctx, "stages", None)
    if reading is None:
        reading = ctx.stages = replay(ctx)
        if reading.has_device:
            per = max(reading.supersteps, 1)
            print("[bench] stages over "
                  f"{reading.jobs} jobs, {reading.supersteps} supersteps: "
                  "device ms a superstep " + json.dumps(
                      {k: 1e3 * v / per for k, v in
                       sorted(reading.device_s.items())}) +
                  "; idle ms a superstep " + json.dumps(
                      {k: 1e3 * v / per for k, v in
                       sorted(reading.idle_s.items())}),
                  file=sys.stderr, flush=True)
    return reading
