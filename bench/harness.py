"""One run of one cell: make the graph, load it, warm one job, run jobs
back to back for the window, then judge a seeded sample of the window's
answers against the plain reference and read the cell's metrics.

The window is one analyst in a closed loop: the next job starts when the
last one's ``run_host`` has returned and the device is synchronised. A
job is ``repro_torch.core.run_host(vert, program, plan)`` with a fresh
program. Superstep latencies are read on the device's clock: a CUDA
event at the job's start and one in each ``on_superstep`` call (which
follows the driver's overflow readback, a device sync), so a regrow's
discarded attempt or a host gap falls inside the latency it delays.

``device="cpu"`` runs the same steps on the port's plain kernels; the
command line refuses it, and the tests use it at small sizes.
"""
from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from bench import graphs, jobs as jobgen, manifest as mf, timeline

# the --trace 1 run profiles this many jobs, the window's first ones
TRACE_JOBS = 3


@dataclass
class JobRecord:
    args: dict
    stats: list              # RunResult.stats
    latencies: list          # seconds, one a completed superstep
    supersteps: int
    traced: bool


@dataclass
class RunContext:
    """What a metric reader reads (``metrics/<name>.py`` ``read(ctx)``)."""
    workload: str
    config: dict
    traffic: dict
    algorithm: object        # the algorithms/<name>.py module
    n: int
    num_edges: int           # stored: each pair both ways
    listed_edges: int        # as the source lists them: a pair once
    parts: int
    value_dims: int
    msg_dims: int
    plan: object             # the PhysicalPlan the jobs ran
    device: torch.device
    setup_s: float = 0.0
    load_s: float = 0.0
    window_s: float = 0.0
    window_peak_bytes: int | None = None
    jobs: list = field(default_factory=list)
    trace: timeline.TraceReading | None = None
    edges: torch.Tensor | None = None   # the benchmark's own edges

    @property
    def latencies(self) -> list:
        return [s for j in self.jobs for s in j.latencies]

    @property
    def traced_jobs(self) -> list:
        return [j for j in self.jobs if j.traced]


class Marks:
    """Superstep boundaries: CUDA events on the card (its clock), the
    host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) * 1e-3 if self.cuda else b - a


class Reservoir:
    """A uniform sample of ``k`` of the window's jobs, drawn from the
    seed as the jobs finish (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 2])
        self.items: list = []
        self.seen = 0

    def offer(self, item):
        """Keep ``item`` or not; -> the slot it took, or None."""
        slot = None
        if len(self.items) < self.k:
            slot = len(self.items)
            self.items.append(item)
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < self.k:
                slot = r
                self.items[r] = item
        self.seen += 1
        return slot


def _free(device: torch.device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None, cell: dict | None = None,
             log=None) -> dict:
    """Run ``workload`` once and return its result line as a dict (the
    keys the command prints, ``checks`` last). ``overrides`` replaces
    keys of the configuration (the tests' small graphs); ``cell`` stands
    for the workload's entry in ``BENCHMARK.json`` (the tests' pairs of a
    configuration and a mix that no cell runs yet)."""
    from repro_torch.core import gather_values, load_graph, run_host

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    manifest = mf.load()
    cell = cell or mf.cell(manifest, workload)
    cfg = {**mf.config(cell["config"]), **(overrides or {})}
    traffic = mf.traffic(cell["traffic"])
    alg = mf.algorithm(traffic["algorithm"])
    dev = torch.device(device)
    max_ss = int(traffic["max_supersteps"])

    # 1. the graph, on the device, from the seed
    g = graphs.make_graph(cfg, seed, dev)
    n, num_edges, listed_edges = g.n, g.num_edges, g.listed_edges
    stream = jobgen.JobStream(traffic, g.edges, n, seed)
    warm_args = stream.job(0)
    edges_host = g.edges.cpu().numpy()
    del g
    _free(dev)

    # 2. the bulk load, 3. one warm job (the first run in a checkout
    # builds the kernels here)
    prog = jobgen.make_program(traffic, warm_args)
    plan = jobgen.plan_for(traffic, prog)
    parts = int(cfg["partitions"])
    _sync(dev)
    t = time.perf_counter()
    vert = load_graph(edges_host, n, parts, value_dims=prog.value_dims,
                      device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t
    res = run_host(vert, prog, plan, max_supersteps=max_ss)
    _sync(dev)
    del res
    # the answers a run judges are copied into buffers made here, so the
    # window allocates alike whichever jobs the sample keeps
    n_keep = int(traffic["compare_jobs"])
    keep_vid = torch.empty((n_keep,) + tuple(vert.vid.shape),
                           dtype=vert.vid.dtype, device=dev)
    keep_val = torch.empty((n_keep,) + tuple(vert.value.shape),
                           dtype=vert.value.dtype, device=dev)
    _sync(dev)
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else None)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {workload} seed {seed}: n {n}, edges {num_edges} "
        f"({listed_edges} listed), "
        f"load {load_s:.3f} s, set-up {setup_s:.3f} s")

    ctx = RunContext(workload=workload, config=cfg, traffic=traffic,
                     algorithm=alg, n=n, num_edges=num_edges,
                     listed_edges=listed_edges, parts=parts,
                     value_dims=prog.value_dims, msg_dims=prog.msg_dims,
                     plan=plan, device=dev, setup_s=setup_s, load_s=load_s)

    # 4. the window: jobs back to back
    marks = Marks(dev)
    sample = Reservoir(n_keep, seed)
    job_marks = []
    prof = span = ptrace = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        i += 1
        traced = trace and i <= TRACE_JOBS
        if traced and prof is None:
            prof, span, ptrace = _start_trace(dev)
        args = stream.job(i)
        prog = jobgen.make_program(traffic, args)
        m = [marks.mark()]
        with torch.profiler.record_function("bench.job"):
            res = run_host(vert, prog, plan, max_supersteps=max_ss,
                           on_superstep=lambda *a, m=m: m.append(
                               marks.mark()))
            _sync(dev)
        job_marks.append(m)
        ctx.jobs.append(JobRecord(args=args, stats=res.stats, latencies=[],
                                  supersteps=res.supersteps, traced=traced))
        slot = sample.offer((i, args))
        if slot is not None:
            keep_vid[slot].copy_(res.vertex.vid)
            keep_val[slot].copy_(res.vertex.value)
        del res
        if prof is not None and i == TRACE_JOBS:
            span.__exit__(None, None, None)
            ptrace.stop()
            prof.stop()
        if time.perf_counter() - t0 >= seconds and \
                (not trace or i >= TRACE_JOBS):
            break
    ctx.window_s = time.perf_counter() - t0
    _sync(dev)
    for rec, m in zip(ctx.jobs, job_marks):
        rec.latencies = [marks.seconds(a, b) for a, b in zip(m, m[1:])]
    del job_marks
    memory_peak = None
    if dev.type == "cuda":
        ctx.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        memory_peak = max(setup_peak, ctx.window_peak_bytes)

    for rec in ctx.jobs:
        lat = rec.latencies
        log(f"[bench] job {rec.args}: supersteps {rec.supersteps}, regrows "
            f"{sum(1 for s in rec.stats if s.get('event') == 'regrow')}, "
            f"latency ms first {1e3 * lat[0]:.3f} median "
            f"{1e3 * float(np.median(lat)):.3f} max {1e3 * max(lat):.3f}")

    # 5. the answers, read back; the program's state freed
    answers = [(j, args, gather_values(
        SimpleNamespace(vid=keep_vid[s], value=keep_val[s]), n))
        for s, (j, args) in enumerate(sample.items)]
    del vert, sample, keep_vid, keep_val
    _free(dev)
    if prof is not None:
        ctx.trace = _read_trace(prof)
        del prof
    ctx.edges = torch.from_numpy(edges_host).to(dev)
    del edges_host

    # 6. the comparison with the plain reference
    limits = traffic["limits"]
    worst = {k: None for k in limits}
    failed = 0
    expected = {}
    for j, args, values in answers:
        key = tuple(sorted(args.items()))
        if key not in expected:
            expected = {key: alg.reference(ctx.edges, n, args)}
        nums = alg.compare(values, expected[key])
        bad = False
        for k, v in nums.items():
            log(f"[bench] job {j} {k}: {v} (limit {limits[k]})")
            if worst.get(k) is None or v > worst[k]:
                worst[k] = v
            bad |= not v <= limits[k]
        failed += bad
    del expected, answers
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    # 7. the metrics, each from its reader
    metrics = {}
    for m in mf.metrics_of(manifest, workload, trace):
        v = mf.metric_reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else dev.type),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": memory_peak}
    out = {"correct": bool(correct), "attempted": len(ctx.jobs),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                            "idle_gaps": ctx.trace.top_gaps()}
    out["checks"] = checks
    return out


def _start_trace(dev: torch.device):
    """The profiler over the traced jobs, the program's spans bridged to
    it, and the span that marks the traced window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import trace as ptrace
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    ptrace.start(torch_annotations=True)
    span = record_function(timeline.WINDOW_SPAN)
    span.__enter__()
    return prof, span, ptrace


def _read_trace(prof) -> timeline.TraceReading:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return timeline.read_chrome_trace(path)
    finally:
        os.unlink(path)
