"""One run of one cell: make the graph, load it, warm one job, run jobs
back to back for the window, then judge a seeded sample of the window's
answers against the plain reference and read the cell's metrics.

The window is one analyst in a closed loop: the next job starts when the
last job has returned and the device is synchronised. A job is one call
of the port over a fresh program: on one chip
``repro_torch.core.run_host(vert, program, plan)``; on a cell of
``chips`` > 1 ``repro_torch.core.sharded.run_sharded(vert, program, plan,
devices=chips, pool=pool)``, the partitions split over ``chips`` ranks of
one ``RankPool`` that set-up starts after the bulk load and that is
closed after the window, before the comparison. The pool's transport is
``launch/mesh.py``'s: NCCL with a rank a card, gloo where ranks share a
card (and on the CPU).

Superstep latencies on one chip are read on the device's clock: a CUDA
event at the job's start and one in each ``on_superstep`` call (which
follows the driver's overflow readback, a device sync), so a regrow's
discarded attempt or a host gap falls inside the latency it delays. On
several chips they are read on the host clock: ``on_superstep`` runs in
this process as rank 0's records arrive, where a CUDA event would time
nothing that the ranks do.

Device memory on several chips counts every process: the window's peak
is this process's allocator peak over the window plus each rank's
largest ``peak_bytes`` over the window's jobs (``RunResult.workers``; a
rank resets its peak at each job's start), and the set-up's is reckoned
alike over the warm job. A traced run on several chips profiles the
ranks themselves (``ranktrace``: busy and window seconds, kernels and
gaps, each a rank's mean) and replays nothing (``stages.of``). Before the
pool closes, each rank names the banned modules it holds
(``run.banned_modules``), which the result carries out under
``banned_in_ranks`` for the command to refuse.

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

from bench import (graphs, jobs as jobgen, manifest as mf, ranktrace,
                   timeline)

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
    chips: int = 1           # run_sharded's ranks; 1: run_host
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
    host clock on the CPU or where ``host`` says so."""

    def __init__(self, device: torch.device, host: bool = False):
        self.cuda = device.type == "cuda" and not host

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


class RankPeaks:
    """Each rank's largest ``peak_bytes`` over a run of jobs and the card
    it ran on, from the jobs' ``RunResult.workers`` (none on one chip)."""

    def __init__(self):
        self.bytes: dict = {}     # rank -> bytes
        self.card: dict = {}      # rank -> its device, e.g. "cuda:1"

    def add(self, workers):
        for w in workers or ():
            if w.get("peak_bytes") is not None:
                r = int(w["rank"])
                self.bytes[r] = max(self.bytes.get(r, 0),
                                    int(w["peak_bytes"]))
                self.card[r] = str(w["device"])

    def total(self, own: int) -> int:
        """Every process's bytes: ``own``, this process's, and each
        rank's."""
        return own + sum(self.bytes.values())

    def fullest(self, own: int, own_card: str) -> int:
        """The fullest card's bytes: ``own`` on ``own_card`` and each
        rank's on its own card, summed by card."""
        by = {own_card: own}
        for r, b in self.bytes.items():
            by[self.card[r]] = by.get(self.card[r], 0) + b
        return max(by.values())

    def by_rank(self) -> list:
        return [self.bytes[r] for r in sorted(self.bytes)]


def _banned_in_rank(*, axis=None) -> list:
    """The banned modules loaded in a rank of the pool (``RankPool.map``)."""
    from bench.run import banned_modules
    return banned_modules(sys.modules)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None, cell: dict | None = None,
             log=None) -> dict:
    """Run ``workload`` once and return its result line as a dict (the
    keys the command prints, ``checks`` last, and on several chips
    ``banned_in_ranks``, which the command takes out). ``overrides``
    replaces keys of the configuration (the tests' small graphs);
    ``cell`` stands for the workload's entry in ``BENCHMARK.json`` (the
    tests' pairs of a configuration and a mix that no cell runs yet, or
    another ``chips``).
    The ranks of a cell on several chips are stopped however the run
    ends."""
    pools = []
    try:
        return _run_cell(workload, seed, seconds, trace, device=device,
                         t_start=t_start, overrides=overrides, cell=cell,
                         log=log, pools=pools)
    finally:
        for pool in pools:
            pool.close()


def _run_cell(workload, seed, seconds, trace, *, device, t_start,
              overrides, cell, log, pools) -> dict:
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
    chips = int(cell["chips"])
    cuda = dev.type == "cuda"
    card = f"cuda:{torch.cuda.current_device()}" if cuda else None

    # 1. the graph, on the device, from the seed
    g = graphs.make_graph(cfg, seed, dev)
    n, num_edges, listed_edges = g.n, g.num_edges, g.listed_edges
    stream = jobgen.JobStream(traffic, g.edges, n, seed)
    warm_args = stream.job(0)
    edges_host = g.edges.cpu().numpy()
    del g
    _free(dev)

    # 2. the bulk load (and on several chips the ranks), 3. one warm job
    # (the first run in a checkout builds the kernels here)
    prog = jobgen.make_program(traffic, warm_args)
    plan = jobgen.plan_for(traffic, prog)
    parts = int(cfg["partitions"])
    _sync(dev)
    t = time.perf_counter()
    vert = load_graph(edges_host, n, parts, value_dims=prog.value_dims,
                      device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t
    pool = None
    if chips > 1:
        from repro_torch.core.sharded import RankPool, run_sharded
        pool = RankPool(chips, dev)
        pools.append(pool)

    def run_job(prog, on_superstep=None):
        if pool is None:
            return run_host(vert, prog, plan, max_supersteps=max_ss,
                            on_superstep=on_superstep)
        return run_sharded(vert, prog, plan, devices=chips, pool=pool,
                           max_supersteps=max_ss, on_superstep=on_superstep)

    setup_ranks = RankPeaks()
    if pool is not None and cuda:
        # the set-up's peak on this card before the warm job, then the
        # warm job's in every process
        before_warm = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    res = run_job(prog)
    _sync(dev)
    setup_ranks.add(res.workers)
    del res
    # the answers a run judges are copied into buffers made here, so the
    # window allocates alike whichever jobs the sample keeps
    n_keep = int(traffic["compare_jobs"])
    keep_vid = torch.empty((n_keep,) + tuple(vert.vid.shape),
                           dtype=vert.vid.dtype, device=dev)
    keep_val = torch.empty((n_keep,) + tuple(vert.value.shape),
                           dtype=vert.value.dtype, device=dev)
    _sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if pool is not None and cuda:
        setup_peak = max(before_warm, setup_ranks.fullest(setup_peak, card))
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {workload} seed {seed}: n {n}, edges {num_edges} "
        f"({listed_edges} listed), "
        f"load {load_s:.3f} s, set-up {setup_s:.3f} s"
        + (f", {chips} ranks" if pool is not None else ""))

    ctx = RunContext(workload=workload, config=cfg, traffic=traffic,
                     algorithm=alg, n=n, num_edges=num_edges,
                     listed_edges=listed_edges, parts=parts,
                     value_dims=prog.value_dims, msg_dims=prog.msg_dims,
                     plan=plan, device=dev, chips=chips, setup_s=setup_s,
                     load_s=load_s)

    # 4. the window: jobs back to back
    marks = Marks(dev, host=pool is not None)
    sample = Reservoir(n_keep, seed)
    window_ranks = RankPeaks()
    job_marks = []
    prof = span = ptrace = None
    ranks_traced = False
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    i = 0
    while True:
        i += 1
        traced = trace and i <= TRACE_JOBS
        if traced and pool is None and prof is None:
            prof, span, ptrace = _start_trace(dev)
        if traced and pool is not None and not ranks_traced:
            pool.map(ranktrace.start, [(dev.type,)] * chips)
            ranks_traced = True
        args = stream.job(i)
        prog = jobgen.make_program(traffic, args)
        m = [marks.mark()]
        with torch.profiler.record_function("bench.job"):
            res = run_job(prog, on_superstep=lambda *a, m=m: m.append(
                marks.mark()))
            _sync(dev)
        job_marks.append(m)
        window_ranks.add(res.workers)
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
        if ranks_traced and i == TRACE_JOBS:
            pool.map(ranktrace.stop, [()] * chips)
        if time.perf_counter() - t0 >= seconds and \
                (not trace or i >= TRACE_JOBS):
            break
    ctx.window_s = time.perf_counter() - t0
    _sync(dev)
    for rec, m in zip(ctx.jobs, job_marks):
        rec.latencies = [marks.seconds(a, b) for a, b in zip(m, m[1:])]
    del job_marks
    memory_peak = None
    if cuda:
        own = torch.cuda.max_memory_allocated(dev)
        ctx.window_peak_bytes = window_ranks.total(own)
        memory_peak = max(setup_peak, window_ranks.fullest(own, card))
    if ranks_traced:
        ctx.trace = ranktrace.merge(pool.map(ranktrace.read, [()] * chips))
        log(f"[bench] {chips} ranks: busy, window, kernel and gap seconds "
            "are the ranks' means; no stage reading, as the port's spans "
            "are not bridged to the ranks' profilers")
    banned_in_ranks = None
    if pool is not None:
        banned_in_ranks = sorted({m for found in pool.map(
            _banned_in_rank, [()] * chips) for m in found})
        pool.close()

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
    ctx.edges = graphs.to_int64(edges_host, dev)
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
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if cuda else dev.type),
                   "count": chips,
                   "memory_peak_bytes": memory_peak}
    if pool is not None and cuda:
        device_info["peak_bytes_by_rank"] = window_ranks.by_rank()
    out = {"correct": bool(correct), "attempted": len(ctx.jobs),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                            "idle_gaps": ctx.trace.top_gaps()}
    if banned_in_ranks is not None:
        out["banned_in_ranks"] = banned_in_ranks
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
