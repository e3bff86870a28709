"""Command-line entry point of the port: one Pregel job on one device or
sharded over several ranks, with the reference's flags and output lines
(``repro.launch.pregel_run``).

    PYTHONPATH=src python -m repro_torch.launch.pregel_run \\
        --algo sssp --dataset webmap-tiny --parts 4 --auto-plan --explain

The job runs on the card unless ``--device cpu`` asks for the CPU.
Modes: in memory (``run_host``) and ``--ooc`` (``run_out_of_core``, the
graph loaded on the host and streamed through the device), each with
checkpoints and supervised recovery (``--checkpoint-every``,
``--checkpoint-dir``, ``--recover``; ``$REPRO_FAULT_PLAN`` arms the
chaos harness before the run) and the observability outputs
(``--trace`` Chrome JSON, ``--report`` run report, ``--explain`` plan
audit, ``--metrics``, ``--progress``). ``--devices N`` (or ``--mesh
host``) runs the job sharded over N ranks (``core/sharded.py``'s
``run_sharded``, the exchange a ``torch.distributed`` all-to-all), in
memory or ``--ooc`` with a per-worker budget; the ranks follow
``--device`` (the card by default; on one card N > 1 ranks exchange over
gloo, since NCCL refuses two ranks on one GPU). ``--mesh production``
runs in place as one rank of a 256-rank ``torch.distributed`` world
(``torchrun`` with 256 processes; ``launch/mesh.require_world``).

``--dryrun`` touches no device: it counts one superstep of the
production mesh (``--mesh single|multi|both``: 256 or 512 ranks) at
``--scale`` (``GRAPH_SCALES``) and writes one JSON record a mesh to
``--out``, ``{tag}_pregelix-{algo}_{scale}_{mesh}.json``, with the
reference's keys (``pregel_dryrun``)::

    PYTHONPATH=src python -m repro_torch.launch.pregel_run --dryrun \
        --algo pagerank --scale paper-large --mesh both --out /tmp/dr

``main(argv)`` parses and runs; ``run(args, graph=(edges, n))`` runs
parsed arguments on a graph the caller already holds (``--dataset`` then
only labels the output; ``pool=`` a ``core.sharded.RankPool`` for the
sharded modes) and returns the ``RunResult`` and the report document
(None without ``--report``/``--explain``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from pathlib import Path
from typing import Optional

from repro_torch.launch.mesh import fake_group

ALGOS = ("pagerank", "sssp", "cc")

# graph scale ladder: 'paper-large' is Webmap-Large (1.4B vertices / 8B
# edges); 'bigger-4x' is 4x that — Big(ger) Graph Analytics on a 512-
# rank multi-pod mesh.
GRAPH_SCALES = {
    "paper-large": (1_413_511_390, 8_050_112_169),
    "bigger-4x": (5_654_045_560, 32_200_448_676),
}
# what the dry run's record says of its two approximate figures
TEMP_NOTE = ("eager peak of the bytes operator outputs hold alive beyond "
             "the arguments (launch/op_cost.py): no fusion and no buffer "
             "reuse, not XLA's temp_size_in_bytes")
NET_NOTE = ("net_bw is a placeholder (the HBM copy rate), not a measured "
            "link between cards (ROADMAP item 11, PERF.md section 7)")


def make_program(algo: str, n: int):
    from repro_torch.graph import SSSP, ConnectedComponents, PageRank
    if algo == "pagerank":
        return PageRank(n, iterations=15)
    if algo == "sssp":
        return SSSP(source=0)
    return ConnectedComponents()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.pregel_run",
        description="Run one Pregel job on one device or sharded over "
                    "several ranks (the card unless --device cpu).")
    ap.add_argument("--dryrun", action="store_true",
                    help="count one superstep of the 256/512-rank "
                         "production mesh on meta tensors over a fake "
                         "process group (no device) and write its "
                         "record to --out")
    ap.add_argument("--algo", default="pagerank", choices=ALGOS)
    ap.add_argument("--scale", default="paper-large",
                    choices=list(GRAPH_SCALES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "host",
                             "production"],
                    help="--dryrun: single|multi|both pod mesh (256 / 512 "
                         "ranks). Real runs: host = a 1-D mesh of "
                         "--devices ranks (default: one a card, one on "
                         "the CPU) through run_sharded; production = the "
                         "(16, 16) pod mesh, run in place as one rank of "
                         "a 256-rank torch.distributed world (torchrun)")
    ap.add_argument("--devices", type=int, default=0,
                    help="run the job SHARDED over this many ranks via "
                         "run_sharded (one process a rank on --device, "
                         "the bucket exchange a torch.distributed "
                         "all-to-all: NCCL when every rank has a card of "
                         "its own, else gloo); composes with --ooc for "
                         "per-worker tiered stores")
    ap.add_argument("--join", default="full_outer")
    ap.add_argument("--groupby", default="scatter")
    ap.add_argument("--connector", default="partitioning")
    ap.add_argument("--sender-combine", type=int, default=1)
    ap.add_argument("--partition", default="hash",
                    choices=["hash", "range"])
    ap.add_argument("--auto-plan", action="store_true",
                    help="let the cost-based planner pick (and mid-run "
                         "re-pick) the plan, with the machine model of "
                         "--device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the job runs (default: the card)")
    ap.add_argument("--dataset", default="webmap-tiny")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--ooc", action="store_true",
                    help="run out-of-core: the graph on the host, "
                         "super-partitions of --budget-partitions streamed "
                         "through the device")
    ap.add_argument("--budget-partitions", type=int, default=0,
                    help="device-memory budget in partitions for --ooc "
                         "(default: the largest divisor of parts that is "
                         "at most parts // 2)")
    ap.add_argument("--stream", dest="stream", action="store_true",
                    default=True,
                    help="pipeline the --ooc super-partition stream "
                         "(default)")
    ap.add_argument("--no-stream", dest="stream", action="store_false",
                    help="synchronous --ooc loop: upload, step, block, "
                         "collect per super-partition")
    ap.add_argument("--barrier-free", dest="barrier_free",
                    action="store_true", default=True,
                    help="barrier-free superstep pipeline (default): "
                         "per-destination inbox rebuild and mutation "
                         "apply, overlapped with the next superstep")
    ap.add_argument("--no-barrier-free", dest="barrier_free",
                    action="store_false",
                    help="keep the global superstep barrier")
    ap.add_argument("--io-threads", type=int, default=None,
                    help="background page-I/O threads of the --ooc disk "
                         "tier (default: 1 with --disk-dir, else 0)")
    ap.add_argument("--readahead-pages", type=int, default=8,
                    help="max pages the I/O engine prefetches a tick")
    ap.add_argument("--disk-dir", default=None,
                    help="--ooc disk tier: spill directory of the page "
                         "cache (HBM <-> DRAM <-> disk)")
    ap.add_argument("--memory-budget-bytes", type=int, default=None,
                    help="--ooc disk tier: host-DRAM byte budget of the "
                         "page cache (requires --disk-dir)")
    ap.add_argument("--eviction", default="lru", choices=["lru", "mru"],
                    help="--ooc disk tier page replacement")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot the run every N supersteps into "
                         "--checkpoint-dir")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for checkpoints (npz in memory, page "
                         "snapshots for --ooc)")
    ap.add_argument("--recover", action="store_true",
                    help="run under the recovery supervisor: a "
                         "recoverable failure restores the latest VALID "
                         "checkpoint onto the surviving workers and "
                         "replays")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="recovery attempts before the failure is "
                         "forwarded (default 3)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's span timeline as Chrome "
                         "trace-event JSON to PATH (validate with "
                         "python -m repro_torch.obs.export)")
    ap.add_argument("--progress", action="store_true",
                    help="print one line per superstep")
    ap.add_argument("--metrics", action="store_true",
                    help="print the per-superstep metrics registry "
                         "snapshots")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the pregelix-run-report/v1 JSON (plan "
                         "audit, decisions, tier occupancy) to PATH; "
                         "validate or diff with python -m "
                         "repro_torch.obs.report")
    ap.add_argument("--explain", action="store_true",
                    help="print the plan-audit ledger after the run")
    ap.add_argument("--tag", default="baseline",
                    help="--dryrun: the records' file name prefix")
    ap.add_argument("--out", default="results/dryrun",
                    help="--dryrun: the records' directory")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check the arguments; stops (``ap.error``) on
    inconsistent flags."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.dryrun:   # touches no device
        return args
    if args.devices < 0:
        ap.error(f"--devices {args.devices}: a rank count is positive")
    if args.recover and not args.checkpoint_dir:
        ap.error("--recover needs --checkpoint-dir (and a nonzero "
                 "--checkpoint-every) so a failure has a snapshot "
                 "to restore")
    if args.ooc:
        if sharded(args):
            per_worker = args.parts // max(args.devices, 1)
            if args.budget_partitions and \
                    per_worker % args.budget_partitions:
                ap.error(f"--budget-partitions {args.budget_partitions} "
                         f"must divide the per-worker block {per_worker} "
                         f"(--parts {args.parts} / {args.devices} "
                         f"devices)")
        elif args.budget_partitions and \
                args.parts % args.budget_partitions:
            ap.error(f"--budget-partitions {args.budget_partitions} must "
                     f"divide --parts {args.parts}")
        if args.memory_budget_bytes and not args.disk_dir:
            ap.error("--memory-budget-bytes requires --disk-dir "
                     "(a budget needs somewhere to spill)")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            ap.error("no CUDA device: pass --device cpu to run on the CPU")
    return args


def sharded(args: argparse.Namespace) -> bool:
    """Does ``args`` select the sharded driver?"""
    return args.devices > 1 or args.mesh in ("host", "production")


def plan_of(args: argparse.Namespace):
    """The plan the flags name, or "auto" under ``--auto-plan``."""
    from repro_torch.core import PhysicalPlan
    return "auto" if args.auto_plan else PhysicalPlan(
        join=args.join, groupby=args.groupby, connector=args.connector,
        sender_combine=bool(args.sender_combine),
        partition=args.partition)


def _largest_half_divisor(n: int) -> int:
    """The largest divisor of n that is <= n // 2 (1 for n = 1)."""
    return next(b for b in range(max(n // 2, 1), 0, -1) if n % b == 0)


def run(args: argparse.Namespace, graph: Optional[tuple] = None,
        pool=None):
    """Run the job ``args`` describes and print the reference's lines.
    ``graph=(edges, n)`` stands in for the ``--dataset`` lookup; ``pool``
    (a ``core.sharded.RankPool``) runs the sharded modes on existing
    ranks. -> (RunResult, report dict or None)."""
    from repro_torch.core import gather_values, load_graph
    from repro_torch.obs import (explain, fmt_plan, memwatch,
                                 progress_line, report, trace,
                                 write_chrome_trace)
    from repro_torch.runtime import faults

    if args.mesh == "production":   # refuse before loading anything
        _join_production_world(args.device)
    plan = plan_of(args)
    if graph is None:
        from repro_torch.graph import DATASETS
        graph = DATASETS[args.dataset]()
    edges, n = graph
    program = make_program(args.algo, n)
    vert = load_graph(edges, n, P=args.parts, value_dims=program.value_dims,
                      device=("cpu" if args.ooc and not sharded(args)
                              else args.device))
    faults.install_from_env()   # REPRO_FAULT_PLAN: the chaos harness
    ft_kw = dict(checkpoint_every=args.checkpoint_every,
                 checkpoint_dir=args.checkpoint_dir,
                 recover=args.recover, max_retries=args.max_retries)
    if args.trace:
        trace.start()
    if args.report or args.explain:
        explain.start()
        memwatch.start()
    show = None
    if args.progress:
        plan_tag = None if plan == "auto" else plan

        def show(i, rec):
            print(progress_line(rec, plan_tag, n_vertices=n), flush=True)
    try:
        if sharded(args):
            res, mode = _run_sharded(args, vert, program, plan, show, ft_kw,
                                     pool)
        elif args.ooc:
            from repro_torch.core.ooc import run_out_of_core
            budget = args.budget_partitions or \
                _largest_half_divisor(args.parts)
            res = run_out_of_core(
                vert, program, plan, budget_partitions=budget,
                max_supersteps=40, stream=args.stream,
                barrier_free=args.barrier_free,
                memory_budget_bytes=args.memory_budget_bytes,
                disk_dir=args.disk_dir, eviction=args.eviction,
                io_threads=args.io_threads,
                readahead_pages=args.readahead_pages, on_superstep=show,
                device=args.device, **ft_kw)
            tier = (f", disk tier at {args.disk_dir} "
                    f"[{args.eviction}]" if args.disk_dir else "")
            exe = ("synchronous" if not args.stream else
                   "barrier-free" if args.barrier_free else "streaming")
            mode = (f"out-of-core (budget={budget}/{args.parts} "
                    f"partitions, {exe}{tier})")
        else:
            from repro_torch.core import run_host
            host_cb = ((lambda i, v, m, g, rec: show(i, rec))
                       if show is not None else None)
            res = run_host(vert, program, plan, max_supersteps=40,
                           on_superstep=host_cb, **ft_kw)
            mode = "in-memory"
    except BaseException:
        # leave no recorder running behind a failed job
        trace.stop()
        explain.stop()
        memwatch.stop()
        raise
    vals = gather_values(res.vertex, n)
    print(f"{args.algo} on {args.dataset} [{mode}, {args.device}]: "
          f"{res.supersteps} supersteps, {res.wall_s:.2f}s wall")
    if sharded(args):
        ex = [s for s in res.stats if "exchange_stall_s" in s]
        if ex:
            print(f"exchange: "
                  f"{sum(s['exchange_stall_s'] for s in ex):.3f}s stall, "
                  f"{sum(s['exchange_bytes'] for s in ex) / 2**20:.1f} "
                  f"MiB over {len(ex)} supersteps on {len(res.workers)} "
                  f"workers ({ex[-1]['transport']})")
    for ev in res.recovery or ():
        print(f"recovery #{ev.get('attempt')}: restored from "
              f"{ev.get('restored_from') or 'initial relations'} onto "
              f"{ev.get('healthy_workers')} worker(s) "
              f"(blacklist {ev.get('blacklist') or '[]'}) after "
              f"{ev.get('error')}")
    if args.ooc and args.disk_dir:
        recs = [s for s in res.stats if "cache_hit_rate" in s]
        if recs:
            hr = sum(s["cache_hit_rate"] for s in recs) / len(recs)
            sb = sum(s["spill_read_bytes"] + s["spill_write_bytes"]
                     for s in recs)
            qd = max((s.get("io_queue_depth", 0) for s in recs),
                     default=0)
            print(f"disk tier: mean page hit rate {hr:.2f}, "
                  f"{sb / 2**20:.1f} MiB spilled, "
                  f"io queue depth peak {qd}")
    if args.ooc:
        recs = [s for s in res.stats if "readiness_stall_s" in s]
        if recs:
            stall = sum(s["readiness_stall_s"] for s in recs)
            pipe = ("barrier-free" if args.barrier_free and args.stream
                    else "barrier")
            print(f"readiness stall: {stall:.3f}s total over "
                  f"{len(recs)} supersteps ({pipe})")
    if args.auto_plan:
        switches = [s for s in res.stats
                    if s.get("event") == "plan-switch"]
        print(f"final plan: join={res.plan.join} "
              f"groupby={res.plan.groupby} "
              f"connector={res.plan.connector} "
              f"sender_combine={res.plan.sender_combine} "
              f"storage={res.plan.storage}; "
              f"{len(switches)} plan switch(es)")
        for s in switches:
            print(f"  superstep {s['superstep']}: -> join={s['join']} "
                  f"connector={s['connector']} "
                  f"sender_combine={s['sender_combine']} "
                  f"storage={s.get('storage', '-')}")
    print("per-superstep:", [round(s["wall_s"], 3) for s in res.stats
                             if "wall_s" in s])
    if args.metrics:
        for s in res.stats:
            m = s.get("metrics")
            if not m:
                continue
            print(f"metrics @ superstep {s.get('superstep', '?')}:")
            for name in sorted(m):
                snap = m[name]
                if isinstance(snap, dict):   # histogram percentiles
                    body = "  ".join(
                        f"{k}={v:.4g}" for k, v in snap.items())
                else:
                    body = f"{snap:.6g}"
                print(f"  {name:<22} {body}")
    rep = None
    if args.report or args.explain:
        aud = explain.stop()
        mem = memwatch.stop()
        rep = report.build_report(
            stats=res.stats, explain=aud, memwatch=mem,
            recovery=res.recovery,
            meta={"algo": args.algo, "dataset": args.dataset,
                  "mode": mode, "device": args.device,
                  "parts": args.parts, "plan": fmt_plan(res.plan),
                  "supersteps": res.supersteps, "wall_s": res.wall_s})
        if args.explain:
            print(report.to_markdown(rep))
        if args.report:
            report.write_report(args.report, rep)
            errs = report.validate_report(rep)
            print(f"report: {args.report} "
                  f"({len(rep['supersteps'])} supersteps, "
                  f"{len(rep['decisions'])} decisions, "
                  f"{len(errs)} schema violation(s))")
    if args.trace:
        summary = write_chrome_trace(args.trace, trace.stop())
        print(f"trace: {args.trace} "
              f"({summary['spans']} spans on "
              f"{summary['span_threads']} thread(s); load in "
              f"chrome://tracing or ui.perfetto.dev)")
    print("value head:", vals[:5, 0])
    return res, rep


def _run_sharded(args, vert, program, plan, show, ft_kw, pool):
    """The sharded modes: run_sharded over --devices ranks (in memory, or
    --ooc with the reference's per-worker budget rule). -> (RunResult,
    mode label)."""
    from repro_torch.core.sharded import run_sharded
    from repro_torch.launch.mesh import make_host_mesh
    if args.mesh == "production":   # in place, this process one rank
        mesh, n_dev = None, _join_production_world(args.device)
    else:
        mesh = make_host_mesh(args.devices or None, device=args.device)
        n_dev = mesh.n_workers
    ooc_kw, tier = {}, ""
    if args.ooc:
        per_worker = args.parts // n_dev
        budget = args.budget_partitions or _largest_half_divisor(per_worker)
        ooc_kw = dict(budget_partitions=budget, disk_dir=args.disk_dir,
                      memory_budget_bytes=args.memory_budget_bytes,
                      io_threads=args.io_threads,
                      readahead_pages=args.readahead_pages,
                      eviction=args.eviction)
        tier = (f", ooc budget={budget}/{per_worker} per worker" +
                (f", disk tier at {args.disk_dir}/worker*"
                 f" [{args.eviction}]" if args.disk_dir else ""))
        # sharded npz checkpointing is in-memory mode only; recover
        # without checkpoints would only restart from scratch
        ft_kw = dict(recover=args.recover, max_retries=args.max_retries)
    res = run_sharded(vert, program, plan, mesh=mesh, max_supersteps=40,
                      on_superstep=show, pool=pool, **ooc_kw, **ft_kw)
    return res, f"sharded x{n_dev} devices{tier}"


def _join_production_world(device: str) -> int:
    """The production mesh's world: under ``torchrun`` (its environment
    names the world) join it, one rank a card over NCCL on CUDA, gloo
    on the CPU; then require exactly 256 ranks. -> the rank count."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh, require_world
    mesh = make_production_mesh()
    if not dist.is_initialized() and "TORCHELASTIC_RUN_ID" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    require_world(mesh)
    return mesh.n_ranks


# ---------------------------------------------------------------------
# the dry run: rank 0's superstep of the production mesh, counted
# ---------------------------------------------------------------------

def dryrun_capacities(n_vertices: int, n_edges: int, P_total: int):
    """Per-partition vertex/edge slot capacities the dry run counts with
    (the load_graph slack factors applied to uniform partitioning)."""
    Np = int(math.ceil(n_vertices / P_total * 1.3)) + 1
    Ep = int(math.ceil(n_edges / P_total * 1.2)) + 1
    return Np, Ep


def abstract_graph_state(n_vertices: int, n_edges: int, P_total: int,
                         program, plan, mesh, *, p_local: int = 1):
    """The state rank 0 of ``mesh`` holds: its ``p_local`` partitions of
    the P_total-partition graph as ``meta`` tensors (shapes and dtypes,
    no data), and the EngineConfig of a rank of the mesh's fake group
    with the exchange inside the step. -> (vert, msg, gs, ec)."""
    from repro_torch.core.connector import ShardAxis
    from repro_torch.core.relations import (empty_msgs, empty_vertices,
                                            init_gs)
    from repro_torch.core.superstep import EngineConfig
    Np, Ep = dryrun_capacities(n_vertices, n_edges, P_total)
    if plan.sender_combine:
        cap = min(int((Ep / P_total + 8) * 1.5), Np + 8)
    else:
        cap = int((Ep / P_total + 8) * 1.5)
    ec = EngineConfig(n_parts=P_total, bucket_cap=max(cap, 8),
                      frontier_cap=int(Np * plan.frontier_capacity) + 8,
                      axis_name=ShardAxis(0, mesh.n_ranks, None, "fake"),
                      exchange_apart=False)
    vert = empty_vertices(p_local, Np, Ep, program.value_dims, "meta")
    msg = empty_msgs(p_local, P_total * ec.bucket_cap, program.msg_dims,
                     "meta")
    gs = init_gs(program.agg_dims, "meta")
    return vert, msg, gs, ec


def dryrun_auto_plan(program, n_vertices: int, n_edges: int, P_total: int,
                     machine):
    """``plan="auto"`` of the dry run: one static choice at superstep-0
    statistics (every vertex active) on ``machine``; the host drivers
    re-choose mid-run, the dry run cannot."""
    from repro_torch.planner import GraphStats, Observation, choose
    Np, Ep = dryrun_capacities(n_vertices, n_edges, P_total)
    g = GraphStats(n_vertices=n_vertices, n_edges=n_edges,
                   n_partitions=P_total, vertex_capacity=Np,
                   edge_capacity=Ep, value_dims=program.value_dims,
                   msg_dims=program.msg_dims)
    return choose(program, g, Observation(frontier_density=1.0),
                  machine=machine)[0]


def pregel_dryrun(algo: str, scale: str, mesh_kind: str, plan) -> dict:
    """Count rank 0's superstep of the production mesh (``mesh_kind``
    "multi": 512 ranks, else 256) at ``scale``: the step runs on meta
    tensors over a fake group of the mesh's size, the all-to-all and the
    all-reduces inside it, under ``launch/op_cost.measure``. Every rank
    holds the same shapes, so rank 0 stands for every device. ``plan``
    "auto" is chosen once, at superstep-0 statistics, with
    ``H100_MACHINE``. -> the reference's record, priced with
    ``H100_MACHINE``."""
    import dataclasses

    from repro_torch.core.superstep import make_superstep
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.planner.cost import H100_MACHINE as m
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    P_total = mesh.n_ranks
    n_v, n_e = GRAPH_SCALES[scale]
    program = make_program(algo, n_v)
    if plan == "auto":
        plan = dryrun_auto_plan(program, n_v, n_e, P_total, m)
        print(f"  auto-plan -> join={plan.join} groupby={plan.groupby} "
              f"connector={plan.connector} "
              f"sender_combine={plan.sender_combine}", flush=True)
    vert, msg, gs, ec = abstract_graph_state(n_v, n_e, P_total, program,
                                             plan, mesh)
    t0 = time.time()
    with fake_group(P_total):
        step = make_superstep(program, plan, ec)
        cost = op_cost.measure(step, vert, msg, gs)
    wall = time.time() - t0
    terms = {"compute_s": cost.flops / m.peak_flops,
             "memory_s": cost.bytes / m.hbm_bw,
             "collective_s": cost.coll_bytes / m.net_bw}
    return {
        "arch": f"pregelix-{algo}", "shape": scale, "mesh": mesh_kind,
        "status": "ok", "kind": "superstep", "chips": P_total,
        "plan": dataclasses.asdict(plan),
        # the probe's wall time: there is no compile
        "compile_s": round(wall, 2),
        "memory": {
            "argument_bytes": cost.argument_bytes,
            "temp_bytes": cost.peak_temp_bytes,
            "total_per_device_bytes": (cost.argument_bytes +
                                       cost.peak_temp_bytes),
            "arguments": {"vertex": op_cost.nbytes(vert),
                          "message": op_cost.nbytes(msg),
                          "global": op_cost.nbytes(gs)},
            "temp_is": TEMP_NOTE,
        },
        "per_device": {"flops": cost.flops, "bytes": cost.bytes,
                       "collective_bytes": cost.coll_bytes,
                       "collectives": dict(cost.coll_detail)},
        "roofline": {**terms,
                     "dominant": max(terms, key=terms.get),
                     "bound_s": max(terms.values())},
        "machine": {"name": "H100_MACHINE",
                    "peak_flops": m.peak_flops, "hbm_bw": m.hbm_bw,
                    "net_bw": m.net_bw, "net_bw_is": NET_NOTE},
    }


def dryrun(args: argparse.Namespace) -> list:
    """``--dryrun``: one record a mesh of ``--mesh`` into ``--out``.
    -> [(file path, record)]."""
    plan = plan_of(args)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    written = []
    for mk in meshes:
        name = f"{args.tag}_pregelix-{args.algo}_{args.scale}_{mk}.json"
        print(f"[pregel-dryrun] {args.algo} x {args.scale} x {mk}",
              flush=True)
        try:
            rec = pregel_dryrun(args.algo, args.scale, mk, plan)
        except Exception as e:  # noqa: BLE001 - the record carries it
            import traceback
            rec = {"status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-3000:]}
        path = out_dir / name
        path.write_text(json.dumps(rec, indent=1))
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"  ok probe={rec['compile_s']}s "
                  f"mem/dev={rec['memory']['total_per_device_bytes']/2**30:.2f}GiB "
                  f"dominant={r['dominant']}", flush=True)
        else:
            print("  error:", rec["error"][:200], flush=True)
        written.append((path, rec))
    return written


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dryrun:
        recs = dryrun(args)
        return 0 if all(r["status"] == "ok" for _, r in recs) else 1
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
