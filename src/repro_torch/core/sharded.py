"""Multi-device sharded driver (the paper's cluster story) — the port's
``run_sharded``.

``run_host`` rolls one device's frontier; ``run_out_of_core`` streams
super-partitions through ONE device. This driver spreads the partition
dimension over N ranks of ``torch.distributed`` and runs the bucketed
m-to-n exchange as a real collective, ``all_to_all_single``
(``connector.exchange_all_to_all``), instead of the emulated transpose.
Rank w owns the contiguous global partitions [w * P/N, (w+1) * P/N) —
the chunking of the bucket axis the all-to-all splits, which is what
makes the sharded run bit-for-bit equal to ``run_host``.

The reference is one controller over a device mesh; PyTorch's idiom is
one process a rank. ``run_sharded(..., devices=N)``, called from a
process with no process group, keeps the single-call API on top of
that: a ``RankPool`` of N spawned processes (``torch.multiprocessing``'s
spawn context) joins one gloo group through a ``FileStore`` in a
temporary directory (no TCP port, so concurrent runs never collide),
each rank takes its block of the relation, the ranks run the job in
lockstep, and the caller gets back a ``RunResult`` whose relation is
gathered onto the graph's device. Called inside an initialized group (a
``torchrun`` rank), it runs in place as that rank and every rank gets
the gathered result. A pool can be passed in (``pool=``) to run many
jobs on one set of ranks.

Device and transport are explicit (``launch/mesh.py``): a CUDA graph puts
rank w on ``cuda:(w % cards)`` and exchanges over NCCL when every rank
has a card of its own, over gloo otherwise (NCCL refuses two ranks on one
card); a CPU graph runs every rank on the CPU over gloo. A failure to
build the group or to run a collective raises. The port's CUDA fold and
gather run in every rank on the card, on either backend. Every
superstep's record carries ``transport`` and ``n_workers``.

Two modes, as in the reference:

* **In-memory** (default): each rank runs the superstep over its
  ``P/N`` partitions with the message exchange split out as its OWN
  stage (``EngineConfig.exchange_apart``), timed as an ``exchange`` span
  with ``exchange.bytes`` / ``exchange.stall_s`` counters (the planner's
  network axis). The global state is ``all_reduce``d inside the
  superstep; vote-to-halt and the overflow regrow are the same on every
  rank by construction. The adaptive controller reads wall times, which
  differ by rank, so it runs on rank 0 and its decision (plan switch,
  frontier refit) is broadcast. Checkpoints are npz of the gathered
  relations in the reference's format, written by rank 0.

* **Out-of-core** (``budget_partitions`` set): every rank has its own
  ``TieredStore`` (at ``disk_dir/worker{w}`` with a disk tier), streams
  its block through its device ``budget_partitions`` at a time in
  lockstep rounds, and each round's collected buckets cross the ranks in
  the raw (worker-major) all-to-all and LAND into per-destination inbox
  pages. A destination round dispatches only when every source has
  landed its runs (``ExchangeReadiness``). A regrow can span the
  exchange: already-landed pages are end-padded to the new run width
  and the overflowed round is redone. Mutating programs are refused (the
  host mutation inbox is not distributed).

``recover=True`` runs under ``runtime.failure.supervised_run``: a
recoverable failure raised in a rank reaches the supervisor as the same
typed exception, and the replay re-meshes onto ``_fit_devices(P,
healthy)`` ranks of the same pool. The caller's fault injector travels
to the ranks and its counts come back (``runtime.faults``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import connector
from repro_torch.core.connector import ShardAxis
from repro_torch.core.driver import (PlanArg, RunResult, _regrow_msgs,
                                     _resolve_plan, cuda_allocator,
                                     default_engine_config,
                                     grow_overflowed, init_vertex_values)
from repro_torch.core.plan import FRONTIER_FLOOR, PhysicalPlan
from repro_torch.core.relations import (GlobalState, MsgRel, VertexRel,
                                        empty_msgs, gs_from_numpy,
                                        gs_to_numpy, init_gs,
                                        vertex_to_numpy)
from repro_torch.core.superstep import make_superstep
from repro_torch.obs import explain, memwatch, trace
from repro_torch.obs.metrics import MetricsRegistry

_MSG_W = lambda D: (1 + D) * 4 + 1   # dst + payload + valid wire bytes
_VFIELDS = ("vid", "halt", "value", "edge_src", "edge_dst", "edge_val")
_STATE = ("vid", "halt", "value")    # what a non-mutating job changes
# seconds the pool waits for the other ranks' replies after one rank
# raised; a rank still inside a collective by then is killed with the
# pool (which respawns on its next job)
ERROR_GRACE_S = 20.0
START_TIMEOUT_S = 900.0     # for the ranks to import torch and join
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def _exchange_wire_bytes(P: int, n_parts: int, C: int, D: int,
                         n_workers: int) -> int:
    """Capacity-based bytes the all-to-all moves BETWEEN workers: the
    bucket block is (P, n_parts, C) slots of (dst+payload+valid), and
    (N-1)/N of every worker's slots target remote workers."""
    total = P * n_parts * C * _MSG_W(D)
    return int(total * (n_workers - 1) / max(n_workers, 1))


def _fit_devices(P: int, healthy: int) -> int:
    """Largest worker count <= ``healthy`` that P partitions divide over —
    the elastic re-mesh rule. P itself never changes on recovery, so the
    replay stays bit-for-bit; only the blocks-per-worker mapping
    shrinks."""
    for n in range(min(max(healthy, 1), P), 0, -1):
        if P % n == 0:
            return n
    return 1


class ExchangeReadiness:
    """Distributed per-destination readiness bookkeeping.

    A destination round (dst_worker, dst_round) becomes dispatchable for
    superstep i+1 once every (src_worker, src_round) pair of superstep i
    has landed its runs into the destination's inbox page — tracked here
    and asserted at dispatch."""

    def __init__(self, n_workers: int, n_rounds: int):
        self.n_workers = n_workers
        self.n_rounds = n_rounds
        self._landed: dict = {}   # (dst_w, dst_r) -> {(src_w, src_r)}

    def land(self, dst_worker: int, dst_round: int, src_round: int):
        """Record that ALL source workers' round-`src_round` runs landed
        for (dst_worker, dst_round) — one all-to-all delivers every
        source worker's chunk at once."""
        s = self._landed.setdefault((dst_worker, dst_round), set())
        s.update((w, src_round) for w in range(self.n_workers))

    def ready(self, dst_worker: int, dst_round: int) -> bool:
        got = self._landed.get((dst_worker, dst_round), ())
        return len(got) == self.n_workers * self.n_rounds

    def ready_round(self, dst_round: int) -> bool:
        return all(self.ready(w, dst_round)
                   for w in range(self.n_workers))

    def missing(self, dst_worker: int, dst_round: int) -> list:
        got = self._landed.get((dst_worker, dst_round), set())
        return sorted({(w, r) for w in range(self.n_workers)
                       for r in range(self.n_rounds)} - got)


# ---------------------------------------------------------------------
# the rank pool: spawned processes in one process group, taking jobs
# ---------------------------------------------------------------------

def _pack_error(exc: BaseException, rank: int) -> dict:
    """A rank's exception as (type, args, attributes) so the caller can
    raise the same type: exceptions whose __init__ takes other arguments
    than their message do not survive pickle's default path."""
    tb = traceback.format_exc()
    err = {"type": type(exc), "args": exc.args,
           "state": dict(getattr(exc, "__dict__", {})), "traceback": tb,
           "rank": rank}
    try:
        pickle.dumps(err)
    except Exception:  # noqa: BLE001 - an unpicklable exception
        err = {"type": RuntimeError,
               "args": (f"{type(exc).__name__}: {exc}",), "state": {},
               "traceback": tb, "rank": rank}
    return err


def _unpack_error(err: dict) -> BaseException:
    cls = err["type"]
    exc = cls.__new__(cls, *err["args"])
    BaseException.__init__(exc, *err["args"])
    exc.__dict__.update(err["state"])
    exc.add_note(f"raised in sharded rank {err['rank']}:\n"
                 f"{err['traceback']}")
    return exc


def _job_groups(cache: dict, n: int, backend: str, size: int):
    """(tensor group, object group) for a job over ranks 0..n-1. Every
    rank of the pool calls this for every job, so ``new_group`` (which
    all ranks must enter) stays in step; groups are cached by (n,
    backend). The pool's own group is gloo; the object group (decision
    broadcasts, host-side stats) is always gloo."""
    import torch.distributed as dist
    key = (n, backend)
    if key not in cache:
        ranks = list(range(n))
        if n == size and backend == "gloo":
            cache[key] = (None, None)
        else:
            og = None if n == size else dist.new_group(ranks,
                                                       backend="gloo")
            tg = og if backend == "gloo" else \
                dist.new_group(ranks, backend=backend)
            cache[key] = (tg, og)
    return cache[key]


def _rank_main(rank: int, size: int, init_method: str, device_type: str,
               inq, outq):
    """A pool rank: join the pool's gloo group, then run jobs until told
    to stop."""
    import torch.distributed as dist
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init_method,
                                rank=rank, world_size=size,
                                timeout=GROUP_TIMEOUT)
    except Exception as e:  # noqa: BLE001 - reported to the caller
        outq.put(("error", rank, _pack_error(e, rank)))
        return
    outq.put(("ready", rank, None))
    groups: dict = {}
    while True:
        msg = inq.get()
        if msg is None:
            break
        job, n, backend = msg
        try:
            tg, og = _job_groups(groups, n, backend, size)
            if job is None:
                outq.put(("idle", rank, None))
                continue
            ax = ShardAxis(rank, n, tg, backend)
            if "call" in job:      # RankPool.map
                outq.put(("done", rank,
                          {"value": job["call"](*job["args"], axis=ax)}))
                continue
            emit = ((lambda i, rec: outq.put(("progress", rank, (i, rec))))
                    if rank == 0 else None)
            res = _run_job(job, ax, og, emit, spawned=True)
            outq.put(("done", rank, res))
        except Exception as e:  # noqa: BLE001 - reported to the caller
            from repro_torch.runtime import faults
            err = _pack_error(e, rank)
            err["faults"] = faults.export_state()
            outq.put(("error", rank, err))
        finally:
            # drop the job now: a CUDA graph's tensors are the caller's
            # memory, held open by this process until released
            msg = job = None
            if device_type == "cuda":
                torch.cuda.empty_cache()
    dist.destroy_process_group()


class RankPool:
    """``n_workers`` spawned rank processes in one gloo process group
    (rendezvous through a ``FileStore`` in a temporary directory),
    taking sharded jobs in order. A job over n <= n_workers ranks runs on
    ranks 0..n-1 in a subgroup of its own backend (``launch/mesh.py``'s
    rule). A rank that dies, or a failed job whose other ranks do not
    answer within ``error_grace_s`` (one still inside a collective),
    kills the pool; the next job respawns it. Use as a context manager,
    or ``close()`` it."""

    error_grace_s = ERROR_GRACE_S

    def __init__(self, n_workers: int, device="cuda"):
        self.n_workers = int(n_workers)
        self.device_type = torch.device(device).type
        self._procs: list = []
        self._spawn()

    # ---- lifecycle ----------------------------------------------------
    def _spawn(self):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="pregelix-ranks-")
        init = f"file://{os.path.join(self._dir, 'store')}"
        self._out = ctx.Queue()
        self._ins = [ctx.Queue() for _ in range(self.n_workers)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(w, self.n_workers, init, self.device_type, self._ins[w],
                  self._out)) for w in range(self.n_workers)]
        for p in self._procs:
            p.start()
        want = set(range(self.n_workers))
        deadline = time.time() + START_TIMEOUT_S
        while want:
            kind, w, payload = self._get(deadline, want)
            if kind == "error":
                self._kill()
                raise _unpack_error(payload)
            want.discard(w)

    def _get(self, deadline: float, want: set):
        while True:
            try:
                return self._out.get(timeout=0.5)
            except queue.Empty:
                dead = [w for w in want if not self._procs[w].is_alive()]
                if dead or time.time() > deadline:
                    codes = {w: self._procs[w].exitcode for w in dead}
                    self._kill()
                    raise RuntimeError(
                        f"sharded ranks {sorted(dead)} died (exit codes "
                        f"{codes})" if dead else
                        "sharded ranks did not answer in time")

    def _kill(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def close(self):
        if not self._procs:
            return
        for q in self._ins:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
        self._kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- jobs ---------------------------------------------------------
    def map(self, fn: Callable, args: list, backend: str = "gloo") -> list:
        """Call ``fn(*args[w], axis=<rank w's ShardAxis>)`` in ranks 0 ..
        len(args)-1 together (``fn`` importable by name, its arguments
        and result picklable; tensors travel on the CPU) -> the results
        in rank order. A way to run one collective, e.g.
        ``connector.exchange_all_to_all``, on the pool's ranks."""
        return [r["value"] for r in self.run(
            [{"call": fn, "args": tuple(a)} for a in args], backend)]

    def run(self, jobs: list, backend: str,
            on_progress: Optional[Callable] = None) -> list:
        """Run ``jobs[w]`` on rank w (len(jobs) ranks, over ``backend``);
        -> the ranks' replies in rank order. A rank's exception is
        raised here as the same type (the lowest rank's, after the other
        ranks replied or ``error_grace_s`` passed)."""
        from repro_torch.runtime import faults
        n = len(jobs)
        if n > self.n_workers:
            raise ValueError(f"a {n}-rank job on a pool of "
                             f"{self.n_workers} ranks")
        if not self.alive:
            self._kill()
            self._spawn()
        for w in range(self.n_workers):
            self._ins[w].put((jobs[w] if w < n else None, n, backend))
        want = set(range(self.n_workers))
        done, errors = {}, {}
        grace = None
        try:
            while want:
                try:
                    kind, w, payload = self._out.get(timeout=0.5)
                except queue.Empty:
                    dead = [w for w in want
                            if not self._procs[w].is_alive()]
                    late = grace is not None and time.time() > grace
                    if dead or late:
                        codes = {w: self._procs[w].exitcode for w in dead}
                        self._kill()
                        if errors:
                            break
                        raise RuntimeError(
                            f"sharded ranks {sorted(dead)} died (exit "
                            f"codes {codes})")
                    continue
                if kind == "progress":
                    if on_progress is not None:
                        on_progress(*payload)
                    continue
                want.discard(w)
                if kind == "done":
                    done[w] = payload
                elif kind == "error":
                    errors[w] = payload
                    grace = grace or time.time() + self.error_grace_s
        except BaseException:
            if want:
                self._kill()
            raise
        for rep in list(done.values()) + list(errors.values()):
            faults.merge_state(rep.get("faults"))
        if errors:
            raise _unpack_error(errors[min(errors)])
        return [done[w] for w in range(n)]


# ---------------------------------------------------------------------
# the rank side: one job in one rank
# ---------------------------------------------------------------------

def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_dev(rel, fields, dev):
    """numpy block -> tensors on ``dev`` (bool kept)."""
    return {f: torch.from_numpy(np.ascontiguousarray(rel[f])).to(dev)
            for f in fields}


def _block(job) -> dict:
    """This rank's rows of the relation, as tensors where the caller
    left them: a CUDA graph travels as the caller's own tensors (CUDA
    IPC handles, no host copy) and each rank takes its ``rows``; a CPU
    graph travels as each rank's numpy block."""
    rows = job["rows"]
    out = {}
    for f, a in job["block"].items():
        t = a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(a))
        out[f] = t if rows is None else t[rows[0]:rows[1]]
    return out


def _gather_blocks(t: torch.Tensor, ax: ShardAxis) -> torch.Tensor:
    """Concatenate every rank's (P_local, ...) block on dim 0 (all
    ranks get it)."""
    import torch.distributed as dist
    if ax.world == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(ax.world)]
    dist.all_gather(parts, src, group=ax.group)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


class _Occupancy:
    """A remote store's occupancy, for ``memwatch.sample(stores=)``."""

    def __init__(self, occ: dict):
        self._occ = occ

    def occupancy(self) -> dict:
        return self._occ


def _run_job(job: dict, ax: ShardAxis, og, emit, *, spawned: bool) -> dict:
    """Run one rank's part of a job -> the rank's reply (its block of
    the final relation, the global state, rank 0's records, the rank's
    launches, peak device bytes, fault counts and recordings). A spawned
    rank records into its own tracer / ledger / memory watch when the
    caller had them on; in place, the caller's are used."""
    from repro_torch.kernels import COUNTERS
    from repro_torch.runtime import faults
    if job["device_type"] == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        dev = torch.device("cpu")
    if spawned:
        faults.install_state(job["faults"])
        if job["trace"]:
            trace.start()
        if job["explain"] and ax.rank == 0:
            explain.start()
        if job["memwatch"] and ax.rank == 0:
            memwatch.start()
    base = {k: c.launches for k, c in COUNTERS.items()}
    try:
        body = _ooc_rank if job["ooc"] else _inmem_rank
        out = body(job, ax, og, dev, emit)
    finally:
        if spawned:
            tracer, led, mw = trace.stop(), explain.stop(), memwatch.stop()
    out["launches"] = {k: c.launches - base[k] for k, c in COUNTERS.items()}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    out["device"] = str(dev)
    out["backend"] = ax.backend
    out["rank"] = ax.rank
    if spawned:
        out["faults"] = faults.export_state()
        out["trace"] = tracer.drain() if tracer is not None else None
        out["explain"] = led.as_dict() if led is not None else None
        out["memwatch"] = mw if mw is not None else None
    return out


def _decide(ax: ShardAxis, og, fn):
    """Rank 0 computes ``fn()``; every rank gets its value."""
    import torch.distributed as dist
    value = fn() if ax.rank == 0 else None
    if ax.world > 1:
        box = [value]
        dist.broadcast_object_list(box, src=0, group=og)
        value = box[0]
    return value


def _inmem_rank(job, ax: ShardAxis, og, dev, emit) -> dict:
    import torch.distributed as dist
    from repro_torch.core.ooc import _ShapeVert
    from repro_torch.planner.stats import StatsCollector
    from repro_torch.runtime import faults
    from repro_torch.runtime.checkpoint import save_checkpoint

    program = job["program"]
    plan = job["plan"]
    controller = job["controller"]
    N, P = ax.world, job["P"]
    P_l = P // N
    lo = ax.rank * P_l
    D = program.msg_dims
    i0, rmsg, rgs = 0, None, None
    if job["resume_from"] is not None:
        from repro_torch.runtime.checkpoint import load_checkpoint
        v, m, g = load_checkpoint(job["resume_from"], device="cpu")
        if v.num_partitions != P:
            raise ValueError(
                f"checkpoint has {v.num_partitions} partitions; the "
                f"sharded driver resumes at a fixed P={P}")
        blk = slice(lo, lo + P_l)
        vert = VertexRel(**{f: getattr(v, f)[blk].to(dev)
                            for f in _VFIELDS})
        rmsg = MsgRel(dst=m.dst[blk].to(dev), payload=m.payload[blk].to(dev),
                      valid=m.valid[blk].to(dev))
        rgs = GlobalState(**{f: getattr(g, f).to(dev)
                             for f in gs_to_numpy(g)})
        i0 = int(rgs.superstep)
        del v, m, g
    else:
        # a copy: the rows may be a view of the caller's CUDA memory
        vert = VertexRel(**{f: t.to(dev, copy=True)
                            for f, t in _block(job).items()})
    Np, Ep = vert.capacity, vert.edge_src.shape[1]
    shape = _ShapeVert(P, Np, Ep)
    ec = job["ec"] or default_engine_config(shape, program, plan)
    ec = dataclasses.replace(ec, axis_name=ax, exchange_apart=True)
    if rmsg is not None and rmsg.capacity > ec.n_parts * ec.bucket_cap:
        ec = dataclasses.replace(
            ec, bucket_cap=-(-rmsg.capacity // ec.n_parts))
    if explain.enabled() and ax.rank == 0:
        explain.attach(program, g=job["g"], plan=plan,
                       machine=job["machine"], space_kw=job["auto_space"])
    if memwatch.enabled() and ax.rank == 0:
        memwatch.configure(ec=ec, Np=Np, Ep=Ep,
                           value_dims=program.value_dims, msg_dims=D,
                           allocator=cuda_allocator(dev))

    step = make_superstep(program, plan, ec)
    if rgs is not None:
        gs = rgs
        msg = _regrow_msgs(rmsg, ec)
    else:
        gs = init_gs(program.agg_dims, dev)
        vert = init_vertex_values(vert, program, gs)
        msg = empty_msgs(P_l, ec.n_parts * ec.bucket_cap, D, dev)
    initial_plan = plan
    metrics = MetricsRegistry()
    coll = StatsCollector(n_partitions=P, vertex_capacity=Np, msg_dims=D,
                          n_vertices=job["n_live"], metrics=metrics)
    m_exb = metrics.counter("exchange.bytes")
    m_exs = metrics.counter("exchange.stall_s")
    m_regrows = metrics.counter("host.regrows")
    m_switches = metrics.counter("host.plan_switches")
    stats = []
    i = i0
    recompiled = True
    ckpt_every, ckpt_dir = job["checkpoint_every"], job["checkpoint_dir"]
    while i < job["max_supersteps"]:
        faults.superstep_tick(i, "sharded")
        ts = time.time()
        this_recompiled, recompiled = recompiled, False
        with trace.annotate("superstep", "compute"):
            vert2, buckets, gs2 = step(vert, msg, gs)
            ovf_delta = (gs2.overflow - gs.overflow).cpu().numpy()
        if (ovf_delta > 0).any():
            # overflow is all-reduced: every rank regrows together
            ec = grow_overflowed(ec, ovf_delta, vertex_capacity=Np)
            step = make_superstep(program, plan, ec)
            msg = _regrow_msgs(msg, ec)
            stats.append(coll.event(
                i, "regrow", bucket_cap=ec.bucket_cap,
                frontier_cap=ec.frontier_cap,
                mutation_cap=ec.mutation_cap,
                sources=np.flatnonzero(ovf_delta > 0).tolist()).as_dict())
            m_regrows.inc()
            trace.instant("regrow", "replan", superstep=i)
            recompiled = True
            if controller is not None:
                controller.note_shape_change()
            continue
        # ---- the all-to-all exchange, as its own timed stage ---------
        faults.hit("sharded.exchange", f"s{i}")
        _sync(dev)
        t_ex = time.time()
        r_dst, r_pay, r_val = connector.exchange_all_to_all(
            buckets.dst, buckets.payload, buckets.valid, ax)
        _sync(dev)
        t_done = time.time()
        msg = MsgRel(dst=r_dst.reshape(P_l, -1),
                     payload=r_pay.reshape(P_l, -1, D),
                     valid=r_val.reshape(P_l, -1))
        ex_stall = t_done - t_ex
        ex_bytes = _exchange_wire_bytes(P, ec.n_parts, ec.bucket_cap, D, N)
        trace.complete("exchange", "exchange", t_ex, t_done,
                       superstep=i + 1, bytes=ex_bytes, workers=N,
                       worker=ax.rank)
        m_exb.inc(ex_bytes)
        m_exs.inc(ex_stall)
        vert, gs = vert2, gs2
        i += 1
        rec = coll.record(i, active=int(gs.active_count),
                          messages=int(gs.msg_count),
                          wall_s=time.time() - ts,
                          recompiled=this_recompiled,
                          sharded=True, n_workers=N,
                          transport=ax.backend,
                          exchange_bytes=ex_bytes,
                          exchange_stall_s=ex_stall)
        stats.append(rec.as_dict())
        if explain.enabled() and ax.rank == 0:
            explain.superstep(rec, plan=plan, bucket_cap=ec.bucket_cap)
        if memwatch.enabled() and ax.rank == 0:
            memwatch.sample(i)

        def decide():
            new_plan = None
            if controller is not None and not bool(gs.halt):
                with trace.span("replan", "replan"):
                    new_plan = controller.observe(rec,
                                                  bucket_cap=ec.bucket_cap)
            refit = None
            if new_plan is None and plan.join == "left_outer":
                act = int(gs.active_count) // max(P, 1) + 1
                if act * 4 < ec.frontier_cap and \
                        ec.frontier_cap > FRONTIER_FLOOR:
                    refit = max(FRONTIER_FLOOR, act * 2)
            return new_plan, refit

        new_plan, refit = _decide(ax, og, decide)
        if new_plan is not None:
            from repro_torch.planner import migrate_msgs
            msg = migrate_msgs(msg, plan, new_plan, ec.n_parts)
            plan = new_plan
            if plan.join == "left_outer":
                act = int(gs.active_count) // max(P, 1) + 1
                ec = dataclasses.replace(
                    ec, frontier_cap=min(max(FRONTIER_FLOOR, act * 4),
                                         Np + 8))
            need = default_engine_config(shape, program, plan)
            if need.bucket_cap > ec.bucket_cap:
                ec = dataclasses.replace(ec, bucket_cap=need.bucket_cap)
                msg = _regrow_msgs(msg, ec)
            step = make_superstep(program, plan, ec)
            stats.append(coll.event(
                i, "plan-switch", join=plan.join, groupby=plan.groupby,
                connector=plan.connector,
                sender_combine=plan.sender_combine, storage=plan.storage,
                frontier_cap=ec.frontier_cap).as_dict())
            m_switches.inc()
            recompiled = True
            if controller is not None:
                controller.note_shape_change()
        elif refit is not None:
            ec = dataclasses.replace(ec, frontier_cap=refit)
            step = make_superstep(program, plan, ec)
            stats.append(coll.event(i, "frontier-refit",
                                    frontier_cap=ec.frontier_cap).as_dict())
            recompiled = True
            if controller is not None:
                controller.note_shape_change()
        if ckpt_every and i % ckpt_every == 0 and ckpt_dir:
            with trace.span("checkpoint", "checkpoint"):
                full_v = VertexRel(**{f: _gather_blocks(getattr(vert, f),
                                                        ax)
                                      for f in _VFIELDS})
                full_m = MsgRel(dst=_gather_blocks(msg.dst, ax),
                                payload=_gather_blocks(msg.payload, ax),
                                valid=_gather_blocks(msg.valid, ax))
                if ax.rank == 0:
                    save_checkpoint(ckpt_dir, i, full_v, full_m, gs)
                del full_v, full_m
                if N > 1:
                    # the snapshot is a superstep boundary for every
                    # rank: none runs on (and may fail) before it commits
                    dist.barrier(group=og)
        if emit is not None:
            emit(i, rec.as_dict())
        if bool(gs.halt):
            break
    fields = _VFIELDS if program.mutates else _STATE
    return {"vertex": {f: getattr(vert, f).cpu().numpy() for f in fields},
            "gs": gs_to_numpy(gs), "supersteps": i,
            "stats": stats if ax.rank == 0 else None, "plan": plan,
            "initial_plan": initial_plan}


def _ooc_rank(job, ax: ShardAxis, og, dev, emit) -> dict:
    import torch.distributed as dist
    from repro_torch.core.ooc import _ShapeVert
    from repro_torch.planner.stats import StatsCollector
    from repro_torch.runtime import faults
    from repro_torch.storage.tiered import TieredStore

    program, plan = job["program"], job["plan"]
    if program.mutates:
        raise NotImplementedError(_NO_OOC_MUTATIONS)
    N, P = ax.world, job["P"]
    P_w = P // N                     # partitions owned per worker
    b = int(job["budget_partitions"])   # resident partitions per worker
    R = P_w // b                     # lockstep rounds per superstep
    D = program.msg_dims
    block = {f: t.cpu().numpy() for f, t in _block(job).items()}
    Np, Ep = block["vid"].shape[1], block["edge_src"].shape[1]
    base_ec = job["ec"] or default_engine_config(_ShapeVert(P, Np, Ep),
                                                 program, plan)
    ec = dataclasses.replace(base_ec, axis_name=ax, ooc_collect=True)
    budget = job["memory_budget_bytes"]
    if explain.enabled() and ax.rank == 0:
        explain.attach(program, g=job["g"], plan=plan,
                       machine=job["machine"], space_kw=job["auto_space"])
    if memwatch.enabled() and ax.rank == 0:
        memwatch.configure(ec=ec, Np=Np, Ep=Ep,
                           value_dims=program.value_dims, msg_dims=D,
                           budget_bytes=budget * N if budget else None,
                           allocator=cuda_allocator(dev))
    metrics = MetricsRegistry()
    coll = StatsCollector(n_partitions=P, vertex_capacity=Np, msg_dims=D,
                          n_vertices=job["n_live"], metrics=metrics)
    m_exb = metrics.counter("exchange.bytes")
    m_exs = metrics.counter("exchange.stall_s")
    m_regrows = metrics.counter("host.regrows")

    # ---- this rank's tiered store (the tiers shard with the graph)
    disk_dir = job["disk_dir"]
    threads = (job["io_threads"] if job["io_threads"] is not None
               else (1 if disk_dir else 0))
    store = TieredStore(
        n_sp=R, budget_bytes=budget,
        disk_dir=f"{disk_dir}/worker{ax.rank}" if disk_dir else None,
        policy=job["eviction"], io_threads=threads,
        readahead_pages=job["readahead_pages"], metrics=metrics)
    try:
        gs = init_gs(program.agg_dims, "cpu")
        gs_dev = GlobalState(**{f: getattr(gs, f).to(dev)
                                for f in gs_to_numpy(gs)})
        value = np.empty_like(block["value"])
        for r in range(R):
            rows = slice(r * b, (r + 1) * b)
            vpart = VertexRel(**_to_dev({f: block[f][rows]
                                         for f in _VFIELDS}, _VFIELDS, dev))
            value[rows] = init_vertex_values(vpart, program,
                                             gs_dev).value.cpu().numpy()
        for f in _VFIELDS:
            store.register(f, value if f == "value" else block[f])
        del block, value, vpart, gs_dev
        gen = 0
        gen_width = {0: ec.bucket_cap}   # inbox run width per generation
        step = make_superstep(program, plan, ec)
        ready_prev = None   # landings that built the current inbox gen

        def empty_inbox(C_in):
            return (np.full((b, P, C_in), -1, np.int32),
                    np.zeros((b, P, C_in, D), np.float32),
                    np.zeros((b, P, C_in), bool))

        def read_inbox(r):
            try:
                return tuple(store.get_page(("inbox", gen, r, k))
                             for k in ("dst", "pay", "val"))
            except KeyError:
                return empty_inbox(gen_width[gen])

        stats = []
        i = 0
        halted = False
        recompiled = True
        while i < job["max_supersteps"] and not halted:
            faults.superstep_tick(i, "sharded")
            ts = time.time()
            this_recompiled, recompiled = recompiled, False
            nxt: dict = {}           # dst_round -> (d, p, v) pages
            readiness = ExchangeReadiness(N, R)
            fold_active = fold_msgs = 0
            fold_agg = np.zeros((program.agg_dims,), np.float32)
            local_halt = True
            ex_stall_total = 0.0
            ex_bytes_total = 0
            stall_total = 0.0
            delta_bytes = full_bytes = 0
            gdev = GlobalState(**{f: getattr(gs, f).to(dev)
                                  for f in gs_to_numpy(gs)})
            r = 0
            while r < R:
                # ---- distributed readiness gate: every source must have
                # landed this destination round's runs before dispatch
                t_gate = time.time()
                if ready_prev is not None and not ready_prev.ready(ax.rank, r):
                    raise RuntimeError(
                        f"superstep {i} round {r} dispatched before all "
                        f"sources landed: missing "
                        f"{ready_prev.missing(ax.rank, r)}")
                stall_total += time.time() - t_gate
                # ---- this rank's resident block (b partitions)
                with trace.span("dispatch", "dispatch", superstep=i,
                                round=r):
                    C_in = gen_width[gen]
                    d_in, p_in, v_in = read_inbox(r)
                    vdev = VertexRel(**_to_dev(
                        {f: store.read(f, r) for f in _VFIELDS}, _VFIELDS,
                        dev))
                    mdev = MsgRel(**_to_dev(
                        {"dst": d_in.reshape(b, P * C_in),
                         "payload": p_in.reshape(b, P * C_in, D),
                         "valid": v_in.reshape(b, P * C_in)},
                        ("dst", "payload", "valid"), dev))
                vert2, buckets, gs2, _, _ = step(vdev, mdev, gdev)
                ovf_delta = (gs2.overflow.cpu() - gs.overflow).numpy()
                if (ovf_delta > 0).any():
                    # regrow SPANNING the exchange: grow, rebuild, end-pad the
                    # pages already landed for gen+1 to the new run width, and
                    # redo this round (nothing of round r landed yet)
                    ec = grow_overflowed(ec, ovf_delta, vertex_capacity=Np)
                    step = make_superstep(program, plan, ec)
                    C_new = ec.bucket_cap
                    for key, (pd, pp, pv) in list(nxt.items()):
                        pad = C_new - pd.shape[2]
                        if pad > 0:
                            nxt[key] = (
                                np.pad(pd, ((0, 0), (0, 0), (0, pad)),
                                       constant_values=-1),
                                np.pad(pp, ((0, 0), (0, 0), (0, pad), (0, 0))),
                                np.pad(pv, ((0, 0), (0, 0), (0, pad))))
                    stats.append(coll.event(
                        i, "regrow", bucket_cap=ec.bucket_cap,
                        frontier_cap=ec.frontier_cap, round=r,
                        sources=np.flatnonzero(ovf_delta > 0).tolist())
                        .as_dict())
                    m_regrows.inc()
                    trace.instant("regrow", "replan", superstep=i, round=r)
                    recompiled = True
                    continue
                C = ec.bucket_cap
                # ---- the all-to-all exchange stage (timed)
                faults.hit("sharded.exchange", f"s{i}r{r}")
                _sync(dev)
                t_ex = time.time()
                xd, xp, xv = connector.exchange_all_to_all(
                    buckets.dst, buckets.payload, buckets.valid, ax,
                    dst_major=False)
                _sync(dev)
                t_done = time.time()
                ex_bytes = _exchange_wire_bytes(N * b, P, C, D, N)
                trace.complete("exchange", "exchange", t_ex, t_done,
                               superstep=i, round=r, bytes=ex_bytes,
                               worker=ax.rank)
                ex_stall_total += t_done - t_ex
                ex_bytes_total += ex_bytes
                m_exb.inc(ex_bytes)
                m_exs.inc(t_done - t_ex)
                # ---- land the worker-major runs into per-destination pages
                t_land = time.time()
                # y[p, j, t]: source rank j's round-r row p -> my local dst t
                yd = xd.cpu().numpy().reshape(b, N, P_w, C)
                yp = xp.cpu().numpy().reshape(b, N, P_w, C, D)
                yv = xv.cpu().numpy().reshape(b, N, P_w, C)
                with trace.span("commit", "commit", superstep=i, round=r):
                    ssl = slice(r * b, (r + 1) * b)
                    for rd in range(R):
                        if rd not in nxt:
                            nxt[rd] = empty_inbox(C)
                        pd, pp, pv = nxt[rd]
                        tsl = slice(rd * b, (rd + 1) * b)
                        # page run index = GLOBAL src partition j*P_w + r*b +
                        # p; valid entries stay a prefix
                        pd.reshape(b, N, P_w, C)[:, :, ssl] = \
                            yd[:, :, tsl].transpose(2, 1, 0, 3)
                        pp.reshape(b, N, P_w, C, D)[:, :, ssl] = \
                            yp[:, :, tsl].transpose(2, 1, 0, 3, 4)
                        pv.reshape(b, N, P_w, C)[:, :, ssl] = \
                            yv[:, :, tsl].transpose(2, 1, 0, 3)
                        readiness.land(ax.rank, rd, r)
                    # ---- commit the updated vertex block to this rank's store
                    nv = {f: getattr(vert2, f).cpu().numpy()
                          for f in ("vid", "halt", "value", "edge_dst",
                                    "edge_val")}
                    local_halt &= bool(np.all(nv["halt"] | (nv["vid"] < 0)))
                    for f, new in nv.items():
                        old = store.read(f, r)
                        if plan.storage == "delta":
                            mask = (new != old).reshape(b, -1).any(1)
                            delta_bytes += int(mask.sum()) * new[0].nbytes
                            store.write_rows(f, r, mask, new[mask])
                        else:
                            delta_bytes += new.nbytes
                            store.write(f, r, new)
                        full_bytes += new.nbytes
                    if threads and r + 1 < R:
                        store.readahead([(f, r + 1) for f in _VFIELDS])
                stall_total += time.time() - t_land
                fold_active += int(gs2.active_count)
                fold_msgs += int(gs2.msg_count)
                fold_agg += gs2.aggregate.cpu().numpy()
                r += 1
            # ---- GS fold across rounds and ranks
            i += 1
            new_gen = gen + 1
            gen_width[new_gen] = ec.bucket_cap
            for rd, (pd, pp, pv) in nxt.items():
                store.put_page(("inbox", new_gen, rd, "dst"), pd)
                store.put_page(("inbox", new_gen, rd, "pay"), pp)
                store.put_page(("inbox", new_gen, rd, "val"), pv)
            for rd in range(R):
                for k in ("dst", "pay", "val"):
                    try:
                        store.delete_page(("inbox", gen, rd, k))
                    except KeyError:
                        pass
            gen = new_gen
            ready_prev = readiness
            # the host-side measurements of every rank, summed as the
            # reference sums its per-worker stores
            mine = {"halt": local_halt, "delta": delta_bytes,
                    "full": full_bytes, "tier": store.take_interval(),
                    "spill": store.spilling,
                    "occ": store.occupancy() if job["memwatch"] else None}
            every = [mine]
            if N > 1:
                every = [None] * N
                dist.all_gather_object(every, mine, group=og)
            all_halt = all(e["halt"] for e in every)
            delta_bytes = sum(e["delta"] for e in every)
            full_bytes = sum(e["full"] for e in every)
            conv = bool(program.is_converged(gs))
            halted = (all_halt and fold_msgs == 0) or conv
            gs = GlobalState(
                halt=torch.tensor(halted),
                aggregate=torch.from_numpy(fold_agg).reshape(
                    gs.aggregate.shape),
                superstep=gs.superstep + 1,
                overflow=gs.overflow,
                active_count=torch.tensor(fold_active, dtype=torch.int32),
                msg_count=torch.tensor(fold_msgs, dtype=torch.int32))
            tier = {}
            for e in every:
                for k, v in e["tier"].items():
                    tier[k] = tier.get(k, 0) + v
            extra = dict(ooc=True, sharded=True, n_workers=N,
                         transport=ax.backend, super_partitions=R,
                         streaming=False, barrier_free=False,
                         exchange_bytes=ex_bytes_total,
                         exchange_stall_s=ex_stall_total,
                         readiness_stall_s=stall_total,
                         delta_bytes=delta_bytes, full_bytes=full_bytes,
                         change_density=(delta_bytes / full_bytes
                                         if full_bytes else 1.0),
                         storage=plan.storage,
                         spill=any(e["spill"] for e in every))
            hits = tier.get("hits", 0)
            total_lookups = hits + tier.get("misses", 0)
            if total_lookups:
                extra["cache_hit_rate"] = hits / total_lookups
            for k in ("spill_read_bytes", "spill_write_bytes"):
                if k in tier:
                    extra[k] = tier[k]
            rec = coll.record(i, active=fold_active, messages=fold_msgs,
                              wall_s=time.time() - ts,
                              recompiled=this_recompiled, **extra)
            stats.append(rec.as_dict())
            if explain.enabled() and ax.rank == 0:
                explain.superstep(rec, plan=plan, bucket_cap=ec.bucket_cap)
            if memwatch.enabled() and ax.rank == 0:
                # N workers each keep b partitions resident at once
                memwatch.sample(i, stores=[_Occupancy(e["occ"])
                                           for e in every],
                                resident_parts=N * b)
            if emit is not None:
                emit(i, rec.as_dict())
        return {"vertex": {f: store.gather(f) for f in _STATE},
                "gs": gs_to_numpy(gs), "supersteps": i,
                "stats": stats if ax.rank == 0 else None, "plan": plan,
                "initial_plan": plan}
    finally:
        store.close()


# ---------------------------------------------------------------------
# the caller's side
# ---------------------------------------------------------------------

_NO_OOC_MUTATIONS = (
    "mutating programs are not supported in sharded OOC mode (the host "
    "mutation inbox is not distributed); run in-memory sharded or "
    "single-host OOC")


def run_sharded(vert: VertexRel, program, plan: PlanArg = PhysicalPlan(),
                *, mesh=None, devices: Optional[int] = None,
                max_supersteps: int = 50, ec=None,
                on_superstep: Optional[Callable] = None,
                auto_config=None, auto_space: Optional[dict] = None,
                budget_partitions: int = 0,
                disk_dir: Optional[str] = None,
                memory_budget_bytes: Optional[int] = None,
                io_threads: Optional[int] = None,
                readahead_pages: int = 8, eviction: str = "lru",
                checkpoint_every: int = 0,
                checkpoint_dir: Optional[str] = None,
                resume_from: Optional[str] = None,
                recover: bool = False, max_retries: int = 3,
                machine=None, pool: Optional[RankPool] = None) -> RunResult:
    """Run ``program`` over N ranks: ``mesh`` (a ``launch.mesh.HostMesh``)
    or ``devices`` sets N for the graph's device (``make_host_mesh``); the
    P partitions shard over the ranks in contiguous blocks. With
    ``budget_partitions`` set, each rank streams its block through its
    device ``budget_partitions`` at a time from its own tiered store.
    ``on_superstep(i, stats_dict)`` is called in this process as rank 0's
    records arrive. ``pool`` runs the job on an existing ``RankPool``
    (else one is spawned for the call).

    ``checkpoint_every``/``checkpoint_dir`` snapshot the gathered global
    relations as npz at superstep boundaries (in-memory mode only);
    ``resume_from=<ckpt npz>`` restarts from one. ``recover=True`` runs
    under the recovery supervisor: a recoverable failure blacklists the
    failed worker, restores the latest VALID checkpoint, re-meshes onto
    the largest divisor of P that fits the surviving worker count and
    replays (P never changes, so the replay is bit-for-bit)."""
    import torch.distributed as dist
    t0 = time.time()
    device = vert.vid.device
    in_place = pool is None and dist.is_available() and \
        dist.is_initialized()
    if in_place:
        N = dist.get_world_size()
    else:
        from repro_torch.launch.mesh import make_host_mesh
        if mesh is None:
            mesh = make_host_mesh(devices, device=device)
        N = mesh.n_workers
    P = vert.num_partitions
    if P % N:
        raise ValueError(f"n_partitions {P} must divide over {N} devices")
    if budget_partitions:
        if program.mutates:
            raise NotImplementedError(_NO_OOC_MUTATIONS)
        if checkpoint_every or resume_from:
            raise ValueError("sharded npz checkpointing is in-memory mode "
                             "only (per-worker OOC stores keep their state "
                             "on their own disk tiers)")
        if (P // N) % budget_partitions:
            raise ValueError(f"budget_partitions {budget_partitions} must "
                             f"divide the per-worker block {P // N}")
    if checkpoint_every and not checkpoint_dir:
        raise ValueError("checkpoint_every needs a checkpoint_dir")
    if machine is None:
        from repro_torch.planner.cost import machine_for
        machine = machine_for(device)
    kw = dict(max_supersteps=max_supersteps, ec=ec,
              on_superstep=on_superstep, auto_config=auto_config,
              auto_space=auto_space, budget_partitions=budget_partitions,
              disk_dir=disk_dir, memory_budget_bytes=memory_budget_bytes,
              io_threads=io_threads, readahead_pages=readahead_pages,
              eviction=eviction, checkpoint_every=checkpoint_every,
              checkpoint_dir=checkpoint_dir, machine=machine)
    if recover:
        if in_place:
            raise ValueError("recover=True re-meshes onto fewer ranks: "
                             "call run_sharded from a process with no "
                             "process group")
        from repro_torch.runtime.checkpoint import latest_checkpoint
        from repro_torch.runtime.failure import supervised_run
        own = pool is None
        pool = pool or RankPool(N, device)

        def _attempt(healthy, resume):
            return run_sharded(vert, program, plan,
                               devices=_fit_devices(P, healthy),
                               resume_from=resume, recover=False,
                               pool=pool, **kw)

        def _pick(bad):
            if not checkpoint_dir:
                return None
            return latest_checkpoint(checkpoint_dir, skip=bad, verify=True)

        try:
            return supervised_run(_attempt, _pick, n_workers=N,
                                  max_retries=max_retries,
                                  initial_resume=resume_from)
        finally:
            if own:
                pool.close()
    kw.pop("on_superstep")
    # a CUDA graph (or a rank's own graph, in place) is shared as
    # tensors; a CPU graph goes to the spawned ranks as numpy blocks
    job, blocks, controller = _make_job(
        vert, program, plan, N=N, shared=in_place or device.type == "cuda",
        resume_from=resume_from, **kw)
    if in_place:
        rank = dist.get_rank()
        job.update(blocks(rank), controller=controller
                   if rank == 0 else None)
        ax = ShardAxis(rank, N, None, dist.get_backend())
        mine = _run_job(job, ax, None, on_superstep, spawned=False)
        replies = [None] * N
        dist.all_gather_object(replies, mine)
        return _assemble(vert, replies, t0)
    own = pool is None
    if own:
        pool = RankPool(N, device)
    try:
        jobs = [dict(job, **blocks(w),
                     controller=controller if w == 0 else None)
                for w in range(N)]
        replies = pool.run(jobs, mesh.backend, on_progress=on_superstep)
    finally:
        if own:
            pool.close()
    _adopt_recordings(replies)
    return _assemble(vert, replies, t0)


def _make_job(vert, program, plan, *, N, shared, resume_from, ec,
              auto_config, auto_space, budget_partitions, machine,
              max_supersteps, disk_dir, memory_budget_bytes, io_threads,
              readahead_pages, eviction, checkpoint_every, checkpoint_dir):
    """The caller-side half: resolve the plan with the whole graph in
    hand, and the job every rank gets (``blocks(w)``: rank w's
    partitions, see ``_block``)."""
    from repro_torch.planner.cost import GraphStats, Observation
    from repro_torch.runtime import faults
    P = vert.num_partitions
    ooc = bool(budget_partitions)
    R = (P // N) // budget_partitions if ooc else 1
    obs0 = Observation(frontier_density=1.0, sharded=True, n_workers=N,
                       ooc=ooc, super_partitions=R)
    # "auto" resolves once in out-of-core mode (non-adaptive), as in the
    # reference: a switch would rebuild every round's step
    plan, controller = _resolve_plan(
        vert, program, plan, adaptive=not ooc, auto_config=auto_config,
        auto_space=auto_space, machine=machine, obs0=obs0)
    g = controller.g if controller is not None else None
    if g is None and explain.enabled():
        g = GraphStats.from_vertex(vert, program)
    n_live = (controller.g.n_vertices if controller is not None
              else int((vert.vid >= 0).sum()))
    P_l = P // N
    host = None if shared or resume_from is not None else \
        vertex_to_numpy(vert)

    def blocks(w):
        rows = (w * P_l, (w + 1) * P_l)
        if resume_from is not None:
            return dict(block=None, rows=None)
        if shared:
            return dict(block={f: getattr(vert, f) for f in _VFIELDS},
                        rows=rows)
        return dict(block={f: a[rows[0]:rows[1]] for f, a in host.items()},
                    rows=None)

    job = dict(program=program, plan=plan, ec=ec, P=P, n_live=n_live, g=g,
               machine=machine, auto_space=auto_space,
               max_supersteps=max_supersteps, resume_from=resume_from,
               checkpoint_every=checkpoint_every,
               checkpoint_dir=checkpoint_dir, ooc=ooc,
               budget_partitions=budget_partitions, disk_dir=disk_dir,
               memory_budget_bytes=memory_budget_bytes,
               io_threads=io_threads, readahead_pages=readahead_pages,
               eviction=eviction, device_type=vert.vid.device.type,
               faults=faults.export_state(), trace=trace.enabled(),
               explain=explain.enabled(), memwatch=memwatch.enabled())
    return job, blocks, controller


def _adopt_recordings(replies: list):
    """Fold the ranks' recordings into the caller's: every rank's trace
    threads (named ``<thread> [worker w]``), rank 0's audit rows and
    decisions, rank 0's memory samples."""
    tracer = trace.get()
    led = explain.get()
    mw = memwatch.get()
    for rep in replies:
        w = rep["rank"]
        if tracer is not None and rep.get("trace"):
            tracer.adopt(rep["trace"], f"worker {w}", (w + 1) << 32)
        if led is not None and rep.get("explain"):
            led.rows.extend(rep["explain"]["supersteps"])
            led.decisions.extend(rep["explain"]["decisions"])
        got = rep.get("memwatch")
        if mw is not None and got is not None:
            mw.samples.extend(got.samples)
            for k, v in got.peaks.items():
                mw._peak(k, v)
            if got._budget is not None:
                mw._budget = got._budget
            if got._hbm_ctx is not None:
                mw._hbm_ctx = got._hbm_ctx


def _assemble(vert: VertexRel, replies: list, t0: float) -> RunResult:
    """The ranks' blocks, in rank order, on the graph's device; fields a
    job did not change come from ``vert``."""
    device = vert.vid.device
    first = replies[0]
    fields = {}
    for f in _VFIELDS:
        if f in first["vertex"]:
            cat = np.concatenate([r["vertex"][f] for r in replies])
            fields[f] = torch.from_numpy(cat).to(device)
        else:
            fields[f] = getattr(vert, f)
    workers = [{"rank": r["rank"], "device": r["device"],
                "transport": r["backend"], "peak_bytes": r["peak_bytes"],
                "launches": r["launches"]} for r in replies]
    return RunResult(vertex=VertexRel(**fields),
                     gs=gs_from_numpy(first["gs"], device),
                     supersteps=first["supersteps"], stats=first["stats"],
                     wall_s=time.time() - t0, plan=first["plan"],
                     initial_plan=first["initial_plan"], workers=workers)
