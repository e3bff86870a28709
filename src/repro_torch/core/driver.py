"""Job drivers.

* ``run_jit``  — a device loop over supersteps with fixed capacities; it
                 checks ``gs.halt`` and the overflow counters after each
                 superstep and raises on overflow.
* ``run_host`` — the superstep loop with per-superstep statistics
                 (Section 5.7 statistics collector), transparent capacity
                 growth on overflow (re-run the superstep from the retained
                 previous state), the left-outer frontier refit, mid-run
                 replanning under plan="auto", and checkpoints at
                 superstep boundaries with resume and supervised recovery
                 (Section 5.5). With the observability switches on it
                 records the reference's spans, audit rows, decisions,
                 memory samples and counters (``repro_torch.obs``).

Both run on the device the graph was loaded on. plan="auto" turns on the
cost-based planner (``repro_torch.planner``), with the machine model of
that device: ``run_jit`` resolves it once, ``run_host`` also re-chooses
at superstep boundaries.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.plan import FRONTIER_FLOOR, PhysicalPlan, \
    bucket_capacity
from repro_torch.core.program import VertexProgram
from repro_torch.core.relations import (OVF_BUCKET, OVF_EDGE, OVF_FRONTIER,
                                        OVF_MUTATION, GlobalState, MsgRel,
                                        VertexRel, empty_msgs, init_gs,
                                        out_degrees)
from repro_torch.core.superstep import EngineConfig, make_superstep
from repro_torch.obs import explain, memwatch, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.planner.stats import StatsCollector

PlanArg = Union[PhysicalPlan, str]   # a PhysicalPlan or the string "auto"
# run_host's counters of a program that mutates, one a superstep
MUTATION_COUNTERS = ("mutate.deleted", "mutate.resurrected")


@dataclass
class RunResult:
    vertex: VertexRel
    gs: GlobalState
    supersteps: int
    stats: list = field(default_factory=list)
    wall_s: float = 0.0
    plan: Optional[PhysicalPlan] = None   # plan in effect at the end
    # plan of the first superstep this call ran (the resumed one after a
    # resume): with the ``plan-switch`` events, every plan it went through
    initial_plan: Optional[PhysicalPlan] = None
    recovery: list = field(default_factory=list)  # supervisor events
    # sharded runs: one dict a rank (device, transport, peak device
    # bytes, kernel launches in that rank)
    workers: list = field(default_factory=list)


def _resolve_plan(vert, program, plan: PlanArg, *, adaptive: bool,
                  auto_config=None, auto_space=None, graph_stats=None,
                  device=None, machine=None, obs0=None):
    """-> (plan, AdaptiveController | None). A PhysicalPlan passes
    through unchanged; plan="auto" is chosen by the cost model for
    superstep 0, with ``machine`` or else the machine model of
    ``device`` (default: the graph's device), and, when ``adaptive``,
    comes with the controller that re-chooses mid-run. ``graph_stats``
    stands in for the vertex scan (the out-of-core resume holds no
    VertexRel); ``obs0`` seeds superstep 0's observation (the sharded
    driver's sharded=True and n_workers, so the first pick prices the
    network axis). ``AdaptiveConfig(calibrate=True)`` refits the model's
    constants first."""
    if isinstance(plan, PhysicalPlan):
        return plan, None
    if plan != "auto":
        raise ValueError(f"plan must be a PhysicalPlan or 'auto', "
                         f"got {plan!r}")
    from repro_torch.planner import (AdaptiveConfig, GraphStats,
                                     calibrate_machine, machine_for,
                                     resolve_auto_plan)
    config = auto_config or AdaptiveConfig()
    if machine is None:
        machine = machine_for(vert.vid.device if device is None
                              else device)
    g = graph_stats or GraphStats.from_vertex(vert, program)
    if config.calibrate:
        machine = calibrate_machine(program, g, machine)
    return resolve_auto_plan(vert, program, adaptive=adaptive,
                             config=config, machine=machine,
                             space_kw=auto_space, g=g, obs0=obs0)


def default_engine_config(vert: VertexRel, program: VertexProgram,
                          plan: PhysicalPlan, *, slack: float = 1.5,
                          axis_name=None) -> EngineConfig:
    """Capacities for ``vert``'s (P, Np) / (P, Ep) shapes; ``axis_name``
    (a ``connector.ShardAxis``) makes it a sharded rank's config."""
    P, Np = vert.vid.shape
    Ep = vert.edge_src.shape[1]
    return EngineConfig(n_parts=P,
                        bucket_cap=bucket_capacity(plan, Ep, Np, P,
                                                   slack=slack),
                        frontier_cap=int(Np * plan.frontier_capacity) + 8,
                        axis_name=axis_name)


def cuda_allocator(device) -> Optional[Callable]:
    """For ``obs.memwatch`` (which imports no torch): a callable that
    reads the CUDA caching allocator of ``device``, (bytes in use, peak
    bytes), or None on any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return lambda: (torch.cuda.memory_allocated(device),
                    torch.cuda.max_memory_allocated(device))


def init_vertex_values(vert: VertexRel, program: VertexProgram,
                       gs: GlobalState) -> VertexRel:
    value = program.init_value(vert.vid, out_degrees(vert), gs)
    return dataclasses.replace(vert, value=torch.where(
        (vert.vid >= 0)[..., None], value, 0.0))


def grow_overflowed(ec: EngineConfig, delta, *,
                    vertex_capacity: int = 0) -> EngineConfig:
    """Double only the capacities whose per-source overflow counter grew
    (`delta` = the GlobalState.overflow increase of the failed step).
    Edge-stream overflow is attributed to the frontier (EF = 8 *
    frontier_cap); a frontier_cap of 0 resolves against
    `vertex_capacity` first so the doubling cannot wedge at 0."""
    delta = np.asarray(delta)
    kw = {}
    if delta[OVF_BUCKET] > 0:
        kw["bucket_cap"] = ec.bucket_cap * 2
    if delta[OVF_FRONTIER] > 0 or delta[OVF_EDGE] > 0:
        cur = ec.frontier_cap or max(vertex_capacity // 2, 1)
        kw["frontier_cap"] = cur * 2
    if delta[OVF_MUTATION] > 0:
        kw["mutation_cap"] = ec.mutation_cap * 2
    return dataclasses.replace(ec, **kw)


def prepare_run(vert, program, plan, ec):
    """Shared set-up of both drivers: engine config and initial state.
    No host layout: the gather walks the edges in their own order."""
    ec = ec or default_engine_config(vert, program, plan)
    gs = init_gs(program.agg_dims, vert.vid.device)
    vert = init_vertex_values(vert, program, gs)
    msg = empty_msgs(vert.num_partitions, ec.n_parts * ec.bucket_cap,
                     program.msg_dims, vert.vid.device)
    return ec, vert, msg, gs


def run_jit(vert: VertexRel, program: VertexProgram,
            plan: PlanArg = PhysicalPlan(), *,
            max_supersteps: int = 50,
            ec: Optional[EngineConfig] = None) -> RunResult:
    """Fixed-capacity loop: stops at halt, at max_supersteps, or at the
    first overflow, which raises (run_host grows capacities instead).
    plan="auto" resolves once, up front (no mid-run switching)."""
    t0 = time.time()
    plan, _ = _resolve_plan(vert, program, plan, adaptive=False)
    ec, v, m, g = prepare_run(vert, program, plan, ec)
    step = make_superstep(program, plan, ec)
    for _ in range(max_supersteps):
        v, m, g = step(v, m, g)
        if bool(g.halt) or bool((g.overflow != 0).any()):
            break
    if int(g.overflow.sum()) > 0:
        raise RuntimeError(
            f"capacity overflow (bucket/frontier/mutation/edge = "
            f"{g.overflow.tolist()} dropped); "
            "use run_host (auto-grows) or raise the capacities")
    return RunResult(vertex=v, gs=g, supersteps=int(g.superstep),
                     wall_s=time.time() - t0, plan=plan, initial_plan=plan)


def run_host(vert: VertexRel, program: VertexProgram,
             plan: PlanArg = PhysicalPlan(), *,
             max_supersteps: int = 50,
             ec: Optional[EngineConfig] = None,
             checkpoint_every: int = 0,
             checkpoint_dir: Optional[str] = None,
             resume_from: Optional[str] = None,
             resume_parts: Optional[int] = None,
             recover: bool = False,
             max_retries: int = 3,
             on_superstep: Optional[Callable] = None,
             failure_injector: Optional[Callable] = None,
             auto_config=None,
             auto_space: Optional[dict] = None) -> RunResult:
    """Superstep loop with statistics, capacity growth (grow only the
    overflowed capacities x2 and redo the superstep from the retained
    state), the left-outer frontier refit and checkpoints (every
    ``checkpoint_every`` supersteps into ``checkpoint_dir``). ``wall_s``
    of each record ends in a device synchronisation.

    plan="auto" turns on the cost-based planner: the initial plan is
    chosen for superstep 0's all-active frontier and re-chosen at
    superstep boundaries as the observed frontier density crosses the
    model's thresholds (``planner.adaptive``; ``auto_config`` an
    ``AdaptiveConfig``, ``auto_space`` restricts the plan space). A
    switch migrates the in-flight messages, resets the frontier capacity
    of a left-outer plan, grows the buckets a dropped sender combine
    needs, and records a ``plan-switch`` event.

    ``resume_from=<ckpt npz>`` restarts from a checkpoint, loaded onto
    the device of ``vert`` (optionally re-hashed onto ``resume_parts``
    partitions — the elastic restore). ``recover=True`` runs the whole
    job under the failure manager's recovery supervisor: a recoverable
    failure (WorkerFailure, disk I/O, typed corruption) restores the
    latest VALID checkpoint onto the surviving partitions and replays;
    application errors forward. ``failure_injector(i, vert, msg, gs)``
    is called after each superstep (tests); the supervisor calls it
    again on every replay, so it must fire once."""
    if recover:
        from repro_torch.runtime.checkpoint import latest_checkpoint
        from repro_torch.runtime.failure import supervised_run
        P0 = vert.num_partitions

        def _attempt(healthy, resume):
            return run_host(
                vert, program, plan, max_supersteps=max_supersteps,
                ec=ec, checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir, resume_from=resume,
                resume_parts=(healthy if resume is not None
                              and healthy < P0 else None),
                recover=False, on_superstep=on_superstep,
                failure_injector=failure_injector,
                auto_config=auto_config, auto_space=auto_space)

        def _pick(bad):
            if not checkpoint_dir:
                return None
            return latest_checkpoint(checkpoint_dir, skip=bad,
                                     verify=True)

        return supervised_run(_attempt, _pick, n_workers=P0,
                              max_retries=max_retries,
                              initial_resume=resume_from)

    with trace.job():
        return _run_job(vert, program, plan, max_supersteps, ec,
                        checkpoint_every, checkpoint_dir, resume_from,
                        resume_parts, on_superstep, failure_injector,
                        auto_config, auto_space)


def _run_job(vert, program, plan, max_supersteps, ec, checkpoint_every,
             checkpoint_dir, resume_from, resume_parts, on_superstep,
             failure_injector, auto_config, auto_space):
    """One job of ``run_host`` (the call, or one attempt of a supervised
    run), inside its ``job`` span."""
    from repro_torch.runtime import faults
    from repro_torch.runtime.checkpoint import save_checkpoint

    t0 = time.time()
    # everything from the call's start to the loop: the plan, the initial
    # state (init_vertex_values' out-degree scatter), the superstep's
    # build and the collector's live-vertex readback
    with trace.annotate("job.prepare", "prepare"):
        i0 = 0
        if resume_from is not None:
            from repro_torch.runtime.checkpoint import (load_checkpoint,
                                                        repartition)
            vert, msg, gs = load_checkpoint(resume_from,
                                            device=vert.vid.device)
            if resume_parts is not None \
                    and resume_parts != vert.num_partitions:
                vert, msg = repartition(vert, msg, resume_parts)
            i0 = int(gs.superstep)
        plan, controller = _resolve_plan(vert, program, plan, adaptive=True,
                                         auto_config=auto_config,
                                         auto_space=auto_space)
        if explain.enabled():
            # plan-audit ledger: bind the run context so each superstep's
            # stats record can be re-priced under the in-effect plan, with
            # the machine model of the graph's device
            from repro_torch.planner.cost import machine_for
            explain.attach(
                program, vert=vert,
                g=controller.g if controller is not None else None,
                plan=plan,
                machine=(controller.machine if controller is not None
                         else machine_for(vert.vid.device)),
                space_kw=auto_space)
        if resume_from is None:
            ec, vert, msg, gs = prepare_run(vert, program, plan, ec)
        else:
            ec = ec or default_engine_config(vert, program, plan)
            if msg.capacity > ec.n_parts * ec.bucket_cap:
                # the checkpointed inbox is wider than the derived config (it
                # grew mid-run): adopt its capacity instead of truncating it
                ec = dataclasses.replace(
                    ec, bucket_cap=-(-msg.capacity // ec.n_parts))
            msg = _regrow_msgs(msg, ec)
        initial_plan = plan
        step = make_superstep(program, plan, ec)
        n_live = (controller.g.n_vertices if controller is not None
                  else int((vert.vid >= 0).sum()))
        metrics = MetricsRegistry()
        coll = StatsCollector(n_partitions=vert.num_partitions,
                              vertex_capacity=vert.capacity,
                              msg_dims=program.msg_dims, n_vertices=n_live,
                              metrics=metrics)
        m_regrows = metrics.counter("host.regrows")
        m_redo_s = metrics.counter("host.redo_s")
        m_switches = metrics.counter("host.plan_switches")
        if program.mutates:
            # vertices deleted (D6) and re-created (D1) a superstep
            m_mutated = [metrics.counter(c) for c in MUTATION_COUNTERS]
    stats = []
    i = i0
    # a superstep built anew (the first, and after a regrow, a refit or a
    # switch) is flagged ``recompiled``, where the reference recompiles
    recompiled = True
    while i < max_supersteps:
        faults.superstep_tick(i, "host")
        ts = time.time()
        this_recompiled, recompiled = recompiled, False
        # the overflow readback is the superstep's device sync: the span
        # closes after it, so it times the superstep and not its enqueue
        with trace.annotate("superstep", "compute", superstep=i) as span:
            vert2, msg2, gs2 = step(vert, msg, gs)
            # (2,) deleted and resurrected of a program that mutates
            mutated = getattr(step, "mutations", None)
            with trace.annotate("superstep.readback", "collect"):
                ovf_delta = gs2.overflow - gs.overflow
                if mutated is None:
                    ovf_delta = ovf_delta.cpu().numpy()
                else:
                    # the mutation counts ride in the same copy
                    read = torch.cat([ovf_delta, mutated]).cpu().numpy()
                    ovf_delta, mutated = read[:-2], read[-2:]
            redo = bool((ovf_delta > 0).any())
            if redo:
                # a regrow's discarded attempt: its seconds up to the
                # readback, which the redo's wall_s leaves out
                attempt_s = time.time() - ts
                span.tag(redo=True)
        # the rest of the loop body: the regrow or the stats record and
        # its readbacks, the refit, replan, checkpoint and callback
        with trace.annotate("boundary", "commit"):
            if redo:
                ec = grow_overflowed(ec, ovf_delta,
                                     vertex_capacity=vert.capacity)
                step = make_superstep(program, plan, ec)
                msg = _regrow_msgs(msg, ec)
                stats.append(coll.event(
                    i, "regrow", bucket_cap=ec.bucket_cap,
                    frontier_cap=ec.frontier_cap,
                    mutation_cap=ec.mutation_cap,
                    sources=np.flatnonzero(ovf_delta > 0).tolist(),
                    attempt_s=attempt_s).as_dict())
                m_regrows.inc()
                m_redo_s.inc(attempt_s)
                trace.instant("regrow", "replan", superstep=i)
                recompiled = True
                if controller is not None:
                    controller.note_shape_change()
                continue
            vert, msg, gs = vert2, msg2, gs2
            i += 1
            if mutated is not None:
                for c, name, v in zip(m_mutated, MUTATION_COUNTERS,
                                      mutated.tolist()):
                    c.inc(v)
                    trace.counter(name, v)
            rec = coll.record(i, active=int(gs.active_count),
                              messages=int(gs.msg_count),
                              wall_s=time.time() - ts,
                              recompiled=this_recompiled)
            stats.append(rec.as_dict())
            if explain.enabled():
                # audit the plan that EXECUTED this superstep (a switch
                # below only affects the next one)
                explain.superstep(rec, plan=plan, bucket_cap=ec.bucket_cap)
            if memwatch.enabled():
                memwatch.configure(ec=ec, Np=vert.capacity,
                                   Ep=vert.edge_src.shape[1],
                                   value_dims=program.value_dims,
                                   msg_dims=program.msg_dims,
                                   allocator=cuda_allocator(vert.vid.device))
                memwatch.sample(i)
            switched = False
            if controller is not None and not bool(gs.halt):
                # mid-run replanning: switch the physical plan when observed
                # frontier density pushes another plan below the current one
                with trace.span("replan", "replan"):
                    new_plan = controller.observe(rec,
                                                  bucket_cap=ec.bucket_cap)
                if new_plan is not None:
                    from repro_torch.planner import migrate_msgs
                    msg = migrate_msgs(msg, plan, new_plan, ec.n_parts)
                    plan = new_plan
                    if plan.join == "left_outer":
                        act = int(gs.active_count) // \
                            max(vert.num_partitions, 1) + 1
                        ec = dataclasses.replace(
                            ec, frontier_cap=min(max(FRONTIER_FLOOR, act * 4),
                                                 vert.capacity + 8))
                    # dropping the sender combine needs room for uncombined
                    # sends: grow the buckets now instead of paying an
                    # overflow redo on the next superstep
                    need = default_engine_config(vert, program, plan)
                    if need.bucket_cap > ec.bucket_cap:
                        ec = dataclasses.replace(ec,
                                                 bucket_cap=need.bucket_cap)
                        msg = _regrow_msgs(msg, ec)
                    step = make_superstep(program, plan, ec)
                    stats.append(coll.event(
                        i, "plan-switch", join=plan.join,
                        groupby=plan.groupby, connector=plan.connector,
                        sender_combine=plan.sender_combine,
                        storage=plan.storage,
                        frontier_cap=ec.frontier_cap).as_dict())
                    m_switches.inc()
                    recompiled = switched = True
                    controller.note_shape_change()
            # adaptive frontier refit (left-outer plan): when the live set
            # collapses, shrink the frontier so each superstep pays only
            # O(|frontier|)
            if plan.join == "left_outer" and not switched:
                act = int(gs.active_count) // max(vert.num_partitions, 1) + 1
                if act * 4 < ec.frontier_cap and ec.frontier_cap > \
                        FRONTIER_FLOOR:
                    ec = dataclasses.replace(
                        ec, frontier_cap=max(FRONTIER_FLOOR, act * 2))
                    step = make_superstep(program, plan, ec)
                    stats.append(coll.event(
                        i, "frontier-refit",
                        frontier_cap=ec.frontier_cap).as_dict())
                    recompiled = True
                    if controller is not None:
                        controller.note_shape_change()
            if controller is not None and not bool(gs.halt):
                # periodic cost-model re-calibration (opt-in): refit the
                # analytic constants after the shapes changed, at most once
                # per AdaptiveConfig.recalibrate_every supersteps
                recal = controller.maybe_recalibrate(program, i)
                if recal is not None:
                    stats.append(coll.event(i, "recalibrate",
                                            **recal).as_dict())
            if failure_injector is not None:
                failure_injector(i, vert, msg, gs)
            if checkpoint_every and i % checkpoint_every == 0 \
                    and checkpoint_dir:
                with trace.span("checkpoint", "checkpoint"):
                    save_checkpoint(checkpoint_dir, i, vert, msg, gs)
            if on_superstep is not None:
                on_superstep(i, vert, msg, gs, rec.as_dict())
            if bool(gs.halt):
                break
    return RunResult(vertex=vert, gs=gs, supersteps=i, stats=stats,
                     wall_s=time.time() - t0, plan=plan,
                     initial_plan=initial_plan)


def _regrow_msgs(msg: MsgRel, ec: EngineConfig) -> MsgRel:
    """Pad capacity per source run, preserving the (n_parts, C) run layout
    the merging connector's receiver group-by relies on. Restored
    checkpoints whose capacity is not run-structured (a repartitioned
    inbox) are end-padded (their first superstep must use a sorting
    group-by, which the default plans do)."""
    P = msg.dst.shape[0]
    n, C_new = ec.n_parts, ec.bucket_cap
    if msg.capacity % n:
        pad = n * C_new - msg.capacity
        if pad <= 0:
            return msg
        return MsgRel(dst=F.pad(msg.dst, (0, pad), value=-1),
                      payload=F.pad(msg.payload, (0, 0, 0, pad)),
                      valid=F.pad(msg.valid.to(torch.uint8), (0, pad))
                      .bool())
    C_old = msg.capacity // n
    pad = C_new - C_old
    if pad <= 0:
        return msg

    def r(a, fill):
        a = a.reshape((P, n, C_old) + a.shape[2:])
        widths = [0, 0] * (a.dim() - 3) + [0, pad]    # last dims first
        if a.dtype == torch.bool:
            a = F.pad(a.to(torch.uint8), widths, value=int(fill)).bool()
        else:
            a = F.pad(a, widths, value=fill)
        return a.reshape((P, n * C_new) + a.shape[3:])

    return MsgRel(dst=r(msg.dst, -1), payload=r(msg.payload, 0.0),
                  valid=r(msg.valid, False))
