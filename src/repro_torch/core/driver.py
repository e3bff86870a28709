"""Job drivers.

* ``run_jit``  — a device loop over supersteps with fixed capacities; it
                 checks ``gs.halt`` and the overflow counters after each
                 superstep and raises on overflow.
* ``run_host`` — the superstep loop with per-superstep statistics
                 (Section 5.7 statistics collector), transparent capacity
                 growth on overflow (re-run the superstep from the retained
                 previous state), and the left-outer frontier refit.

Both run on the device the graph was loaded on. Checkpoints, recovery,
failure injection and plan="auto" come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

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
from repro_torch.kernels import backend as kbackend
from repro_torch.planner.stats import StatsCollector


@dataclass
class RunResult:
    vertex: VertexRel
    gs: GlobalState
    supersteps: int
    stats: list = field(default_factory=list)
    wall_s: float = 0.0
    plan: Optional[PhysicalPlan] = None   # plan in effect at the end


def _concrete_plan(plan, kernel_impl: Optional[str]) -> PhysicalPlan:
    if not isinstance(plan, PhysicalPlan):
        if plan == "auto":
            raise NotImplementedError(
                "plan='auto' comes with the port's planner slice")
        raise ValueError(f"plan must be a PhysicalPlan, got {plan!r}")
    if kernel_impl is not None:
        plan = dataclasses.replace(plan, kernel_impl=kernel_impl)
    return plan


def plan_gather_layout(plan: PhysicalPlan, vert: VertexRel):
    """The reference's host layout for its row-blocked csr_spmv gather,
    on the graph's device, for full-outer plans, else None (the JAX
    driver's layout, kept as the port's copy of it). The port's gather
    reads no layout, so neither driver calls this."""
    if plan.join != "full_outer":
        return None
    perm, tile_row = kbackend.plan_edge_layout(vert.edge_src.cpu().numpy(),
                                               vert.capacity)
    dev = vert.vid.device
    return (torch.from_numpy(perm).to(dev),
            torch.from_numpy(tile_row).to(dev))


def default_engine_config(vert: VertexRel, program: VertexProgram,
                          plan: PhysicalPlan, *,
                          slack: float = 1.5) -> EngineConfig:
    P, Np = vert.vid.shape
    Ep = vert.edge_src.shape[1]
    return EngineConfig(n_parts=P,
                        bucket_cap=bucket_capacity(plan, Ep, Np, P,
                                                   slack=slack),
                        frontier_cap=int(Np * plan.frontier_capacity) + 8)


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
            plan: PhysicalPlan = PhysicalPlan(), *,
            max_supersteps: int = 50,
            ec: Optional[EngineConfig] = None,
            kernel_impl: Optional[str] = None) -> RunResult:
    """Fixed-capacity loop: stops at halt, at max_supersteps, or at the
    first overflow, which raises (run_host grows capacities instead)."""
    t0 = time.time()
    plan = _concrete_plan(plan, kernel_impl)
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
                     wall_s=time.time() - t0, plan=plan)


def run_host(vert: VertexRel, program: VertexProgram,
             plan: PhysicalPlan = PhysicalPlan(), *,
             max_supersteps: int = 50,
             ec: Optional[EngineConfig] = None,
             on_superstep: Optional[Callable] = None,
             kernel_impl: Optional[str] = None,
             checkpoint_every: int = 0,
             checkpoint_dir: Optional[str] = None,
             resume_from: Optional[str] = None,
             recover: bool = False,
             failure_injector: Optional[Callable] = None) -> RunResult:
    """Superstep loop with statistics, capacity growth (grow only the
    overflowed capacities x2 and redo the superstep from the retained
    state) and the left-outer frontier refit. ``wall_s`` of each record
    ends in a device synchronisation."""
    if checkpoint_every or checkpoint_dir or resume_from or recover \
            or failure_injector is not None:
        raise NotImplementedError(
            "checkpoints, resume, recovery and failure injection come "
            "with the port's checkpoint slice")
    t0 = time.time()
    plan = _concrete_plan(plan, kernel_impl)
    ec, vert, msg, gs = prepare_run(vert, program, plan, ec)
    step = make_superstep(program, plan, ec)
    coll = StatsCollector(n_partitions=vert.num_partitions,
                          vertex_capacity=vert.capacity,
                          msg_dims=program.msg_dims,
                          n_vertices=int((vert.vid >= 0).sum()))
    stats = []
    i = 0
    while i < max_supersteps:
        ts = time.time()
        vert2, msg2, gs2 = step(vert, msg, gs)
        ovf_delta = (gs2.overflow - gs.overflow).cpu().numpy()
        if (ovf_delta > 0).any():
            ec = grow_overflowed(ec, ovf_delta,
                                 vertex_capacity=vert.capacity)
            step = make_superstep(program, plan, ec)
            msg = _regrow_msgs(msg, ec)
            stats.append(coll.event(
                i, "regrow", bucket_cap=ec.bucket_cap,
                frontier_cap=ec.frontier_cap,
                mutation_cap=ec.mutation_cap,
                sources=np.flatnonzero(ovf_delta > 0).tolist()).as_dict())
            continue
        vert, msg, gs = vert2, msg2, gs2
        i += 1
        rec = coll.record(i, active=int(gs.active_count),
                          messages=int(gs.msg_count),
                          wall_s=time.time() - ts)
        stats.append(rec.as_dict())
        # adaptive frontier refit (left-outer plan): when the live set
        # collapses, shrink the frontier so each superstep pays only
        # O(|frontier|)
        if plan.join == "left_outer":
            act = int(gs.active_count) // max(vert.num_partitions, 1) + 1
            if act * 4 < ec.frontier_cap and ec.frontier_cap > \
                    FRONTIER_FLOOR:
                ec = dataclasses.replace(
                    ec, frontier_cap=max(FRONTIER_FLOOR, act * 2))
                step = make_superstep(program, plan, ec)
                stats.append(coll.event(
                    i, "frontier-refit",
                    frontier_cap=ec.frontier_cap).as_dict())
        if on_superstep is not None:
            on_superstep(i, vert, msg, gs, rec.as_dict())
        if bool(gs.halt):
            break
    return RunResult(vertex=vert, gs=gs, supersteps=i, stats=stats,
                     wall_s=time.time() - t0, plan=plan)


def _regrow_msgs(msg: MsgRel, ec: EngineConfig) -> MsgRel:
    """Pad capacity per source run, preserving the (n_parts, C) run layout
    the merging connector's receiver group-by relies on."""
    P = msg.dst.shape[0]
    n, C_new = ec.n_parts, ec.bucket_cap
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
