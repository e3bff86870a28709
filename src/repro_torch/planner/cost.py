"""Analytical per-superstep cost model over the physical plan space — the
port's copy of ``repro.planner.cost``.

The engine runs FIXED shapes, so cost scales with the capacities a plan
implies, not with live tuple counts: a full-outer join always touches
every vertex slot; a left-outer join touches the (adaptively refitted)
frontier capacity, which tracks observed frontier density. The model
mirrors the capacity policies in ``core/driver.py``
(``default_engine_config`` bucket caps, the frontier-refit rule) and the
operator structure of ``core/superstep.py``, then converts flops / memory
bytes / exchange bytes to seconds with a machine model.

Two machine models: ``H100_MACHINE`` (the port's CUDA kernels, constants
measured on the card) for graphs on a CUDA device, and ``CPU_MACHINE``
(the plain versions) for graphs on the CPU. ``estimate`` prices the
kernel path from the machine model: on the H100 the D3 gather is the
edge-order stream of ``kernels/csrc/csr_spmv.cu`` and the D7 fold the
one-pass look-back of ``kernels/csrc/segment_combine.cu``; on the CPU
machine every leg is priced exactly as the reference prices its
emulated machine, where its kernel dispatch resolves to the reference
path, so ``plan="auto"`` picks and switches the reference's plans.

Out-of-core runs add a STORAGE dimension: each streamed super-partition
writes its vertex updates back over the device<->host link, and the
``storage_writeback`` term prices the ``inplace`` (full-block stream) vs
``delta`` (changed-records scatter-merge) policies from the measured
change density (``Observation.change_density``). The out-of-core terms
price ``run_out_of_core``'s records, the sharded terms (the network
axis) ``run_sharded``'s.

Only RANKING between plans matters for the optimizer; absolute seconds
are a roofline bound, a lower bound on real wall time.
``op_calibrate`` measures the plain superstep with the operator counter
(``launch/op_cost.py``) and ``calibrate_machine`` refits the analytic
constants against it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

from repro_torch.core.plan import FRONTIER_FLOOR, PhysicalPlan, \
    bucket_capacity

WORD = 4          # bytes per int32/float32 element

# ---- analytic constants (the reference's defaults). ``MachineModel``
# carries a per-instance copy, and ``calibrate_machine`` refits them per
# device from measured probe supersteps when a driver opts in
# (``AdaptiveConfig.calibrate``).

# K_COMPUTE [flops/element]: arithmetic intensity of one elementwise UDF
# stage (compute/send/combine bodies are a handful of ops per element).
K_COMPUTE = 8.0
# K_SCATTER [dimensionless bytes multiplier]: random gather/scatter
# amplification — each randomly-addressed access moves a cache line /
# memory transaction, not one element, so scattered traffic is charged
# K_SCATTER times the payload bytes (streamed traffic is charged 1x).
K_SCATTER = 4.0
# SORT_PASS_FRAC [dimensionless]: sorts are memory-bound; one argsort +
# permute over n rows is modeled as SORT_PASS_FRAC * log2(n) full
# read+write passes over the keyed payload.
SORT_PASS_FRAC = 0.25
FRONTIER_SLACK = 2.0   # refit keeps 2x headroom over the live frontier
MIN_FRONTIER = FRONTIER_FLOOR   # the driver's refit floor


@dataclass(frozen=True)
class MachineModel:
    """Roofline constants plus the analytic cost constants, so
    ``calibrate_machine`` can refit the latter per device without
    touching module globals. The defaults are the H100's
    (``H100_MACHINE``)."""
    # NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate at 700 W.
    # The bandwidths below were measured by chip_smoke.py phase 12 on an
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
    peak_flops: float = 989e12
    # HBM3: a 2 GiB device-to-device copy, bytes read + written over its
    # CUDA-event time, 2.9981e12 B/s (the data sheet says 3.35e12)
    hbm_bw: float = 2.9981e12
    # one card: the exchange is a transpose in HBM, so the "link" is HBM
    link_bw: float = 2.9981e12
    # device<->host: pinned 2 GiB copies, 5.3523e10 B/s host->device and
    # 5.5041e10 device->host (the slower kept); the out-of-core stream
    # and its write-back cross this link
    host_bw: float = 5.3523e10
    # host DRAM<->local SSD: the reference's default, not measured (only
    # the out-of-core spill tier reads it)
    disk_bw: float = 3e9
    # host DRAM: a 2 GiB numpy copy, bytes read + written over host-clock
    # time (one thread); the out-of-core inbox restack runs at this rate
    host_mem_bw: float = 1.8019e10
    # placeholders, unmeasured for a link between cards: the HBM copy
    # rate, and the reference's per-exchange dispatch latency. One card
    # runs run_sharded's ranks over gloo through the host (PERF.md §7)
    net_bw: float = 2.9981e12
    net_latency_s: float = 10e-6
    k_compute: float = K_COMPUTE
    k_scatter: float = K_SCATTER
    sort_pass_frac: float = SORT_PASS_FRAC
    # does this machine run the port's CUDA kernels (the D3 gather and
    # the D7 fold)? ``estimate`` prices the kernel path from THIS flag,
    # not from the host process's devices, so one process can rank plans
    # for either machine.
    cuda_kernels: bool = True


H100_MACHINE = MachineModel()
# the CPU: the plain versions, priced with the reference's emulated-
# transport machine value for value (its roofline constants, in its
# units; they describe no measured speed of this host), so that
# plan="auto" on the CPU chooses and switches the reference's plans. The
# "exchange" is a transpose through memory and the "host link" a memcpy;
# each exchange stage pays a ms-class dispatch latency.
CPU_MACHINE = MachineModel(peak_flops=197e12, hbm_bw=819e9, link_bw=819e9,
                           host_bw=819e9, disk_bw=3e9, host_mem_bw=819e9,
                           net_bw=819e9, net_latency_s=1e-3,
                           cuda_kernels=False)


def machine_for(device) -> MachineModel:
    """The machine model a graph on ``device`` plans with."""
    import torch
    return H100_MACHINE if torch.device(device).type == "cuda" \
        else CPU_MACHINE


@dataclass(frozen=True)
class GraphStats:
    """Static per-job facts the cost model needs (paper Table 1 shapes)."""
    n_vertices: int
    n_edges: int
    n_partitions: int
    vertex_capacity: int   # Np: slots per partition
    edge_capacity: int     # Ep: edge slots per partition
    value_dims: int = 1
    msg_dims: int = 1

    @classmethod
    def from_vertex(cls, vert, program) -> "GraphStats":
        P, Np = vert.vid.shape
        n_v = int((vert.vid >= 0).sum())
        n_e = int((vert.edge_src >= 0).sum())
        return cls(n_vertices=n_v, n_edges=n_e, n_partitions=P,
                   vertex_capacity=Np,
                   edge_capacity=vert.edge_src.shape[1],
                   value_dims=program.value_dims,
                   msg_dims=program.msg_dims)


@dataclass(frozen=True)
class Observation:
    """Runtime statistics the model conditions on (from planner.stats)."""
    frontier_density: float = 1.0   # active fraction of LIVE vertices
    messages: int = 0               # live messages last superstep (total)
    superstep: int = 0
    # live per-(src,dst) bucket capacity (0 = unknown/initial): running
    # drivers only GROW buckets, so a candidate plan cannot realize a
    # smaller message capacity than the engine already carries
    bucket_cap: int = 0
    # fraction of vertex-value bytes that changed last superstep (out-of-
    # core: delta_bytes / full_bytes); drives the storage dimension
    change_density: float = 1.0
    # True when the job streams super-partitions through the device
    # (out-of-core): only then does the storage write-back cross the host
    # link and enter the cost
    ooc: bool = False
    # True when the out-of-core executor PIPELINES the stream: host-link
    # transfers overlap device compute, so the superstep is priced as
    # max(step, transfer) (PlanCost.overlap_host)
    streaming: bool = False
    # True under the barrier-free superstep pipeline: only
    # 1/super_partitions of the inbox rebuild stays on the serial path
    barrier_free: bool = False
    super_partitions: int = 1
    # observed device-idle gap between supersteps and the I/O queue
    # depth (diagnostics; the model prices the rebuild analytically)
    readiness_stall_s: float = 0.0
    io_queue_depth: float = 0.0
    # measured-stall closure: the controller EWMAs the readiness stall
    # over steady supersteps and divides it by the CURRENT plan's
    # analytic serial leg -> serial_scale, applied to every candidate.
    # stall_ewma_s < 0 = no measurement.
    stall_ewma_s: float = -1.0
    serial_scale: float = 1.0
    # messages per DISTINCT destination (>= 1): what a sender combine
    # collapses the host inbox by
    combinability: float = 1.0
    # insert proposals per live vertex last superstep
    mutation_rate: float = 0.0
    # ---- network axis (sharded driver) -------------------------------
    sharded: bool = False
    n_workers: int = 1
    exchange_bytes: float = 0.0
    exchange_stall_s: float = 0.0
    # measured-exchange closure, mirroring serial_scale; < 0 = none yet
    exchange_ewma_s: float = -1.0
    net_scale: float = 1.0
    # the out-of-core store's disk tier: spilling under a memory budget,
    # and the pager's hit rate
    spilling: bool = False
    hit_rate: float = 1.0


@dataclass
class PlanCost:
    flops: float = 0.0
    bytes: float = 0.0            # memory traffic per partition
    exchange_bytes: float = 0.0   # cross-partition link bytes
    host_bytes: float = 0.0       # device<->host link bytes (OOC only)
    disk_bytes: float = 0.0       # DRAM<->disk spill-tier bytes
    net_bytes: float = 0.0        # all_to_all wire bytes per worker
    # seconds of the all_to_all exchange STAGE: additive on the critical
    # path (never hidden by the overlap max)
    net_seconds: float = 0.0
    terms: dict = field(default_factory=dict)   # per-operator seconds
    # pipelined out-of-core streaming: total = max(device, host, disk)
    overlap_host: bool = False
    # SERIAL leg of the critical path (inter-superstep work no pipeline
    # overlaps), added on top of the overlap max
    serial_seconds: float = 0.0
    # per-term raw components (flops / bytes per axis)
    detail: dict = field(default_factory=dict)

    def _detail(self, term: str) -> dict:
        return self.detail.setdefault(term, {
            "flops": 0.0, "hbm_bytes": 0.0, "exchange_bytes": 0.0,
            "host_bytes": 0.0, "disk_bytes": 0.0, "serial_bytes": 0.0,
            "net_bytes": 0.0})

    def add(self, term: str, machine: MachineModel, *, flops: float = 0.0,
            bytes: float = 0.0, exchange_bytes: float = 0.0,
            host_bytes: float = 0.0, disk_bytes: float = 0.0):
        self.flops += flops
        self.bytes += bytes
        self.exchange_bytes += exchange_bytes
        self.host_bytes += host_bytes
        self.disk_bytes += disk_bytes
        self.terms[term] = self.terms.get(term, 0.0) + (
            flops / machine.peak_flops + bytes / machine.hbm_bw +
            exchange_bytes / machine.link_bw +
            host_bytes / machine.host_bw +
            disk_bytes / machine.disk_bw)
        d = self._detail(term)
        d["flops"] += flops
        d["hbm_bytes"] += bytes
        d["exchange_bytes"] += exchange_bytes
        d["host_bytes"] += host_bytes
        d["disk_bytes"] += disk_bytes

    def add_serial(self, term: str, machine: MachineModel, *,
                   bytes: float = 0.0):
        """Host-memory traffic on the SERIAL inter-superstep path, at
        ``machine.host_mem_bw`` and outside the overlap max."""
        s = bytes / machine.host_mem_bw
        self.serial_seconds += s
        self.terms[term] = self.terms.get(term, 0.0) + s
        self._detail(term)["serial_bytes"] += bytes

    def scale_serial(self, factor: float, term: str = "inbox_rebuild"):
        """Apply a measured calibration multiplier to the serial leg."""
        self.serial_seconds *= factor
        if term in self.terms:
            self.terms[term] *= factor

    def add_net(self, term: str, machine: MachineModel, *,
                net_bytes: float = 0.0, latency_s: float = 0.0):
        """All_to_all wire traffic of the sharded exchange stage: at the
        machine's bisection bandwidth plus a per-stage latency, outside
        the overlap max."""
        s = net_bytes / machine.net_bw + latency_s
        self.net_bytes += net_bytes
        self.net_seconds += s
        self.terms[term] = self.terms.get(term, 0.0) + s
        self._detail(term)["net_bytes"] += net_bytes

    def scale_net(self, factor: float, term: str = "exchange_net"):
        """Measured calibration multiplier for the network leg."""
        self.net_seconds *= factor
        if term in self.terms:
            self.terms[term] *= factor

    def device_seconds(self, machine: MachineModel = H100_MACHINE) \
            -> float:
        return (self.flops / machine.peak_flops +
                self.bytes / machine.hbm_bw +
                self.exchange_bytes / machine.link_bw)

    def host_seconds(self, machine: MachineModel = H100_MACHINE) \
            -> float:
        return self.host_bytes / machine.host_bw

    def disk_seconds(self, machine: MachineModel = H100_MACHINE) \
            -> float:
        return self.disk_bytes / machine.disk_bw

    def seconds(self, machine: MachineModel = H100_MACHINE) -> float:
        dev = self.device_seconds(machine)
        hst = self.host_seconds(machine)
        dsk = self.disk_seconds(machine)
        if self.overlap_host:
            # critical path: the slowest of the overlapped legs, plus the
            # serial and network legs; the small residual breaks ties
            # toward the plan doing less total work
            return (max(dev, hst, dsk) + self.serial_seconds
                    + self.net_seconds + 1e-3 * (dev + hst + dsk))
        return dev + hst + dsk + self.serial_seconds + self.net_seconds


def bucket_cap(plan: PhysicalPlan, g: GraphStats, slack: float = 1.5) -> int:
    """The drivers' per-bucket capacity policy (core.plan.bucket_capacity)
    at this graph's shapes."""
    return bucket_capacity(plan, g.edge_capacity, g.vertex_capacity,
                           g.n_partitions, slack=slack)


def refit_frontier_cap(g: GraphStats, density: float) -> int:
    """Frontier capacity the driver's adaptive refit converges to.
    `density` is the active fraction of LIVE vertices."""
    live_pp = density * g.n_vertices / max(g.n_partitions, 1)
    return int(min(g.vertex_capacity,
                   max(MIN_FRONTIER, FRONTIER_SLACK * live_pp)))


def _sort_bytes(n: float, width: float, frac: float) -> float:
    """Memory traffic of one argsort+permute over n keyed rows of `width`
    bytes (log-pass model; `frac` = the machine's sort_pass_frac)."""
    n = max(n, 2.0)
    return frac * math.log2(n) * n * width


def estimate(plan: PhysicalPlan, g: GraphStats, obs: Observation,
             machine: MachineModel = H100_MACHINE) -> PlanCost:
    """Per-superstep, per-partition cost of running `plan` at the observed
    statistics. Follows superstep.py's operator order D1..D3.

    The kernel path is the machine's: a machine with ``cuda_kernels``
    runs the gather (full-outer plans) and the fold (sender combine)
    through the CUDA kernels, one without runs the plain versions (the
    calibration prices its probes so: they measure the plain
    superstep)."""
    P, Np, Ep = g.n_partitions, g.vertex_capacity, g.edge_capacity
    D, V = g.msg_dims, g.value_dims
    kc, ks = machine.k_compute, machine.k_scatter
    sort_b = lambda n, w: _sort_bytes(n, w, machine.sort_pass_frac)
    f = min(max(obs.frontier_density, 1.0 / max(Np, 1)), 1.0)
    c = PlanCost()
    cap = max(bucket_cap(plan, g), obs.bucket_cap)
    M = P * cap                       # received message capacity
    msg_w = (1 + D) * WORD + 1        # dst + payload + valid per slot

    kern = machine.cuda_kernels
    kern_gather = kern and plan.join == "full_outer"
    # (the engine folds only named monoids through the kernel; the model
    # cannot see combine_op here, so a custom combine is mildly mispriced
    # on the kernel path — ranking is plan-relative)
    kern_combine = kern and plan.sender_combine

    # D1: receiver group-by over the full message capacity
    if plan.connector == "partitioning_merging":
        # presorted runs: one segmented scan, then a scatter of the <=1
        # surviving partial per (run, dst) — run_combine_dense
        c.add("recv_groupby", machine, flops=kc * M * D,
              bytes=(1 + ks) * M * msg_w)
    elif plan.groupby == "sort":
        c.add("recv_groupby", machine, flops=kc * M * D,
              bytes=sort_b(M, msg_w) + M * msg_w)
    else:  # scatter (hash)
        c.add("recv_groupby", machine, flops=kc * M * D,
              bytes=ks * M * msg_w)

    # D1/D2: join + compute + write-back
    if plan.join == "full_outer":
        c.add("join_compute", machine, flops=kc * Np * (V + D),
              bytes=Np * (2 * V + D + 1) * WORD)
        e_work = Ep
    else:
        F = refit_frontier_cap(g, f)
        # mask scan + cumsum over all slots, edge-gate prepass over all
        # edges, then gather/compute/scatter-back only F rows
        c.add("join_compute", machine,
              flops=kc * F * (V + D),
              bytes=(Np + Ep) * WORD +
              ks * F * (2 * V + D + 1) * WORD)
        # gen_messages compacts the edge stream to EF = min(8F, Ep); the
        # overflow regrow doubles it until the live edges (~f*Ep) fit
        e_work = min(max(8 * F, MIN_FRONTIER, f * Ep), Ep)

    # D3: edge-parallel payload generation
    if kern_gather:
        # csr_spmv's edge-order stream: each live edge's source index and
        # gathered value are read and its output row written once, in
        # edge order — no scatter amplification and no one-hot flops
        c.add("send", machine, flops=kc * e_work * D,
              bytes=e_work * (V + D + 2) * WORD)
    else:
        c.add("send", machine, flops=kc * e_work * D,
              bytes=ks * e_work * (V + D + 2) * WORD)

    # D3/D7: sender combine = sort + segmented fold over the edge stream
    if kern_combine:
        # segment_combine's one launch over all partitions: the sorted
        # run is read once and the folded run written once (the
        # look-back's tile words are noise); the dst argsort remains
        c.add("sender_combine", machine, flops=kc * e_work * D,
              bytes=sort_b(e_work, msg_w) + 2.0 * e_work * msg_w)
    elif plan.sender_combine:
        c.add("sender_combine", machine, flops=kc * e_work * D,
              bytes=sort_b(e_work, msg_w) + e_work * msg_w)

    # connector bucket build (bucket_by_owner): the merging connector
    # with hash partitioning sorts twice (by dst, then stably by owner);
    # range partitioning needs one dst sort — or none when the sender
    # combine already left the stream dst-ascending; the plain hash
    # connector sorts once by owner
    if plan.partition == "range":
        n_sorts = 0 if plan.sender_combine else 1
    elif plan.connector == "partitioning_merging":
        n_sorts = 2
    else:
        n_sorts = 1
    # with the kernel fold in play the scatter->combine->pack leg is
    # fused: combined survivors are compacted to the bucket capacity (M)
    # before routing (superstep.compact_combined)
    e_pack = min(e_work, float(M)) if kern_combine else e_work
    c.add("connector", machine, flops=kc * e_pack,
          bytes=n_sorts * sort_b(e_pack, msg_w) +
          ks * e_pack * msg_w)

    # exchange: fixed-capacity buckets cross the links whole. On a
    # sharded mesh the cross-WORKER share crosses the network (plus one
    # per-stage latency); the intra-worker share stays a memory move.
    if obs.sharded and obs.n_workers > 1:
        W = obs.n_workers
        P_l = max(P // W, 1)
        c.add("exchange", machine,
              exchange_bytes=M * msg_w * (P_l - 1) / max(P, 1))
        c.add_net("exchange_net", machine,
                  net_bytes=M * msg_w * (P - P_l) / max(P, 1),
                  latency_s=machine.net_latency_s)
        if obs.net_scale != 1.0:
            c.scale_net(obs.net_scale)
    else:
        c.add("exchange", machine,
              exchange_bytes=M * msg_w * (P - 1) / max(P, 1))

    if obs.ooc:
        # super-partition streaming I/O: the vertex block and its inbox
        # runs go H2D, the updates and the collected buckets come back
        # D2H. The inbox going UP is priced from live messages, divided
        # by the measured combinability under a sender combine.
        if obs.messages > 0:
            mpp = obs.messages / max(P, 1)
            if plan.sender_combine:
                mpp = mpp / max(obs.combinability, 1.0)
            inbox_up = min(float(M), mpp + P) * msg_w
        else:
            inbox_up = M * msg_w    # superstep 0: no measurement yet
        up = Np * ((1 + V) * WORD + 1) + 3 * Ep * WORD + inbox_up
        down = Np * (WORD + 1) + 2 * Ep * WORD + M * msg_w
        c.add("stream_io", machine, host_bytes=up + down)
        # storage write-back of the value block, by policy
        vblock = Np * V * WORD
        cd = min(max(obs.change_density, 0.0), 1.0)
        if plan.storage == "delta":
            # changed (slot, value) records cross the link; the compare
            # streams the store once and the merge scatters the survivors
            c.add("storage_writeback", machine,
                  host_bytes=cd * Np * (1 + V) * WORD,
                  bytes=vblock + ks * cd * vblock)
        else:
            # the full value block streams across the link and the store
            c.add("storage_writeback", machine,
                  host_bytes=vblock, bytes=vblock)
        # host mutation inbox: proposals cross D2H and scatter-merge
        if obs.mutation_rate > 0.0:
            mut = obs.mutation_rate * Np
            c.add("mutation_io", machine,
                  host_bytes=mut * ((1 + V) * WORD + 1),
                  bytes=ks * mut * (1 + V) * WORD)
        # disk tier: missed reads fault in, dirty pages write out
        if obs.spilling:
            miss = min(max(1.0 - obs.hit_rate, 0.0), 1.0)
            rel_pages = Np * ((1 + V) * WORD + 1) + 3 * Ep * WORD
            reads = miss * (rel_pages + inbox_up)
            writes = inbox_up + (cd * vblock if plan.storage == "delta"
                                 else vblock)
            c.add("disk_io", machine, disk_bytes=reads + writes)
        # inter-superstep readiness leg: the inbox restack streams the
        # inbox through host memory twice; barrier-free keeps only the
        # first destination's share on the critical path
        rebuild = 2.0 * inbox_up
        if obs.barrier_free:
            rebuild /= max(obs.super_partitions, 1)
        c.add_serial("inbox_rebuild", machine, bytes=rebuild)
        if obs.serial_scale != 1.0:
            c.scale_serial(obs.serial_scale)
        c.overlap_host = bool(obs.streaming)
    return c


def op_calibrate(program, plan: PhysicalPlan, g: GraphStats,
                 obs: Observation = Observation()):
    """Run one plain superstep at the capacities ``estimate`` assumes on
    ``meta`` tensors (shapes and dtypes, no data and no device) under the
    operator counter — the ground truth the analytic constants are
    calibrated against. Returns a ``launch.op_cost.Cost``."""
    from repro_torch.core.relations import (empty_msgs, empty_vertices,
                                            init_gs)
    from repro_torch.core.superstep import EngineConfig, make_superstep
    from repro_torch.launch import op_cost

    cap = bucket_cap(plan, g)
    ec = EngineConfig(n_parts=g.n_partitions, bucket_cap=cap,
                      frontier_cap=refit_frontier_cap(
                          g, obs.frontier_density))
    step = make_superstep(program, plan, ec)
    P = g.n_partitions
    vert = empty_vertices(P, g.vertex_capacity, g.edge_capacity,
                          g.value_dims, "meta")
    msg = empty_msgs(P, P * cap, g.msg_dims, "meta")
    gs = init_gs(program.agg_dims, "meta")
    return op_cost.measure(step, vert, msg, gs)


# (device type, combine_op) -> fitted (k_compute, k_scatter,
# sort_pass_frac); the startup calibration fills this once per process.
# The probe plans legal for a custom combine UDF differ from the monoid
# ones, so the fit is cached per combine class too.
_CALIBRATED: dict = {}


def _fit_constants(program, g: GraphStats, machine: MachineModel):
    """Refit (k_compute, k_scatter, sort_pass_frac) against the operator
    counter. Two probe plans (a scatter-heavy and a sort-heavy group-by;
    sort-only for custom combine UDFs) are measured at the capacities
    ``estimate`` assumes with ``op_calibrate``. The model's flops are
    linear in k_compute and its bytes affine in (k_scatter,
    sort_pass_frac), so unit-coefficient estimates turn the fit into one
    ratio and one 2x2 least-squares solve. Fitted values are clamped to
    sane ranges; a degenerate system keeps the defaults."""
    import numpy as np
    obs = Observation(frontier_density=1.0)
    if program.combine_op == "custom":
        probes = [PhysicalPlan(join="full_outer", groupby="sort",
                               connector="partitioning",
                               sender_combine=False),
                  PhysicalPlan(join="full_outer", groupby="sort",
                               connector="partitioning",
                               sender_combine=True)]
    else:
        probes = [PhysicalPlan(join="full_outer", groupby="scatter",
                               connector="partitioning",
                               sender_combine=False),
                  PhysicalPlan(join="full_outer", groupby="sort",
                               connector="partitioning",
                               sender_combine=False)]
    P = max(g.n_partitions, 1)   # the counter measures all partitions;
    # the model is per one. op_calibrate measures the plain superstep,
    # so the fit prices the probes on a machine without the kernels (the
    # kernel path's constants ride along unfitted)
    unit = lambda kc, ks, sp: dataclasses.replace(
        machine, k_compute=kc, k_scatter=ks, sort_pass_frac=sp,
        cuda_kernels=False)
    kcs, rows, rhs = [], [], []
    for p in probes:
        meas = op_calibrate(program, p, g, obs)
        f_unit = estimate(p, g, obs, unit(1.0, 0.0, 0.0)).flops
        if f_unit > 0 and meas.flops > 0:
            kcs.append(meas.flops / P / f_unit)
        base = estimate(p, g, obs, unit(0.0, 0.0, 0.0)).bytes
        scat = estimate(p, g, obs, unit(0.0, 1.0, 0.0)).bytes - base
        srt = estimate(p, g, obs, unit(0.0, 0.0, 1.0)).bytes - base
        rows.append([scat, srt])
        rhs.append(meas.bytes / P - base)
    kc = (float(np.clip(np.mean(kcs), 0.5, 128.0)) if kcs
          else machine.k_compute)
    ks, sp = machine.k_scatter, machine.sort_pass_frac
    try:
        sol, *_ = np.linalg.lstsq(np.asarray(rows, float),
                                  np.asarray(rhs, float), rcond=None)
        if np.isfinite(sol).all():
            ks = float(np.clip(sol[0], 1.0, 64.0))
            sp = float(np.clip(sol[1], 0.02, 4.0))
    except np.linalg.LinAlgError:
        pass
    return kc, ks, sp


def calibrate_machine(program, g: GraphStats,
                      machine: MachineModel = H100_MACHINE,
                      *, refresh: bool = False) -> MachineModel:
    """Startup calibration (opt-in via ``AdaptiveConfig.calibrate``):
    measure probe supersteps with the operator counter and return a
    MachineModel whose analytic constants are refit to them, instead of
    the defaults K_COMPUTE / K_SCATTER / SORT_PASS_FRAC. The fit is cached
    per (device type, combine op) for the life of the process — the
    device type is the machine's (``cuda`` for a machine that runs the
    CUDA kernels, else ``cpu``); ``refresh=True`` bypasses the cache and
    refits in place (the periodic re-calibration path)."""
    key = ("cuda" if machine.cuda_kernels else "cpu", program.combine_op)
    if refresh or key not in _CALIBRATED:
        _CALIBRATED[key] = _fit_constants(program, g, machine)
    kc, ks, sp = _CALIBRATED[key]
    return dataclasses.replace(machine, k_compute=kc, k_scatter=ks,
                               sort_pass_frac=sp)
