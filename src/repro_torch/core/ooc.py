"""Out-of-core execution (the paper's central claim, Sections 2.3/5.4/7.2)
— the port's ``run_out_of_core``.

On Hyracks, operators spill to disk through the buffer cache, so the same
plans run in memory and out of core. The port's memory hierarchy is three
tiers: device memory <-> host DRAM <-> disk. The Vertex relation and the
run-structured message inbox live in a ``storage.TieredStore`` — a
page-granular buffer cache chunked one page per (relation,
super-partition) with a configurable DRAM byte budget
(``memory_budget_bytes``), evicting cold pages to mmap-backed spill files
(``disk_dir``) and faulting them back on access. Each superstep streams
SUPER-PARTITIONS (blocks of ``budget_partitions`` partitions, the
device-memory budget) through the partial superstep: the sender fold
(``segment_combine.cu``) and, on full-outer plans, the edge gather
(``csr_spmv.cu``) run once per super-partition, on its smaller block. With
no disk dir and no budget the store is the pure-DRAM tier, and results
are bit-for-bit identical either way (the disk tier only moves bytes).

The graph need not fit on the card: ``vert`` may live on the CPU
(``load_graph(..., device="cpu")``), only one super-partition per
pipeline slot is ever resident on ``device``, and the final relation
comes back on the CPU.

PIPELINED STREAMING (``stream=True``, the default): up to
``prefetch_depth`` super-partitions are in flight. The DISPATCHER copies
super-partition s+1's pages into a pinned staging buffer (a ring, one a
pipeline slot), uploads them with non-blocking copies on a dedicated
host-to-device stream and enqueues the step on the compute stream behind
an event, while s still computes; the step's results go back on a
device-to-host stream into pinned buffers behind a compute-stream event.
A COLLECTOR picks finished super-partitions (out of dispatch order when a
later one finishes first: ``event.query()``), blocks on the oldest
otherwise (``event.synchronize()``), and commits each one's host
write-back while the device works on the next. No reference to an
uploaded block outlives its step's enqueue, so a pipeline slot costs one
resident block (torch has no buffer donation; the reference donates).
``stream=False`` is the synchronous upload -> step -> wait -> commit loop
(a window of 1).

BARRIER-FREE PIPELINE (``barrier_free=True``, the default with
``stream=True``): a destination super-partition of superstep i+1 is
dispatchable once every source has landed its runs for it; its inbox
chunk rebuild and mutation apply (``prepare``) run just before its
dispatch, while the device computes earlier destinations. The GS fold,
vote-to-halt and the write-back/combinability/mutation measurements
commit per super-partition at collect time and fold in super-partition
order (bit-for-bit with the synchronous loop); the executor synchronizes
the frontier only for plan switches, regrows and checkpoints. With a
disk tier, ``io_threads`` workers own the disk legs (readahead of the
next destination's pages, coalesced dirty drain); they do disk and numpy
work only — every device copy runs on this driver's thread.

Overflow is DEFERRED: host state for a super-partition commits only when
its result is collected clean; an overflowed result drains the pipeline
(committing the clean ones), doubles only the overflowed capacities,
end-pads the committed bucket blocks and redoes the overflowed
super-partitions from retained host state.

The host inbox is RUN-STRUCTURED: the per-super-partition ``(sp, P, C)``
bucket blocks (valid entries a prefix of every (src, dst) bucket) are
restacked destination-major into per-destination chunks ``(sp, P_src,
C)`` and trimmed to the widest occupied run (a power of two), so the
merging receiver's run-capacity assumption holds host-side and
``plan="auto"`` searches the full join x group-by x connector x
sender-combine x storage space, switching at superstep boundaries.
MUTATIONS span super-partitions through a host mutation inbox (the
superstep buckets insert proposals over all P partitions under
``ec.ooc_collect``); each destination's proposals are applied host-side
with numpy's ``add.at`` / ``maximum.at``, the reference's order, so the
float32 sums match its bits. ``storage="delta"`` writes back only the
changed vertex values. Both policies' write-back bytes, the pager's
per-superstep hit rate and spill bytes, the combinability, the mutation
rate and the dispatch / collect-wait / commit split feed the planner.

Checkpoints export the store's pages at the file level
(``runtime.checkpoint.save_ooc_checkpoint``, the reference's on-disk
format) with the plan, the capacities and the controller's hysteresis
state in the meta; ``resume_from=`` restarts from such a directory.

With the observability switches on, the run records the reference's
spans and counters (``obs.trace``). Its ``superstep`` spans, one per
super-partition nested in ``step_enqueue`` as the reference's jitted
step wrapper nests them, time the enqueue of the step only: unlike
``run_host``'s, they do not close on a device sync. It also records a
plan-audit row per superstep
(``obs.explain``: the in-effect plan re-priced with the machine model of
``device``) and a tier-occupancy sample per superstep (``obs.memwatch``:
the HBM estimate for the resident super-partition, the store's DRAM and
spill bytes).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.driver import (PlanArg, RunResult, _resolve_plan,
                                     cuda_allocator, default_engine_config,
                                     grow_overflowed, init_vertex_values)
from repro_torch.core.plan import FRONTIER_FLOOR, STORAGES, PhysicalPlan
from repro_torch.core.program import VertexProgram
from repro_torch.core.relations import _DTYPES as _TORCH_DTYPES
from repro_torch.core.relations import (GlobalState, MsgRel, VertexRel,
                                        init_gs)
from repro_torch.core.superstep import EngineConfig, make_superstep
from repro_torch.obs import explain, memwatch, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.storage import TieredStore

# the OOC planner searches both storage policies on top of the full
# per-superstep space (in-memory drivers inherit the base plan's storage:
# they never pay a write-back, so the dimension would only produce ties)
_OOC_AUTO_SPACE = {"storages": STORAGES}

# host-resident relations (the chunked pages of the TieredStore)
_RELS = ("vid", "halt", "value", "edge_src", "edge_dst", "edge_val")
_OUT = ("out_dst", "out_pay", "out_val")     # collected sender buckets
_MUT = ("mut_dst", "mut_pay", "mut_val")     # collected insert proposals
_INBOX = ("inbox_dst", "inbox_pay", "inbox_val")
_GS = ("halt", "aggregate", "superstep", "overflow", "active_count",
       "msg_count")


@dataclasses.dataclass
class _InFlight:
    """One dispatched, uncollected super-partition: its results in host
    buffers (pinned on CUDA), valid once ``event`` has completed (None on
    the CPU, where they are ready at once). No device tensor is held."""
    s: int
    host: dict                      # name -> np.ndarray
    event: Optional[object]         # torch.cuda.Event of the downloads
    has_mut: bool
    edges_changed: bool

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


@dataclasses.dataclass
class _Done:
    """One committed super-partition (host-side results; the bucket and
    mutation blocks themselves live as pages in the TieredStore)."""
    counts: np.ndarray    # (sp, P) per-bucket occupancy of the out block
    halt_ok: bool
    active: int
    agg: np.ndarray
    delta_bytes: int
    full_bytes: int
    has_mut: bool


def _round_run_width(max_count: int, cap: int) -> int:
    """Trim width for the inbox runs: next power of two >= the widest
    occupied run, clamped to [1, bucket_cap]. Power-of-two rounding keeps
    the set of distinct message shapes logarithmic in cap as the
    frontier breathes."""
    w = 1
    while w < max_count:
        w *= 2
    return max(1, min(w, cap))


def _sort_inbox_runs(inbox):
    """Sort every (dst, src) run of a host inbox chunk by dst — the
    host-side mirror of ``planner.adaptive.migrate_msgs`` for a mid-run
    switch onto the merging connector when the previous plan produced
    UNSORTED runs (plain partitioning without a sender combine). Invalid
    slots key as int32 max, so the stable sort keeps valid entries a run
    prefix."""
    d, p, v = inbox
    key = np.where(v, d, np.iinfo(np.int32).max)
    order = np.argsort(key, axis=2, kind="stable")
    return (np.take_along_axis(d, order, axis=2),
            np.take_along_axis(p, order[..., None], axis=2),
            np.take_along_axis(v, order, axis=2))


def _pad_run_width(block, C_new: int):
    """End-pad a collected (sp, P, C_old) bucket block to C_new. Valid
    entries occupy a prefix per bucket, so end-padding with invalid
    slots preserves the run layout (cf. driver._regrow_msgs)."""
    d, p, v = block
    pad = C_new - d.shape[2]
    if pad <= 0:
        return block
    return (np.pad(d, ((0, 0), (0, 0), (0, pad)), constant_values=-1),
            np.pad(p, ((0, 0), (0, 0), (0, pad), (0, 0))),
            np.pad(v, ((0, 0), (0, 0), (0, pad))))


def _host_slot_of(dst, valid, Np: int, P: int, partition: str):
    """Host-side mirror of the superstep's vid -> local slot map, for
    applying the mutation inbox. Slots past the capacity clamp to the
    drop row Np — the device scatter drops out-of-bounds insert vids,
    and np.add.at would raise instead."""
    if partition == "range":
        owner = np.minimum(dst // Np, P - 1)
        slot = np.where(valid, dst - owner * Np, Np)
    else:
        slot = np.where(valid, dst // P, Np)
    return np.minimum(slot, Np)


def _distinct_run_dsts(b_dst: np.ndarray, b_val: np.ndarray) -> int:
    """Distinct destinations PER (source, dst-partition) RUN of one
    collected bucket block — the duplicates a SENDER-side combine could
    collapse (global distinct would also count cross-source fan-in,
    which no sender can remove). Sort each run and count value
    boundaries; invalid slots key as int max. Measured at commit time,
    overlapped by the pipeline."""
    key = np.where(b_val, b_dst, np.iinfo(np.int32).max)
    srt = np.sort(key, axis=2)
    new_run = np.ones(srt.shape, bool)
    new_run[:, :, 1:] = srt[:, :, 1:] != srt[:, :, :-1]
    return int((new_run & (srt != np.iinfo(np.int32).max)).sum())


def _apply_mutation_chunk(store: TieredStore, program, plan, P: int,
                          sp: int, n_sp: int, gen: int, q: int):
    """Apply destination super-partition ``q``'s collected insert
    proposals to the host store — the per-destination half of the host
    mutation inbox. Mirrors the in-memory ``apply_mutations``
    scatter/resolve: per destination partition, sum conflicting
    proposals per slot, count them, recover the vid, run
    ``program.resolve`` (on tensor views of the numpy arrays; the port's
    UDFs take tensors), and install the result (vid set, value replaced,
    halt cleared) where any proposal landed. numpy's ``add.at`` keeps
    the reference's summation order, so the float32 sums are its bits."""
    d = np.concatenate([store.get_page(("mut_dst", gen, s, q))
                        for s in range(n_sp)])    # (P, sp, Cm)
    pv = np.concatenate([store.get_page(("mut_pay", gen, s, q))
                         for s in range(n_sp)])   # (P, sp, Cm, V)
    ok = np.concatenate([store.get_page(("mut_val", gen, s, q))
                         for s in range(n_sp)])   # (P, sp, Cm)
    V = pv.shape[-1]
    vid_pg = store.read("vid", q)
    Np = vid_pg.shape[1]
    touched = False
    val_pg = halt_pg = None
    for p_local in range(sp):
        dd = d[:, p_local, :].reshape(-1)
        oo = ok[:, p_local, :].reshape(-1)
        if not oo.any():
            continue
        vv = pv[:, p_local, :, :].reshape(-1, V)
        slot = _host_slot_of(dd, oo, Np, P, plan.partition)
        # float32 sums, int32 counts: the device's dtypes, so a custom
        # resolve sees the same promotion rules host-side
        summed = np.zeros((Np + 1, V), np.float32)
        np.add.at(summed, slot,
                  np.where(oo[:, None], vv, np.float32(0.0)))
        cnt = np.zeros((Np + 1,), np.int32)
        np.add.at(cnt, slot, oo)
        newvid = np.full((Np + 1,), -1, np.int32)
        np.maximum.at(newvid, slot,
                      np.where(oo, dd, -1).astype(np.int32))
        resolved = program.resolve(torch.from_numpy(newvid[:Np]),
                                   torch.from_numpy(summed[:Np]),
                                   torch.from_numpy(cnt[:Np]))
        resolved = np.asarray(resolved.numpy(), np.float32)
        take = cnt[:Np] > 0
        if not take.any():
            continue
        if not touched:
            # pages may be shared read-only buffers: write fresh copies
            vid_pg = np.array(vid_pg)
            val_pg = np.array(store.read("value", q))
            halt_pg = np.array(store.read("halt", q))
            touched = True
        vid_pg[p_local][take] = newvid[:Np][take]
        val_pg[p_local][take] = resolved[take]
        halt_pg[p_local][take] = False
    if touched:
        store.write("vid", q, vid_pg)
        store.write("value", q, val_pg)
        store.write("halt", q, halt_pg)


def _gs_from_host(z: dict) -> GlobalState:
    """A GlobalState of CPU tensors from host scalars/arrays."""
    return GlobalState(
        halt=torch.tensor(bool(z["halt"])),
        aggregate=torch.from_numpy(
            np.array(z["aggregate"], np.float32).reshape(-1)),
        superstep=torch.tensor(int(z["superstep"]), dtype=torch.int32),
        overflow=torch.from_numpy(np.array(z["overflow"], np.int32)),
        active_count=torch.tensor(int(z["active"]), dtype=torch.int32),
        msg_count=torch.tensor(int(z["msgs"]), dtype=torch.int32))


def _adopt_checkpoint(store: TieredStore, z: dict, src) -> GlobalState:
    """Install a spill-directory checkpoint into a fresh store (pages
    hard-linked/copied at the file level; on the disk tier nothing is
    read into DRAM until first touch). ``z``/``src`` come from the
    caller's ``load_ooc_meta``. Returns the restored GlobalState, on the
    CPU."""
    for nm in _RELS:
        for s in range(store.n_sp):
            store.adopt_page((nm, s), src / f"{nm}_{s}.npy", relation=nm)
    for nm in _INBOX:
        for q in range(store.n_sp):
            store.adopt_page((nm, 0, q), src / f"{nm}_{q}.npy",
                             immutable=True)
    return _gs_from_host(z)


class _ShapeVert:
    """Shape-only stand-in for a VertexRel (resume path: the capacity
    policies only read ``.vid.shape`` / ``.edge_src.shape``)."""

    def __init__(self, P, Np, Ep):
        self.vid = np.empty((P, Np), np.bool_)
        self.edge_src = np.empty((P, Ep), np.bool_)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Mover:
    """Every host<->device copy of the run, on the driver's thread.

    On a CUDA ``device``: uploads go through a ring of pinned staging
    buffers (one a pipeline slot; a slot is reused only after its upload
    event completed) with non-blocking copies on the host-to-device
    stream; the compute stream waits on the upload event before the
    step, and each uploaded tensor is ``record_stream``-ed onto the
    compute stream. Downloads wait on a compute-stream event, copy on
    the device-to-host stream into pinned buffers, and record one event
    a super-partition; the outputs are ``record_stream``-ed onto that
    stream so their memory is not handed out before the copies ran. On
    the CPU both directions are plain copies."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.n_slots = max(int(slots), 1)
        self._next = 0
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
            self.staging = [None] * self.n_slots     # pinned uint8
            self.staged = [None] * self.n_slots      # upload events

    def upload(self, arrays: dict) -> dict:
        """{name: numpy array} -> {name: tensor on the device}; on CUDA
        the tensors are ready on the compute stream, in stream order."""
        if not self.cuda:
            # a copy: pages are cached (possibly read-only) buffers
            return {k: torch.from_numpy(np.array(a)) for k, a in
                    arrays.items()}
        slot = self._next
        self._next = (slot + 1) % self.n_slots
        if self.staged[slot] is not None:
            self.staged[slot].synchronize()
        sizes = {k: (a.nbytes + 255) // 256 * 256 for k, a in
                 arrays.items()}
        need = sum(sizes.values())
        buf = self.staging[slot]
        if buf is None or buf.numel() < need:
            buf = torch.empty(need + need // 4, dtype=torch.uint8,
                              pin_memory=True)
            self.staging[slot] = buf
        host = buf.numpy()
        out = {}
        off = 0
        with torch.cuda.stream(self.h2d):
            for k, a in arrays.items():
                a = np.ascontiguousarray(a)
                view = host[off:off + a.nbytes].view(a.dtype) \
                    .reshape(a.shape)
                np.copyto(view, a)
                src = buf[off:off + a.nbytes].view(
                    _TORCH_DTYPES[a.dtype]).view(a.shape)
                dev = torch.empty(a.shape, dtype=src.dtype,
                                  device=self.device)
                dev.copy_(src, non_blocking=True)
                dev.record_stream(self.compute)
                out[k] = dev
                off += sizes[k]
            ev = torch.cuda.Event()
            ev.record(self.h2d)
        self.staged[slot] = ev
        self.compute.wait_event(ev)
        return out

    def download(self, tensors: dict):
        """{name: tensor} -> ({name: host array}, event or None). The
        arrays are valid once the event completed."""
        if not self.cuda:
            return {k: _np(t) for k, t in tensors.items()}, None
        done = torch.cuda.Event()
        done.record(self.compute)
        host = {}
        with torch.cuda.stream(self.d2h):
            self.d2h.wait_event(done)
            for k, t in tensors.items():
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(self.d2h)
                host[k] = h.numpy()
            ev = torch.cuda.Event()
            ev.record(self.d2h)
        return host, ev


def run_out_of_core(vert: Optional[VertexRel], program: VertexProgram,
                    plan: PlanArg = PhysicalPlan(), *,
                    budget_partitions: int,
                    max_supersteps: int = 50,
                    ec: Optional[EngineConfig] = None,
                    auto_config=None,
                    auto_space: Optional[dict] = None,
                    stream: bool = True,
                    prefetch_depth: int = 2,
                    barrier_free: bool = True,
                    memory_budget_bytes: Optional[int] = None,
                    disk_dir: Optional[str] = None,
                    eviction: str = "lru",
                    io_threads: Optional[int] = None,
                    readahead_pages: int = 8,
                    checkpoint_every: int = 0,
                    checkpoint_dir: Optional[str] = None,
                    resume_from: Optional[str] = None,
                    recover: bool = False,
                    max_retries: int = 3,
                    on_superstep=None,
                    device="cuda") -> RunResult:
    """Run ``program`` streaming super-partitions of ``budget_partitions``
    partitions (the device-memory budget; P % budget_partitions must be
    0) through the superstep on ``device``. ``vert`` may live on any
    device (a graph that does not fit on the card is loaded with
    ``load_graph(..., device="cpu")``); the returned ``RunResult.vertex``
    is on the CPU, and ``gather_values`` reads it there. ``device="cuda"``
    without CUDA raises.

    plan="auto" picks the plan from the cost model (the machine model of
    ``device``) and re-picks it at superstep boundaries over the full
    plan space, storage included.

    stream=True (default) keeps up to ``prefetch_depth`` super-partitions
    in flight; stream=False is the synchronous loop. barrier_free=True
    (default; requires stream=True) interleaves the per-destination inbox
    rebuild and mutation apply with the next superstep's dispatches.
    Results are bit-for-bit identical across the three modes.

    DISK TIER: ``memory_budget_bytes`` caps the host-DRAM bytes of the
    run's pages; cold pages spill under ``disk_dir`` (required with a
    budget) and fault back on access. ``eviction`` is "lru" or "mru" (the
    latter resists the superstep's cyclic scan). ``io_threads`` (default
    1 with a disk dir, else 0) moves the disk legs to background workers;
    ``readahead_pages`` bounds their readahead a tick. Results are
    bit-for-bit identical to the pure-DRAM tier.

    ``checkpoint_every``/``checkpoint_dir`` snapshot the store at
    superstep boundaries (file-level page export); ``resume_from=<dir>``
    restarts from such a snapshot (``vert`` may then be None).
    ``recover=True`` runs the job under the recovery supervisor: a
    recoverable failure restores the latest VALID snapshot under
    ``checkpoint_dir`` and replays. ``on_superstep(i, rec_dict)`` is
    called after each superstep's record lands."""
    from repro_torch.planner.stats import StatsCollector
    from repro_torch.runtime import faults as chaos
    from repro_torch.runtime.checkpoint import save_ooc_checkpoint

    if recover:
        from repro_torch.runtime.checkpoint import latest_ooc_checkpoint
        from repro_torch.runtime.failure import supervised_run
        n_workers = (vert.vid.shape[0] // budget_partitions
                     if vert is not None else max(1, max_retries + 1))

        def _attempt(healthy, resume):
            if resume is None and vert is None:
                raise RuntimeError(
                    "no valid checkpoint to restore and no initial "
                    "relations to restart from")
            return run_out_of_core(
                vert, program, plan,
                budget_partitions=budget_partitions,
                max_supersteps=max_supersteps, ec=ec,
                auto_config=auto_config, auto_space=auto_space,
                stream=stream,
                prefetch_depth=prefetch_depth, barrier_free=barrier_free,
                memory_budget_bytes=memory_budget_bytes,
                disk_dir=disk_dir, eviction=eviction,
                io_threads=io_threads, readahead_pages=readahead_pages,
                checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir, resume_from=resume,
                recover=False, on_superstep=on_superstep, device=device)

        def _pick(bad):
            if not checkpoint_dir:
                return None
            return latest_ooc_checkpoint(checkpoint_dir, skip=bad,
                                         deep=True)

        return supervised_run(_attempt, _pick, n_workers=n_workers,
                              max_retries=max_retries,
                              initial_resume=resume_from)

    t0 = time.time()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_out_of_core(device='cuda'): no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    sp = budget_partitions
    if checkpoint_every and not checkpoint_dir:
        raise ValueError("checkpoint_every needs a checkpoint_dir — "
                         "otherwise the job would silently run "
                         "without any checkpoints")
    barrier_free = bool(barrier_free and stream)
    if io_threads is None:
        io_threads = 1 if disk_dir else 0
    store = None
    try:
        ck_meta = ck_gs = ck_src = None
        if resume_from is not None:
            # shapes come from the checkpoint pages; vert is not needed
            from repro_torch.runtime.checkpoint import load_ooc_meta
            ck_meta, ck_gs, ck_src = load_ooc_meta(resume_from)
            n_sp = ck_meta["n_sp"]
            P = n_sp * sp
            if ck_meta.get("sp", sp) != sp:
                raise ValueError(
                    f"checkpoint streams {ck_meta.get('sp')} "
                    f"partitions per super-partition; got "
                    f"budget_partitions={sp}")
        else:
            P = vert.vid.shape[0]
            if P % sp:
                raise ValueError(f"budget_partitions={sp} must divide the "
                                 f"{P} partitions")
            n_sp = P // sp
        metrics = MetricsRegistry()
        store = TieredStore(n_sp=n_sp, budget_bytes=memory_budget_bytes,
                            disk_dir=disk_dir, policy=eviction,
                            io_threads=io_threads,
                            readahead_pages=readahead_pages,
                            metrics=metrics)
        gen = 0            # inbox generation (one per superstep fold)
        graph_stats = None
        if resume_from is not None:
            gs = _adopt_checkpoint(store, ck_gs, ck_src)
            i = int(ck_meta["superstep"])
            Np = store.read("vid", 0).shape[1]
            Ep = store.read("edge_src", 0).shape[1]
            C_in = store.get_page(("inbox_dst", 0, 0)).shape[2]
            shape_vert = _ShapeVert(P, Np, Ep)
            if plan == "auto":
                # only the auto-planner needs graph statistics: a static
                # resume must not stream two whole relations through the
                # budgeted cache just to discard the counts
                n_live = sum(int((store.read("vid", s) >= 0).sum())
                             for s in range(n_sp))
                n_edges = sum(int((store.read("edge_src", s) >= 0).sum())
                              for s in range(n_sp))
                from repro_torch.planner.cost import GraphStats
                graph_stats = GraphStats(
                    n_vertices=n_live, n_edges=n_edges, n_partitions=P,
                    vertex_capacity=Np, edge_capacity=Ep,
                    value_dims=program.value_dims,
                    msg_dims=program.msg_dims)
        else:
            Np = vert.vid.shape[1]
            shape_vert = vert
            i = 0
        saved_plan = None
        if ck_meta is not None and ck_meta.get("plan"):
            saved_plan = PhysicalPlan.from_dict(ck_meta["plan"])
        wanted_auto = plan == "auto"
        plan, controller = _resolve_plan(
            shape_vert if resume_from is None else None, program, plan,
            adaptive=True, auto_config=auto_config,
            auto_space=_OOC_AUTO_SPACE if auto_space is None
            else auto_space, graph_stats=graph_stats, device=device)
        if saved_plan is not None:
            if wanted_auto:
                # restart auto jobs from the plan IN EFFECT at the
                # checkpoint (it produced the restored inbox's layout);
                # the controller re-plans from live statistics as usual
                plan = saved_plan
                if controller is not None:
                    controller.plan = plan
            if (plan.connector == "partitioning_merging"
                    and saved_plan.connector != "partitioning_merging"
                    and not saved_plan.sender_combine):
                # the checkpointed inbox's runs are unsorted but the
                # resumed plan's merging receiver assumes dst order
                for q in range(n_sp):
                    triple = _sort_inbox_runs(tuple(
                        store.get_page((nm, 0, q)) for nm in _INBOX))
                    for nm, a in zip(_INBOX, triple):
                        store.put_page((nm, 0, q), a, immutable=True)
        if controller is not None and ck_meta is not None \
                and ck_meta.get("controller"):
            # restore the hysteresis window/streak/cooldown, so a resume
            # right before a pending switch does not re-pay the patience
            # window
            controller.load_state(ck_meta["controller"])
        caller_ec = ec is not None
        ec = ec or default_engine_config(shape_vert, program, plan)
        if not caller_ec and ck_meta is not None and ck_meta.get("caps"):
            # restore the checkpointed (possibly overflow-regrown)
            # capacities instead of replaying the regrow cascade
            ec = dataclasses.replace(ec, **ck_meta["caps"])
        # resolve frontier_cap=0 (the EngineConfig "Np/2" default) to its
        # concrete value up front: the overflow regrow path doubles it,
        # and 0 * 2 = 0 would rebuild the identical config forever
        ec = dataclasses.replace(ec, ooc_collect=True,
                                 frontier_cap=ec.frontier_cap or
                                 max(Np // 2, 1))
        if explain.enabled():
            # plan-audit ledger: the shadow auditor re-prices the
            # in-effect plan per superstep with the machine model of
            # ``device`` (static resumes without graph statistics stay
            # decision-log-only)
            from repro_torch.planner.cost import machine_for
            explain.attach(
                program,
                vert=shape_vert if resume_from is None else None,
                g=(controller.g if controller is not None
                   else graph_stats),
                plan=plan,
                machine=(controller.machine if controller is not None
                         else machine_for(device)),
                space_kw=(_OOC_AUTO_SPACE if auto_space is None
                          else auto_space))
        if memwatch.enabled():
            memwatch.configure(
                ec=ec, Np=Np, Ep=shape_vert.edge_src.shape[1],
                value_dims=program.value_dims,
                msg_dims=program.msg_dims,
                budget_bytes=memory_budget_bytes,
                allocator=cuda_allocator(device))
        step = make_superstep(program, plan, ec)
        seen_widths = set()   # inbox widths this `step` has already run
        window = max(int(prefetch_depth), 1) if stream else 1
        mover = _Mover(device, window)

        D = program.msg_dims
        if resume_from is None:
            # host-resident state through the buffer cache (DRAM pages
            # backed by the disk tier when configured)
            for k in _RELS:
                store.register(k, _np(getattr(vert, k)))
            gs = init_gs(program.agg_dims, "cpu")
            # init values on the device, a super-partition at a time
            gs_dev = GlobalState(**{f: getattr(gs, f).to(device)
                                    for f in _GS})
            for s in range(n_sp):
                vpart = VertexRel(**{
                    k: torch.from_numpy(np.array(store.read(k, s)))
                    .to(device) for k in _RELS})
                vpart = init_vertex_values(vpart, program, gs_dev)
                store.write("value", s, _np(vpart.value))
            del vpart, gs_dev
            # run-structured empty inbox: one invalid slot per (dst, src)
            # run, chunked per destination super-partition
            C_in = 1
            for q in range(n_sp):
                store.put_page(("inbox_dst", 0, q),
                               np.full((sp, P, 1), -1, np.int32),
                               immutable=True)
                store.put_page(("inbox_pay", 0, q),
                               np.zeros((sp, P, 1, D), np.float32),
                               immutable=True)
                store.put_page(("inbox_val", 0, q),
                               np.zeros((sp, P, 1), bool),
                               immutable=True)
        n_live = (controller.g.n_vertices if controller is not None
                  else sum(int((store.read("vid", s) >= 0).sum())
                           for s in range(n_sp)))
        coll = StatsCollector(n_partitions=P, vertex_capacity=Np,
                              msg_dims=D, n_vertices=n_live,
                              metrics=metrics)
        m_prepare = metrics.histogram("ooc.prepare_s")
        m_regrows = metrics.counter("ooc.regrows")
        m_switches = metrics.counter("ooc.plan_switches")
        stats = []
        delta_bytes = full_bytes = 0
        recompiled = True  # the first superstep builds the step
        initial_plan = plan
        store.take_interval()    # reset per-superstep pager counters
        # ---- rolling-frontier state (reassigned at every fold; the
        # closures below read the CURRENT binding at call time) ---------
        prepared = set(range(n_sp))   # gen-0 chunks exist (init / resume)
        cur_has_mut = False           # no mutation pages precede gen 0
        sort_on_build = False         # one-off run sort on a merging switch
        todo = deque()
        committed = {}
        t_io = {"dispatch": 0.0, "wait": 0.0, "commit": 0.0}
        acc = {"distinct": 0, "proposals": 0, "applied": False}
        stall_cell = [None]
        gs_cell = [None]              # this superstep's GS on the device
        t_ready0 = time.time()

        def prepare(q):
            """Per-destination readiness work for generation ``gen``:
            restack destination q's inbox chunk from the runs all n_sp
            sources landed for it (source-major stack, destination-major
            transpose, every run trimmed to C_in; valid entries are a
            bucket PREFIX, so the trim drops only invalid tail slots),
            then apply q's mutation-inbox columns."""
            if q in prepared:
                return
            tp = time.time()
            d_q = np.concatenate([store.get_page(("out_dst", gen, s, q))
                                  for s in range(n_sp)], axis=0)
            p_q = np.concatenate([store.get_page(("out_pay", gen, s, q))
                                  for s in range(n_sp)], axis=0)
            v_q = np.concatenate([store.get_page(("out_val", gen, s, q))
                                  for s in range(n_sp)], axis=0)
            triple = (np.ascontiguousarray(
                          d_q.transpose(1, 0, 2)[:, :, :C_in]),
                      np.ascontiguousarray(
                          p_q.transpose(1, 0, 2, 3)[:, :, :C_in]),
                      np.ascontiguousarray(
                          v_q.transpose(1, 0, 2)[:, :, :C_in]))
            if sort_on_build:
                # a plan switch onto the merging receiver landed at the
                # fold before this chunk was built
                triple = _sort_inbox_runs(triple)
            for nm, a in zip(_INBOX, triple):
                store.put_page((nm, gen, q), a, immutable=True)
            for s in range(n_sp):
                for nm in _OUT:
                    store.delete_page((nm, gen, s, q))
            if gen > 0:
                for nm in _INBOX:
                    store.delete_page((nm, gen - 1, q))
            if cur_has_mut:
                _apply_mutation_chunk(store, program, plan, P, sp, n_sp,
                                      gen, q)
                for s in range(n_sp):
                    for nm in _MUT:
                        store.delete_page((nm, gen, s, q))
            m_prepare.observe(time.time() - tp)
            trace.complete("prepare", "prepare", tp, time.time(), q=q)
            prepared.add(q)

        def dispatch(q):
            """disk -> DRAM -> device prefetch + step enqueue for one
            super-partition: pages fault in from the spill tier if
            evicted, go up through the pinned staging ring, the step is
            enqueued behind the upload, and its results start back to
            pinned host buffers behind it. The value page stays PINNED
            until commit (the delta compare needs the pre-step values
            resident)."""
            td = time.time()
            if store.engine is not None:
                # announce the NEXT destination's pages to the I/O
                # engine so its faults happen off the critical path;
                # when this superstep's queue has drained, warm the next
                # superstep's first destination instead
                if todo:
                    qn = todo[0]
                    keys = [(nm, qn) for nm in _RELS]
                    if qn in prepared:
                        keys += [(nm, gen, qn) for nm in _INBOX]
                    else:
                        keys += [(nm, gen, s2, qn)
                                 for s2 in range(n_sp) for nm in _OUT]
                        if cur_has_mut:
                            keys += [(nm, gen, s2, qn)
                                     for s2 in range(n_sp)
                                     for nm in _MUT]
                else:
                    keys = [(nm, 0) for nm in _RELS]
                    keys += [(nm, gen + 1, s2, 0)
                             for s2 in range(n_sp) for nm in _OUT]
                store.readahead(keys)
            store.pin("value", q)
            pages = {k: store.read(k, q) for k in _RELS}
            # incoming chunk: the run-structured inbox page for this
            # destination super-partition, runs flattened — already
            # the receiver's layout
            pages["m_dst"] = store.get_page(("inbox_dst", gen, q)) \
                .reshape(sp, P * C_in)
            pages["m_pay"] = store.get_page(("inbox_pay", gen, q)) \
                .reshape(sp, P * C_in, D)
            pages["m_val"] = store.get_page(("inbox_val", gen, q)) \
                .reshape(sp, P * C_in)
            up = mover.upload(pages)
            vpart = VertexRel(**{k: up[k] for k in _RELS})
            msg = MsgRel(dst=up["m_dst"], payload=up["m_pay"],
                         valid=up["m_val"])
            del up
            # part0 = this block's first GLOBAL partition index, so
            # resurrect mints correct vids past super-partition 0
            # (the inner ``superstep`` span is the one the reference's
            # jitted step wrapper records around each call; both time
            # the enqueue, with no device sync)
            with trace.annotate("step_enqueue", "compute"), \
                    trace.annotate("superstep", "compute"):
                v2, buckets, g2, cnts, mut = step(vpart, msg, gs_cell[0],
                                                  part0=q * sp)
            edges_changed = (v2.edge_dst is not vpart.edge_dst
                             or v2.edge_val is not vpart.edge_val)
            # drop the uploaded block now: a slot holds one block
            del vpart, msg
            outs = {"value": v2.value, "halt": v2.halt, "vid": v2.vid,
                    "b_dst": buckets.dst, "b_pay": buckets.payload,
                    "b_val": buckets.valid, "counts": cnts,
                    "overflow": g2.overflow,
                    "active": g2.active_count, "agg": g2.aggregate}
            if edges_changed:
                outs["edge_dst"] = v2.edge_dst
                outs["edge_val"] = v2.edge_val
            if mut is not None:
                outs.update(m_dst=mut[0], m_pay=mut[1], m_ok=mut[2])
            host, ev = mover.download(outs)
            del v2, buckets, g2, cnts, mut, outs
            now = time.time()
            t_io["dispatch"] += now - td
            trace.complete("dispatch", "dispatch", td, now, q=q)
            if stall_cell[0] is None:
                # device-idle gap: from the previous superstep's last
                # collect to this superstep's first step enqueue — the
                # readiness stall the barrier-free pipeline minimizes
                stall_cell[0] = now - t_ready0
                trace.complete("readiness_stall", "dispatch",
                               t_ready0, now)
            return _InFlight(q, host, ev, "m_dst" in host, edges_changed)

        def commit(e):
            """Commit one clean super-partition's host state (delta vs
            full write-back; both byte counts are measured every
            superstep for the cost model's storage dimension). Dirty
            pages write back to disk lazily. The fold-time signals —
            combinability, mutation proposal count, will-any-insert-land
            — are measured HERE on the full-width collected blocks."""
            tc = time.time()
            h = e.host
            new_value = h["value"]
            old_value = store.read("value", e.s)
            changed = np.any(new_value != old_value, axis=-1)
            d_b = int(changed.sum()) * new_value.shape[-1] * 4
            f_b = new_value.size * 4
            if plan.storage == "delta":
                store.write_rows("value", e.s, changed,
                                 new_value[changed])
            else:
                store.write("value", e.s, new_value)
            new_halt = h["halt"]
            new_vid = h["vid"]
            store.write("halt", e.s, new_halt)
            store.write("vid", e.s, new_vid)
            if e.edges_changed:
                store.write("edge_dst", e.s, h["edge_dst"])
                store.write("edge_val", e.s, h["edge_val"])
            store.unpin("value", e.s)
            # collected sender buckets -> per-destination out pages of
            # the NEXT generation; once every source has landed its runs
            # for destination q, q is dispatchable
            b_dst, b_pay, b_val = h["b_dst"], h["b_pay"], h["b_val"]
            counts = np.array(h["counts"])
            if controller is not None:
                # only the adaptive controller consumes the signal; trim
                # the sort to the block's occupancy (valid entries are a
                # bucket prefix)
                w = max(int(counts.max(initial=0)), 1)
                acc["distinct"] += _distinct_run_dsts(
                    b_dst[:, :, :w], b_val[:, :, :w])
            for q in range(n_sp):
                qsl = slice(q * sp, (q + 1) * sp)
                store.put_page(("out_dst", gen + 1, e.s, q),
                               b_dst[:, qsl])
                store.put_page(("out_pay", gen + 1, e.s, q),
                               b_pay[:, qsl])
                store.put_page(("out_val", gen + 1, e.s, q),
                               b_val[:, qsl])
            if e.has_mut:
                # chunked per destination like the out blocks; the
                # vote-to-halt input ("will any proposal land?") is
                # decided here from the same slot math the apply uses
                m_dst, m_pay, m_ok = h["m_dst"], h["m_pay"], h["m_ok"]
                acc["proposals"] += int(m_ok.sum())
                if not acc["applied"]:
                    lands = _host_slot_of(m_dst, m_ok, Np, P,
                                          plan.partition) < Np
                    if bool((m_ok & lands).any()):
                        acc["applied"] = True
                for q in range(n_sp):
                    qsl = slice(q * sp, (q + 1) * sp)
                    store.put_page(("mut_dst", gen + 1, e.s, q),
                                   m_dst[:, qsl])
                    store.put_page(("mut_pay", gen + 1, e.s, q),
                                   m_pay[:, qsl])
                    store.put_page(("mut_val", gen + 1, e.s, q),
                                   m_ok[:, qsl])
            done = _Done(
                counts=counts,
                halt_ok=bool(np.all(new_halt | (new_vid < 0))),
                active=int(h["active"]),
                agg=np.array(h["agg"], np.float32),
                delta_bytes=d_b, full_bytes=f_b, has_mut=e.has_mut)
            e.host = None
            now = time.time()
            t_io["commit"] += now - tc
            trace.complete("commit", "commit", tc, now, q=e.s)
            return done

        def collect_wait(e):
            """Block until ``e``'s results are on the host (the
            pipeline's compute-wait)."""
            tw = time.time()
            e.wait()
            tc = time.time()
            t_io["wait"] += tc - tw
            trace.complete("collect_wait", "collect", tw, tc, q=e.s)

        while i < max_supersteps and not bool(gs.halt):
            chaos.superstep_tick(i, "ooc")
            ts = time.time()
            this_recompiled = recompiled
            recompiled = False
            if C_in not in seen_widths:
                # a new message width: the first step at this shape
                seen_widths.add(C_in)
                this_recompiled = True
            ovf0 = gs.overflow.numpy().copy()
            gs_cell[0] = GlobalState(**{f: getattr(gs, f).to(device)
                                        for f in _GS})
            t_io = {"dispatch": 0.0, "wait": 0.0, "commit": 0.0}
            acc = {"distinct": 0, "proposals": 0, "applied": False}
            stall_cell = [None]
            committed = {}                # s -> _Done
            todo = deque(range(n_sp))     # dispatch queue (redo re-enters)
            pending = []                  # _InFlight, dispatch order

            while todo or pending:
                # fill the pipeline window, preparing each destination
                # (chunk rebuild + mutation apply) just before its
                # dispatch
                while todo and len(pending) < window:
                    q = todo.popleft()
                    prepare(q)
                    pending.append(dispatch(q))
                # collect a completed super-partition — out of dispatch
                # order when a later one is already done — else block on
                # the oldest
                j = 0
                if len(pending) > 1:
                    j = next((k for k, e in enumerate(pending)
                              if e.ready()), 0)
                e = pending.pop(j)
                collect_wait(e)
                delta = e.host["overflow"] - ovf0
                if (delta > 0).any():
                    # DEFERRED OVERFLOW: drain every pending result,
                    # committing the clean ones and marking overflowed
                    # ones for redo; then double ONLY the overflowed
                    # capacities, rebuild the step, end-pad the committed
                    # blocks and redo from retained host state
                    t_rg = time.time()
                    redo = {e.s}
                    store.unpin("value", e.s)
                    for other in pending:
                        collect_wait(other)
                        od = other.host["overflow"] - ovf0
                        if (od > 0).any():
                            delta = delta + od
                            redo.add(other.s)
                            store.unpin("value", other.s)
                        else:
                            committed[other.s] = commit(other)
                    pending = []
                    ec = grow_overflowed(ec, delta)
                    step = make_superstep(program, plan, ec)
                    seen_widths = {C_in}
                    for s2, done in committed.items():
                        for q in range(n_sp):
                            old = tuple(
                                store.get_page((nm, gen + 1, s2, q))
                                for nm in _OUT)
                            new = _pad_run_width(old, ec.bucket_cap)
                            if new[0] is not old[0]:
                                for nm, a in zip(_OUT, new):
                                    store.put_page((nm, gen + 1, s2, q),
                                                   a)
                        if done.has_mut:
                            for q in range(n_sp):
                                old = tuple(
                                    store.get_page((nm, gen + 1, s2, q))
                                    for nm in _MUT)
                                new = _pad_run_width(old,
                                                     ec.mutation_cap)
                                if new[0] is not old[0]:
                                    for nm, a in zip(_MUT, new):
                                        store.put_page(
                                            (nm, gen + 1, s2, q), a)
                    todo = deque(sorted(redo | set(todo)))
                    stats.append(coll.event(
                        i, "regrow", bucket_cap=ec.bucket_cap,
                        frontier_cap=ec.frontier_cap,
                        mutation_cap=ec.mutation_cap,
                        sources=np.flatnonzero(delta > 0).tolist(),
                        redo=sorted(redo)).as_dict())
                    m_regrows.inc()
                    trace.complete("overflow_regrow", "replan",
                                   t_rg, time.time())
                    this_recompiled = True
                    if controller is not None:
                        controller.note_shape_change()
                    continue
                committed[e.s] = commit(e)
            t_ready0 = time.time()

            # ROLLING FOLD: every input was measured at collect time, so
            # this is scalar work, folded in super-partition order (the
            # float aggregate's order must not depend on completion
            # order — bit-for-bit vs the synchronous loop)
            t_fold = time.time()
            ordered = [committed[s] for s in range(n_sp)]
            halt_all = all(d.halt_ok for d in ordered)
            active = sum(d.active for d in ordered)
            agg = np.zeros((program.agg_dims,), np.float32)
            for d in ordered:
                agg += d.agg
            step_delta = sum(d.delta_bytes for d in ordered)
            step_full = sum(d.full_bytes for d in ordered)
            delta_bytes += step_delta
            full_bytes += step_full
            msg_count = int(sum(int(d.counts.sum()) for d in ordered))
            C_eff = _round_run_width(
                int(max((int(d.counts.max(initial=0)) for d in ordered),
                        default=0)), ec.bucket_cap)
            combinability = (msg_count / acc["distinct"]
                             if acc["distinct"] else 1.0)
            # host mutation inbox vote: an insert that WILL land clears
            # halt on its slot, exactly as the in-device path would
            mutation_rate = 0.0
            if any(d.has_mut for d in ordered):
                mutation_rate = acc["proposals"] / max(n_live, 1)
                if acc["applied"]:
                    halt_all = False
            gen += 1
            C_in = C_eff
            prepared = set()
            cur_has_mut = any(d.has_mut for d in ordered)
            sort_on_build = False
            i += 1
            gs = _gs_from_host(dict(
                halt=halt_all and msg_count == 0, aggregate=agg,
                superstep=i, overflow=gs.overflow.numpy(), active=active,
                msgs=msg_count))
            trace.complete("fold", "commit", t_fold, time.time(), i=i)
            if not barrier_free:
                # the barrier: rebuild the whole generation and apply
                # every destination's mutations before anything else
                # dispatches
                for q in range(n_sp):
                    prepare(q)
            if store.engine is not None:
                # fit the readahead depth to how many observed-latency
                # page faults the compute window can hide
                store.engine.autopace(t_io["wait"])
            interval = store.take_interval()
            pool_now = store.stats()
            faults = interval["misses"]
            looks = faults + interval["hits"]
            spill_rd = interval["spill_read_bytes"]
            spill_wr = interval["spill_write_bytes"]
            rec = coll.record(
                i, active=active, messages=msg_count,
                wall_s=time.time() - ts, recompiled=this_recompiled,
                delta_bytes=delta_bytes, full_bytes=full_bytes,
                change_density=step_delta / max(step_full, 1),
                storage=plan.storage, ooc=True, streaming=stream,
                barrier_free=barrier_free,
                super_partitions=n_sp,
                readiness_stall_s=stall_cell[0] or 0.0,
                dispatch_s=t_io["dispatch"], collect_wait_s=t_io["wait"],
                commit_s=t_io["commit"],
                combinability=combinability,
                mutation_rate=mutation_rate,
                # MEASURED paging, not configuration; all pager counters
                # are per-superstep interval counters
                spill=bool(spill_rd or spill_wr),
                cache_hit_rate=(1.0 - faults / looks) if looks else 1.0,
                spill_read_bytes=spill_rd,
                spill_write_bytes=spill_wr,
                io_queue_depth=interval.get("io_queue_depth_peak", 0),
                io_queue_depth_mean=interval.get("io_queue_depth_mean",
                                                 0.0),
                io_queue_depth_p50=interval.get("io_queue_depth_p50",
                                                0.0),
                io_queue_depth_p90=interval.get("io_queue_depth_p90",
                                                0.0),
                io_queue_depth_max=interval.get("io_queue_depth_max",
                                                0.0),
                readahead_depth=interval.get("readahead_depth",
                                             readahead_pages),
                pager_resident_bytes=pool_now["resident_bytes"],
                pager_peak_bytes=pool_now["peak_resident_bytes"])
            stats.append(rec.as_dict())
            if explain.enabled():
                # audit the plan that EXECUTED this superstep (a switch
                # below only takes effect on the next one)
                explain.superstep(rec, plan=plan,
                                  bucket_cap=ec.bucket_cap)
            if memwatch.enabled():
                # tier snapshot at the superstep boundary: only `sp`
                # partitions are device-resident under the stream
                memwatch.sample(i, store=store, resident_parts=sp)
            if trace.enabled():
                trace.counter("active", active)
                trace.counter("messages", msg_count)
                trace.counter("io_queue_depth",
                              interval.get("io_queue_depth_peak", 0))
            if on_superstep is not None:
                on_superstep(i, stats[-1])
            switched = False
            if controller is not None and not bool(gs.halt):
                with trace.span("replan", "replan"):
                    new_plan = controller.observe(rec,
                                                  bucket_cap=ec.bucket_cap)
                if new_plan is not None:
                    if (new_plan.connector == "partitioning_merging"
                            and plan.connector != "partitioning_merging"
                            and not plan.sender_combine):
                        # the old plan left runs unsorted: chunks already
                        # built get a one-off host-side sort, the rest
                        # are sorted at build time
                        for q in sorted(prepared):
                            triple = _sort_inbox_runs(tuple(
                                store.get_page((nm, gen, q))
                                for nm in _INBOX))
                            for nm, a in zip(_INBOX, triple):
                                store.put_page((nm, gen, q), a,
                                               immutable=True)
                        sort_on_build = True
                    plan = new_plan
                    if plan.join == "left_outer":
                        # refit the frontier to the live set
                        act = active // max(P, 1) + 1
                        ec = dataclasses.replace(
                            ec, frontier_cap=min(
                                max(FRONTIER_FLOOR, act * 4), Np + 8))
                    # dropping the sender combine needs room for
                    # uncombined sends: grow the buckets now instead of
                    # paying an overflow-redo on the next superstep
                    need = default_engine_config(shape_vert, program, plan)
                    if need.bucket_cap > ec.bucket_cap:
                        ec = dataclasses.replace(
                            ec, bucket_cap=need.bucket_cap)
                    step = make_superstep(program, plan, ec)
                    seen_widths = set()
                    stats.append(coll.event(
                        i, "plan-switch", join=plan.join,
                        groupby=plan.groupby, connector=plan.connector,
                        sender_combine=plan.sender_combine,
                        storage=plan.storage,
                        frontier_cap=ec.frontier_cap).as_dict())
                    m_switches.inc()
                    recompiled = True
                    switched = True
                    controller.note_shape_change()
            # adaptive frontier refit (left-outer plan), mirroring
            # run_host: when the live set collapses, shrink the frontier
            # capacity so each super-partition only pays O(|frontier|)
            if plan.join == "left_outer" and not switched \
                    and not bool(gs.halt):
                act = active // max(P, 1) + 1
                if act * 4 < ec.frontier_cap and ec.frontier_cap > \
                        FRONTIER_FLOOR:
                    ec = dataclasses.replace(
                        ec, frontier_cap=max(FRONTIER_FLOOR, act * 2))
                    step = make_superstep(program, plan, ec)
                    seen_widths = set()
                    stats.append(coll.event(
                        i, "frontier-refit",
                        frontier_cap=ec.frontier_cap).as_dict())
                    recompiled = True
                    if controller is not None:
                        controller.note_shape_change()
            if controller is not None and not bool(gs.halt):
                # periodic cost-model re-calibration (opt-in)
                recal = controller.maybe_recalibrate(program, i)
                if recal is not None:
                    stats.append(coll.event(
                        i, "recalibrate", **recal).as_dict())
            if checkpoint_every and checkpoint_dir \
                    and i % checkpoint_every == 0:
                # checkpoints synchronize the rolling frontier: the saved
                # inbox generation must be complete and every pending
                # mutation applied before the pages export
                t_ck = time.time()
                for q in range(n_sp):
                    prepare(q)
                if store.engine is not None:
                    store.engine.drain()
                save_ooc_checkpoint(
                    checkpoint_dir, i, store, gs, inbox_gen=gen,
                    inbox_width=C_in, sp=sp, plan=plan, ec=ec,
                    controller_state=(controller.state_dict()
                                      if controller is not None else None))
                trace.complete("checkpoint_sync", "checkpoint",
                               t_ck, time.time(), superstep=i)
            if bool(gs.halt):
                break
        # the rolling frontier defers mutation application to each
        # destination's prepare; a run that stops here must land them
        # before the final gather, exactly like run_host's in-step apply
        if cur_has_mut:
            for q in range(n_sp):
                if q not in prepared:
                    _apply_mutation_chunk(store, program, plan, P, sp,
                                          n_sp, gen, q)
        final = VertexRel(**{k: torch.from_numpy(store.gather(k))
                             for k in _RELS})
        return RunResult(vertex=final, gs=gs, supersteps=i, stats=stats,
                         wall_s=time.time() - t0, plan=plan,
                         initial_plan=initial_plan)
    finally:
        if store is not None:
            store.close()
