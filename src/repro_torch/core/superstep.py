"""One Pregel superstep as a sequence of tensor operators (paper Figures
3/4/5), with the partitions on the leading axis P of every tensor.

    Msg_i --[receiver group-by + combine]--> combined payloads      (D1)
    Vertex_i --[join: full-outer dense | left-outer frontier]--> compute
    compute UDF --> value'/halt'/sends/aggregate/mutations          (D2)
    sends --[edge gather]--[sender combine]--[bucket]--[exchange]   (D3/D7)
    aggregates --[reduction]--> GS_{i+1}
    mutations --[bucket + resolve]--> Vertex_{i+1}                  (D6)

The superstep has one structure, whatever the device: full-outer plans
gather edge values through the csr_spmv kernel, and the sender combine
of a named monoid folds through the segment_combine kernel; the
combined survivors are compacted straight into the bucket pack. A custom
combine UDF folds with the sort group-by instead (the kernel takes named
monoids only), as the reference does. Only the innermost kernel call
changes with the device (kernels/backend.py).

Two transports: with ``EngineConfig.axis_name`` None the exchange is
the single-device transpose and the global state reduces locally; with
a ``connector.ShardAxis`` the superstep runs over this rank's block of
partitions, the exchange is ``connector.exchange_all_to_all`` and the
counts, overflow, halt vote and aggregate are ``all_reduce``d over the
axis's group (``core/sharded.py``). Under ``EngineConfig.ooc_collect``
(the out-of-core drivers) the superstep runs over one super-partition's
block and hands the pre-exchange buckets back instead of exchanging
them; under ``exchange_apart`` (the in-memory sharded driver) it does
the same for the messages, so the driver can time the exchange as its
own stage.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch

from repro_torch.core import connector, groupby
from repro_torch.core.plan import PhysicalPlan
from repro_torch.core.program import ComputeOut, VertexProgram
from repro_torch.core.relations import GlobalState, MsgRel, VertexRel
from repro_torch.kernels import backend as kbackend
from repro_torch.obs import trace

INT32_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class EngineConfig:
    n_parts: int                 # total partitions
    bucket_cap: int              # per (src,dst)-partition bucket capacity
    mutation_cap: int = 64       # insert-proposal bucket capacity
    frontier_cap: int = 0        # left-outer frontier capacity (0 = Np/2)
    # the rank's connector.ShardAxis (group, rank, world size); None =
    # one device, the emulated transport
    axis_name: Optional[connector.ShardAxis] = None
    # out-of-core: return the (sp, n_parts, C) sender buckets to the host
    # instead of exchanging them; the out-of-core driver performs the
    # exchange as a host-side transpose into its run-structured inbox
    ooc_collect: bool = False
    # sharded driver: return the MESSAGE leg's pre-exchange (P_local,
    # n_parts, C) buckets, so the driver runs the all-to-all as its own
    # timed stage. Mutations still exchange inside the superstep.
    exchange_apart: bool = False


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1 for (P, n) or (P, n, V) tensors."""
    idx = idx.long()
    if a.dim() == 3:
        idx = idx[..., None].expand(*idx.shape, a.shape[2])
    return torch.gather(a, 1, idx)


def _scatter_rows(full: torch.Tensor, rows: torch.Tensor,
                  tgt: torch.Tensor) -> torch.Tensor:
    """full.at[p, tgt[p]].set(rows[p]) with tgt == n dropped (sink)."""
    P, n = full.shape[:2]
    sink = torch.zeros((P, 1) + full.shape[2:], dtype=full.dtype,
                       device=full.device)
    out = torch.cat([full, sink], dim=1)
    idx = tgt.long()
    if full.dim() == 3:
        idx = idx[..., None].expand(*idx.shape, full.shape[2])
    out.scatter_(1, idx, rows.to(full.dtype))
    return out[:, :n]


def _count(mask: torch.Tensor) -> torch.Tensor:
    """The True entries of a bool tensor, as an int32 device scalar,
    summed as bytes into int32: on the H100, 0.45 ms over 4 x 34.6 M
    vertex slots against 0.85 ms for ``mask.sum()``."""
    return mask.view(torch.uint8).sum(dtype=torch.int32)


def compact_combined(dst, payload, valid, capc: int):
    """Fused combine -> exchange-pack leg: compact each partition's
    combined survivors (one row per distinct destination, dst ascending)
    down to the ``capc`` rows the buckets can accept, so the bucket build
    never re-materializes the full (P, Ep) payload relation.
    Order-preserving (the ``presorted`` contract holds); rows beyond capc
    count as bucket overflow."""
    idx, _, ovf = groupby.compact(valid, capc)
    ok = idx >= 0
    take = idx.clamp(min=0)
    return (torch.where(ok, _take(dst, take), -1),
            torch.where(ok[..., None], _take(payload, take), 0.0),
            ok, ovf.sum())


def make_superstep(program: VertexProgram, plan: PhysicalPlan,
                   ec: EngineConfig):
    plan.validate(program.combine_op)
    n_parts = ec.n_parts
    axis = ec.axis_name
    if axis is None:
        exchange = connector.exchange_emulated
        part_base = 0
    else:
        import torch.distributed as dist
        exchange = partial(connector.exchange_all_to_all, axis=axis)
        # rank w owns the CONTIGUOUS global partitions [w * P/N, ...)
        part_base = axis.rank * (n_parts // axis.world)
    op = program.combine_op
    named_comb = op != "custom"
    kernel_gather = plan.join == "full_outer"

    def _slot_of(dst, valid, Np):
        if plan.partition == "range":
            owner = torch.clamp_max(dst // Np, n_parts - 1)
            return torch.where(valid, dst - owner * Np, Np)
        return torch.where(valid, dst // n_parts, Np)

    def receiver_groupby(msg: MsgRel, Np: int):
        # run-capacity contract: msg.capacity = n_parts equal-width runs
        slot = _slot_of(msg.dst, msg.valid, Np)
        P = slot.shape[0]
        if not named_comb:
            # custom combine: the sort group-by, whatever the connector
            ident = program.combine_identity().to(slot.device)
            return groupby.sort_combine_dense(
                slot, msg.payload, msg.valid, Np, (program.combine, ident))
        if plan.connector == "partitioning_merging":
            C = msg.capacity // n_parts
            return groupby.run_combine_dense(
                slot.reshape(P, n_parts, C),
                msg.payload.reshape(P, n_parts, C, -1),
                msg.valid.reshape(P, n_parts, C), Np, op)
        if plan.groupby == "sort":
            return groupby.sort_combine_dense(slot, msg.payload, msg.valid,
                                              Np, op)
        return groupby.scatter_combine_dense(slot, msg.payload, msg.valid,
                                             Np, op)

    def resurrect(vert: VertexRel, has_msg, part0):
        """Paper Fig. 2 left-outer case: a message to a non-existent vid
        CREATES the vertex (value 0, not halted). Slot s of partition p
        holds vid s * n_parts + p (hash) or s + p * Np (range), so the
        vid is recoverable from the address. ``part0`` (out-of-core) is
        the global index of the block's first partition: the resident
        rows are partitions part0 .. part0 + P - 1, not 0 .. P - 1.
        Returns (the relation, the number of vertices re-created)."""
        P, Np = vert.vid.shape
        dev = vert.vid.device
        make = has_msg & (vert.vid < 0)
        s_ids = torch.arange(Np, dtype=torch.int32, device=dev)[None, :]
        p_ids = torch.arange(P, dtype=torch.int32, device=dev)[:, None] \
            + part_base
        if part0:
            p_ids = p_ids + part0
        slot_vid = (s_ids + p_ids * Np if plan.partition == "range"
                    else s_ids * n_parts + p_ids)
        return dataclasses.replace(
            vert, vid=torch.where(make, slot_vid, vert.vid),
            halt=torch.where(make, False, vert.halt),
            value=torch.where(make[..., None], 0.0, vert.value)), _count(make)

    def run_compute(vert: VertexRel, combined, has_msg, gs):
        P, Np = vert.vid.shape
        active = ((~vert.halt) | has_msg) & (vert.vid >= 0)
        if plan.join == "full_outer":
            out = program.compute(vert.vid, vert.value, combined, has_msg,
                                  active, gs)
            return out, active, None
        # left-outer: compact the frontier and gather (index probe)
        F = ec.frontier_cap or max(Np // 2, 1)
        idx, _, ovf = groupby.compact(active, F)
        take = idx.clamp(min=0)
        fvid = torch.where(idx >= 0, _take(vert.vid, take), -1)
        fval = _take(vert.value, take)
        fcomb = _take(combined, take)
        fhas = _take(has_msg, take) & (idx >= 0)
        factive = idx >= 0
        out = program.compute(fvid, fval, fcomb, fhas, factive, gs)
        return out, active, (idx, factive, ovf)

    def apply_updates(vert: VertexRel, out: ComputeOut, active, frontier):
        P, Np = vert.vid.shape
        if frontier is None:
            upd = active
            value = torch.where(upd[..., None], out.value, vert.value)
            halt = torch.where(upd, out.halt, vert.halt | ~active)
            gate = out.send_gate & upd
            agg = (out.aggregate, upd) if out.aggregate is not None else None
            return value, halt, gate, agg
        idx, factive, _ = frontier
        tgt = torch.where(factive, idx, Np)                 # Np = sink
        value = _scatter_rows(vert.value, out.value, tgt)
        halt = _scatter_rows(vert.halt, out.halt, tgt)
        gate = _scatter_rows(torch.zeros_like(vert.halt), out.send_gate,
                             tgt)
        agg = (out.aggregate, factive) if out.aggregate is not None else None
        return value, halt, gate & active, agg

    def gen_messages(vert: VertexRel, value_new, gate_dense, gs):
        """Edge-parallel send (dataflow D3). Under the left-outer plan the
        edge stream is COMPACTED to the frontier's edges first, so payload
        generation, the sender combine and the bucket sort run at
        O(|frontier edges|) instead of O(|E|)."""
        Ep = vert.edge_src.shape[1]
        esl = vert.edge_src.clamp(min=0)
        egate = _take(gate_dense, esl) & (vert.edge_src >= 0) & \
            (vert.edge_dst >= 0)
        edge_src, edge_dst, edge_val = (vert.edge_src, vert.edge_dst,
                                        vert.edge_val)
        if plan.join == "left_outer":
            EF = min(max(ec.frontier_cap * 8, 64), Ep)
            eidx, _, ovf_e = groupby.compact(egate, EF)
            etake = eidx.clamp(min=0)
            edge_src = torch.where(eidx >= 0, _take(vert.edge_src, etake),
                                   -1)
            edge_dst = torch.where(eidx >= 0, _take(vert.edge_dst, etake),
                                   -1)
            edge_val = _take(vert.edge_val, etake)
            egate = eidx >= 0
            esl = edge_src.clamp(min=0)
            ovf_edges = ovf_e.sum()
        else:
            ovf_edges = torch.zeros((), dtype=torch.int32,
                                    device=egate.device)
        src_vid = _take(vert.vid, esl)
        if kernel_gather:
            # csr_spmv kernel (plain gather on CPU tensors): invalid lanes
            # read 0.0, masked by egate before anything observable
            src_val = kbackend.edge_gather_values(value_new, edge_src)
        else:
            src_val = _take(value_new, esl)
        payload = program.send(src_vid, src_val, edge_val, edge_dst, gs)
        return edge_dst, payload, egate, ovf_edges

    def sender_combine(dst, payload, valid):
        if not named_comb:
            # a custom UDF: the sort group-by's fold (no kernel)
            ks, folded, is_last = groupby.sort_combine(
                dst, payload, valid, program.combine)
            return torch.where(is_last, ks, -1), folded, is_last
        # segment_combine kernel: one blocked segmented fold over all
        # partitions' stably dst-sorted streams, each folded on its own
        key = torch.where(valid, dst, INT32_MAX)
        order = torch.argsort(key, dim=1, stable=True)
        ks = torch.gather(key, 1, order)
        ps = _take(payload, order)
        vs = torch.gather(valid, 1, order)
        folded, is_last = kbackend.sorted_segment_fold(ks, ps, vs, op)
        return torch.where(is_last, ks, -1), folded, is_last

    def route(dst, payload, valid, cap, Np, presorted, collect=False):
        b_dst, b_pay, b_val, ovf = connector.bucket_by_owner(
            dst, payload, valid, n_parts, cap,
            sort_by_dst=(plan.connector == "partitioning_merging"),
            partition=plan.partition, capacity=Np, presorted=presorted)
        if collect:   # out-of-core: the buckets go back to the host
            return b_dst, b_pay, b_val, ovf.sum()
        r_dst, r_pay, r_val = exchange(b_dst, b_pay, b_val)
        P = dst.shape[0]
        flat = lambda a: a.reshape((P, -1) + a.shape[3:])
        return flat(r_dst), flat(r_pay), flat(r_val), ovf.sum()

    def apply_mutations(vert: VertexRel, value, halt, out: ComputeOut):
        """Dataflow D6 (Figure 5): deletions before insertions, conflicts
        via resolve. Insert proposals are routed to their owners like
        messages (capacity ``mutation_cap``), then summed, counted and
        max-vid'ed per slot through a sink row (the reference's dropped
        scatters); own-edge rewrites are local to the owning partition.
        Out of core (``ec.ooc_collect``) the proposals are bucketed by
        owner over all n_parts partitions and handed back instead: the
        resident block spans one super-partition, so an insert into
        another one travels through the driver's host mutation inbox.
        Returns (vid, value, halt, edge_dst, edge_val, overflow,
        mutation buckets or None)."""
        P, Np = vert.vid.shape
        dev = vert.vid.device
        vid = vert.vid
        if out.delete_self is not None:
            vid = torch.where(out.delete_self, -1, vid)
            halt = torch.where(out.delete_self, True, halt)
        ovf = torch.zeros((), dtype=torch.int32, device=dev)
        mut_buckets = None
        if out.insert_vid is not None and ec.ooc_collect:
            ins_dst = out.insert_vid.reshape(P, -1).to(torch.int32)
            ins_val = out.insert_value.reshape(P, Np, -1).float()
            mb_dst, mb_val, mb_ok, ovf = route(
                ins_dst, ins_val, ins_dst >= 0, ec.mutation_cap, Np, False,
                collect=True)
            mut_buckets = (mb_dst, mb_val, mb_ok)
        elif out.insert_vid is not None:
            ins_dst = out.insert_vid.reshape(P, -1).to(torch.int32)
            ins_val = out.insert_value.reshape(P, Np, -1).float()
            r_dst, r_val, r_ok, ovf = route(
                ins_dst, ins_val, ins_dst >= 0, ec.mutation_cap, Np, False)
            # slots past the relation go to the sink row Np, as the
            # reference's scatters drop them
            slot = torch.clamp_max(_slot_of(r_dst, r_ok, Np), Np).long()
            V = r_val.shape[-1]
            summed = torch.zeros((P, Np + 1, V), dtype=torch.float32,
                                 device=dev)
            summed.scatter_add_(1, slot[..., None].expand(-1, -1, V),
                                torch.where(r_ok[..., None], r_val, 0.0))
            cnt = torch.zeros((P, Np + 1), dtype=torch.int32, device=dev)
            cnt.scatter_add_(1, slot, r_ok.to(torch.int32))
            newvid = torch.full((P, Np + 1), -1, dtype=torch.int32,
                                device=dev)
            newvid.scatter_reduce_(1, slot, torch.where(r_ok, r_dst, -1),
                                   "amax", include_self=True)
            newvid, cnt = newvid[:, :Np], cnt[:, :Np]
            resolved = program.resolve(newvid, summed[:, :Np], cnt)
            take = cnt > 0
            vid = torch.where(take, newvid, vid)
            value = torch.where(take[..., None], resolved, value)
            halt = torch.where(take, False, halt)
        edge_dst, edge_val = vert.edge_dst, vert.edge_val
        if out.new_edge_dst is not None:
            edge_dst = torch.where(out.new_edge_dst >= -1,
                                   out.new_edge_dst.to(torch.int32),
                                   edge_dst)
        if out.new_edge_val is not None:
            edge_val = torch.where(torch.isnan(out.new_edge_val), edge_val,
                                   out.new_edge_val.float())
        return vid, value, halt, edge_dst, edge_val, ovf, mut_buckets

    def superstep(vert: VertexRel, msg: MsgRel, gs: GlobalState,
                  part0: Optional[int] = None):
        """``part0`` (out-of-core only): the global index of the block's
        first partition, so resurrect mints correct vids past the first
        super-partition. Under ``ec.ooc_collect`` the message output
        carries the PRE-EXCHANGE (P, n_parts, C) buckets, and the step
        also returns the per-(src, dst) occupancy counts (P, n_parts)
        and the insert-proposal buckets (or None).

        For a program that ``mutates``, each call leaves on
        ``superstep.mutations`` its (2,) int32 device tensor of vertices
        deleted (D6) and re-created (D1's resurrect) in this superstep,
        summed over the ranks like the other tallies; None otherwise."""
        P, Np = vert.vid.shape
        dev = vert.vid.device
        i32 = lambda x: x.to(torch.int32)
        # each stage is a span (a profiler range under annotations); no
        # kwargs, so with tracing off a span costs one global check
        # 1-2. receiver group-by + join + select (D1)
        with trace.annotate("superstep.groupby", "compute"):
            combined, has_msg = receiver_groupby(msg, Np)
        if program.mutates:
            with trace.annotate("superstep.resurrect", "compute"):
                vert, n_resurrected = resurrect(vert, has_msg, part0)
        with trace.annotate("superstep.compute", "compute"):
            out, active, frontier = run_compute(vert, combined, has_msg,
                                                gs)
            # 3. vertex updates (D2)
            value, halt, gate, agg = apply_updates(vert, out, active,
                                                   frontier)
        # 4. message generation + sender combine + exchange (D3/D7)
        with trace.annotate("superstep.gather", "compute"):
            dst, payload, valid, ovf_edges = gen_messages(vert, value,
                                                          gate, gs)
        presorted = False
        ovf_pack = torch.zeros((), dtype=torch.int32, device=dev)
        if plan.sender_combine:
            with trace.annotate("superstep.combine", "compute"):
                dst, payload, valid = sender_combine(dst, payload, valid)
                presorted = True  # the sorted fold leaves dst ascending
                capc = n_parts * ec.bucket_cap
                if capc < dst.shape[1]:
                    dst, payload, valid, ovf_pack = compact_combined(
                        dst, payload, valid, capc)
        with trace.annotate("superstep.route", "compute"):
            r_dst, r_pay, r_val, ovf = route(
                dst, payload, valid, ec.bucket_cap, Np, presorted,
                collect=ec.ooc_collect or ec.exchange_apart)
        # 5. mutations (D6), after the sends: gen_messages read the edges
        # as they were, so a vertex that deletes itself still sends
        m_ovf = torch.zeros((), dtype=torch.int32, device=dev)
        mut_buckets = None
        vid, edge_dst, edge_val = vert.vid, vert.edge_dst, vert.edge_val
        n_deleted = None
        if out.has_mutations():
            with trace.annotate("superstep.mutate", "compute"):
                if program.mutates and out.delete_self is not None:
                    n_deleted = _count(out.delete_self & (vert.vid >= 0))
                (vid, value, halt, edge_dst, edge_val, m_ovf,
                 mut_buckets) = apply_mutations(vert, value, halt, out)
        # 6. global state. Overflow is counted PER SOURCE (bucket /
        # frontier / mutation / edge) so the driver doubles only the
        # capacity that overflowed.
        with trace.annotate("superstep.reduce", "compute"):
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            tallies = [
                i32(r_val.sum()),
                i32(ovf) + i32(ovf_pack),
                i32(frontier[2].sum()) if frontier is not None else zero,
                i32(m_ovf),
                i32(ovf_edges),
                i32(active.sum())]
            if program.mutates:
                tallies += [zero if n_deleted is None else n_deleted,
                            n_resurrected]
            tallies = torch.stack(tallies)
            not_all_halted = i32(~(halt | (vid < 0)).all()).reshape(1)
            if agg is not None:
                contrib, mask = agg
                agg_val = torch.where(mask[..., None], contrib, 0.0) \
                    .reshape(-1, program.agg_dims).sum(0)
            else:
                agg_val = gs.aggregate
            if axis is not None:
                # every rank ends the superstep with the same global
                # state: SUM of the counts and the overflow vector, MAX
                # of the "not all halted" votes, SUM of the aggregate
                # partials (the ranks' adding order is not run_host's: a
                # float aggregate agrees to rounding)
                dist.all_reduce(tallies, group=axis.group)
                dist.all_reduce(not_all_halted, op=dist.ReduceOp.MAX,
                                group=axis.group)
                if agg is not None:
                    agg_val = agg_val.to(torch.float32).contiguous()
                    dist.all_reduce(agg_val, group=axis.group)
        msg_count = tallies[0]
        overflow = tallies[1:5]
        active_count = tallies[5]
        superstep.mutations = tallies[6:] if program.mutates else None
        halt_all = not_all_halted[0] == 0
        g_halt = halt_all & (msg_count == 0)
        new_vert = VertexRel(vid=vid, halt=halt, value=value,
                             edge_src=vert.edge_src, edge_dst=edge_dst,
                             edge_val=edge_val)
        # under ooc_collect / exchange_apart new_msg carries the
        # PRE-EXCHANGE (P, n_parts, C) buckets; the driver exchanges them
        new_msg = MsgRel(dst=r_dst, payload=r_pay, valid=r_val)
        new_gs = GlobalState(
            halt=g_halt | program.is_converged(gs),
            aggregate=agg_val.to(torch.float32).reshape(
                gs.aggregate.shape),
            superstep=gs.superstep + 1,
            overflow=gs.overflow + overflow,
            active_count=active_count,
            msg_count=msg_count)
        if ec.ooc_collect:
            # per-(src, dst) bucket occupancy, counted on the device so
            # the host never scans the buckets for the run-width trim
            counts = r_val.sum(dim=2, dtype=torch.int32)
            return new_vert, new_msg, new_gs, counts, mut_buckets
        return new_vert, new_msg, new_gs

    superstep.mutations = None
    return superstep
