"""Checkpointing and elastic recovery (paper Section 5.5): the port's copy
of ``repro.runtime.checkpoint``.

A checkpoint stores the GLOBAL relations (Vertex, Msg, GS) as one npz
with the reference's field names and dtypes (``vid`` ... ``gs_msgs``),
so either package reads the other's snapshots. Restore can re-partition
onto a DIFFERENT partition count P' (the paper's "newly selected set of
failure-free worker machines"): vids are re-hashed vid % P' and edges
re-bucketed, which is what makes recovery elastic after blacklisting a
failed node. The arrays pass through the host; ``load_checkpoint`` and
``repartition`` put their relations on the device they are given.

VALIDITY: every checkpoint carries an atomic ``<name>.COMMIT`` sidecar,
written LAST, with the file's size and checksum. A writer that dies
mid-checkpoint leaves a sidecar-less partial that ``latest_checkpoint``
skips; the ``LATEST`` marker is a hint, never trusted over the sidecar.
The gap between payload and sidecar is a chaos-harness site
(``checkpoint.commit``).

OUT-OF-CORE checkpoints (``save_ooc_checkpoint``) snapshot the
``TieredStore`` at the FILE level: its spill pages are hard-linked or
copied into a checkpoint directory (DRAM-tier pages serialize through a
``SpillSlot``, so every page carries its CRC trailer), beside ``gs.npz``,
``meta.json`` (the plan in effect, the capacities, the controller's
hysteresis state) and, written LAST, the atomic ``COMMIT.json`` manifest.
The format is the reference's, so either package resumes the other's
snapshots (``run_out_of_core(resume_from=...)``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.relations import (N_OVERFLOW, GlobalState, MsgRel,
                                        VertexRel, gs_from_numpy,
                                        msgs_from_numpy, vertex_from_numpy)
from repro_torch.obs import trace
from repro_torch.storage.spillfile import page_checksum, verify_page_file

# the host-resident relations an OOC checkpoint carries (one spill page
# per super-partition each) plus the run-structured inbox chunks
OOC_RELATIONS = ("vid", "halt", "value", "edge_src", "edge_dst",
                 "edge_val")
OOC_INBOX = ("inbox_dst", "inbox_pay", "inbox_val")

OOC_COMMIT = "COMMIT.json"


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed its manifest/CRC check. Recoverable: the
    supervisor fails over to the previous valid snapshot."""

    def __init__(self, path, detail: str):
        super().__init__(f"corrupt checkpoint {path}: {detail}")
        self.path = str(path)


def _faults():
    from repro_torch.runtime import faults
    return faults


def _file_crc(path: Path) -> tuple:
    return page_checksum(path.read_bytes())


def _write_commit(path: Path, doc: dict):
    """Atomic manifest publish (tmp + os.replace in the same dir)."""
    tmp = path.with_name(f".{path.name}.tmp")
    tmp.write_text(json.dumps(doc))
    os.replace(tmp, path)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(ckpt_dir: str, superstep: int, vert: VertexRel,
                    msg: MsgRel, gs: GlobalState) -> str:
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"ckpt_{superstep:06d}.npz"
    tmp = d / f".tmp_{superstep:06d}.npz"
    with trace.span("save_checkpoint", "checkpoint"):
        np.savez_compressed(
            tmp,
            vid=_np(vert.vid), halt=_np(vert.halt), value=_np(vert.value),
            edge_src=_np(vert.edge_src), edge_dst=_np(vert.edge_dst),
            edge_val=_np(vert.edge_val),
            m_dst=_np(msg.dst), m_pay=_np(msg.payload),
            m_val=_np(msg.valid),
            gs_halt=_np(gs.halt), gs_agg=_np(gs.aggregate),
            gs_step=_np(gs.superstep), gs_overflow=_np(gs.overflow),
            gs_active=_np(gs.active_count), gs_msgs=_np(gs.msg_count))
        os.replace(tmp, path)  # atomic payload publish
        # the crash-mid-checkpoint window: payload visible, no manifest
        _faults().hit("checkpoint.commit", path.name)
        algo, crc = _file_crc(path)
        _write_commit(d / f"{path.name}.COMMIT",
                      {"superstep": int(superstep), "file": path.name,
                       "bytes": path.stat().st_size,
                       "crc_algo": algo, "crc": crc,
                       "saved_at": time.time()})
        (d / "LATEST").write_text(path.name)
    return str(path)


def save_ooc_checkpoint(ckpt_dir: str, superstep: int, store, gs, *,
                        inbox_gen: int, inbox_width: int,
                        sp: int, plan=None, ec=None,
                        controller_state=None) -> str:
    """Snapshot an out-of-core job at a superstep boundary. Pages move at
    the file level (hard-link for immutable inbox generations, copy
    otherwise — no DRAM round-trip on the disk tier; every exported page
    carries its CRC trailer). The directory is written in place and
    COMMITTED by the atomic ``COMMIT.json`` manifest at the end — a
    writer that dies mid-export leaves a manifest-less partial that the
    checkpoint selectors skip. ``gs`` is a GlobalState (any device)."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    name = f"ooc_{superstep:06d}"
    tmp = d / name
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    with trace.span("export_pages", "checkpoint"):
        for nm in OOC_RELATIONS:
            for s in range(store.n_sp):
                store.export_page((nm, s), tmp / f"{nm}_{s}.npy")
        for nm in OOC_INBOX:
            for q in range(store.n_sp):
                store.export_page((nm, inbox_gen, q),
                                  tmp / f"{nm}_{q}.npy")
    np.savez(tmp / "gs.npz",
             halt=_np(gs.halt), aggregate=_np(gs.aggregate),
             superstep=_np(gs.superstep), overflow=_np(gs.overflow),
             active=_np(gs.active_count), msgs=_np(gs.msg_count))
    (tmp / "meta.json").write_text(json.dumps(
        {"format": 1, "superstep": int(superstep), "n_sp": store.n_sp,
         "sp": int(sp), "inbox_width": int(inbox_width),
         # the plan IN EFFECT: it produced the checkpointed inbox's run
         # layout, and a plan="auto" resume restarts from it
         "plan": dataclasses.asdict(plan) if plan is not None else None,
         # the (possibly overflow-regrown) capacities
         "caps": ({"bucket_cap": ec.bucket_cap,
                   "frontier_cap": ec.frontier_cap,
                   "mutation_cap": ec.mutation_cap}
                  if ec is not None else None),
         # the AdaptiveController's hysteresis state, so a resume right
         # before a pending switch does not re-pay the patience window
         "controller": controller_state,
         "saved_at": time.time()}))
    # the crash-mid-checkpoint window: pages + meta visible, no manifest
    _faults().hit("checkpoint.commit", name)
    files = {}
    crcs = {}
    for f in sorted(tmp.iterdir()):
        if f.name == OOC_COMMIT or f.name.startswith("."):
            continue
        files[f.name] = f.stat().st_size
        if f.suffix != ".npy":   # page files carry their own CRC trailer
            algo, crc = _file_crc(f)
            crcs[f.name] = [algo, crc]
    _write_commit(tmp / OOC_COMMIT,
                  {"superstep": int(superstep), "files": files,
                   "crcs": crcs, "saved_at": time.time()})
    (d / "LATEST_OOC").write_text(name)
    return str(tmp)


def verify_ooc_checkpoint(path, *, deep: bool = True) -> list:
    """Validity check against the COMMIT manifest: every listed file
    present with its recorded size, manifest'd CRCs matching, and (deep)
    every page file passing its embedded CRC trailer. Returns the list
    of violations — empty means the snapshot is safe to resume from."""
    p = Path(path)
    errs = []
    commit = p / OOC_COMMIT
    if not commit.exists():
        return [f"{p.name}: no {OOC_COMMIT} manifest (partial checkpoint)"]
    try:
        doc = json.loads(commit.read_text())
    except (OSError, ValueError) as e:
        return [f"{p.name}: unreadable manifest ({e})"]
    for name, size in doc.get("files", {}).items():
        f = p / name
        if not f.exists():
            errs.append(f"{p.name}/{name}: listed in manifest but missing")
            continue
        if f.stat().st_size != size:
            errs.append(f"{p.name}/{name}: size {f.stat().st_size} != "
                        f"manifest {size}")
            continue
        if name in doc.get("crcs", {}):
            algo, want = doc["crcs"][name]
            got_algo, got = _file_crc(f)
            if got_algo == algo and got != want:
                errs.append(f"{p.name}/{name}: CRC mismatch")
        elif deep and name.endswith(".npy"):
            if not verify_page_file(f):
                errs.append(f"{p.name}/{name}: page CRC trailer mismatch")
    return errs


def ooc_checkpoints(ckpt_dir: str) -> list:
    """COMMITTED checkpoint directories under ``ckpt_dir``, oldest
    first. Partials (no manifest) are never listed."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(str(p) for p in d.iterdir()
                  if p.is_dir() and p.name.startswith("ooc_")
                  and (p / OOC_COMMIT).exists())


def latest_ooc_checkpoint(ckpt_dir: str, *, skip=(), deep: bool = False):
    """Newest VALID out-of-core checkpoint: committed manifest, not in
    ``skip``, and (``deep=True``, the recovery path) passing full page
    CRC verification. The LATEST_OOC marker is only a hint — a partial
    or corrupt directory is never selected."""
    skip = {str(Path(s)) for s in skip}
    for p in reversed(ooc_checkpoints(ckpt_dir)):
        if str(Path(p)) in skip:
            continue
        if deep and verify_ooc_checkpoint(p, deep=True):
            continue
        return p
    return None


def load_ooc_meta(path: str):
    """Resolve an OOC checkpoint path (a checkpoint directory or a parent
    directory of checkpoints) and load its metadata. Parent resolution
    only ever lands on a COMMITTED snapshot.
    -> (meta dict, gs npz mapping, checkpoint Path)."""
    p = Path(path)
    if not (p / "meta.json").exists():
        cand = latest_ooc_checkpoint(p)
        if cand is None:
            raise FileNotFoundError(
                f"{path!r} is not an out-of-core checkpoint (no meta.json "
                "and no committed checkpoints inside)")
        p = Path(cand)
    elif not (p / OOC_COMMIT).exists():
        raise CheckpointCorruption(p, "no COMMIT manifest (partial)")
    meta = json.loads((p / "meta.json").read_text())
    gs = dict(np.load(p / "gs.npz"))
    return meta, gs, p


def checkpoints(ckpt_dir: str) -> list:
    """COMMITTED npz checkpoints under ``ckpt_dir``, oldest first."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(str(p) for p in d.iterdir()
                  if p.name.startswith("ckpt_") and p.suffix == ".npz"
                  and p.with_name(f"{p.name}.COMMIT").exists())


def latest_checkpoint(ckpt_dir: str, *, skip=(), verify: bool = False):
    """Newest VALID npz checkpoint (committed sidecar present; with
    ``verify=True`` the npz's CRC is recomputed against it). Partial or
    corrupt snapshots are never selected; LATEST is just a hint."""
    skip = {str(Path(s)) for s in skip}
    for p in reversed(checkpoints(ckpt_dir)):
        if str(Path(p)) in skip:
            continue
        if verify and _npz_commit_errors(Path(p)):
            continue
        return p
    return None


def _npz_commit_errors(path: Path) -> list:
    commit = path.with_name(f"{path.name}.COMMIT")
    if not commit.exists():
        return [f"{path.name}: no COMMIT sidecar (partial checkpoint)"]
    try:
        doc = json.loads(commit.read_text())
    except (OSError, ValueError) as e:
        return [f"{path.name}: unreadable COMMIT sidecar ({e})"]
    if path.stat().st_size != doc.get("bytes"):
        return [f"{path.name}: size != manifest"]
    algo, got = _file_crc(path)
    if algo == doc.get("crc_algo") and got != doc.get("crc"):
        return [f"{path.name}: CRC mismatch"]
    return []


def load_checkpoint(path: str, device="cuda"):
    """-> (VertexRel, MsgRel, GlobalState) on ``device``."""
    p = Path(path)
    if p.with_name(f"{p.name}.COMMIT").exists():
        errs = _npz_commit_errors(p)
        if errs:
            raise CheckpointCorruption(p, "; ".join(errs))
    z = dict(np.load(path))
    if z["gs_overflow"].ndim == 0:
        # pre-split checkpoint: one aggregated counter — restore it into
        # the bucket slot (the only source the old regrow could attribute)
        ovf = np.zeros((N_OVERFLOW,), np.int32)
        ovf[0] = int(z["gs_overflow"])
        z["gs_overflow"] = ovf
    vert = vertex_from_numpy(
        {k: z[k] for k in ("vid", "halt", "value", "edge_src", "edge_dst",
                           "edge_val")}, device)
    msg = msgs_from_numpy(dict(dst=z["m_dst"], payload=z["m_pay"],
                               valid=z["m_val"]), device)
    gs = gs_from_numpy(dict(halt=z["gs_halt"], aggregate=z["gs_agg"],
                            superstep=z["gs_step"],
                            overflow=z["gs_overflow"],
                            active_count=z["gs_active"],
                            msg_count=z["gs_msgs"]), device)
    return vert, msg, gs


def repartition(vert: VertexRel, msg: MsgRel, new_P: int,
                capacity_factor: float = 1.3, *, device=None):
    """Elastic restore: re-hash the global relations onto P' partitions
    (steps 1/2 of the paper's recovery: scan, partition, sort, bulk
    load), in numpy on the host. The new relations go to ``device``
    (default: the device of ``vert``)."""
    device = vert.vid.device if device is None else device
    old_P, Np, V = vert.value.shape
    vid = _np(vert.vid).reshape(-1)
    ok = vid >= 0
    vids = vid[ok].astype(np.int64)
    halt = _np(vert.halt).reshape(-1)[ok]
    value = _np(vert.value).reshape(-1, V)[ok]
    n_max = int(vids.max()) + 1 if len(vids) else 1
    Np2 = int(np.ceil(n_max / new_P) * capacity_factor) + 1
    nv = np.full((new_P, Np2), -1, np.int32)
    nh = np.zeros((new_P, Np2), bool)
    nval = np.zeros((new_P, Np2, V), np.float32)
    p, s = vids % new_P, vids // new_P
    nv[p, s] = vids.astype(np.int32)
    nh[p, s] = halt
    nval[p, s] = value
    # edges: owner follows the (re-hashed) source vid
    e_src_slot = _np(vert.edge_src)
    e_dst = _np(vert.edge_dst)
    e_val = _np(vert.edge_val)
    part_idx = np.repeat(np.arange(old_P), e_src_slot.shape[1]) \
        .reshape(e_src_slot.shape)
    ok_e = e_src_slot >= 0
    src_vid = (e_src_slot.astype(np.int64) * old_P + part_idx)[ok_e]
    dst = e_dst[ok_e].astype(np.int64)
    val = e_val[ok_e]
    owner = src_vid % new_P
    order = np.argsort(owner, kind="stable")
    src_vid, dst, val, owner = (src_vid[order], dst[order], val[order],
                                owner[order])
    counts = np.bincount(owner, minlength=new_P)
    Ep2 = int(max(counts.max(), 1))
    ns = np.full((new_P, Ep2), -1, np.int32)
    nd = np.full((new_P, Ep2), -1, np.int32)
    nev = np.zeros((new_P, Ep2), np.float32)
    start = 0
    for q in range(new_P):
        c = counts[q]
        ns[q, :c] = (src_vid[start:start + c] // new_P).astype(np.int32)
        nd[q, :c] = dst[start:start + c].astype(np.int32)
        nev[q, :c] = val[start:start + c]
        start += c
    new_vert = vertex_from_numpy(dict(vid=nv, halt=nh, value=nval,
                                      edge_src=ns, edge_dst=nd,
                                      edge_val=nev), device)
    # messages: re-bucket by dst % P' (step 2 of recovery)
    m_dst = _np(msg.dst).reshape(-1)
    m_pay = _np(msg.payload).reshape(-1, msg.payload.shape[-1])
    m_ok = _np(msg.valid).reshape(-1)
    dsts = m_dst[m_ok]
    pays = m_pay[m_ok]
    owner = dsts.astype(np.int64) % new_P
    counts = np.bincount(owner, minlength=new_P)
    M2 = int(max(counts.max(), 1) + 8)
    nmd = np.full((new_P, M2), -1, np.int32)
    nmp = np.zeros((new_P, M2, m_pay.shape[-1]), np.float32)
    nmv = np.zeros((new_P, M2), bool)
    order = np.argsort(owner, kind="stable")
    dsts, pays, owner = dsts[order], pays[order], owner[order]
    start = 0
    for q in range(new_P):
        c = counts[q]
        nmd[q, :c] = dsts[start:start + c]
        nmp[q, :c] = pays[start:start + c]
        nmv[q, :c] = True
        start += c
    new_msg = msgs_from_numpy(dict(dst=nmd, payload=nmp, valid=nmv), device)
    return new_vert, new_msg
