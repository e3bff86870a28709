"""Checkpointing and elastic recovery (paper Section 5.5): the npz half of
``repro.runtime.checkpoint``.

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

The out-of-core (directory) checkpoints come with the out-of-core slice.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.relations import (N_OVERFLOW, GlobalState, MsgRel,
                                        VertexRel, gs_from_numpy,
                                        msgs_from_numpy, vertex_from_numpy)
from repro_torch.storage.spillfile import page_checksum


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
    np.savez_compressed(
        tmp,
        vid=_np(vert.vid), halt=_np(vert.halt), value=_np(vert.value),
        edge_src=_np(vert.edge_src), edge_dst=_np(vert.edge_dst),
        edge_val=_np(vert.edge_val),
        m_dst=_np(msg.dst), m_pay=_np(msg.payload), m_val=_np(msg.valid),
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
