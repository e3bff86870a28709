"""The Pregel state as relations (paper Table 1), as dense tensors.

Vertex(vid, halt, value, edges) / Msg(vid, payload) / GS(halt, aggregate,
superstep) — struct-of-tensors with a leading partition axis P.
Hash partitioning by vid (the paper's default): owner(vid) = vid % P,
local slot = vid // P, so the dense slot array IS the vid index.
Edges are owned by their source partition as flat (edge_slot -> src slot,
dst vid, value) arrays — the CSR adaptation for edge-parallel sends.

Dtypes follow the reference: int32 vids, sentinels and counts, float32
values, bool masks. Tensors are cast to int64 only where they index.

The ``*_from_numpy`` / ``*_to_numpy`` functions carry a state across to
or from plain numpy arrays keyed by the field names, so a run can start
from, or be compared with, another engine's state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class VertexRel:
    vid: torch.Tensor        # (P, Np) int32, -1 = empty slot
    halt: torch.Tensor       # (P, Np) bool
    value: torch.Tensor      # (P, Np, V) float32
    edge_src: torch.Tensor   # (P, Ep) int32 local src slot, -1 = pad
    edge_dst: torch.Tensor   # (P, Ep) int32 global dst vid
    edge_val: torch.Tensor   # (P, Ep) float32

    @property
    def num_partitions(self) -> int:
        return self.vid.shape[0]

    @property
    def capacity(self) -> int:
        return self.vid.shape[1]


@dataclass
class MsgRel:
    dst: torch.Tensor        # (P, M) int32 global dst vid, -1 = invalid
    payload: torch.Tensor    # (P, M, D) float32
    valid: torch.Tensor      # (P, M) bool

    @property
    def capacity(self) -> int:
        return self.dst.shape[1]


# GlobalState.overflow attributes every capacity overflow to its source,
# so a regrow doubles ONLY the capacity that overflowed.
OVF_BUCKET = 0     # message bucket capacity (EngineConfig.bucket_cap)
OVF_FRONTIER = 1   # left-outer frontier compaction (frontier_cap)
OVF_MUTATION = 2   # insert-proposal buckets (mutation_cap)
OVF_EDGE = 3       # frontier edge-stream compaction (8 * frontier_cap)
N_OVERFLOW = 4


@dataclass
class GlobalState:
    halt: torch.Tensor          # () bool
    aggregate: torch.Tensor     # (A,) float32 user aggregate
    superstep: torch.Tensor     # () int32
    overflow: torch.Tensor      # (N_OVERFLOW,) int32 dropped per source
    active_count: torch.Tensor  # () int32
    msg_count: torch.Tensor     # () int32


def empty_vertices(P: int, Np: int, Ep: int, V: int, device) -> VertexRel:
    """A relation of P partitions with no vertex and no edge: Np empty
    vertex slots and Ep empty edge slots each. On ``meta`` it is the
    shapes and dtypes alone (the operator counter's probes)."""
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
    return VertexRel(
        vid=full((P, Np), -1, torch.int32),
        halt=full((P, Np), True, torch.bool),
        value=full((P, Np, V), 0.0, torch.float32),
        edge_src=full((P, Ep), -1, torch.int32),
        edge_dst=full((P, Ep), -1, torch.int32),
        edge_val=full((P, Ep), 0.0, torch.float32))


def empty_msgs(P: int, M: int, D: int, device) -> MsgRel:
    return MsgRel(
        dst=torch.full((P, M), -1, dtype=torch.int32, device=device),
        payload=torch.zeros((P, M, D), dtype=torch.float32, device=device),
        valid=torch.zeros((P, M), dtype=torch.bool, device=device))


def init_gs(agg_dims: int, device) -> GlobalState:
    z = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return GlobalState(
        halt=torch.zeros((), dtype=torch.bool, device=device),
        aggregate=torch.zeros((agg_dims,), dtype=torch.float32,
                              device=device),
        superstep=z(),
        overflow=torch.zeros((N_OVERFLOW,), dtype=torch.int32,
                             device=device),
        active_count=z(), msg_count=z())


def load_graph(edges: np.ndarray, num_vertices: int, P: int, *,
               value_dims: int, edge_values: np.ndarray | None = None,
               capacity_factor: float = 1.3, partition: str = "hash",
               device="cuda") -> VertexRel:
    """Partition an edge list (E, 2) into a VertexRel on ``device`` (the
    paper's bulk load: scan, partition by vid, sort, bulk-load). Built in
    numpy on the host, then uploaded.

    partition="hash" (paper default): vid lives at (vid % P, vid // P).
    partition="range": vid lives at (vid // cap, vid % cap);
    capacity_factor is forced to 1.0 (no insert headroom)."""
    edges = np.asarray(edges, dtype=np.int64)
    if partition == "range":
        capacity_factor = 1.0
    Np = int(np.ceil(num_vertices / P) * capacity_factor) + 1

    def owner_slot(v):
        if partition == "range":
            o = np.minimum(v // Np, P - 1)
            return o, v - o * Np
        return v % P, v // P

    vid = np.full((P, Np), -1, np.int32)
    all_v = np.arange(num_vertices, dtype=np.int64)
    po, ps = owner_slot(all_v)
    vid[po, ps] = all_v.astype(np.int32)

    src, dst = edges[:, 0], edges[:, 1]
    ev = (np.asarray(edge_values, np.float32) if edge_values is not None
          else np.ones(len(src), np.float32))
    owner, slot = owner_slot(src)
    order = np.argsort(owner * (num_vertices + 1) + src, kind="stable")
    dst, ev, owner, slot = dst[order], ev[order], owner[order], slot[order]
    counts = np.bincount(owner, minlength=P)
    Ep = int(max(counts.max(), 1))
    e_src = np.full((P, Ep), -1, np.int32)
    e_dst = np.full((P, Ep), -1, np.int32)
    e_val = np.zeros((P, Ep), np.float32)
    start = 0
    for p in range(P):
        c = counts[p]
        e_src[p, :c] = slot[start:start + c]
        e_dst[p, :c] = dst[start:start + c]
        e_val[p, :c] = ev[start:start + c]
        start += c
    return vertex_from_numpy(
        dict(vid=vid, halt=np.zeros((P, Np), bool),
             value=np.zeros((P, Np, value_dims), np.float32),
             edge_src=e_src, edge_dst=e_dst, edge_val=e_val), device)


def out_degrees(vert: VertexRel) -> torch.Tensor:
    """(P, Np) float32 out-degree per vertex slot."""
    P, Np = vert.vid.shape
    valid = vert.edge_src >= 0
    tgt = torch.where(valid, vert.edge_src, Np).long()     # Np = sink
    deg = torch.zeros((P, Np + 1), dtype=torch.float32,
                      device=vert.vid.device)
    deg.scatter_add_(1, tgt, valid.float())
    return deg[:, :Np]


def gather_values(vert: VertexRel, num_vertices: int) -> np.ndarray:
    """Dump the Vertex relation back out (HDFS write analogue):
    -> (num_vertices, V) float32 in vid order, on the host. The rows are
    placed on the relation's device and copied back once (on the card a
    host scatter of 10^8 rows took seconds)."""
    P, Np, V = vert.value.shape
    vid = vert.vid.reshape(-1)
    ok = vid >= 0
    out = torch.zeros((num_vertices, V), dtype=torch.float32,
                      device=vid.device)
    out[vid[ok].long()] = vert.value.reshape(-1, V)[ok].float()
    return out.cpu().numpy()


# ------------------------------------------------------------ state transfer

_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool,
           np.dtype(np.float32): torch.float32}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected state dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _from_numpy(cls, arrays: dict, device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__} is missing {sorted(missing)}")
    return cls(**{n: _tensor(arrays[n], device) for n in names})


def _to_numpy(rel) -> dict:
    return {f.name: getattr(rel, f.name).cpu().numpy()
            for f in dataclasses.fields(rel)}


def vertex_from_numpy(arrays: dict, device) -> VertexRel:
    return _from_numpy(VertexRel, arrays, device)


def msgs_from_numpy(arrays: dict, device) -> MsgRel:
    return _from_numpy(MsgRel, arrays, device)


def gs_from_numpy(arrays: dict, device) -> GlobalState:
    return _from_numpy(GlobalState, arrays, device)


def vertex_to_numpy(vert: VertexRel) -> dict:
    return _to_numpy(vert)


def msgs_to_numpy(msg: MsgRel) -> dict:
    return _to_numpy(msg)


def gs_to_numpy(gs: GlobalState) -> dict:
    return _to_numpy(gs)
