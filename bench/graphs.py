"""Graphs made on the device from a seed. A configuration file names its
generator under ``"generator"``, a file of its own, ``generators/<name>.py``,
whose ``make(cfg, gen, device)`` draws the edges with the
``torch.Generator`` ``gen``; the same seed on the same device gives the same
graph. A generator of an undirected graph hands its draw to
``unique_pairs`` and, the draw freed, the pairs to ``graph_of_pairs``:
together they give the graph the form LDBC Graphalytics lists its
datasets in.

A configuration with a ``"dataset_seed"`` is one dataset, as Graphalytics
ships one file a dataset: its graph is drawn from that seed, and the run's
seed only relabels it (``relabel_in_partitions``), so every seed gives
the same work under new ids. Without one, the run's seed draws the
graph.

The card holds no more than one copy of the whole edge list at a time
while a graph is made, so a graph of graph500-26's size (2**26 ids, about
2.1 B stored edges) is made on one card: ids are int32 where they fit,
and the cleaning, the unique and the sorts run over blocks of at most
``BLOCK`` rows, cut by ranges of the id that leads the sort key, so the
blocks' results in order are the whole sort's."""
from __future__ import annotations

from dataclasses import dataclass

import torch

BLOCK = 1 << 27      # rows of a block of the cleaning, unique and sorts


@dataclass
class Graph:
    edges: torch.Tensor      # (E, 2) (src, dst) on the device, in
    #                          id_dtype(n) as make_graph returns it
    n: int                   # vertices
    listed_edges: int        # edges as the source lists them: a pair once

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


def id_dtype(n: int) -> torch.dtype:
    """The narrowest integer type that holds the ids 0 .. n - 1."""
    return torch.int32 if n <= 2 ** 31 else torch.int64


def _blocks(total: int):
    for a in range(0, total, BLOCK):
        yield slice(a, min(a + BLOCK, total))


def _cuts(counts: torch.Tensor) -> list:
    """Boundaries 0 = c_0 < c_1 < ... = len(counts) of runs of ids whose
    counts sum to about ``BLOCK`` each: a run ends where the running sum
    passes a multiple of ``BLOCK``."""
    cum = torch.cumsum(counts, 0)
    total = int(cum[-1]) if cum.numel() else 0
    marks = torch.arange(BLOCK, max(total, BLOCK), BLOCK,
                         device=counts.device)
    inner = torch.searchsorted(cum, marks, right=True).tolist()
    return sorted({0, counts.numel(), *inner})


def _joined(parts: list) -> torch.Tensor:
    """The pieces of ``parts`` as one tensor; the list is emptied, so the
    pieces go as soon as the caller drops the result."""
    t = parts[0] if len(parts) == 1 else torch.cat(parts)
    parts.clear()
    return t


def _key(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """src * n + dst as int64, with one temporary: ``src`` is a tensor of
    the caller's own, overwritten where it is int64 already."""
    k = src.long()
    return k.mul_(n).add_(dst)


def _sorted_keys_into(out: torch.Tensor, at: int, src: list, dst: list,
                      n: int) -> int:
    """Sort one block's rows, the pieces ``src`` and ``dst`` (emptied),
    by src * n + dst into ``out[at:]``; -> the row after the last
    written."""
    keys = torch.sort(_key(_joined(src), _joined(dst), n)).values
    end = at + keys.numel()
    torch.floor_divide(keys, n, out=out[at:end, 0])
    torch.remainder(keys, n, out=out[at:end, 1])
    return end


def _trim(cuts: list, device: torch.device):
    """Between the blocks of a step cut into several, hand the card the
    cache the blocks' varying sizes left in pieces."""
    if len(cuts) > 2 and device.type == "cuda":
        torch.cuda.empty_cache()


def unique_pairs(src: torch.Tensor, dst: torch.Tensor,
                 n: int) -> torch.Tensor:
    """The distinct undirected pairs of a drawn edge list over ``n`` ids,
    self-loops dropped: sorted int64 keys lo * n + hi, lo < hi; made by
    blocks of lo."""
    lo_counts = torch.zeros(n, dtype=torch.int64, device=src.device)
    for b in _blocks(src.numel()):
        s, d = src[b], dst[b]
        lo_counts += torch.bincount(torch.minimum(s, d)[s != d],
                                    minlength=n)
    cuts = _cuts(lo_counts)
    del lo_counts
    out = []
    for a, z in zip(cuts, cuts[1:]):
        keys = []
        for b in _blocks(src.numel()):
            s, d = src[b], dst[b]
            lo, hi = torch.minimum(s, d), torch.maximum(s, d)
            keep = (s != d) & (lo >= a) & (lo < z)
            keys.append(_key(lo[keep], hi[keep], n))
            del lo, hi, keep
        out.append(torch.unique(_joined(keys)))
        _trim(cuts, src.device)
    return _joined(out)


def graph_of_pairs(pairs: torch.Tensor, n: int) -> Graph:
    """Graphalytics' form of the sorted unique pair keys ``pairs`` over
    ``n`` ids (``unique_pairs``): isolated vertices dropped and the rest
    renumbered 0 .. n' - 1 in id order; each pair stored in both
    directions, the list sorted by (src, dst) as a dataset's edge file
    orders it, made by blocks of src."""
    dev = pairs.device
    present = torch.zeros(n, dtype=torch.bool, device=dev)
    for b in _blocks(pairs.numel()):
        present[pairs[b] // n] = True
        present[pairs[b] % n] = True
    new_id = torch.cumsum(present, 0) - 1
    n2 = int(present.sum())
    del present
    idt = id_dtype(n2)
    new_id = new_id.to(idt)
    lo = torch.empty(pairs.numel(), dtype=idt, device=dev)
    hi = torch.empty_like(lo)
    for b in _blocks(pairs.numel()):
        lo[b] = new_id[pairs[b] // n]
        hi[b] = new_id[pairs[b] % n]
    listed = int(pairs.numel())
    del new_id
    deg = torch.zeros(n2, dtype=torch.int64, device=dev)
    for b in _blocks(listed):
        deg += torch.bincount(lo[b], minlength=n2)
        deg += torch.bincount(hi[b], minlength=n2)
    cuts = _cuts(deg)
    del deg
    edges = torch.empty((2 * listed, 2), dtype=idt, device=dev)
    at = 0
    for a, z in zip(cuts, cuts[1:]):
        m1 = (lo >= a) & (lo < z)
        m2 = (hi >= a) & (hi < z)
        at = _sorted_keys_into(edges, at, [lo[m1], hi[m2]],
                               [hi[m1], lo[m2]], n2)
        del m1, m2
        _trim(cuts, dev)
    return Graph(edges, n2, listed)


def relabel_in_partitions(g: Graph, parts: int,
                          gen: torch.Generator) -> Graph:
    """The same graph under new ids: the ids of each hash partition
    (vid % parts) shuffled among themselves, so each partition keeps its
    vertices' and edges' counts; the list sorted again by (src, dst), by
    blocks of the new src."""
    n = g.n
    dev = g.edges.device
    vid = torch.arange(n, device=dev)
    new_id = torch.empty_like(vid)
    for r in range(parts):
        cls = vid[r::parts]
        perm = torch.randperm(cls.numel(), generator=gen, device=dev)
        new_id[cls] = cls[perm]
    del vid
    idt = id_dtype(n)
    new_id = new_id.to(idt)
    e = g.edges
    deg = torch.zeros(n, dtype=torch.int64, device=dev)
    for b in _blocks(g.num_edges):
        deg += torch.bincount(e[b, 0], minlength=n)
    new_deg = torch.empty_like(deg)
    new_deg[new_id.long()] = deg
    cuts = _cuts(new_deg)
    del deg, new_deg
    edges = torch.empty((g.num_edges, 2), dtype=idt, device=dev)
    at = 0
    for a, z in zip(cuts, cuts[1:]):
        src, dst = [], []
        for b in _blocks(g.num_edges):
            s = new_id[e[b, 0]]
            keep = (s >= a) & (s < z)
            src.append(s[keep])
            dst.append(new_id[e[b, 1][keep]])
            del s, keep
        at = _sorted_keys_into(edges, at, src, dst, n)
        _trim(cuts, dev)
    return Graph(edges, n, g.listed_edges)


def make_graph(cfg: dict, seed: int, device) -> Graph:
    """The configuration's graph for ``seed`` on ``device``: drawn from
    ``seed``, or from the configuration's ``dataset_seed`` and relabelled
    from ``seed``; the edges in ``id_dtype(n)``, int32 where the ids fit
    (a reader that needs int64 widens them: ``to_int64``)."""
    from bench import manifest
    gen = torch.Generator(device=device)
    dataset_seed = cfg.get("dataset_seed")
    gen.manual_seed(int(seed if dataset_seed is None else dataset_seed))
    g = manifest.generator(cfg["generator"]).make(cfg, gen, device)
    if dataset_seed is not None:
        gen.manual_seed(int(seed))
        g = relabel_in_partitions(g, int(cfg["partitions"]), gen)
    g.edges = g.edges.to(id_dtype(g.n))
    return g


def to_int64(edges, device) -> torch.Tensor:
    """The (E, 2) edges (a tensor or a numpy array, on any device) as
    int64 on ``device``, a block of ``BLOCK`` rows at a time: each block
    moved in its own type and widened there, so no second whole copy
    stands beside the source."""
    edges = torch.as_tensor(edges)
    out = torch.empty(tuple(edges.shape), dtype=torch.int64, device=device)
    for b in _blocks(edges.shape[0]):
        out[b] = edges[b].to(device)
    return out
