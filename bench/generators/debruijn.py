"""The de Bruijn graph of a genome's ``k``-mers, as a genome assembler
builds it from error-free reads at full coverage: a vertex a distinct
``k``-mer of either strand, an edge from each ``k``-mer to the next one
on its strand, duplicate edges dropped. Directed; each strand's ``k``-mers
are vertices of their own (no canonical ``k``-mers), since a path merge
follows out-edges.

The genome is drawn from the generator under a repeat model: a uniform
background with copies of a repeat library pasted in between its bases.
Each class of repeat (``repeat_consensus``: its name and consensus
length) has one consensus; each family (``repeat_families``) takes its
``share`` of the genome's bases in copies of that consensus, full length
(``"copy_length": "full"``) or 3' fragments of exponential length with
the given mean, cut to the consensus, each base of a copy replaced by
another at the family's ``divergence``. Vertex ids follow the order of
the ``k``-mers' 2-bit codes (A, C, G, T = 0..3); the edge list is sorted
by (src, dst)."""
import torch

from bench.graphs import Graph


def kmer_codes(seq: torch.Tensor, k: int) -> torch.Tensor:
    """(L - k + 1,) int64 codes of the ``k``-mers of a (L,) sequence of
    bases 0..3, the first base in the highest bits (k <= 31)."""
    s = seq.long()
    m = s.numel() - k + 1
    code = torch.zeros(m, dtype=torch.int64, device=seq.device)
    for j in range(k):
        code = (code << 2) | s[j:j + m]
    return code


def reverse_complement(seq: torch.Tensor) -> torch.Tensor:
    return (3 - seq).flip(0)


def draw_sequence(cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """The genome of ``cfg["bases"]`` bases, (B,) uint8 on ``device``."""
    B = int(cfg["bases"])
    u8 = dict(dtype=torch.uint8, device=device, generator=gen)
    classes = dict(cfg.get("repeat_consensus", {}))
    library = {name: torch.randint(0, 4, (int(length),), **u8)
               for name, length in classes.items()}
    lens, fams = [], []
    for f, fam in enumerate(cfg.get("repeat_families", [])):
        L = int(classes[fam["consensus"]])
        full = fam["copy_length"] == "full"
        mean = L if full else float(fam["copy_length"])
        copies = round(float(fam["share"]) * B / mean)
        if full:
            ln = torch.full((copies,), L, dtype=torch.int64, device=device)
        else:
            ln = torch.empty(copies, dtype=torch.float64, device=device)
            ln = ln.exponential_(1.0 / mean, generator=gen).ceil().long() \
                .clamp_(1, L)
        lens.append(ln)
        fams.append(torch.full((copies,), f, dtype=torch.int64,
                               device=device))
    if not lens or sum(int(x.numel()) for x in lens) == 0:
        return torch.randint(0, 4, (B,), **u8)
    lens, fams = torch.cat(lens), torch.cat(fams)
    order = torch.randperm(lens.numel(), generator=gen, device=device)
    lens, fams = lens[order], fams[order]
    R = int(lens.sum())
    G = B - R                                   # background bases
    if G < 0:
        raise ValueError(f"repeats take {R} of {B} bases")
    seq = torch.empty(B, dtype=torch.uint8, device=device)
    # copy j goes before background base ins[j]
    ins = torch.sort(torch.randint(0, G + 1, (lens.numel(),),
                                   generator=gen, device=device)).values
    end = torch.cumsum(lens, 0)
    before = torch.cat([end.new_zeros(1), end])
    pos = torch.arange(G, device=device)
    seq[pos + before[torch.searchsorted(ins, pos, right=True)]] = \
        torch.randint(0, 4, (G,), **u8)
    del pos
    # each copy: the 3' end of its consensus, then diverged
    names = list(classes)
    lib = torch.cat([library[c] for c in names])
    lib_end = torch.cumsum(torch.tensor([classes[c] for c in names],
                                        device=device), 0)
    fam_end = torch.stack([lib_end[names.index(fam["consensus"])]
                           for fam in cfg["repeat_families"]])
    div = torch.tensor([float(fam["divergence"])
                        for fam in cfg["repeat_families"]],
                       dtype=torch.float64, device=device)
    cid = torch.repeat_interleave(torch.arange(lens.numel(), device=device),
                                  lens)
    off = torch.arange(R, device=device) - (end - lens)[cid]
    base = lib[fam_end[fams][cid] - lens[cid] + off]
    mut = torch.rand(R, dtype=torch.float64, generator=gen,
                     device=device) < div[fams][cid]
    shift = torch.randint(1, 4, (R,), **u8)
    base = torch.where(mut, (base + shift) % 4, base)
    seq[ins[cid] + before[cid] + off] = base
    return seq


def make(cfg: dict, gen: torch.Generator, device) -> Graph:
    k = int(cfg["k"])
    seq = draw_sequence(cfg, gen, device)
    fwd = kmer_codes(seq, k)
    rev = kmer_codes(reverse_complement(seq), k)
    del seq
    m = fwd.numel()
    codes, ids = torch.unique(torch.cat([fwd, rev]), return_inverse=True)
    del fwd, rev
    n = int(codes.numel())
    del codes
    # the next k-mer on the same strand
    src = torch.cat([ids[:m - 1], ids[m:2 * m - 1]])
    dst = torch.cat([ids[1:m], ids[m + 1:]])
    del ids
    keys = torch.unique(src * n + dst)
    del src, dst
    edges = torch.stack([keys // n, keys % n], dim=1)
    return Graph(edges, n, int(keys.numel()))
