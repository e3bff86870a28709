"""A source vertex with an out-edge. The vertices with out-edges, ordered
by out-degree and then by vid, are cut at the mix's ``source_quantiles``
evenly spaced quantiles q; job i takes
quantile ``perm[i % q]``, ``perm`` a permutation drawn from the seed, so
every seed sends the same spread of sources, in another order."""
import torch


def make(traffic, edges, n, rng):
    q = int(traffic["source_quantiles"])
    deg = torch.bincount(edges[:, 0], minlength=n)
    cand = torch.nonzero(deg).squeeze(1)
    order = torch.sort(deg[cand], stable=True).indices   # ties: vid order
    at = ((torch.arange(q, dtype=torch.float64) + 0.5) * len(cand)
          / q).long()
    sources = cand[order][at.to(cand.device)].tolist()
    perm = rng.permutation(q)
    return lambda i: sources[perm[i % q]]
