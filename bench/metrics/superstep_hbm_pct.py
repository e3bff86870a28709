"""A PageRank superstep's share of the card's HBM bandwidth, whatever
implements it: the bytes the superstep needs (two int32 ids an edge;
rank and degree read and rank written, 12 B a vertex), summed over the
supersteps of the untraced jobs, over their summed ``wall_s`` (the
driver's own record, ending in a device sync), over 3.35 TB/s."""
from bench.roofline import H100_HBM_BYTES_PER_S

EDGE_BYTES = 8
VERTEX_BYTES = 12


def read(ctx):
    jobs = [j for j in ctx.jobs if not j.traced] or ctx.jobs
    walls = [s["wall_s"] for j in jobs for s in j.stats if "wall_s" in s]
    if not walls or sum(walls) <= 0:
        return None
    need = (EDGE_BYTES * ctx.num_edges + VERTEX_BYTES * ctx.n) * len(walls)
    return 100.0 * need / H100_HBM_BYTES_PER_S / sum(walls)
