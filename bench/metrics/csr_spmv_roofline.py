"""The edge-gather kernel (``kernels/csrc/csr_spmv.cu``, ``gather_quads``
or ``gather_scalar``) against its HBM roofline over the traced jobs: the
bytes the sends need (each sending edge's source id read once, each
distinct source's value row read once, one value an edge written once;
``roofline.gather_bytes``) over the kernel's device time by name."""
from bench import roofline

KERNELS = ("gather_quads", "gather_scalar")


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_seconds(*KERNELS)
    need = sum(roofline.gather_bytes(
        ctx.edges, ctx.algorithm.sending_edges(ctx.edges, ctx.n, j.args),
        ctx.value_dims) for j in ctx.traced_jobs)
    return roofline.share_pct(need, t)
