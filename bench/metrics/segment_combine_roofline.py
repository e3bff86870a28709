"""The fold kernel (``kernels/csrc/segment_combine.cu``, ``fold_tiles``)
against its HBM roofline over the traced jobs: the bytes the sender
combine needs (each sent message's key and payload read once, each
folded row written once; ``roofline.fold_bytes``) over the kernel's
device time by name in the profiler's trace."""
from bench import roofline

KERNELS = ("fold_tiles",)


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_seconds(*KERNELS)
    need = sum(roofline.fold_bytes(
        ctx.edges, ctx.n, ctx.parts,
        ctx.algorithm.sending_edges(ctx.edges, ctx.n, j.args), ctx.msg_dims)
        for j in ctx.traced_jobs)
    return roofline.share_pct(need, t)
