"""Process start to the first timed job: imports, making the graph,
the bulk load, the kernels' build or load, one warm job. Host clock."""


def read(ctx):
    return ctx.setup_s
