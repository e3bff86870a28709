"""``repro_torch.core.load_graph`` alone: host clock around the call,
ending in a device sync."""


def read(ctx):
    return ctx.load_s
