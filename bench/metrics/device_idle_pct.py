"""The share of the traced window (the traced jobs, back to back) in
which no kernel, copy or memset runs on the device, from the profiler's
timeline."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
