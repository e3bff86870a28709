"""The allocator's peak of device memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start: the
loaded graph, the jobs' state and the answers kept for the comparison)
over the graph's edges."""


def read(ctx):
    if ctx.window_peak_bytes is None or ctx.num_edges <= 0:
        return None
    return ctx.window_peak_bytes / ctx.num_edges
