"""The allocator's peak of device memory over the window over the graph's
stored edges. On one chip, ``torch.cuda.max_memory_allocated`` after a
reset at the window's start: the loaded graph, the jobs' state and the
answers kept for the comparison. On several chips every process counts:
the harness's own peak (the loaded graph it shares with the ranks, the
gathered answers) plus each rank's largest peak over the window's jobs
(its block and its jobs' state), on one scale with the one-chip cells
(``harness.RankPeaks``)."""


def read(ctx):
    if ctx.window_peak_bytes is None or ctx.num_edges <= 0:
        return None
    return ctx.window_peak_bytes / ctx.num_edges
