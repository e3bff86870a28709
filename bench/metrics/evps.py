"""Graphalytics' EVPS: vertices plus edges of the graph as the source
lists them (an undirected pair once), times the jobs that ended in the
window, over the window from its start to the end of the last job (all
the work over all the time, gaps between jobs included). Host clock."""


def read(ctx):
    if not ctx.jobs or ctx.window_s <= 0:
        return None
    return (ctx.n + ctx.listed_edges) * len(ctx.jobs) / ctx.window_s
