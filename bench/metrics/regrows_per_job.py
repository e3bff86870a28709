"""The driver's capacity regrows (``regrow`` events in
``RunResult.stats``, what its ``host.regrows`` counter counts), each a
superstep attempt thrown away and redone, over the window's jobs."""


def read(ctx):
    if not ctx.jobs:
        return None
    n = sum(1 for j in ctx.jobs for s in j.stats
            if s.get("event") == "regrow")
    return n / len(ctx.jobs)
