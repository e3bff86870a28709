"""Device ms a superstep launched under the sort group-by's two spans:
``superstep.groupby.sort`` (the stable argsort of the whole (P, M) inbox,
invalid rows included, and its gathers) and ``superstep.groupby.fold``
(the segmented fold and the dense scatters through the sink slot), over
the completed supersteps of the traced jobs (``bench/stages.py``). None
where neither span ran: a plan whose receiver group-by does not sort, or
a program without these spans."""
from bench import stages

SPANS = ("superstep.groupby.sort", "superstep.groupby.fold")


def read(ctx):
    r = stages.of(ctx)
    if r is None:
        return None
    ms = [r.device_ms(s, r.supersteps) for s in SPANS]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None
