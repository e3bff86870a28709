"""Device idle ms a superstep while the host is in the driver's own code:
gaps of the device's timeline whose innermost program span is ``job``,
``job.prepare``, ``superstep.readback`` or ``boundary`` (the readbacks,
the stats record, the refit, replan and callback), over the completed
supersteps of the traced jobs (``bench/stages.py``)."""
from bench import stages

SPANS = stages.DRIVER


def read(ctx):
    r = stages.of(ctx)
    return None if r is None else r.idle_ms(SPANS, r.supersteps)
