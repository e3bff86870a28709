"""Device ms a superstep launched under the port's ``superstep.combine``
span: D7, the sender combine (the stable argsort, the ``segment_combine``
fold) and the compaction of its survivors, over the completed supersteps
of the traced jobs (``bench/stages.py``)."""
from bench import stages

SPANS = ("superstep.combine",)


def read(ctx):
    r = stages.of(ctx)
    return None if r is None else r.device_ms(SPANS[0], r.supersteps)
