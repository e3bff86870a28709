"""Device ms a superstep launched under the port's ``superstep.route``
span: the bucketing by owner and the in-step exchange, over the completed
supersteps of the traced jobs (``bench/stages.py``)."""
from bench import stages

SPANS = ("superstep.route",)


def read(ctx):
    r = stages.of(ctx)
    return None if r is None else r.device_ms(SPANS[0], r.supersteps)
