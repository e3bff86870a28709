"""Device ms a superstep launched under the port's ``superstep.groupby``
span: D1, the receiver group-by (and the resurrect of a program that
mutates), over the completed supersteps of the traced jobs. Each kernel,
copy and memset counts under the innermost program span over its launch
(``bench/stages.py``)."""
from bench import stages

SPANS = ("superstep.groupby",)


def read(ctx):
    r = stages.of(ctx)
    return None if r is None else r.device_ms(SPANS[0], r.supersteps)
