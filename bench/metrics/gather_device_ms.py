"""Device ms a superstep launched under the port's ``superstep.gather``
span: D3, the message generation, where the ``csr_spmv`` gather runs, over
the completed supersteps of the traced jobs (``bench/stages.py``)."""
from bench import stages

SPANS = ("superstep.gather",)


def read(ctx):
    r = stages.of(ctx)
    return None if r is None else r.device_ms(SPANS[0], r.supersteps)
