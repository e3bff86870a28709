"""Device ms a job launched under the port's ``job.prepare`` span: what
``run_host`` does before its loop (the plan, ``prepare_run`` with
``init_vertex_values``' out-degree scatter, the superstep's build, the
live-vertex count), which the harness's first superstep latency of a job
holds, over the traced jobs (``bench/stages.py``)."""
from bench import stages

SPANS = (stages.PREPARE,)


def read(ctx):
    r = stages.of(ctx)
    return None if r is None else r.device_ms(SPANS[0], r.jobs)
