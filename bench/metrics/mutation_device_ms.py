"""Device ms a superstep launched under the graph mutations' spans:
``superstep.mutate`` (D6: deletions and inserts) and
``superstep.resurrect`` (D1's re-creation of a deleted vertex that is
sent a message), over the completed supersteps of the traced jobs
(``bench/stages.py``). None where neither span ran. Prints beside it the
traced jobs' ``mutate.deleted`` and ``mutate.resurrected`` counts a
superstep, from ``RunResult.stats``, where the program publishes them."""
import json
import sys

from bench import stages

SPANS = ("superstep.mutate", "superstep.resurrect")
COUNTERS = ("mutate.deleted", "mutate.resurrected")


def counts(job) -> list:
    """[(deleted, resurrected)] a completed superstep of ``job``, or []
    where its records carry no such counter."""
    recs = [s.get("metrics", {}) for s in job.stats if "wall_s" in s]
    return [[int(m[c]) for c in COUNTERS] for m in recs
            if all(c in m for c in COUNTERS)]


def read(ctx):
    r = stages.of(ctx)
    if r is None:
        return None
    for j in ctx.traced_jobs[:1]:
        if counts(j):
            print("[bench] (mutate.deleted, mutate.resurrected) a superstep "
                  f"of the first traced job: {json.dumps(counts(j))}",
                  file=sys.stderr, flush=True)
    ms = [r.device_ms(s, r.supersteps) for s in SPANS]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None
