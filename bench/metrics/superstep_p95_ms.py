"""The 95th percentile (nearest rank) of every superstep latency of the
window's jobs, in ms: from one completed superstep to the next, on the
device's clock (CUDA events), the first from the job's start."""
import math


def p95(values):
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def read(ctx):
    lat = ctx.latencies
    return 1e3 * p95(lat) if lat else None
