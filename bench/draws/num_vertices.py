"""The graph's vertex count, the same for every job."""


def make(traffic, edges, n, rng):
    return lambda i: n
