"""One file a per-job draw, found by the name a traffic mix's ``"bind"``
gives an argument: ``make(traffic, edges, n, rng)`` is called once a run,
with the benchmark's own (E, 2) edges on the device, the vertex count and
the run's ``numpy`` generator, and returns ``value(i)``, the argument of
job ``i``."""
