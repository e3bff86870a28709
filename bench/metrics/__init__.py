"""One reader a metric, ``<metric name>.py``, found by the name in
``BENCHMARK.json``. ``read(ctx)`` takes the run's ``harness.RunContext``
and returns the value, or None where the run holds nothing to read (the
harness then leaves the metric out of the line)."""
