"""Runtime observability of the port: span tracing and metrics (the
port's copies of ``repro.obs.trace`` and ``repro.obs.metrics``, which the
storage tier and the out-of-core driver record into). The plan audit,
the memory ledger, the run reports, the exporter and the progress line
come with a later slice."""
from repro_torch.obs import trace
from repro_torch.obs.metrics import Counter, Gauge, Histogram, \
    MetricsRegistry

__all__ = ["trace", "Counter", "Gauge", "Histogram", "MetricsRegistry"]
