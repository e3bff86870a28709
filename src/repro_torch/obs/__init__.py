"""Runtime observability of the port (the reference's ``repro.obs``):
span tracing, metrics, Chrome-trace export, plan audit and
tier-occupancy ledgers, and schema-validated run reports.

* ``repro_torch.obs.trace`` — thread-safe span recorder (per-thread
  buffers, nestable spans categorized by pipeline leg, instant/counter
  events; near-zero-cost when disabled; ``torch.profiler`` bridge).
* ``repro_torch.obs.metrics`` — named counters/gauges/histograms whose
  per-superstep interval snapshot merges into ``SuperstepStats.extra``.
* ``repro_torch.obs.export`` — Chrome trace-event JSON (Perfetto-
  loadable), one track per thread, plus its schema validator.
* ``repro_torch.obs.progress`` — the human per-superstep progress line.
* ``repro_torch.obs.explain`` — per-superstep predicted-vs-measured
  ledger (the plan audit) plus the controller decision log.
* ``repro_torch.obs.memwatch`` — HBM/DRAM/SSD occupancy samples with
  peak watermarks and the OOM-proximity gauge.
* ``repro_torch.obs.report`` — assembles the above into a
  schema-validated ``pregelix-run-report/v1`` document, with
  ``compare()``.

None of these modules imports torch at import time: the storage tier's
I/O threads record into ``trace`` and ``metrics``.
"""
from repro_torch.obs import explain, memwatch, report, trace
from repro_torch.obs.export import (chrome_trace, validate_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, \
    MetricsRegistry
from repro_torch.obs.progress import fmt_plan, progress_line
from repro_torch.obs.report import build_report, compare, \
    validate_report, write_report

__all__ = [
    "trace", "explain", "memwatch", "report",
    "chrome_trace", "validate_chrome_trace", "write_chrome_trace",
    "build_report", "compare", "validate_report", "write_report",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "fmt_plan", "progress_line",
]
