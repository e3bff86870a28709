"""Named counters, gauges, and histograms for the runtime — the port's
copy of ``repro.obs.metrics``.

The second consumer of the paper's Section 5.7 statistics stream is
numeric rather than visual: the adaptive planner and the benchmark
harness want per-superstep scalars, not timelines. A ``MetricsRegistry``
holds the run's instruments; ``StatsCollector`` calls
``registry.interval()`` once per superstep and merges the snapshot into
``SuperstepStats.extra["metrics"]``, so every downstream consumer (plan
controller, progress line, BENCH JSON) sees the same numbers.

Instruments:

* ``Counter`` — monotonic count; ``interval()`` reports the delta since
  the previous superstep, ``snapshot()`` the cumulative total.
* ``Gauge`` — last-set value (both views report the current level).
* ``Histogram`` — bounded reservoir of observations; the interval view
  reports ``count``/``mean``/``p50``/``p90``/``max`` over the superstep's
  observations and resets. This is what promotes ``io_queue_depth`` from
  a single mean to real percentiles.

All instruments are thread-safe: the I/O-engine workers observe queue
depths and read latencies concurrently with the main loop reading the
interval snapshot.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional


def percentile(sorted_vals: List[float], f: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = int(round(f * (len(sorted_vals) - 1)))
    return float(sorted_vals[i])


class Counter:
    __slots__ = ("_mu", "_total", "_mark")

    def __init__(self):
        self._mu = threading.Lock()
        self._total = 0.0
        self._mark = 0.0          # total at the last interval() call

    def inc(self, n: float = 1.0):
        with self._mu:
            self._total += n

    @property
    def value(self) -> float:
        return self._total

    def snapshot(self) -> float:
        return self._total

    def interval(self) -> float:
        with self._mu:
            delta, self._mark = self._total - self._mark, self._total
        return delta


class Gauge:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v: float):
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> float:
        return self._value

    def interval(self) -> float:
        return self._value


class Histogram:
    """Reservoir of observations since the last interval. The reservoir
    is bounded (default 4096) so a pathological superstep cannot grow
    memory without bound; overflow keeps the first ``cap`` observations
    and still counts the rest."""

    __slots__ = ("_mu", "_vals", "_count", "_sum", "_max", "cap")

    def __init__(self, cap: int = 4096):
        self._mu = threading.Lock()
        self._vals: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self.cap = int(cap)

    def observe(self, v: float):
        v = float(v)
        with self._mu:
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            if len(self._vals) < self.cap:
                self._vals.append(v)

    def snapshot(self) -> dict:
        with self._mu:
            vals = sorted(self._vals)
            return {
                "count": self._count,
                "mean": (self._sum / self._count) if self._count else 0.0,
                "p50": percentile(vals, 0.50),
                "p90": percentile(vals, 0.90),
                "max": self._max,
            }

    def interval(self) -> dict:
        out = self.snapshot()
        with self._mu:
            self._vals.clear()
            self._count = 0
            self._sum = 0.0
            self._max = 0.0
        return out


class MetricsRegistry:
    """Get-or-create registry of named instruments for one run."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._mu:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._mu:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(cap)
            return h

    def _merge(self, view: str) -> dict:
        with self._mu:
            items = (list(self._counters.items())
                     + list(self._gauges.items())
                     + list(self._hists.items()))
        return {name: getattr(inst, view)() for name, inst in items}

    def snapshot(self) -> dict:
        """Non-destructive view: counter totals, gauge levels, histogram
        percentiles over the current (un-reset) interval."""
        return self._merge("snapshot")

    def interval(self) -> dict:
        """Per-superstep view: counter deltas, gauge levels, histogram
        percentiles since the previous call; resets interval state.
        Empty dict when no instrument was ever registered."""
        return self._merge("interval")
