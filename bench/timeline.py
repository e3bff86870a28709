"""The reduction of a ``torch.profiler`` trace (its Chrome trace-event
JSON) to what the per-layer metrics read: the device's busy time inside
the traced window, device time by kernel name, and the device's idle
gaps named by what the host was doing in them. Times in the trace are
microseconds on one clock for host and device."""
from __future__ import annotations

import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench.traced_window"
TOP = 10
NAME_CHARS = 120     # a kernel's name in the breakdown, cut to this


@dataclass
class TraceReading:
    """One trace's reading, or the mean of ``ranks`` ranks' readings
    (``ranktrace.merge``): every field a rank's mean."""
    window_s: float                      # length of the traced window
    busy_s: float                        # device busy inside it
    kernel_s: dict = field(default_factory=dict)   # name -> device s
    gaps: list = field(default_factory=list)       # [(host name, s)]
    ranks: int = 1

    def kernel_seconds(self, *patterns) -> float:
        """Device seconds of the kernels whose name holds a pattern,
        summed over the ranks: the seconds of the whole graph's work."""
        return self.ranks * sum(s for k, s in self.kernel_s.items()
                                if any(p in k for p in patterns))

    def top_ops(self, k: int = TOP) -> list:
        return [[name[:NAME_CHARS], s] for name, s in sorted(
            self.kernel_s.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = TOP) -> list:
        by = {}
        for name, s in self.gaps:
            by[name] = by.get(name, 0.0) + s
        return [[name[:NAME_CHARS], s] for name, s in sorted(
            by.items(), key=lambda kv: -kv[1])[:k]]


def merge(intervals) -> list:
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def clip(intervals, t0: float, t1: float) -> list:
    return [[max(a, t0), min(b, t1)] for a, b in intervals
            if b > t0 and a < t1]


def idle_gaps(busy, t0: float, t1: float) -> list:
    """The (start, end) stretches of [t0, t1] that ``busy`` (merged,
    clipped) leaves uncovered."""
    gaps, t = [], t0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < t1:
        gaps.append((t, t1))
    return gaps


def name_gaps(host_events, gaps) -> list:
    """(name, seconds) for each (start, end) gap in time order: the
    innermost host event (the shortest) that covers the gap's middle, or
    ``"host (no op)"``. ``host_events`` sorted by start; one sweep."""
    out, i, live = [], 0, []
    for a, b in gaps:
        t = (a + b) / 2
        while i < len(host_events) and host_events[i]["ts"] <= t:
            live.append(host_events[i])
            i += 1
        live = [e for e in live if e["ts"] + e["dur"] >= t]
        best = min(live, key=lambda e: e["dur"]) if live else None
        out.append((best["name"] if best is not None else "host (no op)",
                    (b - a) * 1e-6))
    return out


def reduce_events(events: list) -> TraceReading:
    """Reduce a list of trace events (``"ph": "X"`` complete events with
    ``cat``, ``name``, ``ts``, ``dur``) to a ``TraceReading`` over the
    ``bench.traced_window`` span."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        raise ValueError(f"no {WINDOW_SPAN} span in the trace")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    dev, kernel_us = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, d = float(e["ts"]), float(e.get("dur", 0.0))
        if a + d <= t0 or a >= t1:
            continue
        dev.append((a, a + d))
        kernel_us[e["name"]] = kernel_us.get(e["name"], 0.0) + \
            min(a + d, t1) - max(a, t0)
    busy = clip(merge(dev), t0, t1)
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW_SPAN
                   and float(e["ts"]) < t1
                   and float(e["ts"]) + float(e.get("dur", 0.0)) > t0),
                  key=lambda e: float(e["ts"]))
    host = [dict(name=e["name"], ts=float(e["ts"]),
                 dur=float(e.get("dur", 0.0))) for e in host]
    gaps = name_gaps(host, idle_gaps(busy, t0, t1))
    return TraceReading(window_s=(t1 - t0) * 1e-6,
                        busy_s=sum(b - a for a, b in busy) * 1e-6,
                        kernel_s={k: v * 1e-6 for k, v in kernel_us.items()},
                        gaps=gaps)


def read_chrome_trace(path) -> TraceReading:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return reduce_events(events)
