"""A device profile inside each rank of the port's ``RankPool``, for a
traced run on several chips, where the ranks' kernels run in processes of
their own and a profiler in the harness's process sees none of them.

``start``, ``stop`` and ``read`` run in every rank through
``RankPool.map``: ``start`` before the traced jobs opens a
``torch.profiler`` and the traced window's span in the rank, ``stop``
after them closes both, and ``read`` after the run's window reduces the
rank's trace (``timeline.reduce_events``) and returns its reading.
``merge`` makes the run's reading of the ranks': busy and window
seconds, device seconds by kernel and the idle gaps, each averaged over
the ranks, so every number of a traced line is a rank's, as a traced
line's ``busy_s`` is averaged over the chips used;
``TraceReading.kernel_seconds`` gives a kernel's seconds summed over the
ranks, which the rooflines hold the whole graph's bytes to.

The port's program spans are not bridged to these profilers (the pool
drives a rank's tracer itself), so a traced run on several chips reads no
stage (``stages.of``)."""
from __future__ import annotations

import os
import tempfile

from bench import timeline

# the rank process's open profile: the profiler and the window's span;
# one rank process runs one traced window at a time
_OPEN: dict = {}


def start(device_type: str, *, axis=None):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    span = record_function(timeline.WINDOW_SPAN)
    span.__enter__()
    _OPEN.update(prof=prof, span=span)


def stop(*, axis=None):
    _OPEN.pop("span").__exit__(None, None, None)
    _OPEN["prof"].stop()


def read(*, axis=None) -> timeline.TraceReading:
    prof = _OPEN.pop("prof")
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return timeline.read_chrome_trace(path)
    finally:
        os.unlink(path)


def merge(readings: list) -> timeline.TraceReading:
    """One reading of the ranks' ``readings`` (a rank a chip), each field
    averaged over the ranks: busy and window seconds, device seconds by
    kernel, and the idle gaps, every rank's with its seconds divided by
    the ranks' count."""
    n = len(readings)
    kernel_s: dict = {}
    for r in readings:
        for k, s in r.kernel_s.items():
            kernel_s[k] = kernel_s.get(k, 0.0) + s / n
    return timeline.TraceReading(
        window_s=sum(r.window_s for r in readings) / n,
        busy_s=sum(r.busy_s for r in readings) / n,
        kernel_s=kernel_s,
        gaps=[(name, s / n) for r in readings for name, s in r.gaps],
        ranks=n)
