"""Chrome trace-event JSON export + validation — the port's copy of
``repro.obs.export``, over the port's ``obs.trace``.

Converts a ``Tracer``'s per-thread span buffers into the trace-event
format that chrome://tracing and https://ui.perfetto.dev load directly:
one track (``tid``) per OS thread, named via ``thread_name`` metadata
events, so the dispatcher/collector main loop and the ``pregelix-io-*``
worker threads render as parallel timelines and the readiness-stall gap
between "inbox ready" and "first dispatch" is visible as a span on the
main track.

Event mapping (timestamps in microseconds after the file's
``baseTimeNanoseconds``, an epoch time in ns that ``torch.profiler``'s
export also writes: the start of the ~91-day interval, 7,889,238 s long,
that holds the recording. A ``torch.profiler`` trace of the same run
carries the same base, so its events and these lie on one axis):

* span   → ``{"ph": "X", "name", "cat", "pid", "tid", "ts", "dur", "args"}``;
  ``args`` holds the span's own ``span`` id, its ``parent`` (absent at a
  thread's root) and its ``job`` (absent outside every job) beside the
  caller's arguments
* instant→ ``{"ph": "i", "s": "t", ...}``
* counter→ ``{"ph": "C", "args": {"value": v}}`` (a Perfetto area track)

``validate_chrome_trace`` is the schema check CI runs against the trace
artifact the disk-tier smoke benchmark writes:

    python -m repro_torch.obs.export BENCH_trace.json --min-threads 3
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs import trace as _trace

_PID = 1  # single-process engine: one trace process
# libkineto's ChromeTraceBaseTime: epoch seconds floored to this interval
BASE_INTERVAL_S = 7_889_238


def base_time_ns(t_ns: int) -> int:
    """The ``baseTimeNanoseconds`` of a trace whose earliest event is at
    ``t_ns`` (epoch ns): ``torch.profiler``'s floor."""
    step = BASE_INTERVAL_S * 1_000_000_000
    return (int(t_ns) // step) * step


def chrome_trace(tracer: Optional[_trace.Tracer] = None) -> dict:
    """Render a tracer's buffers as a trace-event JSON object."""
    tracer = tracer if tracer is not None else _trace.get()
    if tracer is None:
        raise ValueError("no tracer: pass one or call trace.start() first")
    bufs = tracer.drain()
    t0 = tracer.t_origin
    for _, _, events in bufs:
        for ev in events:
            if ev[0] in ("X", "i"):
                t0 = min(t0, ev[3])
            else:
                t0 = min(t0, ev[2])
    base = base_time_ns(t0)
    us = lambda t: (t - base) / 1000.0
    out = []
    for tid, name, events in bufs:
        out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                    "tid": tid, "args": {"name": name}})
        for ev in events:
            if ev[0] == "X":
                _, nm, cat, ts, dur, args, sid, parent, job = ev
                a = {**(args or {}), "span": sid}
                if parent:
                    a["parent"] = parent
                if job:
                    a["job"] = job
                out.append({"ph": "X", "name": nm, "cat": cat, "pid": _PID,
                            "tid": tid, "ts": us(ts), "dur": dur / 1000.0,
                            "args": a})
            elif ev[0] == "i":
                _, nm, cat, ts, args = ev
                e = {"ph": "i", "s": "t", "name": nm, "cat": cat,
                     "pid": _PID, "tid": tid, "ts": us(ts)}
                if args:
                    e["args"] = args
                out.append(e)
            else:
                _, nm, ts, value = ev
                out.append({"ph": "C", "name": nm, "pid": _PID,
                            "tid": tid, "ts": us(ts),
                            "args": {"value": value}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "baseTimeNanoseconds": base}


def write_chrome_trace(path: str,
                       tracer: Optional[_trace.Tracer] = None) -> dict:
    """Write the trace JSON to ``path``; returns the validation summary."""
    obj = chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(obj, f)
    return validate_chrome_trace(obj)


def trace_violations(obj, *, min_threads: int = 1):
    """Collect EVERY schema violation in a trace-event JSON object.
    Returns ``(violations, summary)`` — an empty list means valid. The
    first entry is always the violation ``validate_chrome_trace`` would
    raise (same scan order, same message)."""
    errs: list = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return (["trace: top level must be a dict with traceEvents"],
                None)
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["trace: traceEvents must be a list"], None
    span_threads: set = set()
    thread_names: dict = {}
    cats: set = set()
    n_spans = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errs.append(f"trace: event {i} is not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M"):
            errs.append(f"trace: event {i} has unknown phase {ph!r}")
        if "name" not in e or "pid" not in e or "tid" not in e:
            errs.append(f"trace: event {i} missing name/pid/tid")
        if ph == "M":
            if e.get("name") == "thread_name":
                thread_names[e.get("tid")] = \
                    e.get("args", {}).get("name", "")
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"trace: event {i} has bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"trace: event {i} has bad dur {dur!r}")
            if e.get("cat") not in _trace.CATEGORIES:
                errs.append(f"trace: event {i} has unknown category "
                            f"{e.get('cat')!r}")
            n_spans += 1
            span_threads.add(e.get("tid"))
            cats.add(e.get("cat"))
    if len(span_threads) < min_threads:
        errs.append(f"trace: spans on {len(span_threads)} thread(s), "
                    f"need >= {min_threads}")
    summary = {
        "events": len(events),
        "spans": n_spans,
        "span_threads": len(span_threads),
        "thread_names": sorted(thread_names.get(t, str(t))
                               for t in span_threads),
        "categories": sorted(c for c in cats if c is not None),
    }
    return errs, summary


def validate_chrome_trace(obj, *, min_threads: int = 1) -> dict:
    """Schema-check a trace-event JSON object. Raises ``ValueError`` on
    the first violation; returns a summary dict (event count, threads
    with spans, categories seen) on success. ``trace_violations`` is the
    collect-everything variant the CLI uses."""
    errs, summary = trace_violations(obj, min_threads=min_threads)
    if errs:
        raise ValueError(errs[0])
    return summary


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Validate a Chrome trace-event JSON file.")
    p.add_argument("path")
    p.add_argument("--min-threads", type=int, default=1,
                   help="require spans from at least this many threads")
    args = p.parse_args(argv)
    with open(args.path) as f:
        obj = json.load(f)
    violations, summary = trace_violations(obj,
                                           min_threads=args.min_threads)
    if violations:
        # CI logs get the FULL list in one run, not just the first
        print(f"INVALID {args.path}: {len(violations)} violation(s)")
        for v in violations:
            print(f"  - {v}")
        return 1
    print(f"OK {args.path}: {summary['spans']} spans on "
          f"{summary['span_threads']} threads "
          f"{summary['thread_names']}, categories {summary['categories']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
