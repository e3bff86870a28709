"""Thread-safe span tracing for the barrier-free pipeline — the port's
copy of ``repro.obs.trace``.

The paper's statistics collector (Section 5.7) aggregates per-superstep
scalars; the out-of-core executor is a concurrent system — a rolling
dispatcher/collector loop plus background I/O-engine worker threads —
whose behavior a flat dict cannot explain. This module records *spans*
(nested, timestamped intervals categorized by pipeline leg) plus instant
and counter events, into PER-THREAD buffers so recording never contends
on a lock in the steady state; ``obs.export`` turns the buffers into
Chrome trace-event JSON with one track per thread, which is what makes
the dispatcher / collector / io-engine overlap — and the readiness-stall
gap — visible on a timeline.

Design constraints:

* **Disabled tracing is a near-zero-cost no-op.** Instrumentation stays
  in the hot path permanently, so ``span()`` with no active tracer
  returns one cached singleton context manager and allocates nothing.
  Callers on hot paths should pass no kwargs when possible — kwargs
  build a dict before the check.
* **Recording is thread-safe and lock-free per event.** Each thread owns
  a buffer (registered once under a lock on first use); appends are
  plain ``list.append``. Export snapshots the buffers concurrently with
  recording (``Tracer.drain``).
* **Device bridging is optional.** ``start(torch_annotations=True)``
  makes ``annotate`` (and ``job``) also enter a
  ``torch.profiler.record_function``, so spans line up with device
  activity when the run is profiled with ``torch.profiler``. A span adds
  no device sync and no tensor: host spans time the enqueue, device time
  comes from the profiler.
* **One clock with the profiler.** Timestamps are integer nanoseconds of
  ``time.time_ns()``, the epoch clock ``torch.profiler`` stamps its host
  events with; ``obs.export`` writes them against the same
  ``baseTimeNanoseconds`` convention, so both traces of a run overlay.
* **Spans form trees.** Each span records its own id, its parent (the
  enclosing live span on its thread, 0 at a thread's root) and the job
  it belongs to: ``job()`` opens a job's root span and makes its id the
  process's current job until it closes, so spans on I/O-engine worker
  threads carry the job too.

Span categories (one per pipeline leg; ``CATEGORIES``): ``dispatch``,
``prepare``, ``compute``, ``collect``, ``commit``, ``fault``,
``readahead``, ``writeback``, ``checkpoint``, ``replan``, ``exchange``,
``retry`` / ``degrade`` (the I/O engine's fault-retry ladder)
(the sharded driver's all_to_all stage — what the planner's network
axis is calibrated against).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

# pipeline legs; the exporter colors/filters by these
CATEGORIES = ("dispatch", "prepare", "compute", "collect", "commit",
              "fault", "readahead", "writeback", "checkpoint", "replan",
              "exchange", "retry", "degrade")

# event tuples stored in the per-thread buffers (times in integer
# nanoseconds of time.time_ns()):
#   ("X", name, cat, t0, dur, args, span_id, parent_id, job)
#                                     complete span (parent 0: a root;
#                                     job 0: outside every job)
#   ("i", name, cat, t, args)         instant event
#   ("C", name, t, value)             counter sample


class _NullSpan:
    """The cached no-op context manager the disabled path returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **args):
        pass


_NULL = _NullSpan()


class _Span:
    """A live span: pushes its id on its thread's stack on enter, and on
    exit pops it and appends one ("X", ...) event to its thread's buffer.
    Created only when a tracer is active; entered and left by ``with``,
    so the spans of a thread nest."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_id",
                 "_parent", "_job")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        t = self._tracer
        stack = t._stack()
        self._parent = stack[-1] if stack else 0
        self._id = next(t._ids)
        self._job = t.job
        stack.append(self._id)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        t = self._tracer
        t._stack().pop()                 # spans nest: ``with`` only
        t._buf().append(
            ("X", self._name, self._cat, self._t0, t1 - self._t0,
             self._args, self._id, self._parent, self._job))
        return False

    def tag(self, **args):
        """Add arguments to the span before it closes (a superstep found
        to be a redo only at its readback)."""
        self._args = {**(self._args or {}), **args}


class _Annotated:
    """A span combined with a ``torch.profiler.record_function`` (device
    bridging). The profiler's range opens first and closes last, so the
    span lies inside it on the shared clock."""

    __slots__ = ("_span", "_ann")

    def __init__(self, span, ann):
        self._span = span
        self._ann = ann

    def __enter__(self):
        self._ann.__enter__()
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._span.__exit__(*exc)
        finally:
            self._ann.__exit__(*exc)

    def tag(self, **args):
        self._span.tag(**args)


class _Job:
    """A job's root span: takes the tracer's next job id and makes it the
    process's current job while the span is open."""

    __slots__ = ("_tracer", "_span", "_prev")

    def __init__(self, tracer, span):
        self._tracer = tracer
        self._span = span

    def __enter__(self):
        t = self._tracer
        self._prev = t.job
        t.job = next(t._job_ids)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            return self._span.__exit__(*exc)
        finally:
            self._tracer.job = self._prev


class Tracer:
    """Per-thread span buffers and span stacks, the span and job ids,
    and the clock origin (ns) for one recording."""

    def __init__(self, *, torch_annotations: bool = False):
        self._mu = threading.Lock()
        self._bufs: list = []            # [(tid, thread_name, events)]
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._job_ids = itertools.count(1)
        self.job = 0                     # the current job's id, 0: none
        self.t_origin = time.time_ns()
        self.annotation = None
        if torch_annotations:
            from torch.profiler import record_function
            self.annotation = record_function
            _warm_record_function()

    def _buf(self) -> list:
        b = getattr(self._local, "buf", None)
        if b is None:
            th = threading.current_thread()
            b = []
            with self._mu:
                self._bufs.append((th.ident or 0, th.name, b))
            self._local.buf = b
        return b

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # ---- recording ---------------------------------------------------
    def span(self, name: str, cat: str, args: Optional[dict] = None):
        return _Span(self, name, cat, args)

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 args: Optional[dict] = None):
        """Record a span with explicit endpoints in seconds of
        ``time.time()`` (for intervals measured elsewhere, e.g. the
        readiness stall); its parent is the thread's live span."""
        stack = self._stack()
        a, b = round(t0 * 1e9), round(t1 * 1e9)
        self._buf().append(("X", name, cat, a, max(b - a, 0), args,
                            next(self._ids), stack[-1] if stack else 0,
                            self.job))

    def instant(self, name: str, cat: str, args: Optional[dict] = None):
        self._buf().append(("i", name, cat, time.time_ns(), args))

    def counter(self, name: str, value):
        self._buf().append(("C", name, time.time_ns(), value))

    # ---- export surface ----------------------------------------------
    def drain(self) -> list:
        """Snapshot of (tid, thread_name, events) per thread. Safe while
        other threads keep recording: buffers are copied under the
        registry lock; appends racing the copy land in the next drain."""
        with self._mu:
            return [(tid, nm, list(ev)) for tid, nm, ev in self._bufs]

    def n_events(self) -> int:
        return sum(len(ev) for _, _, ev in self.drain())

    def adopt(self, buffers: list, label: str, tid_base: int):
        """Take another process's drained (tid, thread_name, events)
        buffers into this recording, each thread named ``<name>
        [<label>]`` with its id offset by ``tid_base`` (the sharded
        driver's ranks: their clocks are this host's wall clock)."""
        with self._mu:
            for tid, nm, ev in buffers:
                self._bufs.append((tid_base + tid % (1 << 32),
                                   f"{nm} [{label}]", list(ev)))


def _warm_record_function():
    """Do now what ``record_function`` does on its first entry in a
    process: import torch's optional CUPTI monitor module (1.7 ms on an
    idle CPU host, more on a loaded one). Left to the first span, that
    import falls between the profiler's stamp of the range's start and
    the span's own, so the first span would start late on the shared
    clock."""
    from torch.autograd import profiler
    warm = getattr(profiler, "_maybe_cupti_monitor", None)
    if warm is not None:
        warm()


# ---- module-level API (what the engine instruments against) ----------
_tracer: Optional[Tracer] = None


def start(*, torch_annotations: bool = False) -> Tracer:
    """Enable tracing globally; returns the (fresh) tracer."""
    global _tracer
    _tracer = Tracer(torch_annotations=torch_annotations)
    return _tracer


def stop() -> Optional[Tracer]:
    """Disable tracing; returns the detached tracer (for export)."""
    global _tracer
    t, _tracer = _tracer, None
    return t


def get() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


def span(name: str, cat: str, **args):
    """Context manager timing one pipeline-leg interval on the calling
    thread. With no active tracer this returns a cached no-op singleton
    — no allocation, so instrumentation can stay on hot paths."""
    t = _tracer
    if t is None:
        return _NULL
    return t.span(name, cat, args or None)


def annotate(name: str, cat: str = "compute", **args):
    """Like ``span`` but also enters ``torch.profiler.record_function``
    when the tracer was started with ``torch_annotations=True`` — bridges
    the host-side timeline to device activity under torch.profiler."""
    t = _tracer
    if t is None:
        return _NULL
    s = t.span(name, cat, args or None)
    if t.annotation is not None:
        return _Annotated(s, t.annotation(name))
    return s


def job():
    """The root span of one job, ``job`` (annotated like ``annotate``):
    the tracer assigns it the next job id, which every span made while it
    is open carries, on any thread. The cached no-op when disabled."""
    t = _tracer
    if t is None:
        return _NULL
    s = t.span("job", "compute", None)
    if t.annotation is not None:
        s = _Annotated(s, t.annotation("job"))
    return _Job(t, s)


def complete(name: str, cat: str, t0: float, t1: float, **args):
    """Record a span with explicit endpoints in seconds of
    ``time.time()`` (no-op when disabled)."""
    t = _tracer
    if t is None:
        return
    t.complete(name, cat, t0, t1, args or None)


def instant(name: str, cat: str, **args):
    t = _tracer
    if t is None:
        return
    t.instant(name, cat, args or None)


def counter(name: str, value):
    """Sample a counter track (renders as a stacked area in Perfetto)."""
    t = _tracer
    if t is None:
        return
    t.counter(name, value)
