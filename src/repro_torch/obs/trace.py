"""Thread-safe span tracing for the barrier-free pipeline — the port's
copy of ``repro.obs.trace``.

The paper's statistics collector (Section 5.7) aggregates per-superstep
scalars; the out-of-core executor is a concurrent system — a rolling
dispatcher/collector loop plus background I/O-engine worker threads —
whose behavior a flat dict cannot explain. This module records *spans*
(nested, timestamped intervals categorized by pipeline leg) plus instant
and counter events, into PER-THREAD buffers so recording never contends
on a lock in the steady state; ``Tracer.drain`` hands the buffers out,
one track per thread, which is what makes the dispatcher / collector /
io-engine overlap — and the readiness-stall gap — visible on a timeline
(the Chrome trace exporter of the reference comes with the port's
observability slice).

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
  makes ``annotate`` also enter a ``torch.profiler.record_function``, so
  spans line up with device activity when the run is profiled with
  ``torch.profiler``.

Span categories (one per pipeline leg; ``CATEGORIES``): ``dispatch``,
``prepare``, ``compute``, ``collect``, ``commit``, ``fault``,
``readahead``, ``writeback``, ``checkpoint``, ``replan``, ``exchange``,
``retry`` / ``degrade`` (the I/O engine's fault-retry ladder)
(the sharded driver's all_to_all stage — what the planner's network
axis is calibrated against).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

# pipeline legs; the exporter colors/filters by these
CATEGORIES = ("dispatch", "prepare", "compute", "collect", "commit",
              "fault", "readahead", "writeback", "checkpoint", "replan",
              "exchange", "retry", "degrade")

# event tuples stored in the per-thread buffers:
#   ("X", name, cat, t0, dur, args)   complete span (seconds, wall clock)
#   ("i", name, cat, t, args)         instant event
#   ("C", name, t, value)             counter sample


class _NullSpan:
    """The cached no-op context manager the disabled path returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """A live span: appends one ("X", ...) event to its thread's buffer
    on exit. Created only when a tracer is active."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        t1 = time.time()
        self._tracer._buf().append(
            ("X", self._name, self._cat, self._t0, t1 - self._t0,
             self._args))
        return False


class _Annotated:
    """A span combined with a ``torch.profiler.record_function`` (device
    bridging): both contexts enter/exit together."""

    __slots__ = ("_span", "_ann")

    def __init__(self, span, ann):
        self._span = span
        self._ann = ann

    def __enter__(self):
        self._span.__enter__()
        self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        self._ann.__exit__(*exc)
        return self._span.__exit__(*exc)


class Tracer:
    """Per-thread span buffers + the clock origin for one recording."""

    def __init__(self, *, torch_annotations: bool = False):
        self._mu = threading.Lock()
        self._bufs: list = []            # [(tid, thread_name, events)]
        self._local = threading.local()
        self.t_origin = time.time()
        self.annotation = None
        if torch_annotations:
            from torch.profiler import record_function
            self.annotation = record_function

    def _buf(self) -> list:
        b = getattr(self._local, "buf", None)
        if b is None:
            th = threading.current_thread()
            b = []
            with self._mu:
                self._bufs.append((th.ident or 0, th.name, b))
            self._local.buf = b
        return b

    # ---- recording ---------------------------------------------------
    def span(self, name: str, cat: str, args: Optional[dict] = None):
        return _Span(self, name, cat, args)

    def complete(self, name: str, cat: str, t0: float, t1: float,
                 args: Optional[dict] = None):
        """Record a span with explicit wall-clock endpoints (for
        intervals measured elsewhere, e.g. the readiness stall)."""
        self._buf().append(("X", name, cat, t0, max(t1 - t0, 0.0), args))

    def instant(self, name: str, cat: str, args: Optional[dict] = None):
        self._buf().append(("i", name, cat, time.time(), args))

    def counter(self, name: str, value):
        self._buf().append(("C", name, time.time(), value))

    # ---- export surface ----------------------------------------------
    def drain(self) -> list:
        """Snapshot of (tid, thread_name, events) per thread. Safe while
        other threads keep recording: buffers are copied under the
        registry lock; appends racing the copy land in the next drain."""
        with self._mu:
            return [(tid, nm, list(ev)) for tid, nm, ev in self._bufs]

    def n_events(self) -> int:
        return sum(len(ev) for _, _, ev in self.drain())


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


def complete(name: str, cat: str, t0: float, t1: float, **args):
    """Record a span with explicit wall-clock endpoints (no-op when
    disabled)."""
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
