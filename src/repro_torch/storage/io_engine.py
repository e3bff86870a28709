"""Background page-I/O engine: disk reads/writes off the critical path —
the port's copy of ``repro.storage.io_engine``.

The disk tier makes page faults and dirty write-backs *lazy*, but on its
own they run synchronously on whichever thread touches the pool — the
OOC dispatcher would pay a disk read for every faulted page and the
collector a disk write for every eviction under budget pressure. This
module owns that I/O on worker threads instead (GraphD/GraphH discipline: an
out-of-core engine must overlap its disk leg with everything else):

* **Readahead** — the executor announces the pages the next dispatchable
  destination will touch (``prefetch``); non-resident ones fault in from
  their spill files in the background, so the foreground ``get`` that
  follows is a DRAM hit. A readahead that loses the race to a foreground
  fault simply drops its bytes; a readahead that *fails* is recorded and
  retried synchronously by the foreground fault, which surfaces the real
  error to the caller.
* **Dirty-page drain** — under budget pressure the engine writes back
  cold dirty pages ahead of eviction (``clean_ahead`` targets pages in
  eviction order), so the evictor finds CLEAN victims and drops them
  without blocking on disk. Writes are COALESCED: a page queued while a
  write for it is already queued is enqueued once, and a page re-dirtied
  after its write-back simply stays dirty (the pool's per-page version
  counter detects the race) to be drained again later.
* **Pin-aware scheduling** — pages with in-flight engine I/O are marked
  ``io_busy`` and are never eviction victims (``pager._victim`` skips
  them), so eviction never blocks behind the engine; the engine likewise
  never writes a page mid-replacement (versioning) and performs all disk
  I/O *outside* the pool lock.

Worker failures never kill the run silently — and transient ones never
kill it at all:

* **Retry ladder** — every disk op (background AND the pool's foreground
  faults, which share this module's ``retry_io``) retries transient
  ``OSError``s with capped exponential backoff + jitter before
  surfacing. ``PageCorruption`` is never retried: re-reading corrupt
  bytes returns the same corrupt bytes, so it surfaces immediately for
  the recovery supervisor. Retries are visible as ``retry`` trace
  instants and the ``io.retries`` registry counter.
* **Degradation ladder** — repeated faults raise a health score that
  first shrinks readahead to one page (stop speculating against a sick
  disk), then falls back to synchronous foreground I/O entirely; clean
  ops decay the score back toward full pipelining when the disk heals.
  Transitions emit ``degrade`` trace instants and the live level rides
  ``stats()``/``take_interval`` and the ``io.degrade_level`` gauge.

Per-key errors are kept in ``errors`` — BOUNDED (oldest evicted past
``ERRORS_CAP``) so a persistently bad disk can't grow it without limit —
and counted on the ``io.errors`` registry counter. Read failures
re-raise from the foreground fault; write failures leave the page dirty
for the synchronous ``flush`` fallback to surface. ``close`` drains the
queue — dirty pages handed to the engine are on disk before shutdown
returns.

The workers do disk and numpy work only: no CUDA call runs on them. Every
host<->device copy of the out-of-core driver stays on its own thread.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.obs import trace
from repro_torch.obs.metrics import Counter, Histogram
from repro_torch.storage.spillfile import PageCorruption

_SENTINEL = object()

ERRORS_CAP = 64          # bounded error log (satellite: no unbounded growth)


@dataclass
class RetryPolicy:
    """Capped exponential backoff + jitter for transient disk faults."""
    attempts: int = 4            # total tries (1 initial + retries)
    base_s: float = 0.002        # first backoff
    cap_s: float = 0.25          # backoff ceiling
    jitter: float = 0.5          # uniform extra fraction of the delay


DEFAULT_RETRY = RetryPolicy()


def retry_io(fn, policy: RetryPolicy = DEFAULT_RETRY, *, on_retry=None):
    """Run a disk op under the retry ladder. Retries ``OSError`` (real
    EIO and injected faults alike); ``PageCorruption`` and application
    errors surface immediately. ``on_retry(attempt, exc)`` fires before
    each backoff sleep."""
    delay = policy.base_s
    for attempt in range(policy.attempts):
        try:
            return fn()
        except PageCorruption:
            raise
        except OSError as exc:
            if attempt + 1 >= policy.attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            trace.instant("io_retry", "retry", attempt=attempt,
                          error=type(exc).__name__)
            time.sleep(min(delay * (1.0 + policy.jitter * random.random()),
                           policy.cap_s))
            delay *= 2.0


class IOEngine:
    """Worker thread(s) owning a ``BufferPool``'s spill-tier I/O."""

    def __init__(self, pool, *, threads: int = 1,
                 readahead_pages: int = 8, metrics=None,
                 retry: Optional[RetryPolicy] = None):
        if threads < 1:
            raise ValueError("io engine needs at least one worker thread")
        self.pool = pool
        # `readahead_pages` is the configured CEILING; the live depth
        # adapts within [1, ceiling] from observed fault latency vs
        # compute time (`autopace`).
        self.readahead_max = max(int(readahead_pages), 1)
        self.readahead_pages = self.readahead_max
        # Retry + degradation ladder state. The policy and the counters
        # are SHARED with the pool so foreground faults ride the same
        # ladder and feed the same health score.
        self.retry = retry or RetryPolicy()
        self.retries = 0
        self.error_count = 0
        self._c_retries = (metrics.counter("io.retries")
                           if metrics is not None else Counter())
        self._c_errors = (metrics.counter("io.errors")
                          if metrics is not None else Counter())
        self._g_degrade = (metrics.gauge("io.degrade_level")
                           if metrics is not None else None)
        self._health = 0                 # fault pressure; 0 = healthy
        self.degrade_readahead_at = 4    # health >= this: readahead -> 1
        self.degrade_sync_at = 8         # health >= this: sync fallback
        self.degrade_level = 0           # 0 full / 1 throttled / 2 sync
        pool.retry_policy = self.retry
        pool.retry_notify = self._note_retry
        self._q: queue.Queue = queue.Queue()
        self._mu = threading.Lock()
        self._queued: set = set()        # (op, key) pending — coalescing
        self._idle = threading.Condition(self._mu)
        self._outstanding = 0            # queued + in-flight items
        self.errors: dict = {}           # key -> last exception
        self.reads = 0                   # completed readahead faults
        self.read_bytes = 0
        self.writes = 0                  # completed background drains
        self.write_bytes = 0
        self.dropped = 0                 # readaheads beaten by foreground
        self._depth_peak = 0
        self._depth_sum = 0
        self._depth_n = 0
        # queue-depth distribution per superstep (p50/p90/max travel in
        # SuperstepStats.extra); shared with the run registry when given
        # — then take_interval only SNAPSHOTS it and leaves the reset to
        # the registry's own interval pass (StatsCollector.record runs
        # right after), so the same numbers appear on both streams
        self._own_hist = metrics is None
        self._depth_hist = (metrics.histogram("io.queue_depth")
                            if metrics is not None else Histogram())
        self._int_reads = 0              # interval fault-latency sample
        self._int_read_s = 0.0
        self._closed = False
        self._workers = [
            threading.Thread(target=self._run, name=f"pregelix-io-{k}",
                             daemon=True)
            for k in range(int(threads))]
        for w in self._workers:
            w.start()

    # ---- scheduling --------------------------------------------------
    def _enqueue(self, op: str, key) -> bool:
        with self._mu:
            if self._closed or (op, key) in self._queued:
                return False
            self._queued.add((op, key))
            self._outstanding += 1
            depth = self._outstanding
            self._depth_peak = max(self._depth_peak, depth)
            self._depth_sum += depth
            self._depth_n += 1
        self._depth_hist.observe(depth)
        self._q.put((op, key))
        return True

    def effective_readahead(self) -> int:
        """Live depth after the degradation ladder: level 1 stops
        speculating (one page), level 2 is the sync-I/O fallback (no
        background reads at all — the foreground fault path, with its
        own retry ladder, does the work)."""
        if self.degrade_level >= 2:
            return 0
        if self.degrade_level == 1:
            return 1
        return self.readahead_pages

    def prefetch(self, keys) -> int:
        """Schedule background faults for up to ``readahead_pages`` of
        ``keys`` that are present-but-not-resident (fewer while the
        degradation ladder is engaged). Returns the number scheduled."""
        n = 0
        depth = self.effective_readahead()
        for key in keys:
            if n >= depth:
                break
            if self.pool.wants_prefetch(key) and self._enqueue("read", key):
                n += 1
        return n

    def clean_ahead(self, limit: int = 4) -> int:
        """Schedule write-backs for up to ``limit`` dirty unpinned pages
        in EVICTION ORDER (the pages the evictor would reach next), so a
        future eviction finds clean victims it can drop without I/O."""
        n = 0
        for key in self.pool.dirty_eviction_candidates(limit):
            if self._enqueue("write", key):
                n += 1
        return n

    # ---- retry / degradation ladder ----------------------------------
    def _note_retry(self, attempt: int, exc: Exception):
        """Shared with the pool's foreground faults (``retry_notify``)."""
        self._c_retries.inc()
        with self._mu:
            self.retries += 1
        self._bump_health(+1)

    def _bump_health(self, delta: int):
        with self._mu:
            self._health = max(0, self._health + delta)
            level = (2 if self._health >= self.degrade_sync_at else
                     1 if self._health >= self.degrade_readahead_at else 0)
            prev, self.degrade_level = self.degrade_level, level
        if level != prev:
            trace.instant("io_degrade" if level > prev else "io_heal",
                          "degrade", level=level, health=self._health)
        if self._g_degrade is not None:
            self._g_degrade.set(level)

    def _record_error(self, key, e: Exception):
        self._c_errors.inc()
        with self._mu:
            self.error_count += 1
            self.errors[key] = e
            while len(self.errors) > ERRORS_CAP:
                self.errors.pop(next(iter(self.errors)))

    # ---- worker ------------------------------------------------------
    def _run(self):
        from repro_torch.runtime import faults
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                self._q.task_done()
                return
            op, key = item
            try:
                if op == "read":
                    t0 = time.time()
                    with trace.span("fault_bg", "readahead"):
                        nbytes = retry_io(
                            lambda: (faults.hit("io.bg", f"read:{key}"),
                                     self.pool.fault_background(key))[1],
                            self.retry, on_retry=self._note_retry)
                    dt = time.time() - t0
                    with self._mu:
                        if nbytes is None:
                            self.dropped += 1
                        else:
                            self.reads += 1
                            self.read_bytes += nbytes
                            self._int_reads += 1
                            self._int_read_s += dt
                            self.errors.pop(key, None)
                    self._bump_health(-1)
                else:
                    with trace.span("writeback_bg", "writeback"):
                        nbytes = retry_io(
                            lambda: (faults.hit("io.bg", f"write:{key}"),
                                     self.pool.writeback_background(key))[1],
                            self.retry, on_retry=self._note_retry)
                    if nbytes is not None:
                        with self._mu:
                            self.writes += 1
                            self.write_bytes += nbytes
                            self.errors.pop(key, None)
                    self._bump_health(-1)
            except Exception as e:  # noqa: BLE001 — surfaced via errors
                self._record_error(key, e)
                self._bump_health(+2)
            finally:
                with self._mu:
                    self._queued.discard((op, key))
                    self._outstanding -= 1
                    if self._outstanding == 0:
                        self._idle.notify_all()
                self._q.task_done()

    # ---- lifecycle / statistics --------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued request has completed."""
        with self._idle:
            return self._idle.wait_for(lambda: self._outstanding == 0,
                                       timeout=timeout)

    def close(self):
        """Drain outstanding I/O and stop the workers. Dirty pages whose
        write-backs were queued are on disk when this returns."""
        if self._closed:
            return
        self.drain()
        with self._mu:
            self._closed = True
        for _ in self._workers:
            self._q.put(_SENTINEL)
        for w in self._workers:
            w.join(timeout=30.0)

    def stats(self) -> dict:
        with self._mu:
            mean = (self._depth_sum / self._depth_n) if self._depth_n else 0.0
            return {
                "io_reads": self.reads, "io_read_bytes": self.read_bytes,
                "io_writes": self.writes,
                "io_write_bytes": self.write_bytes,
                "io_dropped_readaheads": self.dropped,
                "io_queue_depth_peak": self._depth_peak,
                "io_queue_depth_mean": mean,
                "io_errors": self.error_count,
                "io_retries": self.retries,
                "io_degrade_level": self.degrade_level,
            }

    def autopace(self, compute_s: float) -> int:
        """Close the I/O pacing loop (ROADMAP "Measurement-driven
        planning"): set the live readahead depth to the number of page
        faults the measured per-fault latency says fit inside one
        superstep's compute window, clamped to [1, readahead_max].
        Prefetching deeper than that outruns the window the pipeline can
        hide and only pressures the eviction clock; shallower leaves
        hideable faults on the foreground path. Consumes and resets the
        interval fault-latency sample; with no faults observed this
        superstep the depth is left unchanged."""
        with self._mu:
            reads, read_s = self._int_reads, self._int_read_s
            self._int_reads, self._int_read_s = 0, 0.0
        if reads == 0 or read_s <= 0.0 or compute_s <= 0.0:
            return self.readahead_pages
        lat = read_s / reads
        k = int(compute_s / lat)
        self.readahead_pages = max(1, min(self.readahead_max, k))
        return self.readahead_pages

    def take_interval(self) -> dict:
        """Per-superstep view: returns current depth statistics —
        including the p50/p90/max of the queue-depth distribution — and
        resets the interval accumulators (the satellite counterpart of
        ``BufferPool.take_interval``)."""
        hist = (self._depth_hist.interval() if self._own_hist
                else self._depth_hist.snapshot())
        with self._mu:
            out = {
                "io_queue_depth_peak": self._depth_peak,
                "io_queue_depth_mean": (self._depth_sum / self._depth_n
                                        if self._depth_n else 0.0),
                "io_queue_depth_p50": hist["p50"],
                "io_queue_depth_p90": hist["p90"],
                "io_queue_depth_max": hist["max"],
                "readahead_depth": self.readahead_pages,
                "io_degrade_level": self.degrade_level,
            }
            self._depth_peak = self._outstanding
            self._depth_sum = 0
            self._depth_n = 0
            return out
