"""Page-granular buffer cache (the Hyracks buffer-cache analogue) — the
port's copy of ``repro.storage.pager``.

Pregelix's graceful out-of-core story rests on every operator reading and
writing relations THROUGH a buffer cache, so the same physical plans run
whether the working set fits in memory or not (paper Sections 2.3/5.4).
This module is that layer for the GPU's hierarchy: a ``BufferPool``
holds fixed-key ``Page`` objects (one page = one super-partition slice of
one relation, or one run-structured inbox chunk) under a configurable
DRAM byte budget, evicting to mmap-backed spill files
(``storage.spillfile``) when the budget is exceeded and faulting pages
back in on access.

Eviction policies (``policy=``):

* ``"lru"``   — classic least-recently-used. Right when the working set
  fits or accesses have temporal locality.
* ``"mru"``   — evict the MOST recently used unpinned page. The OOC
  driver's access pattern is a CYCLIC SEQUENTIAL SCAN (super-partitions
  0..n_sp-1, every superstep): under LRU a cache smaller than the scan
  re-faults every page every cycle (hit rate 0), while MRU pins down a
  stable prefix of the cycle and converges to a hit rate of
  budget/working-set — the classic sequential-flooding fix, tuned to the
  superstep's cyclic pattern (GraphH's hot-data cache makes the same
  observation, arXiv 1705.05595).

Pages are PINNED while a pipeline slot is in flight (the dispatcher pins
a super-partition's pages at upload, the collector unpins at commit);
pinned pages are never eviction victims, so the budget must cover the
pinned working set — the pool raises with the shortfall when it cannot.
Dirty pages write back lazily: only on eviction, ``flush()`` (checkpoint
barrier) or shape-changing replacement, and clean pages are dropped
without any I/O.

BACKGROUND I/O (``storage.io_engine``): when an ``IOEngine`` is attached
the pool becomes a shared structure — every public method takes the pool
lock, and the engine moves page bytes through the ``fault_background`` /
``writeback_background`` entry points, which mark the page ``io_busy``
while the disk transfer runs OUTSIDE the lock. ``io_busy`` pages are
never eviction victims (eviction must not block behind an in-flight
transfer), and with an engine attached the evictor PREFERS CLEAN victims
— the engine's ``clean_ahead`` keeps cold dirty pages written back ahead
of time, so foreground evictions degrade to a free page drop instead of
a synchronous disk write. A per-page ``version`` counter (bumped by
``mark_dirty`` and in-place writes) lets a background write-back detect
that it raced a new mutation and leave the page dirty for the next
drain, which is what makes write coalescing safe.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from repro_torch.obs import trace
from repro_torch.storage.io_engine import DEFAULT_RETRY, retry_io
from repro_torch.storage.spillfile import SpillDir

EVICTION_POLICIES = ("lru", "mru")


def _faults():
    from repro_torch.runtime import faults
    return faults


class Page:
    """One cached block: resident numpy data or a spill-file residue."""

    __slots__ = ("key", "data", "nbytes", "dirty", "pins", "immutable",
                 "slot", "version")

    def __init__(self, key, data: Optional[np.ndarray], *,
                 dirty: bool, immutable: bool = False, slot=None):
        self.key = key
        self.data = data
        self.nbytes = int(data.nbytes) if data is not None else 0
        self.dirty = dirty
        self.pins = 0
        self.immutable = immutable
        self.slot = slot
        self.version = 0       # bumped on every mutation of `data`

    @property
    def resident(self) -> bool:
        return self.data is not None


def _own(arr: np.ndarray) -> np.ndarray:
    """Contiguous array that OWNS its buffer: a page must not keep a view
    alive into a larger caller array (that would defeat eviction)."""
    a = np.ascontiguousarray(arr)
    if a.base is not None:
        a = a.copy()
    return a


# the counters ``take_interval`` snapshots per superstep
_INTERVAL_FIELDS = ("hits", "misses", "evictions", "spill_read_bytes",
                    "spill_write_bytes")


class BufferPool:
    """Budgeted page cache with pluggable eviction and lazy write-back.

    ``budget_bytes=None`` disables eviction (pure-DRAM tier: every page
    stays resident; hit/miss statistics still flow). A byte budget
    requires a ``spill`` directory to evict into.
    """

    def __init__(self, budget_bytes: Optional[int] = None, *,
                 policy: str = "lru", spill: Optional[SpillDir] = None):
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"policy must be one of {EVICTION_POLICIES}, "
                             f"got {policy!r}")
        if budget_bytes is not None and spill is None:
            raise ValueError(
                "a DRAM byte budget needs a spill directory to evict into "
                "(pass disk_dir=...)")
        self.budget = int(budget_bytes) if budget_bytes is not None else None
        self.policy = policy
        self.spill = spill
        self.engine = None          # attached storage.io_engine.IOEngine
        # Foreground disk ops ride the same retry ladder as the engine's
        # background ops; an attached IOEngine shares its policy and its
        # health-score callback through these two attributes.
        self.retry_policy = DEFAULT_RETRY
        self.retry_notify = None
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)   # background-fault done
        self._io_busy: set = set()   # keys with in-flight engine I/O
        self._tombstones: set = set()   # deleted while I/O was in flight
        self._pages: dict = {}
        self._order: OrderedDict = OrderedDict()   # residency, LRU->MRU
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.resident_bytes = 0
        self.peak_resident_bytes = 0
        self.spill_read_bytes = 0
        self.spill_write_bytes = 0
        self._interval_base = {f: 0 for f in _INTERVAL_FIELDS}

    # ---- internals (callers hold self._mu) ---------------------------
    def _account(self, delta: int):
        self.resident_bytes += delta
        if self.resident_bytes > self.peak_resident_bytes:
            self.peak_resident_bytes = self.resident_bytes

    def _touch(self, key):
        if key in self._order:
            self._order.move_to_end(key)

    def _candidates(self):
        return (self._order if self.policy == "lru"
                else reversed(self._order))

    def _victim(self) -> Optional[Page]:
        """Next eviction victim: first evictable page in policy order.
        With an IOEngine attached, CLEAN evictable pages are preferred
        (dropping them is free; the engine's clean-ahead exists exactly
        to make such victims available) and pages with in-flight engine
        I/O are never victims."""
        fallback = None
        for k in self._candidates():
            page = self._pages[k]
            if page.pins > 0 or k in self._io_busy:
                continue
            if self.engine is None or not page.dirty:
                return page
            if fallback is None:
                fallback = page
        return fallback

    def _evict(self, page: Page):
        if page.dirty:
            self._writeback(page)
        self._order.pop(page.key, None)
        self._account(-page.nbytes)
        page.data = None
        self.evictions += 1

    def _writeback(self, page: Page):
        with trace.span("page_writeback", "writeback"):
            if page.slot is None:
                page.slot = self.spill.slot_for(page.key)
            retry_io(lambda: page.slot.store(page.data),
                     self.retry_policy, on_retry=self.retry_notify)
        self.spill_write_bytes += page.nbytes
        page.dirty = False

    def _ensure_room(self, nbytes: int):
        if self.budget is None:
            return
        while self.resident_bytes + nbytes > self.budget:
            victim = self._victim()
            if victim is None:
                if self._io_busy:
                    # every otherwise-evictable page is mid-transfer on
                    # the I/O engine (or its readahead reservation holds
                    # the bytes): wait for a completion and retry
                    # instead of failing the caller — eviction skips
                    # io-busy pages, it never blocks ON one, but the
                    # budget itself must wait for the bytes to settle
                    self._cv.wait(timeout=1.0)
                    continue
                pinned = sum(p.nbytes for p in self._pages.values()
                             if p.resident and p.pins > 0)
                if nbytes > self.budget:
                    raise RuntimeError(
                        f"buffer-cache budget of {self.budget} bytes is "
                        f"smaller than a single page ({nbytes} bytes — "
                        f"one super-partition slice of one relation); "
                        f"raise memory_budget_bytes at least that far")
                raise RuntimeError(
                    f"buffer-cache budget of {self.budget} bytes cannot "
                    f"hold the pinned working set ({pinned} bytes pinned, "
                    f"{nbytes} more requested); raise "
                    f"memory_budget_bytes or lower prefetch_depth")
            self._evict(victim)

    def _insert_resident(self, page: Page):
        self._ensure_room(page.nbytes)
        self._account(page.nbytes)
        self._order[page.key] = None
        self._order.move_to_end(page.key)

    # ---- public API --------------------------------------------------
    def put(self, key, arr: np.ndarray, *, dirty: bool = True,
            immutable: bool = False):
        """Insert or replace a page. ``dirty=True`` (default) defers the
        spill write until eviction/flush; ``immutable=True`` marks the
        page's spill file safe to hard-link (checkpoints)."""
        arr = _own(np.asarray(arr))
        with self._mu:
            old = self._pages.get(key)
            pins = 0
            if old is not None:
                if old.resident:
                    self._order.pop(key, None)
                    self._account(-old.nbytes)
                slot = old.slot
                pins = old.pins    # replacement keeps the caller's pins
            else:
                slot = None
            page = Page(key, arr, dirty=dirty, immutable=immutable,
                        slot=slot)
            page.pins = pins
            if not dirty and slot is None and self.spill is not None:
                # caller asserts the data is already durable; without a
                # file backing it an eviction would lose it, so keep it
                # dirty
                page.dirty = True
            self._pages[key] = page
            self._insert_resident(page)
            return page

    def adopt(self, key, slot, nbytes: int, *, immutable: bool = False):
        """Install a NON-RESIDENT page backed by an existing spill file
        (the resume-from-checkpoint path): no bytes enter DRAM until the
        first ``get`` faults it in."""
        with self._mu:
            page = Page(key, None, dirty=False, immutable=immutable,
                        slot=slot)
            page.nbytes = int(nbytes)
            self._pages[key] = page
            return page

    def get(self, key) -> np.ndarray:
        """Fetch a page's data, faulting it in from its spill file if it
        was evicted. The returned array is the CACHED buffer — callers
        that mutate it must call ``mark_dirty``."""
        with self._mu:
            page = self._pages[key]
            if not page.resident and key in self._io_busy:
                # a background fault for this page is already in flight:
                # wait for its bytes instead of duplicating the disk
                # read on the critical path (on timeout or engine
                # failure we fall through to the synchronous fault,
                # which surfaces the real error)
                self._cv.wait_for(
                    lambda: self._pages.get(key) is not page
                    or page.resident or key not in self._io_busy,
                    timeout=30.0)
                page = self._pages[key]
            if page.resident:
                self.hits += 1
                self._touch(key)
                return page.data
            self.misses += 1
            slot = page.slot
            # perform the disk read OUTSIDE the lock (marked io_busy so
            # the engine and the evictor leave the page alone): a
            # foreground fault must not serialize every background
            # worker behind its transfer
            self._io_busy.add(key)
        try:
            with trace.span("page_fault", "fault"):
                _faults().hit("pager.fault", str(key))
                data = retry_io(slot.load, self.retry_policy,
                                on_retry=self.retry_notify)
        except BaseException:
            with self._mu:
                self._io_done(key)
            raise
        with self._mu:
            self._io_done(key)
            if self._pages.get(key) is not page:
                # deleted/replaced while we read: hand the caller the
                # bytes but do not resurrect the page in the pool
                return data
            if page.resident:      # engine landed it while we read
                self._touch(key)
                return page.data
            self._ensure_room(int(data.nbytes))
            page.data = data
            page.nbytes = int(data.nbytes)
            self.spill_read_bytes += page.nbytes
            self._insert_resident(page)
            return page.data

    def __contains__(self, key) -> bool:
        with self._mu:
            return key in self._pages

    def keys(self):
        with self._mu:
            return list(self._pages.keys())

    def page(self, key) -> Page:
        with self._mu:
            return self._pages[key]

    def mark_dirty(self, key):
        with self._mu:
            page = self._pages[key]
            page.dirty = True
            page.version += 1

    def pin(self, key):
        """Pin (faulting in if needed): the page cannot be evicted until
        the matching ``unpin``. Pins nest. The fault runs outside the
        lock (see ``get``), so the pin re-checks residency — an eviction
        sneaking between the fault and the pin just re-faults."""
        while True:
            self.get(key)
            with self._mu:
                page = self._pages[key]
                if page.resident:
                    page.pins += 1
                    return

    def unpin(self, key):
        with self._mu:
            page = self._pages[key]
            if page.pins <= 0:
                raise RuntimeError(f"unpin of unpinned page {key!r}")
            page.pins -= 1

    def delete(self, key):
        with self._mu:
            page = self._pages.pop(key, None)
            if page is None:
                return
            if page.resident:
                self._order.pop(key, None)
                self._account(-page.nbytes)
            if page.slot is not None:
                page.slot.delete()
                if key in self._io_busy:
                    # an engine write in flight may atomically recreate
                    # the file; the I/O completion sweeps it back up
                    self._tombstones.add(key)

    def flush(self):
        """Write back every dirty page (no evictions). The pool must have
        a spill directory; this is the checkpoint barrier. With an
        IOEngine attached the caller drains it first (``TieredStore.flush``
        does), so no page is mid-transfer here."""
        if self.spill is None:
            return
        with self._mu:
            for page in self._pages.values():
                if page.resident and page.dirty \
                        and page.key not in self._io_busy:
                    self._writeback(page)

    # ---- IOEngine entry points ---------------------------------------
    def attach_engine(self, engine):
        self.engine = engine

    def _io_done(self, key):
        """Clear a key's in-flight marker and wake every waiter (both
        foreground faults waiting on this page and _ensure_room waiting
        for evictable room); if the page was deleted while the transfer
        ran, remove the file the write may have recreated (callers hold
        self._mu)."""
        self._io_busy.discard(key)
        self._cv.notify_all()
        if key in self._tombstones:
            self._tombstones.discard(key)
            if self.spill is not None:
                self.spill.slot_for(key).delete()

    def wants_prefetch(self, key) -> bool:
        """True when a background fault for ``key`` would do useful work
        (page exists, is evicted, has a spill file, no I/O in flight)."""
        with self._mu:
            page = self._pages.get(key)
            return (page is not None and not page.resident
                    and key not in self._io_busy
                    and page.slot is not None)

    def dirty_eviction_candidates(self, limit: int):
        """Keys of up to ``limit`` dirty, unpinned, idle resident pages
        in EVICTION ORDER — the engine's clean-ahead targets; only
        meaningful under a byte budget."""
        out = []
        with self._mu:
            if self.budget is None or self.spill is None:
                return out
            if self.resident_bytes < self.budget - self.budget // 8:
                # no eviction pressure: a drain now would only risk
                # rewriting pages that get re-dirtied before they are
                # ever evicted
                return out
            for k in self._candidates():
                page = self._pages[k]
                if (page.dirty and page.pins == 0 and page.resident
                        and k not in self._io_busy):
                    out.append(k)
                    if len(out) >= limit:
                        break
        return out

    def fault_background(self, key) -> Optional[int]:
        """Engine-side page fault: RESERVE room under the lock by
        evicting CLEAN victims only (a readahead must never perform or
        wait on a dirty write-back — if no free room exists it is simply
        dropped, before paying the read), load the spill file OUTSIDE
        the lock, and install the bytes if the page is still evicted.
        Returns the bytes installed, or None when the readahead was
        dropped or the foreground won the race."""
        with self._mu:
            page = self._pages.get(key)
            if (page is None or page.resident or key in self._io_busy
                    or page.slot is None):
                return None
            hold = int(page.nbytes)
            if self.budget is not None:
                while self.resident_bytes + hold > self.budget:
                    victim = next(
                        (self._pages[k] for k in self._candidates()
                         if self._pages[k].pins == 0
                         and k not in self._io_busy
                         and not self._pages[k].dirty), None)
                    if victim is None:
                        return None   # no free room: drop the readahead
                    self._evict(victim)   # clean victim: a free drop
                self._account(hold)       # reservation
            self._io_busy.add(key)
            slot = page.slot
        try:
            data = slot.load()
        except BaseException:
            with self._mu:
                if self.budget is not None:
                    self._account(-hold)
                self._io_done(key)
                self._cv.notify_all()
            raise
        with self._mu:
            installed = None
            if self._pages.get(key) is page and not page.resident:
                if self.budget is not None:
                    self._account(int(data.nbytes) - hold)
                else:
                    self._account(int(data.nbytes))
                page.data = data
                page.nbytes = int(data.nbytes)
                # an engine-served fault is still a PAGE FAULT: the
                # bytes came off disk, just off the critical path —
                # count it as a miss so cache_hit_rate (and the cost
                # model's disk-read term it feeds) reflects measured
                # disk traffic, not merely who performed the read
                self.misses += 1
                self.spill_read_bytes += page.nbytes
                self._order[key] = None
                self._order.move_to_end(key)
                installed = page.nbytes
            elif self.budget is not None:
                self._account(-hold)
            self._io_done(key)
            self._cv.notify_all()
            return installed

    def writeback_background(self, key) -> Optional[int]:
        """Engine-side dirty drain: snapshot the page under the lock,
        write its spill file outside it, and mark the page clean only if
        nobody re-dirtied it meanwhile (version check) — the coalescing
        contract. Returns bytes written, or None if there was nothing to
        do."""
        with self._mu:
            page = self._pages.get(key)
            if (page is None or not page.resident or not page.dirty
                    or key in self._io_busy):
                return None
            if page.slot is None:
                if self.spill is None:
                    return None
                page.slot = self.spill.slot_for(page.key)
            self._io_busy.add(key)
            data, slot, version = page.data, page.slot, page.version
        try:
            slot.store(data)
        except BaseException:
            with self._mu:
                self._io_done(key)
            raise
        with self._mu:
            self._io_done(key)
            cur = self._pages.get(key)
            if cur is page and page.version == version:
                page.dirty = False
            self.spill_write_bytes += data.nbytes
            return int(data.nbytes)

    # ---- statistics --------------------------------------------------
    def stats(self) -> dict:
        with self._mu:
            total = self.hits + self.misses
            return {
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 1.0,
                "evictions": self.evictions,
                "resident_bytes": self.resident_bytes,
                "peak_resident_bytes": self.peak_resident_bytes,
                "spill_read_bytes": self.spill_read_bytes,
                "spill_write_bytes": self.spill_write_bytes,
            }

    def occupancy(self) -> dict:
        """Live page accounting for the memory-pressure ledger
        (``obs.memwatch``): resident / dirty / pinned bytes at
        this instant, under the pool lock, plus the hard budget and the
        peak watermark. Unlike ``stats()`` these are walked from the
        page table, so dirty and pinned bytes — the part of the tier an
        eviction cannot reclaim — are exact."""
        with self._mu:
            resident = dirty = pinned = 0
            for p in self._pages.values():
                if not p.resident:
                    continue
                resident += p.nbytes
                if p.dirty:
                    dirty += p.nbytes
                if p.pins > 0:
                    pinned += p.nbytes
            return {
                "resident_bytes": resident,
                "dirty_bytes": dirty,
                "pinned_bytes": pinned,
                "budget_bytes": self.budget,
                "peak_resident_bytes": self.peak_resident_bytes,
                "spill_read_bytes": self.spill_read_bytes,
                "spill_write_bytes": self.spill_write_bytes,
            }

    def take_interval(self) -> dict:
        """Counters SINCE THE LAST CALL (one superstep's worth for the
        OOC driver), so the planner observes current — not cumulative —
        paging behavior. Cumulative totals stay available via
        ``stats()``."""
        with self._mu:
            out = {}
            for f in _INTERVAL_FIELDS:
                cur = getattr(self, f)
                out[f] = cur - self._interval_base[f]
                self._interval_base[f] = cur
            return out

    def close(self, *, delete_files: bool = True):
        with self._mu:
            for key in list(self._pages):
                page = self._pages.pop(key)
                if page.resident:
                    self._order.pop(key, None)
                    self._account(-page.nbytes)
                if delete_files and page.slot is not None:
                    page.slot.delete()
