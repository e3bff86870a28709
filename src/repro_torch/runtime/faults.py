"""Deterministic chaos harness: seeded fault plans injected at named
runtime sites.

The chaos loop (paper Section 5.7 is about *recovering* from failures;
this module is how we *cause* them on demand): a ``FaultPlan`` is a
seeded list of ``FaultSpec``s, each naming an injection site
("spill.read", "checkpoint.commit", "superstep", ...), a fault kind
(transient/permanent I/O error, page corruption, latency spike, worker
failure) and firing rules (skip the first ``after`` hits, fire at most
``times`` times, per-hit probability ``p`` drawn from the plan's seeded
RNG). The storage and driver layers call the module-level hooks at
their sites; with no plan installed every hook is a near-free early
return, mirroring ``obs.trace``'s process-global start/stop idiom.

Sites wired through the runtime:

====================  =====================================================
site                  hook point
====================  =====================================================
``spill.read``        ``SpillSlot.load`` — before reading a page file
``spill.write``       ``SpillSlot.store`` — before writing a page file
``page.corrupt``      ``SpillSlot.store`` — flips bytes in the written
                      page so the CRC check catches it on fault-in
``pager.fault``       ``BufferPool`` fault-in (foreground + background)
``io.bg``             ``IOEngine`` worker loop, per background op
``checkpoint.commit`` both checkpoint savers, between payload export and
                      the COMMIT manifest (the crash-mid-checkpoint site)
``superstep``         driver loop top; ``kind="worker"`` raises
                      ``WorkerFailure(worker)`` at ``superstep == k``
``sharded.exchange``  ``run_sharded``'s all_to_all exchange stage
====================  =====================================================

Determinism: with ``p=1.0`` (the default) firing depends only on hit
counts, which the plan controls via ``after``/``times``; with ``p<1``
draws come from ``random.Random(plan.seed)``. Injector state is
process-global and survives recovery attempts, so a ``times=1`` fault
fires once and the replay passes — exactly the transient-failure model
the recovery supervisor is built for.

Every site but ``sharded.exchange`` is wired in the port: the storage
sites by ``repro_torch.storage``, ``checkpoint.commit`` by both savers,
``superstep`` by ``run_host`` and ``run_out_of_core``;
``sharded.exchange`` comes with the multi-device slice.

``REPRO_FAULT_PLAN`` is either a path to a plan JSON or the JSON itself
(starts with ``{``); ``install_from_env`` arms it (the port's CLI, which
will call it, comes with the observability slice).
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import List, Optional

from repro_torch.runtime.failure import WorkerFailure

SITES = ("spill.read", "spill.write", "page.corrupt", "pager.fault",
         "io.bg", "checkpoint.commit", "superstep", "sharded.exchange")
KINDS = ("transient", "permanent", "corrupt", "delay", "worker")

ENV_PLAN = "REPRO_FAULT_PLAN"


class InjectedFault(OSError):
    """A planned disk/I-O fault. Subclasses OSError so the retry ladder
    and the failure manager treat it exactly like a real EIO."""

    def __init__(self, site: str, tag: str, spec_index: int):
        super().__init__(f"injected fault at {site} ({tag or 'untagged'})")
        self.site = site
        self.tag = tag
        self.spec_index = spec_index


@dataclass
class FaultSpec:
    """One planned fault. ``match`` substring-filters the hit tag (page
    key / file path / driver name); ``after`` hits pass unharmed first;
    ``times`` caps firings (``0`` = unlimited, i.e. a permanent fault);
    ``p`` is the per-hit firing probability under the plan's seed."""
    site: str
    kind: str = "transient"
    times: int = 1
    after: int = 0
    p: float = 1.0
    match: str = ""
    superstep: int = -1        # kind="worker": fire when superstep == this
    worker: int = 0            # worker id carried by the WorkerFailure
    delay_s: float = 0.0       # kind="delay": injected latency

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds: {KINDS}")


@dataclass
class FaultPlan:
    """A seeded, serializable chaos schedule."""
    faults: List[FaultSpec] = field(default_factory=list)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [asdict(f) for f in self.faults]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        return cls(seed=int(doc.get("seed", 0)),
                   faults=[FaultSpec(**f) for f in doc.get("faults", [])])


class FaultInjector:
    """Evaluates a FaultPlan at runtime. All counter state is behind a
    lock (the I/O engine hits sites from worker threads)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        self._hits = [0] * len(plan.faults)    # matching hits per spec
        self._fired = [0] * len(plan.faults)   # injections per spec
        self.site_hits: dict = {}

    # -- firing decision ------------------------------------------------
    def _should_fire(self, idx: int, spec: FaultSpec) -> bool:
        """Caller holds the lock; the hit already matched site+tag."""
        self._hits[idx] += 1
        if self._hits[idx] <= spec.after:
            return False
        if spec.times > 0 and self._fired[idx] >= spec.times:
            return False
        if spec.p < 1.0 and self._rng.random() >= spec.p:
            return False
        self._fired[idx] += 1
        return True

    def _matching(self, site: str, tag: str):
        for idx, spec in enumerate(self.plan.faults):
            if spec.site == site and (not spec.match or spec.match in tag):
                yield idx, spec

    # -- hooks ----------------------------------------------------------
    def hit(self, site: str, tag: str = ""):
        """Error/latency hook: may sleep (kind=delay) and/or raise
        InjectedFault (kind=transient/permanent)."""
        delay = 0.0
        fire: Optional[int] = None
        with self._lock:
            self.site_hits[site] = self.site_hits.get(site, 0) + 1
            for idx, spec in self._matching(site, tag):
                if spec.kind not in ("transient", "permanent", "delay"):
                    continue
                if self._should_fire(idx, spec):
                    if spec.kind == "delay":
                        delay = max(delay, spec.delay_s)
                    elif fire is None:
                        fire = idx
        if delay > 0.0:
            time.sleep(delay)
        if fire is not None:
            raise InjectedFault(site, tag, fire)

    def corrupt(self, site: str, tag: str = "") -> bool:
        """Corruption hook: True tells the caller to damage the payload
        it just wrote (the CRC trailer was computed on the clean bytes,
        so verification on the next fault-in raises PageCorruption)."""
        with self._lock:
            self.site_hits[site] = self.site_hits.get(site, 0) + 1
            for idx, spec in self._matching(site, tag):
                if spec.kind == "corrupt" and self._should_fire(idx, spec):
                    return True
        return False

    def superstep_tick(self, superstep: int, driver: str = ""):
        """Driver-loop hook: raises WorkerFailure when a kind="worker"
        spec targets this superstep (and, via ``match``, this driver)."""
        fire: Optional[FaultSpec] = None
        with self._lock:
            self.site_hits["superstep"] = \
                self.site_hits.get("superstep", 0) + 1
            for idx, spec in self._matching("superstep", driver):
                if spec.kind != "worker" or spec.superstep != superstep:
                    continue
                if self._should_fire(idx, spec):
                    fire = spec
                    break
        if fire is not None:
            raise WorkerFailure(fire.worker,
                                f"injected at superstep {superstep}"
                                f" ({driver or 'any driver'})")

    # -- reporting ------------------------------------------------------
    def summary(self) -> dict:
        with self._lock:
            return {
                "seed": self.plan.seed,
                "site_hits": dict(self.site_hits),
                "specs": [{"site": s.site, "kind": s.kind,
                           "match": s.match, "hits": h, "fired": f}
                          for s, h, f in zip(self.plan.faults,
                                             self._hits, self._fired)],
            }


# -- process-global switch (the obs.trace idiom) ------------------------
_injector: Optional[FaultInjector] = None


def install(plan: FaultPlan) -> FaultInjector:
    """Arm the chaos harness for this process."""
    global _injector
    _injector = FaultInjector(plan)
    return _injector


def clear() -> Optional[FaultInjector]:
    """Disarm; returns the injector (for its summary())."""
    global _injector
    inj, _injector = _injector, None
    return inj


def get() -> Optional[FaultInjector]:
    return _injector


def enabled() -> bool:
    return _injector is not None


def install_from_env() -> Optional[FaultInjector]:
    """Arm from ``REPRO_FAULT_PLAN`` — inline JSON or a path to it."""
    raw = os.environ.get(ENV_PLAN)
    if not raw:
        return None
    text = raw if raw.lstrip().startswith("{") else \
        open(raw, encoding="utf-8").read()
    return install(FaultPlan.from_json(text))


# Module-level hooks: near-free when no plan is installed (one global
# load + None check), so they sit on the storage hot paths safely.
def hit(site: str, tag: str = ""):
    if _injector is not None:
        _injector.hit(site, tag)


def corrupt(site: str, tag: str = "") -> bool:
    if _injector is not None:
        return _injector.corrupt(site, tag)
    return False


def superstep_tick(superstep: int, driver: str = ""):
    if _injector is not None:
        _injector.superstep_tick(superstep, driver)


def summary() -> Optional[dict]:
    return _injector.summary() if _injector is not None else None
