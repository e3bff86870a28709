"""Failure manager (paper Section 5.7): analyzes failures, blacklists
machines, recovers recoverable errors from the latest checkpoint onto the
surviving partitions; application errors are forwarded to the user.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


class WorkerFailure(RuntimeError):
    """Infrastructure failure (machine power-off / disk IO) — recoverable."""

    def __init__(self, worker: int, msg: str = ""):
        super().__init__(f"worker {worker} failed: {msg}")
        self.worker = worker


def _corruption_types():
    # typed corruption is infrastructure damage (recoverable via a
    # checkpoint restore); lazy import keeps runtime <-> storage acyclic
    from repro_torch.runtime.checkpoint import CheckpointCorruption
    from repro_torch.storage.spillfile import PageCorruption
    return PageCorruption, CheckpointCorruption


@dataclass
class FailureManager:
    n_workers: int
    blacklist: set = field(default_factory=set)
    events: list = field(default_factory=list)
    max_retries: int = 3
    failure_counts: dict = field(default_factory=dict)

    def healthy_workers(self) -> int:
        return self.n_workers - len(self.blacklist)

    def record(self, exc: Exception, worker=None) -> bool:
        """-> True if recoverable (infrastructure), False for application
        errors (forwarded to the user, as in the paper).

        A ``WorkerFailure`` blacklists its worker immediately; any OTHER
        recoverable failure attributable to a worker (the ``worker``
        kwarg, e.g. the sharded driver naming the worker whose store
        faulted) counts against it, and a repeat offender is blacklisted
        after ``max_retries`` recoverable failures — a machine with a
        sick disk must not get an infinite benefit of the doubt."""
        recoverable = isinstance(
            exc, (WorkerFailure, OSError, IOError) + _corruption_types())
        if isinstance(exc, WorkerFailure):
            worker = exc.worker
        self.events.append({"time": time.time(), "error": repr(exc),
                            "recoverable": recoverable, "worker": worker})
        if recoverable and worker is not None:
            self.failure_counts[worker] = \
                self.failure_counts.get(worker, 0) + 1
            if isinstance(exc, WorkerFailure) \
                    or self.failure_counts[worker] >= self.max_retries:
                self.blacklist.add(worker)
        return recoverable

    def run_with_recovery(self, run_fn, restore_fn):
        """run_fn(n_workers) -> result; restore_fn(n_workers) re-shards the
        latest checkpoint onto the surviving workers and returns fresh
        state for run_fn."""
        attempt = 0
        while True:
            try:
                return run_fn(self.healthy_workers())
            except Exception as exc:  # noqa: BLE001
                if not self.record(exc) or attempt >= self.max_retries:
                    raise
                attempt += 1
                if self.healthy_workers() < 1:
                    raise RuntimeError("no healthy workers left") from exc
                restore_fn(self.healthy_workers())


def supervised_run(run_attempt, pick_checkpoint, *, n_workers: int,
                   max_retries: int = 3, initial_resume=None):
    """The drivers' shared recovery supervisor (each driver's
    ``recover=True`` path lands here, on ``run_with_recovery``).

    ``run_attempt(healthy_workers, resume_from)`` runs the job once;
    ``pick_checkpoint(bad)`` returns the newest VALID checkpoint not in
    ``bad`` (or None — restart from the initial relations). On a
    recoverable failure the supervisor re-picks, excluding any snapshot
    whose restore raised typed corruption (the fail-over-to-previous
    rule), and replays; every recovery event is prepended to the final
    ``RunResult.recovery`` so the run report can show the story."""
    corruption = _corruption_types()
    fm = FailureManager(n_workers=n_workers, max_retries=max_retries)
    state = {"resume": initial_resume, "bad": set(), "events": []}

    def attempt(healthy):
        try:
            res = run_attempt(healthy, state["resume"])
        except corruption:
            if state["resume"] is not None:
                # a restore that surfaced corruption taints its snapshot:
                # never select it again, fail over to the previous one
                state["bad"].add(str(state["resume"]))
            raise
        if state["events"]:
            res.recovery[:0] = state["events"]
        return res

    def restore(healthy):
        ck = pick_checkpoint(state["bad"])
        state["resume"] = ck
        state["events"].append({
            "event": "recovery",
            "attempt": len(state["events"]) + 1,
            "error": fm.events[-1]["error"] if fm.events else None,
            "recoverable": True,
            "restored_from": ck,
            "healthy_workers": healthy,
            "blacklist": sorted(fm.blacklist),
            "time": time.time()})

    return fm.run_with_recovery(attempt, restore)


@dataclass
class StragglerMonitor:
    """Per-superstep straggler detection from the statistics collector's
    wall times: flags partitions (BSP steps) slower than k x median."""
    threshold: float = 2.0
    history: list = field(default_factory=list)

    def observe(self, superstep: int, wall_s: float):
        self.history.append(wall_s)
        if len(self.history) < 5:
            return None
        import statistics
        med = statistics.median(self.history[:-1])
        if wall_s > self.threshold * med:
            return {"superstep": superstep, "wall_s": wall_s,
                    "median_s": med, "action": "flag-straggler"}
        return None
