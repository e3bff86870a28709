"""Plan-audit ledger: per-superstep predicted-vs-measured cost accounting
— the port's copy of ``repro.obs.explain``.

The planner prices every candidate plan (``PlanCost.terms`` /
``PlanCost.detail``) and the runtime measures every pipeline leg (span
timers, exchange counters) — but until now nothing joined the two beyond
the two scalar EWMA closures (``Observation.serial_scale`` /
``net_scale``).  This module closes the audit gap: when enabled, drivers
feed each superstep's stats record through :func:`superstep`, which
re-prices the IN-EFFECT plan under the same ``Observation`` the adaptive
controller would build and joins the per-term predicted seconds against
the measured leg times of the same superstep.

The join is leg-granular, not term-granular — measured timers cover
pipeline legs (the device step, the host dispatch+commit, the serial
inbox rebuild, the exchange stage, the spill tier), each of which
aggregates one or more model terms:

=================  =============================================  =============================
leg                model terms                                    measured from
=================  =============================================  =============================
``device``         recv_groupby join_compute send sender_combine  ``collect_wait_s`` (OOC) or
                   connector exchange                             wall minus exchange stall
``host_io``        stream_io storage_writeback mutation_io        ``dispatch_s + commit_s``
``serial``         inbox_rebuild                                  ``readiness_stall_s``
``net``            exchange_net                                   ``exchange_stall_s``
``disk``           disk_io                                        spill bytes / disk bandwidth
=================  =============================================  =============================

Per-leg drift is the absolute log-ratio ``|ln((measured+eps) /
(predicted+eps))|`` — scale-free, symmetric in over/under-prediction,
and always finite; a row's ``drift_score`` is the mean over the legs the
run actually measured.  Terms whose leg has no measurement (e.g. the
disk leg of an in-memory run) stay in the predicted table but are
excluded from the join.

The ledger also keeps a decision log: every ``AdaptiveController``
replan carries the full candidate price table it chose from (the losing
candidates' prices), and every recalibration carries the refit
constants.  Static-plan runs get a SHADOW controller — constructed at
:func:`attach`, it reuses the controller's observation builder and EWMA
closures but never switches plans, so audit rows price exactly what ran.

Mirrors the tracer's module API: ``start()`` / ``stop()`` / ``get()`` /
``enabled()``; every record call is a no-op returning ``None`` while
disabled, so the hot path pays one predicate when audit is off.
"""
from __future__ import annotations

import math
from typing import Optional

_EPS = 1e-6

#: model term -> measured pipeline leg
TERM_LEG = {
    "recv_groupby": "device",
    "join_compute": "device",
    "send": "device",
    "sender_combine": "device",
    "connector": "device",
    "exchange": "device",
    "stream_io": "host_io",
    "storage_writeback": "host_io",
    "mutation_io": "host_io",
    "inbox_rebuild": "serial",
    "exchange_net": "net",
    "disk_io": "disk",
}

LEGS = ("device", "host_io", "serial", "net", "disk")

DECISION_KINDS = ("replan", "recalibrate")


def drift(predicted_s: float, measured_s: float) -> float:
    """Absolute log-ratio drift between a predicted and a measured time:
    0 = perfect, ~0.69 = off by 2x either way. Finite by construction."""
    return abs(math.log((measured_s + _EPS) / (predicted_s + _EPS)))


def measured_legs(rec, machine) -> dict:
    """Measured seconds per pipeline leg, lifted from a stats record.

    Only legs the run actually measured appear; the device leg always
    does (every driver measures wall time)."""
    ex = rec.extra
    legs = {}
    if "collect_wait_s" in ex:
        legs["device"] = float(ex["collect_wait_s"])
    else:
        dev = float(rec.wall_s)
        if "exchange_stall_s" in ex:
            dev = max(dev - float(ex["exchange_stall_s"]), 0.0)
        legs["device"] = dev
    if "dispatch_s" in ex or "commit_s" in ex:
        legs["host_io"] = (float(ex.get("dispatch_s", 0.0)) +
                           float(ex.get("commit_s", 0.0)))
    if "readiness_stall_s" in ex:
        legs["serial"] = float(ex["readiness_stall_s"])
    if "exchange_stall_s" in ex:
        legs["net"] = float(ex["exchange_stall_s"])
    if "spill_read_bytes" in ex or "spill_write_bytes" in ex:
        spill = (float(ex.get("spill_read_bytes", 0.0)) +
                 float(ex.get("spill_write_bytes", 0.0)))
        legs["disk"] = spill / machine.disk_bw
    return legs


class ExplainLedger:
    """Per-run audit state: superstep rows + the decision log.

    ``attach`` binds the run context (program / graph statistics /
    machine model / initial plan); until it is called, ``superstep``
    records nothing — e.g. an OOC resume from a bare spill directory has
    no vertex relation to derive statistics from."""

    def __init__(self):
        self.rows: list = []
        self.decisions: list = []
        self._auditor = None     # shadow AdaptiveController
        self._g = None

    # ---- run context -------------------------------------------------
    def attach(self, program, *, vert=None, g=None, plan=None,
               machine=None, config=None, space_kw=None):
        """Bind the run context. ``g`` wins over ``vert``; with neither
        the ledger stays decision-log-only. Safe to call once per run;
        a second call rebinds (drivers that resolve plans twice).
        ``machine`` defaults to the machine model of ``vert``'s device
        (``planner.cost.machine_for``), else ``H100_MACHINE``."""
        if plan is None:
            return None
        from repro_torch.planner.adaptive import (AdaptiveConfig,
                                                  AdaptiveController)
        from repro_torch.planner.cost import (H100_MACHINE, GraphStats,
                                              machine_for)
        if g is None:
            if vert is None:
                return None
            g = GraphStats.from_vertex(vert, program)
        if machine is None:
            machine = (machine_for(vert.vid.device) if vert is not None
                       else H100_MACHINE)
        self._g = g
        self._auditor = AdaptiveController(
            program, g, plan, config or AdaptiveConfig(),
            machine=machine, space_kw=space_kw or {})
        return self

    # ---- per-superstep audit row -------------------------------------
    def superstep(self, rec, *, plan=None, bucket_cap: int = 0):
        """Price the in-effect ``plan`` under this record's observation
        and join predicted terms against the measured legs. Returns the
        appended row, or None when unattached / on an event record.

        The audit layer must never take a run down: any modeling failure
        is recorded as an ``error`` row instead of raised."""
        aud = self._auditor
        if aud is None or getattr(rec, "event", None) is not None:
            return None
        try:
            from repro_torch.obs.progress import fmt_plan
            from repro_torch.planner.cost import estimate
            if plan is not None:
                aud.plan = plan        # shadow tracks the live plan
            plan = aud.plan
            aud._update_stall_ewma(rec)
            aud._update_exchange_ewma(rec)
            obs = aud._make_observation(rec, bucket_cap=bucket_cap)
            cost = estimate(plan, self._g, obs, aud.machine)
            machine = aud.machine
            predicted = {}
            for term, secs in cost.terms.items():
                d = {k: float(v)
                     for k, v in cost.detail.get(term, {}).items() if v}
                d["seconds"] = float(secs)
                d["leg"] = TERM_LEG.get(term, "device")
                predicted[term] = d
            leg_pred = {
                "device": cost.device_seconds(machine),
                "host_io": cost.host_seconds(machine),
                "serial": cost.serial_seconds,
                "net": cost.net_seconds,
                "disk": cost.disk_seconds(machine),
            }
            measured = measured_legs(rec, machine)
            legs, drifts = {}, []
            for leg in LEGS:
                pred = float(leg_pred.get(leg, 0.0))
                if leg not in measured:
                    continue    # leg never measured: excluded from join
                meas = float(measured[leg])
                d = drift(pred, meas)
                legs[leg] = {"predicted_s": pred, "measured_s": meas,
                             "drift": d}
                drifts.append(d)
            row = {
                "superstep": int(rec.superstep),
                "plan": fmt_plan(plan),
                "recompiled": bool(rec.recompiled),
                "predicted": predicted,
                "predicted_total_s": float(cost.seconds(machine)),
                "measured_wall_s": float(rec.wall_s),
                "legs": legs,
                "drift_score": (sum(drifts) / len(drifts)
                                if drifts else 0.0),
            }
        except Exception as e:  # pragma: no cover - defensive
            row = {"superstep": int(getattr(rec, "superstep", -1)),
                   "error": f"{type(e).__name__}: {e}"}
        self.rows.append(row)
        return row

    # ---- decision log ------------------------------------------------
    def decision(self, superstep: int, kind: str, **info):
        """Append a controller decision (``replan`` with its candidate
        price table, or ``recalibrate`` with the refit constants)."""
        d = {"superstep": int(superstep), "kind": str(kind)}
        d.update(info)
        self.decisions.append(d)
        return d

    def as_dict(self) -> dict:
        return {"supersteps": list(self.rows),
                "decisions": list(self.decisions)}


# ---- module-level switch (mirrors obs.trace) -------------------

_LEDGER: Optional[ExplainLedger] = None


def start() -> ExplainLedger:
    """Install a fresh ledger; subsequent driver hooks record into it."""
    global _LEDGER
    _LEDGER = ExplainLedger()
    return _LEDGER


def stop() -> Optional[ExplainLedger]:
    """Uninstall and return the active ledger (None if none)."""
    global _LEDGER
    led, _LEDGER = _LEDGER, None
    return led


def get() -> Optional[ExplainLedger]:
    return _LEDGER


def enabled() -> bool:
    return _LEDGER is not None


def attach(program, **kw):
    """Fire-and-forget context bind — None when auditing is off."""
    led = _LEDGER
    return led.attach(program, **kw) if led is not None else None


def superstep(rec, **kw):
    """Fire-and-forget audit row — None when auditing is off."""
    led = _LEDGER
    return led.superstep(rec, **kw) if led is not None else None


def decision(superstep_, kind, **info):
    """Fire-and-forget decision note — None when auditing is off."""
    led = _LEDGER
    return (led.decision(superstep_, kind, **info)
            if led is not None else None)
