"""Mid-run replanning — the port's copy of ``repro.planner.adaptive``.

At each superstep boundary ``run_host`` feeds the latest
``SuperstepStats`` record to an ``AdaptiveController``. When the observed
frontier density pushes a different plan below the current one in the
cost model — by a hysteresis margin, for ``patience`` consecutive
supersteps, and outside a post-switch ``cooldown`` — the controller
proposes the switch. The driver then migrates the in-flight ``MsgRel`` to
the layout the new plan's receiver expects (``migrate_msgs``) and builds
the new superstep. Hysteresis keeps switches amortized: a switch only
pays off over many supersteps, so noisy density estimates never thrash.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core.plan import PhysicalPlan
from repro_torch.core.relations import MsgRel
from repro_torch.obs import explain
from repro_torch.planner.cost import (H100_MACHINE, GraphStats,
                                      MachineModel, Observation, estimate)
from repro_torch.planner.optimizer import choose, rank
from repro_torch.planner.stats import SuperstepStats

INT32_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class AdaptiveConfig:
    margin: float = 0.2      # candidate must model >=20% faster to switch
    patience: int = 2        # consecutive supersteps preferring it
    cooldown: int = 3        # min supersteps between switches
    min_superstep: int = 1   # never switch before this superstep
    # one-shot startup calibration: measure probe supersteps with the
    # operator counter and refit the cost model's analytic constants
    # before picking the initial plan (cost.calibrate_machine; cached per
    # device type and combine op)
    calibrate: bool = False
    # periodic re-calibration (requires calibrate=True): after a regrow /
    # frontier refit / plan switch changed the superstep's shapes
    # (drivers call note_shape_change), refit at most once per this many
    # supersteps. 0 = off.
    recalibrate_every: int = 0
    # EWMA smoothing factor for the measured readiness stall (the serial
    # inter-superstep leg, Observation.serial_scale). 0 = loop open.
    stall_alpha: float = 0.3


# the measured-stall calibration multiplier is clamped: one outlier
# superstep must not flip the plan ranking
_SCALE_MIN, _SCALE_MAX = 0.125, 8.0


class AdaptiveController:
    """Tracks the current plan and decides switches from observed stats."""

    def __init__(self, program, g: GraphStats, plan: PhysicalPlan,
                 config: AdaptiveConfig = AdaptiveConfig(), *,
                 machine: MachineModel = H100_MACHINE,
                 space_kw: Optional[dict] = None):
        self.program = program
        self.g = g
        self.plan = plan
        self.config = config
        self.machine = machine
        self.space_kw = space_kw or {}
        self.switches: list = []     # (superstep, old_plan, new_plan)
        self._want: Optional[PhysicalPlan] = None
        self._streak = 0
        self._last_switch = -10 ** 9
        self._shapes_dirty = False   # a regrow/refit/switch changed shapes
        self._last_recal = -10 ** 9  # superstep of the last refit
        self._stall_ewma: Optional[float] = None  # measured serial leg
        self._exchange_ewma: Optional[float] = None  # measured net leg

    # ---- hysteresis persistence (checkpoint metadata) -----------------
    def state_dict(self) -> dict:
        """The mutable decision state a checkpoint must carry so a
        resume right before a pending switch does not re-pay the
        patience window: the candidate plan, its streak, and the
        cooldown clock. The same keys as the reference's."""
        return {
            "want": dataclasses.asdict(self._want)
            if self._want is not None else None,
            "streak": int(self._streak),
            "last_switch": int(self._last_switch),
            "last_recal": int(self._last_recal),
            "shapes_dirty": bool(self._shapes_dirty),
            "stall_ewma": (float(self._stall_ewma)
                           if self._stall_ewma is not None else None),
            "exchange_ewma": (float(self._exchange_ewma)
                              if self._exchange_ewma is not None
                              else None),
        }

    def load_state(self, state: dict):
        if not state:
            return
        want = state.get("want")
        self._want = PhysicalPlan.from_dict(want) if want else None
        self._streak = int(state.get("streak", 0))
        self._last_switch = int(state.get("last_switch", -10 ** 9))
        self._last_recal = int(state.get("last_recal", -10 ** 9))
        # a pending recalibration must survive the resume
        self._shapes_dirty = bool(state.get("shapes_dirty", False))
        ewma = state.get("stall_ewma")
        self._stall_ewma = float(ewma) if ewma is not None else None
        xe = state.get("exchange_ewma")
        self._exchange_ewma = float(xe) if xe is not None else None

    # ---- periodic re-calibration -------------------------------------
    def note_shape_change(self):
        """Drivers call this on regrow / frontier refit / plan switch:
        the superstep's shapes changed, so the fitted analytic constants
        may be stale."""
        self._shapes_dirty = True

    def maybe_recalibrate(self, program, superstep: int):
        """Re-run ``cost.calibrate_machine`` when (a) calibration is on,
        (b) ``recalibrate_every`` is set, (c) a shape change was noted
        since the last fit, and (d) at least ``recalibrate_every``
        supersteps passed since then. Updates ``self.machine`` and
        returns the refit constants (for the drivers' event stream),
        else None."""
        cfg = self.config
        if not (cfg.calibrate and cfg.recalibrate_every > 0
                and self._shapes_dirty
                and superstep - self._last_recal >= cfg.recalibrate_every):
            return None
        from repro_torch.planner.cost import calibrate_machine
        self.machine = calibrate_machine(program, self.g, self.machine,
                                         refresh=True)
        self._shapes_dirty = False
        self._last_recal = superstep
        constants = {"k_compute": self.machine.k_compute,
                     "k_scatter": self.machine.k_scatter,
                     "sort_pass_frac": self.machine.sort_pass_frac}
        if explain.enabled():
            explain.decision(superstep, "recalibrate", **constants)
        return constants

    def _update_stall_ewma(self, rec: SuperstepStats):
        """Fold a steady superstep's measured readiness stall into the
        EWMA. Supersteps that rebuilt the superstep (``recompiled``) and
        records that never measured a stall are skipped."""
        if rec.recompiled or "readiness_stall_s" not in rec.extra:
            return
        stall = float(rec.extra["readiness_stall_s"])
        a = self.config.stall_alpha
        if a <= 0.0:
            return
        if self._stall_ewma is None:
            self._stall_ewma = stall
        else:
            self._stall_ewma = a * stall + (1.0 - a) * self._stall_ewma

    def _update_exchange_ewma(self, rec: SuperstepStats):
        """Network-axis mirror of ``_update_stall_ewma`` (the sharded
        driver's ``exchange_stall_s``)."""
        if rec.recompiled or "exchange_stall_s" not in rec.extra:
            return
        a = self.config.stall_alpha
        if a <= 0.0:
            return
        stall = float(rec.extra["exchange_stall_s"])
        if self._exchange_ewma is None:
            self._exchange_ewma = stall
        else:
            self._exchange_ewma = (a * stall +
                                   (1.0 - a) * self._exchange_ewma)

    def _make_observation(self, rec: SuperstepStats, *,
                          bucket_cap: int = 0) -> Observation:
        """Lift a stats record into the cost model's ``Observation``:
        the frontier density and messages, plus what out-of-core and
        sharded drivers annotate in ``extra`` (change density,
        combinability, mutation rate, disk tier, exchange). When a stall
        or exchange EWMA has accumulated, the serial or net leg gets a
        measured multiplier: EWMA / the CURRENT plan's analytic leg,
        clamped, applied to every candidate."""
        obs = Observation(frontier_density=rec.frontier_density,
                          messages=rec.messages, superstep=rec.superstep,
                          bucket_cap=bucket_cap,
                          change_density=rec.extra.get(
                              "change_density", 1.0),
                          ooc=bool(rec.extra.get("ooc", False)),
                          streaming=bool(rec.extra.get("streaming",
                                                       False)),
                          barrier_free=bool(rec.extra.get("barrier_free",
                                                          False)),
                          super_partitions=int(rec.extra.get(
                              "super_partitions", 1)),
                          readiness_stall_s=float(rec.extra.get(
                              "readiness_stall_s", 0.0)),
                          io_queue_depth=float(rec.extra.get(
                              "io_queue_depth", 0.0)),
                          combinability=max(
                              float(rec.extra.get("combinability", 1.0)),
                              1.0),
                          mutation_rate=float(
                              rec.extra.get("mutation_rate", 0.0)),
                          spilling=bool(rec.extra.get("spill", False)),
                          hit_rate=float(rec.extra.get("cache_hit_rate",
                                                       1.0)),
                          sharded=bool(rec.extra.get("sharded", False)),
                          n_workers=int(rec.extra.get("n_workers", 1)),
                          exchange_bytes=float(rec.extra.get(
                              "exchange_bytes", 0.0)),
                          exchange_stall_s=float(rec.extra.get(
                              "exchange_stall_s", 0.0)))
        if self._exchange_ewma is not None and obs.sharded:
            cur_net = estimate(self.plan, self.g, obs,
                               self.machine).net_seconds
            if cur_net > 0.0:
                scale = self._exchange_ewma / cur_net
                scale = min(max(scale, _SCALE_MIN), _SCALE_MAX)
                obs = dataclasses.replace(
                    obs, net_scale=scale,
                    exchange_ewma_s=self._exchange_ewma)
        if self._stall_ewma is not None and obs.ooc:
            cur_serial = estimate(self.plan, self.g, obs,
                                  self.machine).serial_seconds
            if cur_serial > 0.0:
                scale = self._stall_ewma / cur_serial
                scale = min(max(scale, _SCALE_MIN), _SCALE_MAX)
                obs = dataclasses.replace(obs, serial_scale=scale,
                                          stall_ewma_s=self._stall_ewma)
        return obs

    def observe(self, rec: SuperstepStats, *,
                bucket_cap: int = 0) -> Optional[PhysicalPlan]:
        """Returns the new plan when a switch is warranted, else None.
        On a switch the controller's own `plan` is already updated.
        `bucket_cap` = the engine's live bucket capacity, flooring every
        candidate's modeled message capacity (buckets only grow)."""
        cfg = self.config
        self._update_stall_ewma(rec)
        self._update_exchange_ewma(rec)
        obs = self._make_observation(rec, bucket_cap=bucket_cap)
        ranked = rank(self.program, self.g, obs,
                      base=self.plan, machine=self.machine,
                      **self.space_kw)
        best, best_cost = ranked[0]
        cur_s = estimate(self.plan, self.g, obs,
                         self.machine).seconds(self.machine)
        if best == self.plan or \
                cur_s <= best_cost.seconds(self.machine) * (1 + cfg.margin):
            self._want, self._streak = None, 0
            return None
        if best != self._want:
            self._want, self._streak = best, 1
        else:
            self._streak += 1
        if (self._streak >= cfg.patience
                and rec.superstep >= cfg.min_superstep
                and rec.superstep - self._last_switch >= cfg.cooldown):
            old = self.plan
            self.plan = best
            self._last_switch = rec.superstep
            self._want, self._streak = None, 0
            self.switches.append((rec.superstep, old, best))
            if explain.enabled():
                # the losing candidates' prices: the full table the
                # controller just ranked, under the same observation
                from repro_torch.obs.progress import fmt_plan
                explain.decision(
                    rec.superstep, "replan",
                    **{"from": fmt_plan(old)}, to=fmt_plan(best),
                    current_s=float(cur_s),
                    candidates=[{"plan": fmt_plan(p),
                                 "seconds": float(c.seconds(self.machine))}
                                for p, c in ranked])
            return best
        return None


def migrate_msgs(msg: MsgRel, old_plan: PhysicalPlan,
                 new_plan: PhysicalPlan, n_parts: int) -> MsgRel:
    """Migrate in-flight messages between connector layouts.

    The merging connector's receiver treats the message relation as
    n_parts presorted runs; messages produced under the plain
    partitioning connector (without a sender combine, which also leaves
    dst ascending) are unsorted within each run. Sorting each run once
    (a stable sort by dst, invalid rows last) is the one-off cost of the
    switch. No-op when the new receiver has no order assumption or the
    capacity is not run-structured."""
    needs_runs = new_plan.connector == "partitioning_merging"
    already = (old_plan.connector == "partitioning_merging"
               or old_plan.sender_combine)
    if not needs_runs or already or msg.capacity % n_parts:
        return msg
    P, cap = msg.dst.shape
    C = cap // n_parts
    key = torch.where(msg.valid, msg.dst, INT32_MAX).reshape(P, n_parts, C)
    order = torch.argsort(key, dim=-1, stable=True)

    def take(a):
        a = a.reshape((P, n_parts, C) + a.shape[2:])
        idx = order if a.dim() == 3 else \
            order[..., None].expand(*order.shape, a.shape[3])
        return torch.gather(a, 2, idx).reshape((P, cap) + a.shape[3:])

    return MsgRel(dst=take(msg.dst), payload=take(msg.payload),
                  valid=take(msg.valid))


def resolve_auto_plan(vert, program, *,
                      base: Optional[PhysicalPlan] = None,
                      adaptive: bool = True,
                      config: AdaptiveConfig = AdaptiveConfig(),
                      machine: MachineModel = H100_MACHINE,
                      space_kw: Optional[dict] = None,
                      g: Optional[GraphStats] = None,
                      obs0: Optional[Observation] = None,
                      ) -> Tuple[PhysicalPlan, Optional[AdaptiveController]]:
    """Entry point for drivers' ``plan="auto"``: pick the initial plan for
    superstep 0 (Pregel activates EVERY vertex, so density starts at 1.0)
    and, when `adaptive`, the controller that re-chooses mid-run. ``g``
    supplies the graph statistics when the caller has them already.
    ``obs0`` overrides the superstep-0 observation: the sharded driver
    passes sharded=True / n_workers so the INITIAL pick already prices
    the network axis."""
    if base is not None and base.frontier_capacity != 1.0:
        # superstep 0 must cover all vertices under left-outer
        base = dataclasses.replace(base, frontier_capacity=1.0)
    if g is None:
        g = GraphStats.from_vertex(vert, program)
    plan, _ = choose(program, g,
                     obs0 or Observation(frontier_density=1.0),
                     base=base, machine=machine, **(space_kw or {}))
    if not adaptive:
        return plan, None
    return plan, AdaptiveController(program, g, plan, config,
                                    machine=machine, space_kw=space_kw)
