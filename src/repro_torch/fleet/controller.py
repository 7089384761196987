"""Fleet control plane — the shared multi-model scaling policy (a copy
of the reference's ``fleet/controller.py``, imports retargeted).

HydraServe's headline numbers are fleet-level: many models contend for
one GPU pool, and what matters is the *distribution* of cold-start
latency and SLO attainment across them. ``FleetController`` is the one
policy implementation both data planes drive:

  * the discrete-event ``ServerlessSim`` (serving/simulation.py), and
  * the real-engine ``FleetFrontend`` (fleet/frontend.py), whose
    engines are the port's PyTorch engines.

It is deliberately clock-agnostic (every decision takes ``now``) and
holds no data-plane state of its own — hosts pass the live queue /
capacity / at-zero facts in, and get explicit decisions back:

  * ``cold_start_plan``   — demand-driven upscale: how many pipeline
    groups to launch for a model whose queue outruns its in-flight
    capacity, sized by the §6.1 predictor through the
    ``ConsolidationPolicy`` (target-QPS upscale: workers =
    (queue + predicted arrivals) / per-worker capacity).
  * ``keepalive``         — scale-to-zero with *delayed downscale*: the
    idle-reap window stretches while the ``SlidingWindowPredictor``
    still sees demand or the next predicted burst lands inside the
    extension.
  * ``prewarm_due``       — demand-predictive prewarming: per-model
    burst episodes are tracked on top of the sliding-window predictor;
    once a recurrence period is established, a model at zero is
    prewarmed one cold-start-lead before the next predicted episode.
  * ``placement_round``   — Alg. 1 proactive model distribution: the
    demand-ranked hottest models are pre-seeded onto fast fetch tiers
    of chosen servers (``CentralController.plan_distribution`` picks,
    the fleet-wide ``placements`` registry records, the host executes —
    a host-cache fetch in the sim, a ``ModelStore.place`` tier in the
    real data plane). ``preferred_servers`` then biases Alg. 1 scheme
    selection toward the seeded servers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.controller import CentralController

__all__ = ["FleetPolicy", "FleetController", "LaunchPlan",
           "PlacementAction"]


@dataclass
class FleetPolicy:
    """Knobs of the fleet control plane. ``naive()`` turns every
    proactive mechanism off (the scale-by-demand-only baseline);
    ``proactive()`` is the HydraServe-style configuration."""

    keepalive_s: float = 300.0          # base idle window before reap
    downscale_extend_s: float = 0.0     # max extra keep-alive under demand
    prewarm: bool = False               # predictive prewarming on/off
    prewarm_lead_s: Optional[float] = None   # None = auto from profile
    prewarm_min_burst: int = 1          # observed episode size to justify it
    proactive_placement: bool = False   # Alg. 1 model distribution on/off
    placement_top_k: int = 4            # hottest models to pre-seed
    placement_fanout: int = 2           # servers per pre-seeded model
    placement_interval_s: float = 30.0  # distribution rounds cadence
    placement_tier: str = "peer"        # tier name a placement creates
    episode_gap_s: float = 10.0         # arrival gap that splits episodes
    pulse_s: float = 1.0                # host control-loop cadence

    @staticmethod
    def naive(keepalive_s: float = 300.0) -> "FleetPolicy":
        return FleetPolicy(keepalive_s=keepalive_s)

    @staticmethod
    def proactive(keepalive_s: float = 300.0,
                  downscale_extend_s: float = 120.0,
                  **kw) -> "FleetPolicy":
        return FleetPolicy(keepalive_s=keepalive_s,
                           downscale_extend_s=downscale_extend_s,
                           prewarm=True, proactive_placement=True, **kw)


@dataclass
class _Demand:
    """Per-model burst bookkeeping layered over the sliding window: the
    predictor says *how much* demand a window held, episodes say *when*
    the next burst should land."""
    last_arrival: float = -math.inf
    episode_start: float = -math.inf
    episode_size: int = 0
    last_episode_size: int = 0
    period_ema: Optional[float] = None
    n_episodes: int = 0
    total: int = 0


@dataclass(frozen=True)
class LaunchPlan:
    """One model's scaling decision for this tick."""
    model: str
    n_groups: int           # pipeline groups to cold-start now
    mode: str               # consolidation mode for them: down|up|none
    reason: str             # demand | prewarm

    def __bool__(self) -> bool:
        return self.n_groups > 0


@dataclass(frozen=True)
class PlacementAction:
    """Pre-seed ``model`` onto ``server_id``'s ``tier`` (host executes)."""
    model: str
    server_id: str
    tier: str


class FleetController:
    """Shared fleet scaling policy over a ``CentralController``. One
    instance per cluster; both the sim and the real frontend consult it
    so there is exactly one implementation of the scaling logic."""

    def __init__(self, central: CentralController,
                 policy: Optional[FleetPolicy] = None):
        self.central = central
        self.policy = policy or FleetPolicy()
        self._demand: Dict[str, _Demand] = {}
        self._last_placement = -math.inf
        self._last_prewarm: Dict[str, float] = {}

    # ------------------------------------------------------- demand signal
    def record_arrival(self, model: str, now: float):
        """Feed one request arrival: the sliding-window predictor gets the
        sample and the episode tracker updates its period estimate."""
        self.central.record_request(model, now)
        d = self._demand.setdefault(model, _Demand())
        d.total += 1
        if now - d.last_arrival > self.policy.episode_gap_s:
            if math.isfinite(d.episode_start):
                period = now - d.episode_start
                d.period_ema = period if d.period_ema is None else \
                    0.5 * d.period_ema + 0.5 * period
            d.n_episodes += 1
            d.last_episode_size = d.episode_size
            d.episode_size = 0
            d.episode_start = now
        d.episode_size += 1
        d.last_arrival = now

    def predicted_next_episode(self, model: str,
                               now: float) -> Optional[float]:
        """Next burst instant from the episode period (None until two
        episodes established a period). Missed predictions roll forward
        whole periods so the estimate never trails ``now``."""
        d = self._demand.get(model)
        if d is None or d.period_ema is None or d.period_ema <= 0:
            return None
        k = max(1, math.ceil((now - d.episode_start) / d.period_ema))
        return d.episode_start + k * d.period_ema

    def demand_rank(self, now: float) -> List[str]:
        """Models ranked hottest-first: trailing-window arrivals, then
        last burst size, then lifetime volume (deterministic tiebreak by
        name)."""
        def key(item):
            name, d = item
            window = self.central.predictor.predicted_next_window(name, now)
            return (-window, -max(d.last_episode_size, d.episode_size),
                    -d.total, name)
        ranked = sorted(self._demand.items(), key=key)
        return [name for name, d in ranked if d.total > 0]

    # -------------------------------------------------- scaling decisions
    def cold_start_plan(self, model: str, queue_len: int, capacity: int,
                        current: int, now: float,
                        reason: str = "demand") -> LaunchPlan:
        """Demand-driven upscale: nothing while in-flight capacity covers
        the queue; otherwise the §6.1 consolidation policy sizes the
        launch (scale-up bursts create several groups at once)."""
        if queue_len == 0 or queue_len <= capacity:
            return LaunchPlan(model, 0, "none", reason)
        plan = self.central.consolidation_plan(model, queue_len, now,
                                               current)
        n = max(1, len(plan.group_sizes)) if plan.mode == "up" else 1
        return LaunchPlan(model, n, plan.mode, reason)

    def keepalive(self, model: str, now: float) -> float:
        """Idle window before an endpoint is reaped to zero. Delayed
        downscale: while the predictor still sees demand, or the next
        predicted episode lands within the extension, the window
        stretches (never beyond ``keepalive_s + downscale_extend_s``)."""
        base = self.policy.keepalive_s
        extend = self.policy.downscale_extend_s
        if extend <= 0:
            return base
        cap = base + extend
        want = base
        if self.central.predictor.predicted_next_window(model, now) > 0:
            want = cap
        nxt = self.predicted_next_episode(model, now)
        if nxt is not None and now < nxt:
            want = max(want, (nxt - now) + self.policy.pulse_s)
        return min(want, cap)

    def _prewarm_lead(self, model: str) -> float:
        """How early to launch a prewarm: the expected cold-start span
        (runtime init + the widest pipeline's per-stage fetch on the
        fattest NIC), unless the policy pins a lead."""
        if self.policy.prewarm_lead_s is not None:
            return self.policy.prewarm_lead_s
        prof = self.central.models.get(model)
        if prof is None:
            return 10.0
        nic = max(s.nic_bytes_per_s for s in self.central.servers.values())
        return prof.timings.t_c + prof.size_bytes / max(prof.max_pp, 1) / nic

    def prewarm_due(self, now: float,
                    at_zero: Callable[[str], bool]) -> List[LaunchPlan]:
        """Predictive prewarming: models currently scaled to zero whose
        next predicted episode is within one cold-start lead get a
        single proactive group each. ``at_zero`` is the host's truth
        about the data plane (no replicas live or starting)."""
        if not self.policy.prewarm:
            return []
        out: List[LaunchPlan] = []
        for model, d in self._demand.items():
            if d.n_episodes < 2 or not at_zero(model):
                continue
            if max(d.last_episode_size, d.episode_size) \
                    < self.policy.prewarm_min_burst:
                continue
            nxt = self.predicted_next_episode(model, now)
            if nxt is None:
                continue
            # stale pattern: a predicted episode came and went with no
            # arrivals — stop prewarming until traffic re-establishes it
            if now - d.last_arrival > 1.5 * d.period_ema:
                continue
            lead = self._prewarm_lead(model)
            if not (nxt - lead <= now <= nxt + lead):
                continue
            # one prewarm per predicted episode: a reaped prewarm must not
            # refire for the same prediction
            if self._last_prewarm.get(model, -math.inf) >= nxt - lead:
                continue
            self._last_prewarm[model] = now
            out.append(LaunchPlan(model, 1, "down", "prewarm"))
        return out

    # ------------------------------------------------ proactive placement
    def placement_round(self, now: float) -> List[PlacementAction]:
        """Alg. 1 proactive model distribution, one round per interval:
        rank models by demand, let the central controller spread the top
        K over placement targets, record the seedings fleet-wide, and
        hand the new ones to the host to execute."""
        if not self.policy.proactive_placement:
            return []
        if now - self._last_placement < self.policy.placement_interval_s:
            return []
        self._last_placement = now
        ranked = self.demand_rank(now)[: self.policy.placement_top_k]
        new = self.central.plan_distribution(ranked,
                                             self.policy.placement_fanout)
        tier = self.policy.placement_tier
        for model, sid in new:
            self.central.record_placement(model, sid, tier=tier)
        return [PlacementAction(model, sid, tier) for model, sid in new]

    def preferred_servers(self, model: str) -> List[str]:
        """Placement-aware cold-start bias: the servers this model is
        pre-seeded on (pass as ``plan_cold_start(prefer=...)``)."""
        return self.central.placed_servers(model)
