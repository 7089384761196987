"""The real-engine fleet data plane: N models, one shared pool (a port of
the reference's ``fleet/frontend.py``).

``FleetFrontend`` is what the single-model ``ServerlessFrontend`` grew
into — a multi-model cluster frontend whose *decisions* all come from
the shared ``FleetController`` (fleet/controller.py) and whose *data
plane* is the real one: every cold start streams stage parameters out
of the model's ``ModelStore`` through the cluster-shared
``FetchSchedule`` (concurrent launches on one server contend per
Alg. 2), engines are the port's PyTorch engines on the frontend's device
(the card unless the caller passes ``device="cpu"``), and scale-to-zero
round trips are bit-exact because a re-started endpoint reads the same
bytes the first one did.

Time is the simulated cold-start clock the store data plane already
uses: callers drive a trace through ``advance(now)`` / ``submit(...)``
/ ``pump(now)``, and the frontend executes reaps, prewarms and
placement rounds at the policy's pulse cadence. Engine *compute* is
treated as instantaneous on that clock (the real forward passes run at
wall speed); TTFT estimates combine the measured cold-start wait with
the profile's analytic prefill term, matching the discrete-event sim's
convention.

Lifecycle of a managed model:

    zero --(demand/prewarm launch)--> starting --(timeline.ready)-->
    active --(idle past FleetController.keepalive)--> zero

Requests submitted while ``starting`` queue on the frontend and flush
into the engine the moment the measured timeline says the endpoint is
ready; requests finding a ready endpoint are served warm.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import CentralController
from repro_torch.core.types import ModelProfile, ServerSpec
from repro_torch.fleet.controller import (FleetController, FleetPolicy,
                                          LaunchPlan)
from repro_torch.models.model import Model
from repro_torch.router import KVBlockStore, Router
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import (PendingColdStart,
                                          ServerlessFrontend,
                                          ServingEndpoint)
from repro_torch.store.store import ModelStore, PEER_BW, REMOTE_BW

__all__ = ["FleetFrontend", "FleetRequest", "ManagedModel"]


@dataclass
class FleetRequest:
    """One fleet request and how it fared."""
    rid: int
    model: str
    prompt: Sequence[int]
    params: Optional[SamplingParams]
    arrival: float
    wait: Optional[float] = None        # queued seconds until an engine
    ttft: Optional[float] = None        # wait + analytic prefill estimate
    slo_ok: Optional[bool] = None
    cold: bool = False                  # arrived with no ready endpoint
    output: Optional[List[int]] = None  # generated token ids (real engine)
    replica: Optional[str] = None       # routed endpoint (KV-aware router)
    cached_tokens: int = 0              # prompt prefix served from KV cache
    restored_tokens: int = 0            # ...of which restored from a tier
    restore_seconds: float = 0.0        # modeled restore transfer time


@dataclass
class _Slot:
    """One live endpoint of a model (a replica)."""
    endpoint: ServingEndpoint
    ready_at: float
    mode: str                           # consolidation mode: down|up|none
    reason: str                         # demand | prewarm
    idle_since: Optional[float] = None
    consolidated: bool = False
    name: str = ""                      # stable replica id (router key)


@dataclass
class ManagedModel:
    name: str
    cfg: ModelConfig
    profile: ModelProfile
    base_tier: str                      # authoritative (slowest) tier
    engine_kw: dict
    slots: List[_Slot] = field(default_factory=list)
    queue: Deque[FleetRequest] = field(default_factory=collections.deque)
    router: Optional[Router] = None     # KV-aware replica routing, if on
    kv_tier: Optional[KVBlockStore] = None   # shared spill/restore tiers
    n_launched: int = 0                 # replica name counter

    @property
    def state(self) -> str:
        if not self.slots:
            return "zero"
        return "active" if any(s.ready_at is not None for s in self.slots) \
            else "starting"

    def ready_slots(self, now: float) -> List[_Slot]:
        return [s for s in self.slots if s.ready_at <= now]


class FleetFrontend:
    """Multi-model cluster frontend over one shared server pool. All
    scaling decisions come from the shared ``FleetController``; all
    cold-start bytes move through the per-model ``ModelStore``s on the
    one cluster ``FetchSchedule``. Every engine runs on ``device``
    (default: the card)."""

    def __init__(self, servers: Union[Dict[str, ServerSpec],
                                      Sequence[ServerSpec]],
                 policy: Optional[FleetPolicy] = None,
                 controller: Optional[CentralController] = None,
                 source_bw: float = REMOTE_BW,
                 placement_bw: float = PEER_BW,
                 device=None, **controller_kw):
        if not isinstance(servers, dict):
            servers = {s.server_id: s for s in servers}
        self.frontend = ServerlessFrontend(servers, controller,
                                           device=device, **controller_kw)
        self.central = self.frontend.controller
        self.fleet = FleetController(self.central, policy)
        self.policy = self.fleet.policy
        self.source_bw = float(source_bw)
        self.placement_bw = float(placement_bw)
        self.models: Dict[str, ManagedModel] = {}
        self.requests: List[FleetRequest] = []
        self.cold_start_log: List[dict] = []
        self.placement_log: List[dict] = []
        self.now = 0.0
        self._rid = 0
        self._last_pulse = 0.0

    # ----------------------------------------------------------- registry
    def register(self, cfg: ModelConfig, profile: ModelProfile, *,
                 params: Optional[dict] = None,
                 store: Optional[ModelStore] = None,
                 store_dir: Optional[str] = None,
                 routing: Optional[str] = None,
                 kv_tier_blocks: Optional[int] = None,
                 routing_kw: Optional[dict] = None,
                 **engine_kw) -> ManagedModel:
        """Register a model with the fleet, starting at zero replicas.
        ``params`` chunks the live tree behind a ``source_bw``-limited
        tier (the 'remote registry' a never-distributed model fetches
        from); ``store``/``store_dir`` follow ``ServerlessFrontend.deploy``
        — including the cold-deploy path (``params=None`` with an
        existing on-disk store).

        ``routing`` turns on the KV-aware routing subsystem for this
        model: a per-model ``Router`` (policy name or instance,
        ``routing_kw`` forwarded to it) over a shared ``KVBlockStore``
        whose host tier holds at most ``kv_tier_blocks`` live blocks
        (``None`` = unbounded) before demoting to the segment tier.
        Routed models are forced paged + prefix-cached so evicted
        blocks spill instead of vanishing."""
        if store is None and params is not None and store_dir is None:
            store = ModelStore.from_params(Model(cfg), params,
                                           bandwidth=self.source_bw)
        store = self.frontend.deploy(cfg, params, profile, store=store,
                                     store_dir=store_dir)
        base = min(store.tiers, key=lambda t: t.bandwidth).name
        mm = ManagedModel(profile.name, cfg, profile, base, dict(engine_kw))
        if routing is not None:
            server0 = next(iter(self.frontend.servers), "local")
            mm.kv_tier = KVBlockStore(
                self.frontend.schedule, server0,
                host_capacity_blocks=kv_tier_blocks)
            mm.router = Router(routing, kv_tier=mm.kv_tier,
                               **(routing_kw or {}))
            mm.engine_kw.setdefault("paged", True)
            mm.engine_kw.setdefault("prefix_cache", True)
            mm.engine_kw["kv_tier"] = mm.kv_tier
        self.models[profile.name] = mm
        return mm

    # ------------------------------------------------------------ serving
    def submit(self, model: str, prompt: Sequence[int],
               params: Optional[SamplingParams] = None, *,
               now: Optional[float] = None,
               pump: bool = True) -> FleetRequest:
        """Submit a request at simulated instant ``now``. A ready
        endpoint serves it warm; otherwise it queues for the model's
        cold start (``pump=False`` lets a caller batch several same-tick
        submissions so the resulting launches contend on the NICs — done
        automatically by ``run_trace``)."""
        now = self.now if now is None else now
        self.advance(now)
        mm = self.models[model]
        self.fleet.record_arrival(model, now)
        req = FleetRequest(self._rid, model, list(prompt), params, now,
                           cold=not mm.ready_slots(now))
        self._rid += 1
        self.requests.append(req)
        mm.queue.append(req)
        if pump:
            self.pump(now)
        return req

    def pump(self, now: Optional[float] = None):
        """One fleet scheduling round: collect every model's demand
        launch decision, *begin* all resulting cold starts (their
        fetches contend on the shared schedule), then finish them and
        flush what became ready."""
        now = self.now if now is None else max(now, self.now)
        self.now = now
        plans = []
        for mm in self.models.values():
            plan = self.fleet.cold_start_plan(
                mm.name, len(mm.queue), self._capacity(mm),
                len(mm.slots), now)
            if plan:
                plans.append(plan)
        self._launch(plans, now)
        self._flush(now)

    def advance(self, to: float):
        """Advance the simulated clock, running the control loop at the
        policy's pulse cadence: placement rounds, predictive prewarms,
        ready-queue flushes, idle consolidation and scale-to-zero reaps."""
        to = max(to, self.now)
        pulse = max(self.policy.pulse_s, 1e-6)
        while self._last_pulse + pulse <= to:
            self._last_pulse += pulse
            self._tick(self._last_pulse)
        self.now = to
        self._flush(to)

    def run_trace(self, trace, *, drain_to: Optional[float] = None
                  ) -> List[FleetRequest]:
        """Drive (model, arrival, prompt[, params]) records in time
        order; same-instant arrivals are batched into one pump so their
        cold starts contend. ``drain_to`` advances the clock afterwards
        (keepalive reaps included)."""
        out = []
        items = sorted(trace, key=lambda r: r[1])
        i = 0
        while i < len(items):
            t = items[i][1]
            self.advance(t)
            while i < len(items) and items[i][1] == t:
                model, _, prompt = items[i][:3]
                params = items[i][3] if len(items[i]) > 3 else None
                out.append(self.submit(model, prompt, params, now=t,
                                       pump=False))
                i += 1
            self.pump(t)
        if drain_to is not None:
            self.advance(drain_to)
        return out

    def scale_to(self, model: str, n: int,
                 now: Optional[float] = None) -> ManagedModel:
        """Launch demand replicas until ``model`` has ``n`` slots (never
        scales down — the keepalive reaper owns that). Handy for benches
        that want a fixed replica fan before driving a trace."""
        now = self.now if now is None else max(now, self.now)
        self.now = now
        mm = self.models[model]
        while len(mm.slots) < n:
            self._launch([LaunchPlan(model, 1, "none", "demand")], now)
        return mm

    # ---------------------------------------------------------- internals
    def _capacity(self, mm: ManagedModel) -> int:
        cap = self.central.consolidation.per_worker_capacity
        return cap * len(mm.slots)

    def _at_zero(self, model: str) -> bool:
        mm = self.models[model]
        return not mm.slots and not mm.queue

    def _launch(self, plans: List[LaunchPlan], now: float):
        pending: List[tuple] = []
        for plan in plans:
            mm = self.models[plan.model]
            for _ in range(plan.n_groups):
                p = self.frontend.begin_cold_start(
                    plan.model, now=now,
                    prefer=self.fleet.preferred_servers(plan.model),
                    fallback_tier=mm.base_tier, **mm.engine_kw)
                pending.append((plan, p))
        for plan, p in pending:
            self._finish_launch(plan, p, now)

    def _finish_launch(self, plan: LaunchPlan, p: PendingColdStart,
                       now: float):
        mm = self.models[plan.model]
        ep = p.finish()
        ready = ep.cold_start_timeline.ready
        slot = _Slot(ep, ready, plan.mode, plan.reason, idle_since=ready,
                     name=f"{plan.model}/r{mm.n_launched}")
        mm.n_launched += 1
        mm.slots.append(slot)
        if mm.router is not None:
            mm.router.register(slot.name, ep)
            mm.router.set_pending(slot.name, ready > now)
        self.cold_start_log.append({
            "model": plan.model, "t0": now, "ready": ready,
            "duration": ready - now, "reason": plan.reason,
            "s": ep.cold_start_timeline.s,
            "tier": ep.cold_start_timeline.stages[0].tier,
            "servers": list(ep.scheme.servers) if ep.scheme else [],
        })

    def _tick(self, t: float):
        for act in self.fleet.placement_round(t):
            store = self.frontend.store_of(act.model)
            store.place(act.tier, self.placement_bw)
            self.placement_log.append({
                "model": act.model, "server": act.server_id,
                "tier": act.tier, "t": t})
        prewarms = self.fleet.prewarm_due(t, self._at_zero)
        if prewarms:
            self._launch(prewarms, t)
        self._flush(t)
        self._consolidate_idle(t)
        self._reap(t)

    def _flush(self, now: float):
        """Feed queued requests into ready endpoints and run the real
        engines to completion. Router-enabled models pick the replica by
        policy (warm-prefix affinity, saturation overflow) and their
        TTFT estimate discounts the analytic prefill by the measured
        cached fraction, then adds the measured KV-restore transfer."""
        for mm in self.models.values():
            ready = mm.ready_slots(now)
            if not ready or not mm.queue:
                continue
            if mm.kv_tier is not None:
                mm.kv_tier.now = now
            if mm.router is not None:
                for slot in mm.slots:
                    mm.router.set_pending(slot.name, slot.ready_at > now)
            while mm.queue:
                req = mm.queue.popleft()
                slot = self._pick_slot(mm, ready, req)
                handle = slot.endpoint.submit(req.prompt, req.params)
                served_at = max(slot.ready_at, req.arrival)
                req.wait = served_at - req.arrival
                req.replica = slot.name or None
                slot.idle_since = None
                slot.endpoint.run()
                req.output = list(handle.generated)
                est = self._prefill_est(mm, slot)
                if mm.router is not None:
                    # routed models prorate the analytic prefill per
                    # *uncached* token (t_p = full-context prefill), so
                    # the KV the router preserved shows up in TTFT; the
                    # measured restore transfer is paid on top
                    m = handle.metrics
                    req.cached_tokens = m.cached_tokens
                    req.restored_tokens = m.restored_tokens
                    req.restore_seconds = m.restore_seconds
                    ctx = slot.endpoint.engine.max_seq
                    uncached = max(0, len(req.prompt) - m.cached_tokens)
                    est = est * uncached / max(ctx, 1) + m.restore_seconds
                req.ttft = req.wait + est
                req.slo_ok = req.ttft <= mm.profile.slo.ttft + 1e-9
            for slot in ready:
                if not slot.endpoint.has_work() \
                        and slot.idle_since is None:
                    slot.idle_since = now

    def _pick_slot(self, mm: ManagedModel, ready: List[_Slot],
                   req: FleetRequest) -> _Slot:
        if mm.router is not None and len(ready) > 0:
            decision = mm.router.route(req.prompt)
            for slot in ready:
                if slot.name == decision.name:
                    return slot
            # routed to a still-pending replica: serve on a ready one
        return min(ready, key=lambda s: len(s.endpoint.active()))

    def _prefill_est(self, mm: ManagedModel, slot: _Slot) -> float:
        t = mm.profile.timings
        scheme = slot.endpoint.scheme
        s = slot.endpoint.n_stages
        w = scheme.w if scheme else s
        base = t.t_p
        if s <= 1:
            return base
        return base * (s - w + w / s) + t.t_n * s

    def _consolidate_idle(self, t: float):
        """§6.2 merge: an idle pipeline-parallel replica consolidates to
        one standalone worker (weights filled in through the store, KV
        migration accounted as a real flow)."""
        for mm in self.models.values():
            for slot in mm.slots:
                if (slot.ready_at <= t and not slot.consolidated
                        and slot.mode == "down"
                        and slot.endpoint.n_stages > 1
                        and slot.idle_since is not None):
                    self.frontend.consolidate(slot.endpoint, mm.name,
                                              now=t)
                    slot.consolidated = True

    def _reap(self, t: float):
        """Scale-to-zero: idle endpoints past the (demand-extended)
        keep-alive window are retired; their model returns to zero and
        its next request pays a fresh — bit-exact — cold start."""
        for mm in self.models.values():
            keep = self.fleet.keepalive(mm.name, t)
            survivors = []
            for slot in mm.slots:
                idle = slot.idle_since
                if (idle is not None and slot.ready_at <= t
                        and not slot.endpoint.has_work()
                        and t - max(idle, slot.ready_at) >= keep):
                    if mm.kv_tier is not None:
                        # scale-to-zero demotes the replica's whole prefix
                        # cache to the host tier (evict hooks spill) so
                        # the next cold start can restore it
                        mm.kv_tier.now = t
                        slot.endpoint.engine.block_mgr \
                            .drop_unreferenced_cache()
                    if mm.router is not None and slot.name:
                        mm.router.unregister(slot.name)
                    slot.endpoint.engine.retire()
                else:
                    survivors.append(slot)
            mm.slots = survivors

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        done = [r for r in self.requests if r.ttft is not None]
        if not done:
            return {"n": 0}
        waits = sorted(r.wait for r in done)
        ttfts = sorted(r.ttft for r in done)

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else 0.0

        cold = [r for r in done if r.cold]
        cold_ttfts = sorted(r.ttft for r in cold)
        durs = sorted(c["duration"] for c in self.cold_start_log)
        return {
            "n": len(done),
            "ttft_attainment": sum(r.slo_ok for r in done) / len(done),
            "ttft_p50": pct(ttfts, 0.50), "ttft_p99": pct(ttfts, 0.99),
            "wait_p50": pct(waits, 0.50), "wait_p99": pct(waits, 0.99),
            "cold_requests": len(cold),
            "cold_p50": pct(cold_ttfts, 0.50),
            "cold_p99": pct(cold_ttfts, 0.99),
            "cold_starts": len(self.cold_start_log),
            "cold_start_p50": pct(durs, 0.50),
            "cold_start_p99": pct(durs, 0.99),
            "prewarms": sum(1 for c in self.cold_start_log
                            if c["reason"] == "prewarm"),
            "placements": len(self.placement_log),
            "per_model": {name: self._model_metrics(mm)
                          for name, mm in self.models.items()},
        }

    def _model_metrics(self, mm: ManagedModel) -> dict:
        done = [r for r in self.requests
                if r.model == mm.name and r.ttft is not None]
        out = {
            "state": mm.state,
            "replicas": [s.name or f"{mm.name}/?" for s in mm.slots],
            "n": len(done),
            "endpoints": {s.name or str(i): s.endpoint.stats()
                          for i, s in enumerate(mm.slots)},
        }
        if mm.router is not None:
            prompt_tokens = sum(len(r.prompt) for r in done)
            out["router"] = mm.router.stats()
            out["kv_tier"] = mm.kv_tier.stats()
            out["cached_tokens"] = sum(r.cached_tokens for r in done)
            out["restored_tokens"] = sum(r.restored_tokens for r in done)
            out["cached_ratio"] = (out["cached_tokens"] / prompt_tokens
                                   if prompt_tokens else 0.0)
        return out
