"""End-to-end serverless LLM serving simulation (a copy of the
reference's ``serving/simulation.py``, imports retargeted).

Runs the paper's three systems over the same cluster / workload:

  * ``hydra``          — ParaServe/HydraServe: Alg.1 + Alg.2 + worker-level
                         overlapping + pipeline consolidation (+cache opt).
  * ``vllm``           — serverless vLLM baseline: single worker, first-fit
                         placement, fully sequential cold-start stages.
  * ``serverlessllm``  — pre-created containers, host-memory model cache with
                         loading-optimized checkpoints, locality placement.

Compute latencies use the paper's own predictor terms (t_p scaled by prompt
length, t_d per token, t_n per pipeline hop); fetch times come from the
contention-aware fair-share NIC fluid model in cluster/cluster.py.
Worker failures can be injected; recovery is a fresh (pipeline-parallel)
cold start.

All *scaling decisions* — when to launch, how many groups, how long an
idle worker survives, when to prewarm a reaped model, which models to
proactively distribute — come from the shared ``FleetController``
(fleet/controller.py), the same policy object the real-engine
``FleetFrontend`` drives; this simulation is only a data plane executing
its decisions on the discrete-event clock.
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.cluster import Cluster, Flow
from repro_torch.cluster.sim import EventSim
from repro_torch.core.coldstart import OverlapFlags
from repro_torch.core.controller import CentralController
from repro_torch.core.parallelism import NoPlacement
from repro_torch.core.types import GB, ColdStartScheme, ModelProfile, ServerSpec
from repro_torch.fleet.controller import (FleetController, FleetPolicy,
                                    LaunchPlan, PlacementAction)
from repro_torch.workloads.generator import ModelInstance, Request

BG_FETCH_WEIGHT = 0.5                # background (consolidation) fetch priority
PLACEMENT_FETCH_WEIGHT = 0.1         # proactive-distribution seeding priority


@dataclass
class Worker:
    wid: str
    model: str
    base_model: str
    server_id: str
    device: object
    hbm: int
    full_memory: bool
    state: str = "cold"              # cold|pipeline|standalone|dead
    stage: int = 0
    group: Optional["Group"] = None
    ready_time: Optional[float] = None
    active: List[Request] = field(default_factory=list)
    keepalive_ev: object = None
    bg_flow: Optional[Flow] = None
    bg_done: bool = False
    fetch_flow: Optional[Flow] = None


@dataclass
class Group:
    gid: int
    model: str
    scheme: ColdStartScheme
    workers: List[Worker]
    mode: str                        # consolidation mode: 'down'|'up'|'none'
    t0: float = 0.0                  # launch instant
    reason: str = "demand"           # demand | prewarm
    ready: bool = False
    dissolved: bool = False
    active: List[Request] = field(default_factory=list)
    keepalive_ev: object = None

    @property
    def s(self):
        return self.scheme.s

    @property
    def w(self):
        return self.scheme.w


class ServerlessSim:
    def __init__(self, servers: Sequence[ServerSpec],
                 profiles: Dict[str, ModelProfile],
                 instances: Sequence[ModelInstance],
                 system: str = "hydra",
                 cache_enabled: bool = False,
                 flags: Optional[OverlapFlags] = None,
                 max_batch: int = 8,
                 keepalive_s: float = 300.0,
                 consolidate: bool = True,
                 force_s: Optional[int] = None,
                 host_mem_bytes: int = 188 * GB,
                 stage_bytes_fn: Optional[Callable] = None,
                 policy: Optional[FleetPolicy] = None):
        assert system in ("hydra", "vllm", "serverlessllm")
        self.system = system
        self.cache_enabled = cache_enabled or system == "serverlessllm"
        self.sim = EventSim()
        self.cluster = Cluster(self.sim, list(servers), host_mem_bytes)
        self.controller = CentralController(
            {s.server_id: s for s in servers},
            per_worker_capacity=max_batch,
            overlapped=(system == "hydra"))
        # the one scaling-policy implementation, shared with the real
        # FleetFrontend; ``keepalive_s`` remains the naive-policy shorthand
        self.fleet = FleetController(
            self.controller, policy or FleetPolicy(keepalive_s=keepalive_s))
        self.max_batch = max_batch
        self.consolidate = consolidate and system == "hydra"
        self.force_s = force_s
        self.stage_bytes_fn = stage_bytes_fn

        if flags is not None:
            self.flags = flags
        elif system == "hydra":
            self.flags = OverlapFlags.all()
        else:
            self.flags = OverlapFlags.none()

        for name, prof in profiles.items():
            if prof.kv_bytes_per_token is None:
                raise ValueError(
                    f"profile {name!r} has no kv_bytes_per_token: KV"
                    " migration accounting needs the real geometry — set"
                    " ModelProfile.kv_bytes_per_token (see"
                    " ModelProfile.kv_bytes_from_geometry or"
                    " workloads.applications.kv_bytes_for)")

        self.instances = {i.name: i for i in instances}
        # every instance is its own model in the registry (its bytes must be
        # fetched separately), sharing the base model's timing profile
        for inst in instances:
            base = profiles[inst.base_model]
            self.controller.register_model(ModelProfile(
                name=inst.name, size_bytes=base.size_bytes,
                timings=base.timings,
                slo=type(base.slo)(inst.slo_ttft, inst.slo_tpot),
                max_pp=1 if system != "hydra" else base.max_pp,
                full_hbm_bytes=base.full_hbm_bytes,
                kv_bytes_per_token=base.kv_bytes_per_token))

        self.queues: Dict[str, collections.deque] = collections.defaultdict(
            collections.deque)
        self.warm_workers: Dict[str, List[Worker]] = collections.defaultdict(list)
        self.groups: Dict[str, List[Group]] = collections.defaultdict(list)
        self.provisioning: Dict[str, int] = collections.defaultdict(int)

        self._wid = itertools.count()
        self._gid = itertools.count()
        self.finished: List[Request] = []
        self.cold_start_log: List[dict] = []
        self.placement_log: List[dict] = []
        self.failures_injected = 0
        self._retry_pending: set = set()
        self._pulse_armed = False
        self._pulse_until = 0.0

    # ================================================================ util
    def _profile(self, model: str) -> ModelProfile:
        return self.controller.models[model]

    def _prefill_time(self, model: str, prompt_tokens: int, s: int, w: int
                      ) -> float:
        t = self._profile(model).timings
        base = t.t_p * (prompt_tokens / 1024.0)
        if s <= 1:
            return base
        return base * (s - w + w / s) + t.t_n * s

    def _tpot(self, model: str, s: int, w: int) -> float:
        t = self._profile(model).timings
        if s <= 1:
            return t.t_d
        return t.t_d * (s - w + w / s) + t.t_n * s

    def _kv_bytes_per_token(self, model: str) -> int:
        """Per-model KV footprint; registration guarantees the geometry."""
        return self._profile(model).kv_bytes_per_token

    # ============================================================ requests
    def submit(self, requests: Sequence[Request]):
        for r in requests:
            self.sim.at(r.arrival, lambda r=r: self._arrive(r))

    def run(self, until: Optional[float] = None):
        pol = self.fleet.policy
        if until is not None and (pol.prewarm or pol.proactive_placement):
            self._arm_pulses(until)
        self.sim.run(until=until)

    # ------------------------------------------------------- control pulses
    def _arm_pulses(self, until: float):
        """Run the fleet control loop (placement rounds + prewarm checks)
        at the policy's pulse cadence for the span of this ``run`` — the
        sim's twin of ``FleetFrontend.advance``."""
        self._pulse_until = max(self._pulse_until, until)
        if self._pulse_armed:
            return
        pulse = max(self.fleet.policy.pulse_s, 1e-3)

        def tick():
            self._control_tick()
            if self.sim.now + pulse <= self._pulse_until:
                self.sim.after(pulse, tick)
            else:
                self._pulse_armed = False

        self._pulse_armed = True
        self.sim.after(pulse, tick)

    def _control_tick(self):
        now = self.sim.now
        for act in self.fleet.placement_round(now):
            self._seed_placement(act)
        for plan in self.fleet.prewarm_due(now, self._at_zero):
            self._execute_plan(plan.model, plan)

    def _at_zero(self, model: str) -> bool:
        return (not self.warm_workers[model] and not self.groups[model]
                and not self.queues[model]
                and self.provisioning[model] == 0)

    def _seed_placement(self, act: PlacementAction):
        """Execute one Alg. 1 proactive-distribution action: background-
        fetch the model's bytes into the target server's host cache (low
        priority on the NIC), so a later cold start there skips the
        network fetch entirely."""
        server = self.cluster.servers[act.server_id]
        if server.cache_has(act.model):
            return
        prof = self._profile(act.model)
        self.placement_log.append({"model": act.model,
                                   "server": act.server_id,
                                   "t": self.sim.now})
        self.cluster.start_fetch(
            act.server_id, prof.size_bytes,
            lambda: server.cache_put(act.model, prof.size_bytes),
            weight=PLACEMENT_FETCH_WEIGHT)

    def _arrive(self, req: Request):
        self.fleet.record_arrival(req.model, self.sim.now)
        req.cold = not (self.warm_workers[req.model]
                        or any(g.ready and not g.dissolved
                               for g in self.groups[req.model]))
        self.queues[req.model].append(req)
        self._drain(req.model)
        self._maybe_cold_start(req.model)

    def _drain(self, model: str):
        """Assign queued requests to endpoints with spare capacity."""
        q = self.queues[model]
        if not q:
            return
        for wkr in list(self.warm_workers[model]):
            while q and len(wkr.active) < self.max_batch:
                self._start_on_worker(wkr, q.popleft())
        for grp in self.groups[model]:
            if not grp.ready or grp.dissolved:
                continue
            while q and len(grp.active) < self.max_batch:
                self._start_on_group(grp, q.popleft())

    # ------------------------------------------------------------- serving
    def _start_on_worker(self, wkr: Worker, req: Request):
        wkr.active.append(req)
        self._cancel_keepalive(wkr)
        pf = self._prefill_time(req.model, req.prompt_tokens, 1, 1)
        first = self.sim.now + pf
        req.first_token = first
        tpot = self._tpot(req.model, 1, 1)
        dur = pf + max(req.output_tokens - 1, 0) * tpot
        req._rate = tpot                     # type: ignore[attr-defined]
        req._holder = wkr                    # type: ignore[attr-defined]
        req._done_ev = self.sim.after(       # type: ignore[attr-defined]
            dur, lambda: self._complete_on_worker(wkr, req))

    def _complete_on_worker(self, wkr: Worker, req: Request):
        if req in wkr.active:
            wkr.active.remove(req)
        req.completion = self.sim.now
        self.finished.append(req)
        self._drain(req.model)
        if not wkr.active:
            self._arm_keepalive(wkr)

    def _start_on_group(self, grp: Group, req: Request):
        grp.active.append(req)
        self._cancel_group_keepalive(grp)
        pf = self._prefill_time(req.model, req.prompt_tokens, grp.s, grp.w)
        req.first_token = self.sim.now + pf
        tpot = self._tpot(req.model, grp.s, grp.w)
        req._rate = tpot                     # type: ignore[attr-defined]
        req._holder = grp                    # type: ignore[attr-defined]
        dur = pf + max(req.output_tokens - 1, 0) * tpot
        req._done_ev = self.sim.after(       # type: ignore[attr-defined]
            dur, lambda: self._complete_on_group(grp, req))

    def _complete_on_group(self, grp: Group, req: Request):
        if req in grp.active:
            grp.active.remove(req)
        req.completion = self.sim.now
        self.finished.append(req)
        self._drain(req.model)
        if not grp.active and not grp.dissolved:
            self._arm_group_keepalive(grp)

    # ----------------------------------------------------------- keepalive
    def _arm_keepalive(self, wkr: Worker):
        self._cancel_keepalive(wkr)
        wkr.keepalive_ev = self.sim.after(
            self.fleet.keepalive(wkr.model, self.sim.now),
            lambda: self._terminate_worker(wkr))

    def _cancel_keepalive(self, wkr: Worker):
        if wkr.keepalive_ev is not None:
            self.sim.cancel(wkr.keepalive_ev)
            wkr.keepalive_ev = None

    def _arm_group_keepalive(self, grp: Group):
        self._cancel_group_keepalive(grp)
        grp.keepalive_ev = self.sim.after(
            self.fleet.keepalive(grp.model, self.sim.now),
            lambda: self._terminate_group(grp))

    def _cancel_group_keepalive(self, grp: Group):
        if grp.keepalive_ev is not None:
            self.sim.cancel(grp.keepalive_ev)
            grp.keepalive_ev = None

    def _terminate_worker(self, wkr: Worker):
        if wkr.active or wkr.state == "dead":
            return
        wkr.state = "dead"
        server = self.cluster.servers[wkr.server_id]
        server.free(wkr.device, wkr.hbm)
        if wkr in self.warm_workers[wkr.model]:
            self.warm_workers[wkr.model].remove(wkr)

    def _terminate_group(self, grp: Group):
        if grp.active or grp.dissolved:
            return
        grp.dissolved = True
        for wkr in grp.workers:
            if wkr.bg_flow is not None and not wkr.bg_flow.done:
                self.cluster.cancel_fetch(wkr.bg_flow)
            wkr.active = []
            self._terminate_worker(wkr)
        if grp in self.groups[grp.model]:
            self.groups[grp.model].remove(grp)

    # ========================================================== cold start
    def _capacity_in_flight(self, model: str) -> int:
        cap = 0
        for wkr in self.warm_workers[model]:
            cap += self.max_batch - len(wkr.active)
        for grp in self.groups[model]:
            if not grp.dissolved:
                cap += self.max_batch - len(grp.active)
        cap += self.provisioning[model] * self.max_batch
        return cap

    def _maybe_cold_start(self, model: str):
        current = len(self.warm_workers[model]) + sum(
            1 for g in self.groups[model] if not g.dissolved)
        plan = self.fleet.cold_start_plan(
            model, len(self.queues[model]),
            self._capacity_in_flight(model), current, self.sim.now)
        if plan:
            self._execute_plan(model, plan)

    def _execute_plan(self, model: str, plan: LaunchPlan):
        """Run one FleetController launch decision against the data plane
        (with HBM-pressure eviction + retry on placement failure)."""
        try:
            self._launch_plan(model, plan)
        except NoPlacement:
            if not self._evict_idle():
                self._schedule_retry(model)
                return
            try:
                self._launch_plan(model, plan)
            except NoPlacement:
                self._schedule_retry(model)

    def _launch_plan(self, model: str, plan: LaunchPlan):
        now = self.sim.now
        if self.system != "hydra":
            prof = self._profile(model)
            sid = self._place_single(model, prof)
            if sid is None:
                raise NoPlacement(model)
            scheme = ColdStartScheme(1, 1, (sid,), 0.0, prof.timings.t_d,
                                     False)
            self._launch_group(model, scheme, "none", reason=plan.reason)
            return
        mode = plan.mode if self.consolidate else "none"
        # with consolidation off the data plane can't run scale-up groups;
        # cap the fleet's burst sizing at one group (old behaviour)
        n_groups = plan.n_groups if self.consolidate else 1
        for _ in range(n_groups):
            scheme = self.controller.plan_cold_start(
                model, self.cluster.free_hbm(), now, force_s=self.force_s,
                prefer=self.fleet.preferred_servers(model))
            self._launch_group(model, scheme, mode, reason=plan.reason)

    def _evict_idle(self) -> bool:
        """HBM pressure relief: terminate one idle warm worker (LRU-ish) or
        one idle group so a queued model can cold-start."""
        for model, workers in self.warm_workers.items():
            for wkr in workers:
                if not wkr.active and not self.queues[model]:
                    self._cancel_keepalive(wkr)
                    self._terminate_worker(wkr)
                    return True
        for model, groups in self.groups.items():
            for grp in groups:
                if grp.ready and not grp.active and not self.queues[model]:
                    self._cancel_group_keepalive(grp)
                    self._terminate_group(grp)
                    return True
        return False

    def _schedule_retry(self, model: str):
        if model in self._retry_pending:
            return
        self._retry_pending.add(model)

        def retry():
            self._retry_pending.discard(model)
            self._maybe_cold_start(model)

        self.sim.after(1.0, retry)

    # --------------------------------------------------------------- launch
    def _launch_group(self, model: str, scheme: ColdStartScheme, mode: str,
                      reason: str = "demand"):
        now = self.sim.now
        prof = self._profile(model)
        gid = next(self._gid)
        workers: List[Worker] = []
        stage_bytes = self._stage_bytes(model, scheme.s)
        for i, sid in enumerate(scheme.servers):
            full = i < scheme.w
            need = prof.hbm_full() if full else prof.hbm_low(scheme.s)
            server = self.cluster.servers[sid]
            dev = server.fit_device(need)
            if dev is None:          # raced out of memory — retry smaller
                need = prof.hbm_low(scheme.s)
                dev = server.fit_device(need)
                if dev is None:
                    continue
                full = False
            server.alloc(dev, need)
            wkr = Worker(wid=f"w{next(self._wid)}", model=model,
                         base_model=self.instances[model].base_model,
                         server_id=sid, device=dev, hbm=need,
                         full_memory=full, stage=i)
            workers.append(wkr)
        if not workers:
            self._schedule_retry(model)
            return
        grp = Group(gid, model, scheme, workers, mode, t0=now,
                    reason=reason)
        for wkr in workers:
            wkr.group = grp
        self.groups[model].append(grp)
        self.provisioning[model] += 1

        worker_ids = [w.wid for w in workers]
        self.controller.admit_fetches(model, scheme, worker_ids,
                                      stage_bytes[: len(workers)], now)
        t = prof.timings
        pending = {"n": len(workers)}
        t0 = now

        for wkr, nbytes in zip(workers, stage_bytes):
            self._provision_worker(wkr, nbytes, t, t0, pending, grp)

    def _stage_bytes(self, model: str, s: int) -> List[int]:
        prof = self._profile(model)
        if self.stage_bytes_fn is not None:
            return [self.stage_bytes_fn(self.instances[model].base_model,
                                        s, i) for i in range(s)]
        return [prof.size_bytes // s] * s

    def _provision_worker(self, wkr: Worker, nbytes: int, t, t0: float,
                          pending: dict, grp: Group):
        """Run the worker-level overlapped cold-start stages with the
        contention-accurate fetch (see core/coldstart.py for the analytic
        twin of this logic)."""
        server = self.cluster.servers[wkr.server_id]
        flags = self.flags
        # a host-cache hit skips the network fetch — populated either by
        # the serverlessllm-style cache or by Alg. 1 proactive placement
        cached = (self.cache_enabled
                  or self.fleet.policy.proactive_placement) \
            and server.cache_has(wkr.model)
        load_seconds = nbytes / server.spec.pcie_bytes_per_s

        if flags.overlap_load:
            runtime_end = t0 + t.t_cc + t.t_cu
            lib_end = runtime_end + t.t_l
        else:
            lib_end = t0 + t.t_cc + t.t_l
            runtime_end = lib_end + t.t_cu

        if self.system == "serverlessllm":
            # containers pre-created, libraries resident
            runtime_end = t0 + t.t_cu
            lib_end = runtime_end

        def after_fetch(fetch_end: float):
            if self.cache_enabled:
                server.cache_put(wkr.model, int(nbytes))
            load_begin = max(runtime_end, t0 if flags.prefetch else fetch_end)
            if flags.stream:
                load_end = max(fetch_end, load_begin + load_seconds)
            else:
                load_end = max(fetch_end, load_begin) + load_seconds
            ready = max(load_end, lib_end)
            self.controller.fetch_complete(wkr.server_id, wkr.wid,
                                           self.sim.now)
            self.sim.at(ready, lambda: self._worker_ready(wkr, grp, pending,
                                                          ready))

        if cached:
            # host cache hit: no network fetch, load from host memory
            self.sim.at(max(runtime_end, t0),
                        lambda: after_fetch(self.sim.now))
            server.cache_touch(wkr.model)
            return

        fetch_start = t0 if flags.prefetch else runtime_end
        if self.system == "serverlessllm":
            fetch_start = runtime_end

        def start_flow():
            wkr.fetch_flow = self.cluster.start_fetch(
                wkr.server_id, nbytes,
                lambda: after_fetch(self.sim.now))

        self.sim.at(fetch_start, start_flow)

    def _worker_ready(self, wkr: Worker, grp: Group, pending: dict,
                      ready: float):
        if wkr.state == "dead":
            return
        wkr.state = "pipeline" if grp.scheme.s > 1 else "standalone"
        wkr.ready_time = ready
        pending["n"] -= 1
        if pending["n"] == 0:
            self._group_ready(grp)

    def _group_ready(self, grp: Group):
        grp.ready = True
        self.provisioning[grp.model] -= 1
        self.cold_start_log.append({
            "model": grp.model, "s": grp.s, "w": grp.w,
            "t0": grp.t0, "ready": self.sim.now,
            "duration": self.sim.now - grp.t0,
            "reason": grp.reason,
            "predicted_ttft": grp.scheme.predicted_ttft,
        })
        if grp.s == 1:
            # single worker: promote immediately to the warm pool
            wkr = grp.workers[0]
            wkr.state = "standalone"
            wkr.group = None
            self.warm_workers[grp.model].append(wkr)
            grp.dissolved = True
            self.groups[grp.model].remove(grp)
            self._drain(grp.model)
            if not wkr.active:
                self._arm_keepalive(wkr)
            return
        self._drain(grp.model)
        if self.consolidate and grp.mode in ("down", "up"):
            self._start_consolidation(grp)
        if not grp.active:
            self._arm_group_keepalive(grp)

    # ====================================================== consolidation
    def _start_consolidation(self, grp: Group):
        prof = self._profile(grp.model)
        total = prof.size_bytes
        stage_bytes = self._stage_bytes(grp.model, grp.s)
        if grp.mode == "up":
            targets = grp.workers
        else:
            # scale-down: the target must be upgradable to full memory
            targets = [w for w in grp.workers
                       if w.full_memory
                       or w.device.hbm_free >= prof.hbm_full() - w.hbm][:1]
        for wkr in targets:
            rest = total - stage_bytes[min(wkr.stage, len(stage_bytes) - 1)]
            server = self.cluster.servers[wkr.server_id]
            # upgrade a low-memory worker's reservation to full
            if not wkr.full_memory:
                extra = prof.hbm_full() - wkr.hbm
                if wkr.device.hbm_free >= extra:
                    server.alloc(wkr.device, extra)
                    wkr.hbm += extra
                    wkr.full_memory = True
                else:
                    continue        # cannot upgrade now; stay in pipeline
            wkr.bg_flow = self.cluster.start_fetch(
                wkr.server_id, rest,
                lambda wkr=wkr: self._bg_fetch_done(grp, wkr),
                weight=BG_FETCH_WEIGHT)

    def _bg_fetch_done(self, grp: Group, wkr: Worker):
        wkr.bg_done = True
        if grp.dissolved:
            return
        if grp.mode == "down":
            self._consolidate_down(grp, wkr)
        else:
            if all(w.bg_done or not w.full_memory for w in grp.workers):
                self._consolidate_up(grp)

    def _migration_seconds(self, grp: Group) -> float:
        kv_bytes = sum(r.prompt_tokens + self._tokens_done(r)
                       for r in grp.active) \
            * self._kv_bytes_per_token(grp.model)
        # gathered over (s-1) source workers in parallel, streamed
        bw = min(self.cluster.servers[w.server_id].spec.nic_bytes_per_s
                 for w in grp.workers)
        frac = (grp.s - 1) / grp.s
        return 0.02 + kv_bytes * frac / bw

    def _tokens_done(self, req: Request) -> int:
        if req.first_token is None or self.sim.now <= req.first_token:
            return 0
        rate = getattr(req, "_rate", None) or 1e9
        return min(int((self.sim.now - req.first_token) / rate) + 1,
                   req.output_tokens)

    def _consolidate_down(self, grp: Group, wkr: Worker):
        """Migrate KV to `wkr`, retime ongoing requests at standalone rate,
        terminate the other stages (Fig. 4(c) / Fig. 13)."""
        mig = self._migration_seconds(grp)

        def finish():
            if grp.dissolved:
                return
            grp.dissolved = True
            now = self.sim.now
            for req in list(grp.active):
                self._retime(req, wkr, now)
            wkr.active = list(grp.active)
            grp.active = []
            wkr.state = "standalone"
            wkr.group = None
            self.warm_workers[grp.model].append(wkr)
            for other in grp.workers:
                if other is not wkr:
                    other.active = []
                    self._terminate_worker(other)
            if grp in self.groups[grp.model]:
                self.groups[grp.model].remove(grp)
            self._drain(grp.model)
            if not wkr.active:
                self._arm_keepalive(wkr)

        self.sim.after(mig, finish)

    def _consolidate_up(self, grp: Group):
        """Every stage becomes a standalone replica (Fig. 4(d) / Fig. 7)."""
        if grp.dissolved:
            return
        grp.dissolved = True
        now = self.sim.now
        first = grp.workers[0]
        mig = self._migration_seconds(grp)
        for req in list(grp.active):
            self._retime(req, first, now + mig)
        first.active = list(grp.active)
        grp.active = []
        for wkr in grp.workers:
            if not wkr.bg_done:     # couldn't upgrade: terminate
                wkr.active = []
                self._terminate_worker(wkr)
                continue
            wkr.state = "standalone"
            wkr.group = None
            self.warm_workers[grp.model].append(wkr)
            if not wkr.active:
                self._arm_keepalive(wkr)
        if grp in self.groups[grp.model]:
            self.groups[grp.model].remove(grp)
        self._drain(grp.model)

    def _retime(self, req: Request, wkr: Worker, effective_at: float):
        """Re-schedule a request's completion at the standalone decode rate
        from `effective_at` on (KV already migrated)."""
        ev = getattr(req, "_done_ev", None)
        if ev is not None:
            self.sim.cancel(ev)
        done = self._tokens_done(req)
        remaining = max(req.output_tokens - done, 0)
        new_rate = self._tpot(req.model, 1, 1)
        finish_at = max(effective_at, self.sim.now) + remaining * new_rate
        # effective tpot improves from the migration point (Fig. 13)
        req._rate = new_rate                  # type: ignore[attr-defined]
        req._holder = wkr                     # type: ignore[attr-defined]
        req._done_ev = self.sim.at(           # type: ignore[attr-defined]
            finish_at, lambda: self._complete_on_worker(wkr, req))

    # ============================================================ baseline
    def _place_single(self, model: str, prof: ModelProfile) -> Optional[str]:
        servers = self.cluster.servers
        if self.system == "serverlessllm":
            for sid, s in servers.items():
                if s.cache_has(model) and s.fit_device(prof.hbm_full()):
                    return sid
        for sid, s in servers.items():       # first-fit (serverless vLLM)
            if s.fit_device(prof.hbm_full()):
                return sid
        return None

    # ============================================================ failures
    def inject_failure(self, model: str):
        """Kill one running worker of `model`; requests are re-queued and a
        fresh cold start is triggered (recovery path == cold-start path)."""
        victims = self.warm_workers[model] or [
            w for g in self.groups[model] for w in g.workers]
        if not victims:
            return False
        wkr = victims[0]
        self.failures_injected += 1
        requeue = list(wkr.active)
        if wkr.group is not None:
            grp = wkr.group
            requeue = list(grp.active)
            for r in requeue:
                ev = getattr(r, "_done_ev", None)
                self.sim.cancel(ev)
                r.first_token = None
            grp.active = []
            self._terminate_group(grp)
        else:
            for r in requeue:
                ev = getattr(r, "_done_ev", None)
                self.sim.cancel(ev)
                r.first_token = None
            wkr.active = []
            self._terminate_worker(wkr)
        for r in requeue:
            self.queues[model].appendleft(r)
        self._maybe_cold_start(model)
        return True

    # ============================================================= metrics
    def metrics(self) -> dict:
        done = self.finished
        if not done:
            return {"n": 0}
        ttft_ok = sum(1 for r in done if r.ttft_ok())
        tpot_ok = sum(1 for r in done if r.tpot_ok())
        ttfts = sorted(r.ttft for r in done)
        cold_ttfts = sorted(r.ttft for r in done if r.cold)
        durs = sorted(c["duration"] for c in self.cold_start_log)

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else 0.0

        return {
            "n": len(done),
            "ttft_attainment": ttft_ok / len(done),
            "tpot_attainment": tpot_ok / len(done),
            "ttft_mean": sum(ttfts) / len(ttfts),
            "ttft_p50": ttfts[len(ttfts) // 2],
            "ttft_p99": pct(ttfts, 0.99),
            "cold_starts": len(self.cold_start_log),
            # request-experienced cold-start latency: TTFT of requests that
            # arrived with no ready endpoint (prewarming shrinks these)
            "cold_requests": len(cold_ttfts),
            "cold_p50": pct(cold_ttfts, 0.50),
            "cold_p99": pct(cold_ttfts, 0.99),
            # provisioning durations (proactive placement shrinks these)
            "cold_start_p50": pct(durs, 0.50),
            "cold_start_p99": pct(durs, 0.99),
            "prewarms": sum(1 for c in self.cold_start_log
                            if c["reason"] == "prewarm"),
            "placements": len(self.placement_log),
        }
