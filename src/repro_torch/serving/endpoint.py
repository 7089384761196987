"""Stable serving endpoints (§6.2) and the serverless frontend.

HydraServe's client-facing abstraction is the *serving endpoint*: pipeline
groups consolidate and scale behind it, clients never see the swap. A
``ServingEndpoint`` is that stable handle — it owns the backing
``Engine``(s), proxies the request-lifecycle API (serving/api.py), and
performs consolidation / scale-up *in place*: the handle the caller holds
keeps working, in-flight requests continue bit-exactly, and the retired
source engine raises on use instead of silently corrupting block tables
it no longer owns.

``ServerlessFrontend`` glues the control plane to the data plane: it
registers model profiles with the ``CentralController``, and on a cold
start runs Alg. 1 (``plan_cold_start``), *streams* each stage's parameter
slice out of the deployment's ``ModelStore`` (repro_torch/store/) onto the
frontend's device with the ``StreamedStageLoader``, and hands back a live
endpoint whose ``cold_start_timeline`` carries the per-stage spans on the
simulated clock. ``deploy`` without a ``store_dir`` keeps the weights in a
``ModelStore.from_params`` memory tier — same bytes, same engine outputs,
the load path is the real one either way. Consolidation's full-model
fill-in (``full_params``) fetches through the store too.

The port adds ``device=`` to the frontend (default: the card), handed to
every engine and loader it builds.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coldstart import OverlapFlags
from repro_torch.core.controller import CentralController
from repro_torch.core.types import ColdStartScheme, ModelProfile, ServerSpec
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams, StepOutput, TokenEvent
from repro_torch.serving.engine import Engine, GenRequest
from repro_torch.store.loader import (ColdStartReport, StageLoadRecord,
                                      StreamedStageLoader)
from repro_torch.store.store import FetchFlow, FetchSchedule, ModelStore


class ServingEndpoint:
    """Stable handle over a (possibly re-forming) engine. All serving
    traffic goes through the endpoint; ``consolidate``/``scale_up`` swap
    the backing engine without invalidating the handle."""

    def __init__(self, engine: Engine,
                 scheme: Optional[ColdStartScheme] = None,
                 cold_start_timeline: Optional[ColdStartReport] = None):
        self._engine = engine
        self.scheme = scheme              # Alg.1 plan that built us, if any
        # per-stage cold-start spans on the simulated clock (store-backed
        # cold starts)
        self.cold_start_timeline = cold_start_timeline
        # simulated KV-migration transfer of the last consolidation, if the
        # frontend drove it (ServerlessFrontend.consolidate)
        self.last_migration_flow: Optional[FetchFlow] = None

    # -------------------------------------------------------- delegation
    @property
    def engine(self) -> Engine:
        """The live backing engine (raw-engine escape hatch)."""
        return self._engine

    @property
    def cfg(self) -> ModelConfig:
        return self._engine.cfg

    @property
    def paged(self) -> bool:
        return self._engine.paged

    @property
    def policy(self):
        """The live engine's ``SchedulingPolicy`` (survives swaps)."""
        return self._engine.policy

    @property
    def n_stages(self) -> int:
        return len(self._engine.workers)

    @property
    def finished(self) -> List[GenRequest]:
        return self._engine.finished

    @property
    def last_migration_bytes(self) -> Optional[int]:
        return self._engine.last_migration_bytes

    def active(self) -> List[GenRequest]:
        return self._engine.active()

    def has_work(self) -> bool:
        """True while any request is resident, waiting, or preempted —
        use this (not ``active() or queue``) to drive a step loop."""
        return self._engine.has_work()

    def stats(self) -> dict:
        """Cheap saturation snapshot of the live engine (waiting depth,
        free slots/blocks, preemptions...) — the KV-aware router's
        overflow input; survives engine swaps."""
        return self._engine.stats()

    def submit(self, prompt: Sequence[int],
               params: Union[SamplingParams, int, None] = None, *,
               max_new: Optional[int] = None,
               prefix_embeds=None) -> GenRequest:
        return self._engine.submit(prompt, params, max_new=max_new,
                                   prefix_embeds=prefix_embeds)

    def step(self) -> StepOutput:
        return self._engine.step()

    def run(self, max_steps: int = 10_000) -> List[StepOutput]:
        return self._engine.run(max_steps)

    def generate(self, prompt: Sequence[int],
                 params: Union[SamplingParams, int, None] = None, *,
                 prefix_embeds=None,
                 max_steps: int = 10_000) -> Iterator[TokenEvent]:
        return self._engine.generate(prompt, params,
                                     prefix_embeds=prefix_embeds,
                                     max_steps=max_steps)

    # ------------------------------------------------- elastic membership
    def consolidate(self, full_params: dict) -> "ServingEndpoint":
        """§6.2 scale-down behind the handle: gather KV/state onto one
        standalone worker, swap it in, retire the pipeline-group engine.
        In-flight requests (and ``last_migration_bytes``) carry over, and
        so do the scheduling policy and the waiting/preempted pools — a
        consolidation changes the endpoint's capacity, not its scheduling
        behaviour."""
        src = self._engine
        self._engine = src.consolidated(full_params)
        src.retire()
        return self

    def scale_up(self, full_params: dict) -> List["ServingEndpoint"]:
        """§6.2 scale-up: each stage becomes a standalone replica. This
        handle keeps the consolidated engine (in-flight requests continue);
        the fresh replicas come back as new endpoints. Returns all
        endpoints, this one first."""
        src = self._engine
        engines = src.scale_up(full_params)
        src.retire()
        self._engine = engines[0]
        return [self] + [ServingEndpoint(e) for e in engines[1:]]


@dataclass
class _Deployment:
    cfg: ModelConfig
    model: Optional[Model]                # None for a cold deploy
    store: ModelStore                     # from an existing store
    profile: ModelProfile


class PendingColdStart:
    """A cold start whose stage fetch flows are admitted on the shared
    schedule but not yet resolved. ``finish()`` streams the stage
    parameters and builds the live endpoint; everything begun before the
    first ``finish`` contends on the simulated NICs."""

    def __init__(self, name: str, dep: "_Deployment", scheme,
                 flags: OverlapFlags, pending, engine_kw: dict):
        self.name = name
        self.scheme = scheme
        self._dep = dep
        self._flags = flags
        self._pending = pending
        self._engine_kw = engine_kw

    @property
    def n_stages(self) -> int:
        return len(self._pending)

    @property
    def stages(self):
        """The admitted stages, in order: ``finish`` materializes each
        (``materialize()`` reads its chunk ranges and copies them onto the
        device)."""
        return tuple(self._pending)

    def finish(self) -> ServingEndpoint:
        stage_params, records = [], []
        for p in self._pending:
            sp, rec = p.materialize()
            stage_params.append(sp)
            records.append(rec)
        report = ColdStartReport(self.name, len(records), self._flags,
                                 records)
        eng = Engine(self._dep.cfg, stage_params, **self._engine_kw)
        return ServingEndpoint(eng, scheme=self.scheme,
                               cold_start_timeline=report)


class ServerlessFrontend:
    """Control-plane glue: model registry + Alg. 1 planning + streamed
    stage loading out of the per-model ``ModelStore``, producing
    ``ServingEndpoint``s. One frontend per cluster; all its cold-start
    fetches share one ``FetchSchedule`` over the controller's Alg. 2
    contention tracker, so concurrent cold starts on a server contend.
    Every engine and loader it builds runs on ``device`` (default: the
    card)."""

    def __init__(self, servers: Dict[str, ServerSpec],
                 controller: Optional[CentralController] = None,
                 device=None, **controller_kw):
        self.device = resolve_device(device)
        self.controller = controller or CentralController(servers,
                                                          **controller_kw)
        self.servers = self.controller.servers
        self.schedule = FetchSchedule(self.controller.tracker)
        self._deployed: Dict[str, _Deployment] = {}
        self._fid = itertools.count()
        # simulated-clock record of the last full_params fetch (§6.2)
        self.last_full_fetch: Optional[StageLoadRecord] = None

    def deploy(self, cfg: ModelConfig, params: Optional[dict],
               profile: ModelProfile, *,
               store: Optional[ModelStore] = None,
               store_dir: Optional[str] = None) -> ModelStore:
        """'Upload' a model: register its profile with the controller and
        chunk the weights into a ``ModelStore`` the cold-start data plane
        fetches from. ``store_dir`` writes (and serves from) the on-disk
        chunk layout; an explicit ``store`` is used as-is; neither keeps
        the weights behind an in-memory ``ModelStore.from_params`` tier
        — every cold start streams through the store regardless.

        ``params=None`` is the *cold deploy* path: the model was never
        resident in this process — its bytes already live in an existing
        on-disk store (``store_dir``) or an explicit ``store``, and the
        first cold start is the first time any of them are read."""
        self.controller.register_model(profile)
        model = Model(cfg) if params is not None else None
        if store is None:
            if params is None:
                if store_dir is None:
                    raise ValueError(
                        "cold deploy (params=None) needs an existing store: "
                        "pass store= or store_dir=")
                store = ModelStore.open(store_dir)
            elif store_dir is not None:
                store = ModelStore.save(store_dir, model, params)
            else:
                store = ModelStore.from_params(model, params)
        self._deployed[profile.name] = _Deployment(cfg, model, store,
                                                   profile)
        return store

    def store_of(self, name: str) -> ModelStore:
        return self._deployed[name].store

    def _load_bw(self, server_ids: Sequence[str]) -> float:
        known = [self.servers[s].pcie_bytes_per_s for s in server_ids
                 if s in self.servers]
        return min(known) if known else 12e9

    def begin_cold_start(self, name: str, *, now: float = 0.0,
                         free_hbm: Optional[Dict[str, int]] = None,
                         force_s: Optional[int] = None, min_stages: int = 1,
                         max_batch: int = 4, max_seq: int = 128,
                         block_size: int = 16,
                         paged: Optional[bool] = None,
                         prefix_cache: bool = False,
                         prefill_chunk: Optional[int] = None,
                         policy: str = "fcfs",
                         kv_tier=None,
                         flags: OverlapFlags = OverlapFlags.all(),
                         tier: Optional[str] = None,
                         fallback_tier: Optional[str] = None,
                         prefer: Optional[Sequence[str]] = None
                         ) -> "PendingColdStart":
        """Phase 1 of a cold start: plan the Alg. 1 scheme and *admit*
        every stage's fetch into the shared schedule without resolving
        any of them. A fleet launching several models in one tick begins
        them all first, then ``finish()``es each — flows landing on the
        same server then contend per Alg. 2, exactly like the stages of
        a single group already do.

        ``prefer`` biases scheme selection toward those servers (the
        fleet passes the model's proactive placements). When ``tier`` is
        None and the scheme lands on a server this model is pre-seeded
        on, the placement's tier is used automatically — a proactively
        distributed model fetches from its fast tier; an *unseeded*
        scheme falls back to ``fallback_tier`` (the fleet passes the
        store's authoritative/slowest tier; None keeps the store's
        default fastest tier, the single-model behaviour). ``kv_tier``
        goes to the engine: its evicted prefix-cache blocks spill there."""
        dep = self._deployed[name]
        scheme = self.controller.plan_cold_start(name, free_hbm, now,
                                                 force_s=force_s,
                                                 prefer=prefer)
        n_stages = min(max(scheme.s, min_stages), dep.cfg.n_periods)
        if n_stages == scheme.s:
            servers = list(scheme.servers)
        else:                       # min_stages overrode the plan's degree
            pool = scheme.servers or tuple(self.servers)
            servers = [pool[i % len(pool)] for i in range(n_stages)]
        if tier is None:
            placed = {self.controller.placement_tier(name, sid)
                      for sid in servers} - {None}
            for t in sorted(placed):
                if dep.store.has_tier(t):
                    tier = t
                    break
            else:
                tier = fallback_tier
        deadline = self.controller.fetch_deadline(name, scheme, now)
        loader = StreamedStageLoader(dep.store, self.schedule,
                                     dep.profile.timings, flags,
                                     load_bytes_per_s=self._load_bw(servers),
                                     tier=tier, device=self.device)
        worker_ids = [f"{name}/f{next(self._fid)}-s{i}"
                      for i in range(n_stages)]
        pending = [loader.admit_stage(n_stages, i, server_id=servers[i],
                                      worker_id=worker_ids[i], now=now,
                                      deadline=deadline)
                   for i in range(n_stages)]
        engine_kw = dict(max_batch=max_batch, max_seq=max_seq,
                         block_size=block_size, paged=paged,
                         prefix_cache=prefix_cache,
                         prefill_chunk=prefill_chunk, policy=policy,
                         kv_tier=kv_tier, device=self.device)
        return PendingColdStart(name, dep, scheme, flags, pending,
                                engine_kw)

    def cold_start(self, name: str, **kw) -> ServingEndpoint:
        """Alg. 1 cold start, executed: pick a pipeline scheme, admit
        every stage's fetch into the shared schedule (stages landing on
        the same server contend per Alg. 2), stream each stage's
        parameters out of the store in manifest order, and return a live
        endpoint whose ``cold_start_timeline`` is the per-stage
        ``WorkerTimeline`` report under ``flags``, on the simulated clock. Pass ``paged=False`` for
        the slot-contiguous layout (the reference's default; the port's
        ``paged=None`` means the paged one).
        ``prefix_cache``/``prefill_chunk``/``policy`` pass through to the
        engine (the first two need the paged layout) and survive
        consolidation. (``begin_cold_start`` + ``finish`` split the same
        operation for concurrent fleet launches.)"""
        return self.begin_cold_start(name, **kw).finish()

    def full_params(self, name: str, *, now: float = 0.0,
                    server_id: Optional[str] = None,
                    tier: Optional[str] = None) -> dict:
        """The un-sliced weights, fetched through the store (the paper's
        warm-pool / object-store fill-in that consolidation's standalone
        worker performs). The simulated-clock record of the last such
        fetch is kept on ``last_full_fetch``."""
        dep = self._deployed[name]
        sid = server_id or next(iter(self.servers), "local")
        # the consolidating worker is already warm: no container/lib/cuda
        # stubs, just the fetch + load legs
        warm = dataclasses.replace(dep.profile.timings,
                                   t_cc=0.0, t_l=0.0, t_cu=0.0)
        loader = StreamedStageLoader(dep.store, self.schedule, warm,
                                     OverlapFlags.all(),
                                     load_bytes_per_s=self._load_bw([sid]),
                                     tier=tier, device=self.device)
        params, record = loader.load_stage(
            1, 0, server_id=sid, worker_id=f"{name}/full{next(self._fid)}",
            now=now)
        self.last_full_fetch = record
        return params

    def consolidate(self, endpoint: ServingEndpoint, name: str, *,
                    now: float = 0.0,
                    tier: Optional[str] = None) -> ServingEndpoint:
        """§6.2 scale-down, data plane included: fetch the full weights
        through the store onto the surviving worker's server, swap the
        consolidated engine in behind the endpoint handle, then account
        the KV-migration transfer (``last_migration_bytes`` —
        the exact bytes the paged gather moved; None on the contiguous
        layout, which then accounts no flow) as a flow on that server's
        simulated NIC (``endpoint.last_migration_flow``)."""
        sid = endpoint.scheme.servers[0] if (
            endpoint.scheme and endpoint.scheme.servers) \
            else next(iter(self.servers), "local")
        params = self.full_params(name, now=now, server_id=sid, tier=tier)
        endpoint.consolidate(params)
        moved = endpoint.last_migration_bytes
        if moved:
            endpoint.last_migration_flow = self.schedule.transfer(
                sid, f"{name}/kvmig{next(self._fid)}", moved,
                now=max(now, self.last_full_fetch.timeline.ready))
        return endpoint
