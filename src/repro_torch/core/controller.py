"""Cluster-level central controller: glues Algorithm 1 (parallelism size
selection), Algorithm 2 (contention tracking), the consolidation policy,
and the fleet-wide placement registry behind Alg. 1 proactive model
distribution. A copy of the reference's ``core/controller.py``; the port's
``ServerlessFrontend`` drives it for the cold starts it serves on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.consolidation import (ConsolidationPolicy,
                                            SlidingWindowPredictor)
from repro_torch.core.parallelism import (NoPlacement, predict_tpot,
                                          select_scheme)
from repro_torch.core.placement import ContentionTracker
from repro_torch.core.types import (ColdStartScheme, ModelProfile,
                                    ServerSpec, SLO)


class CentralController:
    def __init__(self, servers: Dict[str, ServerSpec],
                 window_s: float = 60.0, per_worker_capacity: int = 8,
                 overlapped: bool = True, max_pp_cap: Optional[int] = None):
        self.servers = servers
        self.tracker = ContentionTracker(servers)
        self.predictor = SlidingWindowPredictor(window_s)
        self.consolidation = ConsolidationPolicy(self.predictor,
                                                 per_worker_capacity)
        self.overlapped = overlapped
        self.max_pp_cap = max_pp_cap
        self.models: Dict[str, ModelProfile] = {}
        # fleet-wide placement state: model -> {server_id: tier_name}.
        # Written by Alg. 1 proactive distribution, read by cold-start
        # planning (seeded servers fetch from fast tiers) and the fleet
        # benchmark's placement accounting.
        self.placements: Dict[str, Dict[str, str]] = {}

    # ------------------------------------------------------------ registry
    def register_model(self, profile: ModelProfile):
        self.models[profile.name] = profile

    def record_request(self, model: str, now: float):
        self.predictor.record(model, now)

    # ----------------------------------------------------------- placement
    def record_placement(self, model: str, server_id: str,
                         tier: str = "peer"):
        self.placements.setdefault(model, {})[server_id] = tier

    def drop_placement(self, model: str, server_id: Optional[str] = None):
        if server_id is None:
            self.placements.pop(model, None)
        else:
            self.placements.get(model, {}).pop(server_id, None)

    def placed_servers(self, model: str) -> List[str]:
        return list(self.placements.get(model, {}))

    def placement_tier(self, model: str, server_id: str) -> Optional[str]:
        return self.placements.get(model, {}).get(server_id)

    def plan_distribution(self, ranked_models: Sequence[str],
                          fanout: int = 2) -> List[Tuple[str, str]]:
        """Alg. 1 proactive model distribution: walk the demand-ranked
        models and give each up to ``fanout`` placement targets, spreading
        over distinct servers fattest-NIC-first so hot models land where
        a cold start fetches fastest. Already-seeded (model, server) pairs
        are skipped; servers are load-balanced by how many placements they
        already hold. Returns the new (model, server_id) seedings — the
        caller executes them (host-cache fetch in the sim, a
        ``ModelStore.place`` tier in the real data plane)."""
        load = {sid: 0 for sid in self.servers}
        for placed in self.placements.values():
            for sid in placed:
                if sid in load:
                    load[sid] += 1
        order = sorted(self.servers,
                       key=lambda sid: (-self.servers[sid].nic_bytes_per_s,
                                        sid))
        out: List[Tuple[str, str]] = []
        for name in ranked_models:
            have = set(self.placed_servers(name))
            want = fanout - len(have)
            for sid in sorted(order, key=lambda sid: load[sid]):
                if want <= 0:
                    break
                if sid in have:
                    continue
                out.append((name, sid))
                load[sid] += 1
                want -= 1
        return out

    # ------------------------------------------------------- cold starts
    def plan_cold_start(self, model_name: str,
                        free_hbm: Optional[Dict[str, int]] = None,
                        now: float = 0.0, queue_wait: float = 0.0,
                        force_s: Optional[int] = None,
                        prefer: Optional[Sequence[str]] = None
                        ) -> ColdStartScheme:
        """Alg. 1 scheme selection. With ``prefer`` (e.g. the model's
        proactively-seeded servers) planning is tried on that restricted
        pool first — a feasible scheme on seeded servers beats one on the
        open pool because its fetches come from a fast tier — falling
        back to the whole cluster when the preferred pool can't host."""
        if free_hbm is None:              # idle cluster: all HBM available
            free_hbm = {sid: s.hbm_bytes for sid, s in self.servers.items()}
        model = self.models[model_name]
        if self.max_pp_cap is not None:
            model = dataclasses.replace(
                model, max_pp=min(model.max_pp, self.max_pp_cap))
        eff = self.tracker.effective_bandwidths(now)
        if prefer:
            sub = {sid: self.servers[sid] for sid in prefer
                   if sid in self.servers}
            if sub:
                try:
                    return select_scheme(
                        model, sub,
                        {sid: free_hbm.get(sid, 0) for sid in sub},
                        {sid: eff[sid] for sid in sub},
                        t_w=queue_wait, overlapped=self.overlapped,
                        fixed_s=force_s)
                except NoPlacement:
                    pass
        return select_scheme(model, self.servers, free_hbm, eff,
                             t_w=queue_wait, overlapped=self.overlapped,
                             fixed_s=force_s)

    def fetch_deadline(self, model_name: str, scheme: ColdStartScheme,
                       now: float) -> float:
        """Alg.2: D_i from the TTFT SLO — fetch must complete early enough
        to leave room for the prefill chain (+ load slack when not
        overlapped)."""
        model = self.models[model_name]
        t = model.timings
        post = t.t_p * (scheme.s - scheme.w + scheme.w / scheme.s) \
            + t.t_n * scheme.s
        d = now + model.slo.ttft - post
        # never earlier than the uncontended fetch itself
        min_fetch = min(
            (model.size_bytes / scheme.s) / self.servers[sid].nic_bytes_per_s
            for sid in scheme.servers)
        return max(d, now + min_fetch)

    def admit_fetches(self, model_name: str, scheme: ColdStartScheme,
                      worker_ids, stage_bytes, now: float) -> float:
        """Register each stage fetch with the contention tracker; returns
        the common deadline."""
        deadline = self.fetch_deadline(model_name, scheme, now)
        for sid, wid, nbytes in zip(scheme.servers, worker_ids, stage_bytes):
            self.tracker.admit(sid, wid, nbytes, deadline, now)
        return deadline

    def fetch_complete(self, server_id: str, worker_id: str, now: float):
        self.tracker.complete(server_id, worker_id, now)

    # --------------------------------------------------------- autoscaling
    def consolidation_plan(self, model_name: str, queue_len: int, now: float,
                           current_workers: int):
        model = self.models[model_name]
        return self.consolidation.plan(model_name, queue_len, now,
                                       model.max_pp, current_workers)
