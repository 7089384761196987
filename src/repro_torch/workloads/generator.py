"""Workload generation following the paper's methodology (§8.3): requests
sampled with Gamma-distributed inter-arrival times controlled by (RPS, CV);
model instances mapped to Azure-trace functions round-robin, which yields a
skewed per-model popularity — approximated here with a Zipf law."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class Request:
    req_id: int
    model: str
    app: str
    arrival: float
    prompt_tokens: int
    output_tokens: int
    slo_ttft: float
    slo_tpot: float
    # filled by the serving system:
    first_token: Optional[float] = None
    completion: Optional[float] = None
    tokens_done: int = 0
    # arrived with no ready endpoint (experienced a cold start / queued
    # behind one) — set by the serving system at admission
    cold: Optional[bool] = None
    # multi-turn conversations (the KV-aware router's workload): turns of
    # one session share a growing prompt prefix, so routing them to the
    # replica holding the session's KV blocks skips most of the prefill
    session: Optional[int] = None
    turn: int = 0
    prompt_ids: Optional[List[int]] = None   # concrete ids, when generated

    @property
    def ttft(self) -> Optional[float]:
        return None if self.first_token is None else self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.completion is None or self.output_tokens <= 1:
            return 0.0 if self.completion is not None else None
        return (self.completion - self.first_token) / (self.output_tokens - 1)

    def ttft_ok(self) -> bool:
        return self.ttft is not None and self.ttft <= self.slo_ttft + 1e-9

    def tpot_ok(self) -> bool:
        t = self.tpot
        return t is not None and t <= self.slo_tpot + 1e-9


@dataclass(frozen=True)
class ModelInstance:
    """One user deployment (the paper creates 64 instances per app)."""
    name: str          # unique instance name, e.g. chatbot-7b#3
    app: str
    base_model: str
    slo_ttft: float
    slo_tpot: float
    mean_prompt: int
    mean_output: int
    popularity: float = 1.0


def make_instances(applications, n_per_app: int, slo_scale: float = 1.0
                   ) -> List[ModelInstance]:
    out = []
    for app in applications:
        for i in range(n_per_app):
            out.append(ModelInstance(
                name=f"{app.name}#{i}", app=app.name,
                base_model=app.model,
                slo_ttft=app.slo.ttft * slo_scale,
                slo_tpot=app.slo.tpot * slo_scale,
                mean_prompt=app.mean_prompt,
                mean_output=app.mean_output))
    return out


def generate(instances: Sequence[ModelInstance], rps: float, cv: float,
             duration: float, seed: int = 0, zipf_a: float = 1.1
             ) -> List[Request]:
    """Gamma arrivals: shape k = 1/CV^2, mean 1/rps. Instance choice ~ Zipf."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    scale = (1.0 / rps) / shape
    n_inst = len(instances)
    ranks = np.arange(1, n_inst + 1, dtype=np.float64)
    pop = ranks ** (-zipf_a)
    pop /= pop.sum()
    perm = rng.permutation(n_inst)           # which instance gets which rank

    reqs: List[Request] = []
    t = 0.0
    rid = 0
    while True:
        t += rng.gamma(shape, scale)
        if t >= duration:
            break
        inst = instances[perm[rng.choice(n_inst, p=pop)]]
        prompt = max(8, int(rng.lognormal(math.log(inst.mean_prompt), 0.6)))
        output = max(4, int(rng.lognormal(math.log(inst.mean_output), 0.6)))
        reqs.append(Request(rid, inst.name, inst.app, t,
                            min(prompt, 16384), min(output, 4096),
                            inst.slo_ttft, inst.slo_tpot))
        rid += 1
    return reqs


def multi_turn_sessions(instance: ModelInstance, n_sessions: int,
                        turns: int, *, first_prompt: int = 32,
                        turn_tokens: int = 16, vocab: int = 512,
                        session_rps: float = 0.5, think_s: float = 2.0,
                        cv: float = 1.0, seed: int = 0) -> List[Request]:
    """K-turn chat sessions against one model instance — the workload a
    KV-aware router wins on. Each session opens with ``first_prompt``
    random tokens; every later turn *re-sends the full conversation so
    far* plus ``turn_tokens`` fresh ones, so turn ``k``'s prompt is a
    strict prefix-extension of turn ``k-1``'s and the shared prefix
    grows with the conversation. Sessions open with Gamma(CV) arrivals
    at ``session_rps``; turns within a session are spaced by an
    exponential think time with mean ``think_s``.

    Token ids are sampled uniformly from ``[0, vocab)`` — keep ``vocab``
    at/below the serving model's vocabulary (ids past it index nothing
    and poison the KV cache with NaNs on any engine). ``prompt_ids``
    carries the concrete ids; ``session``/``turn`` label the
    conversation."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / (cv * cv)
    scale = (1.0 / session_rps) / shape
    reqs: List[Request] = []
    rid = 0
    t_open = 0.0
    for s in range(n_sessions):
        t_open += rng.gamma(shape, scale)
        history = [int(x) for x in rng.integers(0, vocab, first_prompt)]
        t = t_open
        for k in range(turns):
            if k > 0:
                t += rng.exponential(think_s)
                history = history + [int(x) for x in
                                     rng.integers(0, vocab, turn_tokens)]
            reqs.append(Request(rid, instance.name, instance.app, t,
                                len(history), instance.mean_output,
                                instance.slo_ttft, instance.slo_tpot,
                                session=s, turn=k,
                                prompt_ids=list(history)))
            rid += 1
    reqs.sort(key=lambda r: (r.arrival, r.req_id))
    return reqs


def burst(instance: ModelInstance, n: int, at: float = 0.0) -> List[Request]:
    """n simultaneous requests to one model (Fig. 14 scale-up experiment)."""
    return [Request(i, instance.name, instance.app, at,
                    instance.mean_prompt, instance.mean_output,
                    instance.slo_ttft, instance.slo_tpot)
            for i in range(n)]


def periodic_bursts(instances: Sequence[ModelInstance], period: float,
                    n_bursts: int, burst_size: int, *,
                    stagger: float = 2.0, start: float = 1.0,
                    jitter: float = 0.0, seed: int = 0) -> List[Request]:
    """Recurring multi-model burst trace (the fleet benchmark's workload):
    instance ``j`` bursts ``burst_size`` simultaneous requests at
    ``start + j*stagger + k*period`` for ``k < n_bursts``, optionally
    jittered. This is the serverless pattern HydraServe's predictive
    prewarming targets — each model goes fully idle between bursts, so a
    purely reactive fleet pays a cold start per episode."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    rid = 0
    for k in range(n_bursts):
        for j, inst in enumerate(instances):
            at = start + j * stagger + k * period
            if jitter > 0:
                at = max(0.0, at + rng.normal(0.0, jitter))
            for _ in range(burst_size):
                reqs.append(Request(rid, inst.name, inst.app, at,
                                    inst.mean_prompt, inst.mean_output,
                                    inst.slo_ttft, inst.slo_tpot))
                rid += 1
    reqs.sort(key=lambda r: r.arrival)
    return reqs
