"""KV-aware replica routing.

Given N replicas of one model, each with its own paged prefix cache, the
router decides which replica an incoming prompt should land on. Three
policies behind one interface:

  * ``round_robin`` — replica-oblivious rotation (the baseline the bench
    compares against);
  * ``least_loaded`` — min queued+running, ignoring KV residency;
  * ``kv_affinity`` — scores each replica by the prompt's warm-prefix
    length (via the ``ResidencyIndex``), counts lower-tier *restorable*
    blocks at a discount (they ride the transfer network, not HBM), and
    divides by the replica's load so a long warm prefix on a saturated
    replica does not win forever; when the best replica is *saturated*
    (waiting pool at/over threshold, or a cold start still pending) the
    request overflows to the least-loaded unsaturated replica instead —
    affinity must never add head-of-line latency that outweighs the
    prefill it saves.

Policies see ``ReplicaView`` snapshots (residency match + the engine's
cheap ``stats()`` dict + fleet-provided pending flag) and return a
``RouteDecision`` that records what was known at choice time — the bench
aggregates these for the warm/restorable hit accounting.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.router.residency import ResidencyIndex

__all__ = ["ReplicaView", "RouteDecision", "RoutingPolicy",
           "RoundRobinPolicy", "LeastLoadedPolicy", "KVAffinityPolicy",
           "Router", "make_routing_policy", "ROUTING_POLICIES"]


@dataclass
class ReplicaView:
    """What a policy knows about one replica at decision time."""
    name: str
    warm_blocks: int
    restorable_blocks: int
    block_size: int
    stats: dict
    pending: bool = False        # cold start in flight (fleet-provided)

    @property
    def warm_tokens(self) -> int:
        return self.warm_blocks * self.block_size

    @property
    def restorable_tokens(self) -> int:
        return self.restorable_blocks * self.block_size

    @property
    def queued(self) -> int:
        return self.stats.get("waiting", 0) + self.stats.get("preempted", 0)

    @property
    def load(self) -> int:
        return self.queued + self.stats.get("running", 0)


@dataclass(frozen=True)
class RouteDecision:
    name: str                    # chosen replica
    policy: str
    warm_blocks: int             # residency of the prompt on the choice
    restorable_blocks: int
    score: float
    overflowed: bool             # saturation pushed us off the best replica


class RoutingPolicy:
    """Pick one ReplicaView. Stateless except where noted."""

    name = "base"

    def choose(self, views: Sequence[ReplicaView]) -> ReplicaView:
        raise NotImplementedError


class RoundRobinPolicy(RoutingPolicy):
    """Rotate over replicas in name order, skipping pending cold starts
    when a ready replica exists. KV-oblivious — the bench baseline."""

    name = "round_robin"

    def __init__(self):
        self._i = 0

    def choose(self, views):
        ordered = sorted(views, key=lambda v: v.name)
        ready = [v for v in ordered if not v.pending] or ordered
        v = ready[self._i % len(ready)]
        self._i += 1
        return v


class LeastLoadedPolicy(RoutingPolicy):
    """Min queued+running (ties by name). KV-oblivious."""

    name = "least_loaded"

    def choose(self, views):
        ready = [v for v in views if not v.pending] or list(views)
        return min(ready, key=lambda v: (v.load, v.name))


class KVAffinityPolicy(RoutingPolicy):
    """Warm-prefix affinity with saturation overflow.

    score = (warm_tokens + restore_frac * restorable_tokens) / (1 + load)

    ``restore_frac`` discounts blocks that would be restored from the
    host/segment tiers — cheaper than re-prefill but not free like an
    HBM hit. A replica is *saturated* when its waiting+preempted pool is
    at/over ``saturation_queue`` or its cold start is still pending; a
    saturated best replica overflows to the least-loaded unsaturated one
    (or stays put if every replica is saturated — then the queue is the
    cost everywhere and affinity still saves the prefill)."""

    name = "kv_affinity"

    def __init__(self, saturation_queue: int = 4,
                 restore_frac: float = 0.5):
        self.saturation_queue = saturation_queue
        self.restore_frac = restore_frac

    def score(self, v: ReplicaView) -> float:
        warm = v.warm_tokens + self.restore_frac * v.restorable_tokens
        return warm / (1.0 + v.load)

    def saturated(self, v: ReplicaView) -> bool:
        return v.pending or v.queued >= self.saturation_queue

    def choose(self, views):
        best = max(views, key=lambda v: (self.score(v), -v.load, v.name))
        if not self.saturated(best):
            return best
        open_ = [v for v in views if not self.saturated(v)]
        if open_:
            return min(open_, key=lambda v: (v.load, v.name))
        return min(views, key=lambda v: (v.load, v.name))


ROUTING_POLICIES = {p.name: p for p in
                    (RoundRobinPolicy, LeastLoadedPolicy, KVAffinityPolicy)}


def make_routing_policy(policy: Union[str, RoutingPolicy],
                        **kw) -> RoutingPolicy:
    if isinstance(policy, RoutingPolicy):
        return policy
    try:
        return ROUTING_POLICIES[policy](**kw)
    except KeyError:
        raise ValueError(f"unknown routing policy {policy!r}: want one of "
                         f"{sorted(ROUTING_POLICIES)} or a RoutingPolicy "
                         "instance") from None


class Router:
    """Replica registry + residency index + policy, for one model.

    Replicas register with their ``ServingEndpoint`` (anything exposing
    ``.engine.block_mgr`` and ``.stats()`` works); the residency index
    attaches to the endpoint's BlockManager, which survives §6.2 engine
    swaps, so a consolidation needs no re-registration. ``route(tokens)``
    snapshots every replica and asks the policy."""

    def __init__(self, policy: Union[str, RoutingPolicy] = "kv_affinity",
                 kv_tier=None, **policy_kw):
        self.policy = make_routing_policy(policy, **policy_kw)
        self.kv_tier = kv_tier
        self.residency = ResidencyIndex(kv_tier=kv_tier)
        self._endpoints: Dict[str, object] = {}
        self._pending: Dict[str, bool] = {}
        self.decisions: List[RouteDecision] = []

    # ------------------------------------------------------- membership
    def register(self, name: str, endpoint):
        self._endpoints[name] = endpoint
        self._pending.setdefault(name, False)
        self.residency.attach(name, endpoint.engine.block_mgr)

    def unregister(self, name: str):
        del self._endpoints[name]
        self._pending.pop(name, None)
        self.residency.detach(name)

    def replicas(self) -> List[str]:
        return list(self._endpoints)

    def endpoint_of(self, name: str):
        return self._endpoints[name]

    def set_pending(self, name: str, pending: bool = True):
        """Fleet signal: this replica's cold start is still in flight
        (counts as saturated / routed around while a ready one exists)."""
        self._pending[name] = pending

    # ---------------------------------------------------------- routing
    def view(self, name: str, tokens: Sequence[int]) -> ReplicaView:
        warm, restorable = self.residency.match(name, tokens)
        return ReplicaView(name, warm, restorable,
                           self.residency.block_size_of(name),
                           self._endpoints[name].stats(),
                           pending=self._pending.get(name, False))

    def route(self, tokens: Sequence[int]) -> RouteDecision:
        if not self._endpoints:
            raise RuntimeError("router has no registered replicas")
        views = [self.view(name, tokens) for name in
                 sorted(self._endpoints)]
        chosen = self.policy.choose(views)
        best_by_affinity = max(
            views, key=lambda v: (v.warm_tokens + v.restorable_tokens,
                                  v.name))
        overflowed = (chosen.name != best_by_affinity.name
                      and best_by_affinity.warm_tokens
                      + best_by_affinity.restorable_tokens > 0)
        d = RouteDecision(chosen.name, self.policy.name,
                          chosen.warm_blocks, chosen.restorable_blocks,
                          getattr(self.policy, "score",
                                  lambda v: 0.0)(chosen),
                          overflowed)
        self.decisions.append(d)
        return d

    def stats(self) -> dict:
        n_over = sum(d.overflowed for d in self.decisions)
        return {
            "policy": self.policy.name,
            "replicas": sorted(self._endpoints),
            "decisions": len(self.decisions),
            "overflows": n_over,
            "warm_blocks_routed": sum(d.warm_blocks for d in
                                      self.decisions),
            "restorable_blocks_routed": sum(d.restorable_blocks
                                            for d in self.decisions),
        }
