"""KV-aware routing subsystem: residency-indexed replica routing with
multi-tier KV spill/restore.

Three layers (the port of the reference's ``router`` package):

``residency`` — ``ResidencyIndex``: per-replica mirror of each engine's
                prefix index, kept exact via the BlockManager
                commit/evict notifications; answers "longest warm prefix
                for this token chain per replica".
``router``    — ``Router`` + policies (``kv_affinity``, ``round_robin``,
                ``least_loaded``): scores replicas by warm-prefix length
                discounted by saturation, overflows to least-loaded when
                the preferred replica is saturated.
``kvtier``    — ``KVBlockStore``: HBM → host → segment KV tiers; evicted
                prefix-cache blocks spill instead of vanishing and are
                restored into any same-model replica's page pool on a
                routing hit, the transfer accounted as a measured
                contention-fair flow.
"""

from repro_torch.router.kvtier import KVBlockStore
from repro_torch.router.residency import ResidencyIndex
from repro_torch.router.router import (KVAffinityPolicy, LeastLoadedPolicy,
                                 ReplicaView, RouteDecision,
                                 RoundRobinPolicy, Router, RoutingPolicy,
                                 make_routing_policy)

__all__ = [
    "KVBlockStore", "ResidencyIndex",
    "ReplicaView", "RouteDecision", "RoutingPolicy", "RoundRobinPolicy",
    "LeastLoadedPolicy", "KVAffinityPolicy", "Router",
    "make_routing_policy",
]
