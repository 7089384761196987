"""Pipeline consolidation (§6): scale-down / scale-up policy and the
sliding-window worker-count predictor.

Mechanics (background fetch of remaining parts, KV migration) live in
serving/; this module is the *policy*: how many standalone workers a
pipeline group should consolidate into.
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass
from typing import Deque, Dict, List, Tuple


@dataclass(frozen=True)
class ConsolidationPlan:
    mode: str               # 'down' | 'up'
    keep_workers: int       # standalone workers the group becomes
    group_sizes: Tuple[int, ...]   # pipeline groups to create on cold start


class SlidingWindowPredictor:
    """Per-model arrival predictor (§6.1): the request count of the previous
    window is the predicted maximum for the next."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = window_s
        self._arrivals: Dict[str, Deque[float]] = collections.defaultdict(
            collections.deque)

    def record(self, model: str, now: float):
        q = self._arrivals[model]
        q.append(now)
        self._trim(q, now)

    def _trim(self, q: Deque[float], now: float):
        while q and q[0] < now - self.window_s:
            q.popleft()

    def predicted_next_window(self, model: str, now: float) -> int:
        q = self._arrivals[model]
        self._trim(q, now)
        return len(q)


class ConsolidationPolicy:
    """Sizes cold-start groups and picks scale-down vs scale-up."""

    def __init__(self, predictor: SlidingWindowPredictor,
                 per_worker_capacity: int = 8):
        self.predictor = predictor
        self.per_worker_capacity = per_worker_capacity

    def required_workers(self, model: str, queue_len: int, now: float) -> int:
        """Workers needed = (waiting requests + predicted arrivals) /
        per-worker batch capacity (§6.1)."""
        predicted = self.predictor.predicted_next_window(model, now)
        return max(1, math.ceil((queue_len + predicted)
                                / self.per_worker_capacity))

    def plan(self, model: str, queue_len: int, now: float,
             max_pp: int, current_workers: int = 0) -> ConsolidationPlan:
        """Decide group shape for a cold start and the consolidation target.

        Default is scale-DOWN (one standalone worker remains). Under burst
        (required > current+1) switch to scale-UP: create pipeline groups
        covering the deficit; every member later becomes standalone.
        """
        assert max_pp >= 1
        required = self.required_workers(model, queue_len, now)
        deficit = max(1, required - current_workers)
        if deficit <= 1:
            # widest pipeline the placement allows: fastest cold start,
            # consolidating down to one standalone worker afterwards
            return ConsolidationPlan("down", 1, (max_pp,))
        groups: List[int] = []
        remaining = deficit
        while remaining > 0:
            g = min(max_pp, remaining)
            groups.append(g)
            remaining -= g
        return ConsolidationPlan("up", deficit, tuple(groups))
