"""Algorithm 2 — network-contention-aware worker placement.

Per server the tracker keeps the in-flight cold-start fetches (deadline D_i,
pending bytes S_i).  Admission check (Eq. 3): with N residents and one
candidate, every resident must still finish under fair share B/(N+1).
Pending bytes are re-estimated lazily on every bandwidth-changing event
(Eq. 4): S_i' = S_i - B/N * (T - T').
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.types import ColdWorkerRecord, ServerSpec


_DONE_EPS = 1e-6                     # bytes: below this a fetch is finished


@dataclass
class _NodeState:
    spec: ServerSpec
    workers: Dict[str, ColdWorkerRecord] = field(default_factory=dict)
    last_change: float = 0.0
    finish_log: Dict[str, float] = field(default_factory=dict)


class ContentionTracker:
    """Cluster-level bookkeeping behind GETNODEBANDWIDTH /
    HANDLEBANDWIDTHCHANGE in the paper's Algorithm 2."""

    def __init__(self, servers: Dict[str, ServerSpec]):
        self._nodes = {sid: _NodeState(spec) for sid, spec in servers.items()}

    # ----------------------------------------------------------- internals
    def _settle(self, node: _NodeState, now: float):
        """Eq. 4: advance pending sizes to `now`. Every fetch completion is
        itself a bandwidth-change event, so the interval is walked
        iteratively in finish-time order: when a resident's pending bytes
        hit zero mid-interval, the survivors' share steps up to B/(n-1)
        for the remainder — settling the whole interval at the stale B/n
        would undercharge them the freed tail bandwidth. Completion times
        are recorded in ``finish_log`` (queryable via ``finish_time``)."""
        if now <= node.last_change:
            return
        t = node.last_change
        while node.workers and t < now:
            share = node.spec.nic_bytes_per_s / len(node.workers)
            min_pending = min(w.pending_bytes for w in node.workers.values())
            t_fin = t + max(min_pending, 0.0) / share
            step_end = min(t_fin, now)
            dt = max(step_end - t, 0.0)
            done = []
            for w in node.workers.values():
                w.pending_bytes -= share * dt
                if w.pending_bytes <= _DONE_EPS:
                    done.append(w.worker_id)
            if not done and step_end <= t:
                # the residual min pending cannot advance the clock at
                # float resolution (t + dt == t): it is done *now* —
                # without this the loop would spin forever
                done = [w.worker_id for w in node.workers.values()
                        if w.pending_bytes <= min_pending + _DONE_EPS]
            for wid in done:
                node.finish_log[wid] = step_end
                del node.workers[wid]
            if not done and step_end >= now:
                break
            t = step_end
        node.last_change = now

    # ------------------------------------------------------------- queries
    def node_bandwidth(self, server_id: str, now: float) -> float:
        """Effective NIC share a NEW cold-start worker would get on this
        server right now; 0 if admitting it would break Eq. 3 for any
        resident fetch. (Paper's GETNODEBANDWIDTH returns B/N which is
        undefined at N=0 and optimistic otherwise; we return B/(N+1),
        consistent with the Eq. 3 check — noted in DESIGN.md §9.)"""
        node = self._nodes[server_id]
        self._settle(node, now)
        b = node.spec.nic_bytes_per_s
        n = len(node.workers)
        share_after = b / (n + 1)
        for w in node.workers.values():
            if w.pending_bytes > share_after * (w.deadline - now):
                return 0.0
        return share_after

    def effective_bandwidths(self, now: float) -> Dict[str, float]:
        return {sid: self.node_bandwidth(sid, now) for sid in self._nodes}

    def residents(self, server_id: str) -> List[ColdWorkerRecord]:
        return list(self._nodes[server_id].workers.values())

    # ------------------------------------------------------------ mutation
    def admit(self, server_id: str, worker_id: str, fetch_bytes: float,
              deadline: float, now: float):
        node = self._nodes[server_id]
        self._settle(node, now)
        # a re-admitted worker id starts a new fetch: its old completion
        # record is stale (also bounds finish_log growth for id reuse)
        node.finish_log.pop(worker_id, None)
        node.workers[worker_id] = ColdWorkerRecord(worker_id, deadline,
                                                   float(fetch_bytes))

    def complete(self, server_id: str, worker_id: str, now: float):
        """Fetch finished (or worker aborted) — a bandwidth change event."""
        node = self._nodes[server_id]
        self._settle(node, now)
        if node.workers.pop(worker_id, None) is not None:
            node.finish_log[worker_id] = now

    def finish_time(self, server_id: str, worker_id: str) -> Optional[float]:
        """When the fluid model saw this fetch complete (None if still
        pending / unknown). Populated by ``_settle`` at the exact
        fair-share completion instant, or by an explicit ``complete``."""
        return self._nodes[server_id].finish_log.get(worker_id)

    def fair_share(self, server_id: str, now: float) -> float:
        """Current fair share among residents (simulation ground truth)."""
        node = self._nodes[server_id]
        self._settle(node, now)
        n = max(len(node.workers), 1)
        return node.spec.nic_bytes_per_s / n
