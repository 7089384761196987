"""Simulated GPU/TPU cluster: per-server fair-share NIC (weighted fluid
model), per-device HBM accounting, host-memory model cache, and a remote
model registry with unbounded egress (fetch is bottlenecked by the
receiving server's NIC, as in the paper's testbeds)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.cluster.sim import EventSim
from repro_torch.core.types import GB, ServerSpec


@dataclass
class Flow:
    """One remote->host fetch on a server NIC."""
    flow_id: int
    server_id: str
    remaining: float                # bytes
    weight: float                   # priority weight for fair share
    on_done: Callable[[], None]
    rate: float = 0.0
    done: bool = False
    _completion_ev: object = None


@dataclass
class Device:
    device_id: str
    hbm_total: int
    hbm_free: int


class Server:
    def __init__(self, spec: ServerSpec, host_mem_bytes: int):
        self.spec = spec
        self.devices = [
            Device(f"{spec.server_id}/dev{i}", spec.hbm_bytes, spec.hbm_bytes)
            for i in range(spec.n_devices)
        ]
        self.host_mem_total = host_mem_bytes
        self.host_mem_free = host_mem_bytes
        self.flows: Dict[int, Flow] = {}
        self.cached_models: Dict[str, int] = {}     # model -> bytes (LRU)
        self._lru: List[str] = []

    # ------------------------------------------------------------- memory
    def fit_device(self, need: int) -> Optional[Device]:
        for d in self.devices:
            if d.hbm_free >= need:
                return d
        return None

    def max_free_hbm(self) -> int:
        return max((d.hbm_free for d in self.devices), default=0)

    def alloc(self, device: Device, amount: int):
        assert device.hbm_free >= amount, (device.device_id, amount)
        device.hbm_free -= amount

    def free(self, device: Device, amount: int):
        device.hbm_free = min(device.hbm_free + amount, device.hbm_total)

    # --------------------------------------------------------- host cache
    def cache_touch(self, model: str):
        if model in self._lru:
            self._lru.remove(model)
            self._lru.append(model)

    def cache_put(self, model: str, size: int) -> bool:
        if model in self.cached_models:
            self.cache_touch(model)
            return True
        while self.host_mem_free < size and self._lru:
            evict = self._lru.pop(0)
            self.host_mem_free += self.cached_models.pop(evict)
        if self.host_mem_free < size:
            return False
        self.host_mem_free -= size
        self.cached_models[model] = size
        self._lru.append(model)
        return True

    def cache_has(self, model: str) -> bool:
        return model in self.cached_models


class Cluster:
    """Servers + the weighted-fair-share NIC fluid model.

    Every flow on a server receives bandwidth B * w_f / sum(w); on any flow
    set change we settle elapsed progress and recompute completion events.
    """

    def __init__(self, sim: EventSim, servers: List[ServerSpec],
                 host_mem_bytes: int = 188 * GB):
        self.sim = sim
        self.servers: Dict[str, Server] = {
            s.server_id: Server(s, host_mem_bytes) for s in servers}
        self._flow_counter = 0
        self._last_settle: Dict[str, float] = {s.server_id: 0.0
                                               for s in servers}

    # ------------------------------------------------------------ network
    def _settle(self, server: Server):
        now = self.sim.now
        last = self._last_settle[server.spec.server_id]
        dt = now - last
        if dt > 0:
            for f in server.flows.values():
                f.remaining = max(0.0, f.remaining - f.rate * dt)
        self._last_settle[server.spec.server_id] = now

    def _reschedule(self, server: Server):
        self._settle(server)
        total_w = sum(f.weight for f in server.flows.values())
        bw = server.spec.nic_bytes_per_s
        for f in server.flows.values():
            self.sim.cancel(f._completion_ev)
            f.rate = bw * (f.weight / total_w) if total_w else 0.0
            if f.rate <= 0:
                continue
            eta = f.remaining / f.rate
            fid = f.flow_id
            f._completion_ev = self.sim.after(
                eta, lambda fid=fid, sid=server.spec.server_id:
                self._finish_flow(sid, fid))

    def _finish_flow(self, server_id: str, flow_id: int):
        server = self.servers[server_id]
        f = server.flows.get(flow_id)
        if f is None or f.done:
            return
        self._settle(server)
        # done-threshold is in *bytes*: float time resolution (~fs) times
        # GB/s rates leaves micro-byte residuals that must count as done
        if f.remaining > 1.0:       # stale event after resettle
            self._reschedule(server)
            return
        f.done = True
        del server.flows[flow_id]
        self._reschedule(server)
        f.on_done()

    def start_fetch(self, server_id: str, nbytes: float,
                    on_done: Callable[[], None], weight: float = 1.0) -> Flow:
        server = self.servers[server_id]
        self._flow_counter += 1
        f = Flow(self._flow_counter, server_id, float(nbytes), weight, on_done)
        if nbytes <= 0:
            self.sim.after(0.0, on_done)
            f.done = True
            return f
        server.flows[f.flow_id] = f
        self._reschedule(server)
        return f

    def cancel_fetch(self, flow: Flow):
        server = self.servers[flow.server_id]
        if flow.flow_id in server.flows:
            self._settle(server)
            self.sim.cancel(flow._completion_ev)
            del server.flows[flow.flow_id]
            flow.done = True
            self._reschedule(server)

    def flow_progress(self, flow: Flow) -> float:
        """Bytes still pending (after settling)."""
        if flow.done:
            return 0.0
        self._settle(self.servers[flow.server_id])
        return flow.remaining

    # ------------------------------------------------------------ helpers
    def specs(self) -> Dict[str, ServerSpec]:
        return {sid: s.spec for sid, s in self.servers.items()}

    def free_hbm(self) -> Dict[str, int]:
        return {sid: s.max_free_hbm() for sid, s in self.servers.items()}
