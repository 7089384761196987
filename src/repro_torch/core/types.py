"""Shared datatypes for the cold-start controller (a copy of the
reference's ``core/types.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

GB = 1 << 30
Gbps = 1e9 / 8           # bytes/sec per Gbit/s


@dataclass
class SLO:
    ttft: float                      # seconds
    tpot: float                      # seconds / token

    def scaled(self, f: float) -> "SLO":
        return SLO(self.ttft * f, self.tpot * f)


@dataclass
class TimingProfile:
    """Historical per-model / per-platform timings (paper §4.1.2, §5.2).

    Defaults calibrated so model fetching dominates (paper Fig. 1; a
    Llama2-7B cold start on a contended 16 Gbps NIC reaches ~25-40 s, of
    which fetch is the largest stage; Table 1 supplies warm latencies).
    They are inputs of the simulated cold-start clock, taken from the
    paper: no measurement of any device.
    """
    t_cc: float = 2.0                # container creation
    t_l: float = 2.5                 # library loading (CPU-bound)
    t_cu: float = 0.5                # accelerator context init
    t_n: float = 0.010               # per-hop activation transmission
    t_p: float = 1.5                 # full prefill, warm, full memory
    t_d: float = 0.042               # per-token decode, warm, full memory

    @property
    def t_c(self) -> float:
        """Aggregate container+runtime init used by the non-overlapped Eq.1."""
        return self.t_cc + self.t_l + self.t_cu


@dataclass
class ServerSpec:
    server_id: str
    nic_bytes_per_s: float           # b_i
    pcie_bytes_per_s: float          # p_i
    hbm_bytes: int                   # accelerator memory per server
    n_devices: int = 1


@dataclass
class ColdWorkerRecord:
    """Alg.2 bookkeeping entry: one in-flight cold-start fetch on a server."""
    worker_id: str
    deadline: float                  # D_i (absolute time)
    pending_bytes: float             # S_i


@dataclass
class ColdStartScheme:
    """Output of Algorithm 1."""
    s: int                           # pipeline parallelism size
    w: int                           # number of full-memory workers
    servers: Tuple[str, ...]         # one per worker (first w full-memory)
    predicted_ttft: float
    predicted_tpot: float
    slo_ok: bool

    @property
    def full_memory(self) -> Tuple[bool, ...]:
        return tuple(i < self.w for i in range(self.s))


@dataclass
class ModelProfile:
    """What the controller knows about a registered model."""
    name: str
    size_bytes: int
    timings: TimingProfile
    slo: SLO
    max_pp: int = 4
    # HBM a *warm, non-parallelized* worker reserves (weights + KV + runtime)
    full_hbm_bytes: Optional[int] = None
    # per-token KV footprint (all layers); None = geometry unknown, callers
    # fall back to their own default (see kv_bytes_from_geometry)
    kv_bytes_per_token: Optional[int] = None

    @staticmethod
    def kv_bytes_from_geometry(n_attn_layers: int, n_kv_heads: int,
                               head_dim: int, dtype_bytes: int = 2) -> int:
        """KV bytes one token pins across the whole model: K and V, every
        attention layer — 2 * layers * kv_heads * head_dim * dtype."""
        return 2 * n_attn_layers * n_kv_heads * head_dim * dtype_bytes

    def hbm_full(self) -> int:
        if self.full_hbm_bytes is not None:
            return self.full_hbm_bytes
        return int(self.size_bytes * 1.25)     # weights + KV/activations slack

    def hbm_low(self, s: int) -> int:
        return max(self.hbm_full() // s, 1)
