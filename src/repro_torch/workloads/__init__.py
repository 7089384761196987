"""Workloads the simulator and the fleet run (copies of the reference's
``workloads`` modules; numpy only).

``applications`` — the paper's application presets (Tables 1–2): warm
                   profiles, SLOs, per-token KV bytes from the geometry;
``generator``    — Gamma-arrival request traces over Zipf-popular model
                   instances, multi-turn sessions, bursts.
"""

from repro_torch.workloads.applications import (  # noqa: F401
    APPLICATIONS, WARM, Application, WarmProfile, kv_bytes_for, timings_for)
from repro_torch.workloads.generator import (  # noqa: F401
    ModelInstance, Request, burst, generate, make_instances,
    multi_turn_sessions, periodic_bursts)
