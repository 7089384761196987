"""Streamed, overlap-scheduled stage loading (§5 made real; a port of the
reference's ``store/loader.py``).

``StreamedStageLoader`` materializes a pipeline stage's parameters
tensor-by-tensor in manifest order, straight from a ``ModelStore`` tier's
byte ranges, each copied from the host onto the stage's device (the card
unless the caller asks for the CPU). Container / library / accelerator-context spans are stubbed
from the ``TimingProfile`` (this process *is* already a warm runtime);
fetch and load spans are **measured** — driven by the actual per-tensor
byte counts through the contention-aware ``FetchSchedule`` (fetch) and a
configured load bandwidth (PCIe leg). The result is a
``WorkerTimeline``-compatible record honoring ``OverlapFlags``:

  * no ``prefetch``  — the fetch flow is admitted only after the full
    runtime init (container + lib + cuda), whichever order the flags
    put those in;
  * no ``stream``    — tensors are loaded only once the *entire* stage
    fetch has finished, instead of as each tensor arrives;
  * no ``overlap_load`` — runtime init is cc -> lib -> cuda and loading
    waits for all of it; with it, cc -> cuda and lib runs concurrent
    with loading (ready still waits for lib).

Under matched bandwidths the measured spans converge to
``core.coldstart.worker_timeline``'s analytic ones as tensor count grows
(the stream pipeline's residual is one tensor's transfer) — asserted
within 5% by tests and the fig8/fig9 ``--real-loader`` cross-checks.

The record's spans are the simulated clock's, exactly the reference's:
the reads' and the host-to-device copies' own wall time is not in them.
That is in the wall-clock ``telemetry`` spans ``load.read`` and
``load.copy``, one each a chunk range, and ``load.bytes`` counts the
copies' bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.coldstart import OverlapFlags, WorkerTimeline
from repro_torch.core.types import TimingProfile
from repro_torch.device import resolve_device
from repro_torch.store.manifest import torch_dtype, unflatten_paths
from repro_torch.store.store import FetchSchedule, ModelStore


def to_device(data: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """A flat host array of a chunk range (bfloat16 as raw uint16 words)
    as a tensor of ``shape`` on ``device``: one host-to-device copy (a
    copy on the CPU too, so no param aliases the store's buffers)."""
    if data.dtype == np.uint16:
        data = data.view(np.int16)
    t = torch.from_numpy(data).view(torch_dtype(dtype)).reshape(shape)
    return t.to(device, copy=True)


@dataclass
class TensorSpan:
    """Per-tensor stream record: when its bytes arrived and when its
    load (host -> device) leg ran. With ``stream`` the accounted DMA
    chases the byte-arrival profile (a tensor's copy overlaps its own
    fetch tail, like a real pinned-buffer DMA); the tensor copy itself
    stays tensor-granular."""
    key: str
    nbytes: int
    fetch_start: float
    fetch_end: float
    load_start: float
    load_end: float


@dataclass
class StageLoadRecord:
    """Measured cold-start record for one stage worker —
    ``timeline.spans`` uses the same stage names/conventions as the
    analytic ``worker_timeline`` so the two are directly comparable."""
    stage: int
    n_stages: int
    server_id: str
    tier: str
    fetched_bytes: int
    timeline: WorkerTimeline
    tensors: List[TensorSpan] = field(default_factory=list)

    @property
    def ready(self) -> float:
        return self.timeline.ready

    def to_json(self) -> dict:
        return {
            "stage": self.stage, "n_stages": self.n_stages,
            "server": self.server_id, "tier": self.tier,
            "fetched_bytes": self.fetched_bytes,
            "ready": self.timeline.ready,
            "spans": {k: list(v) for k, v in self.timeline.spans.items()},
            "n_tensors": len(self.tensors),
        }


@dataclass
class ColdStartReport:
    """What a whole cold start measured: one record per stage worker."""
    model: str
    s: int
    flags: OverlapFlags
    stages: List[StageLoadRecord]

    @property
    def ready(self) -> float:
        return max(r.timeline.ready for r in self.stages)

    @property
    def total_bytes(self) -> int:
        return sum(r.fetched_bytes for r in self.stages)

    def to_json(self) -> dict:
        return {
            "model": self.model, "s": self.s,
            "flags": {"prefetch": self.flags.prefetch,
                      "stream": self.flags.stream,
                      "overlap_load": self.flags.overlap_load},
            "ready": self.ready, "total_bytes": self.total_bytes,
            "stages": [r.to_json() for r in self.stages],
        }


class StreamedStageLoader:
    """Loads stage parameter slices out of a ``ModelStore`` onto
    ``device`` (default: the card) while accounting a measured cold-start
    timeline on the fetch schedule's simulated clock."""

    def __init__(self, store: ModelStore, schedule: FetchSchedule,
                 timings: Optional[TimingProfile] = None,
                 flags: OverlapFlags = OverlapFlags.all(),
                 load_bytes_per_s: float = 12e9,
                 tier: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.store = store
        self.schedule = schedule
        self.timings = timings or TimingProfile()
        self.flags = flags
        self.load_bw = float(load_bytes_per_s)
        self.tier_name = store.tier(tier).name

    # ----------------------------------------------------------- internals
    def _runtime_spans(self, start: float) -> Dict[str, Tuple[float, float]]:
        """Container / lib / cuda spans stubbed from the TimingProfile,
        in the order the flags dictate (same rules as worker_timeline)."""
        t = self.timings
        spans = {"container": (start, start + t.t_cc)}
        cc_end = start + t.t_cc
        if self.flags.overlap_load:
            spans["cuda"] = (cc_end, cc_end + t.t_cu)
            spans["lib"] = (cc_end + t.t_cu, cc_end + t.t_cu + t.t_l)
        else:
            spans["lib"] = (cc_end, cc_end + t.t_l)
            spans["cuda"] = (cc_end + t.t_l, cc_end + t.t_l + t.t_cu)
        return spans

    # -------------------------------------------------------------- public
    def admit_stage(self, n_stages: int, stage: int, *,
                    server_id: str = "local", worker_id: str = "w0",
                    now: float = 0.0, deadline: float = math.inf):
        """Phase 1: start the stage's fetch flow (prefetch semantics
        decide when relative to runtime init). Admit every stage of a
        group — and any concurrently cold-starting group — before
        materializing, so same-server flows contend (Alg. 2)."""
        spans = self._runtime_spans(now)
        runtime_end = max(spans["lib"][1], spans["cuda"][1])
        fetch_start = now if self.flags.prefetch else runtime_end
        nbytes = self.store.stage_bytes(n_stages, stage)
        cap = self.store.tier(self.tier_name).bandwidth
        flow = self.schedule.admit(server_id, worker_id, nbytes,
                                   now=fetch_start, cap=cap,
                                   deadline=deadline)
        return _PendingStage(self, n_stages, stage, server_id, now, spans,
                             flow)

    def load_stage(self, n_stages: int, stage: int, *,
                   server_id: str = "local", worker_id: str = "w0",
                   now: float = 0.0, deadline: float = math.inf):
        """Admit + materialize one stage (single-worker convenience).
        Returns ``(stage_params, StageLoadRecord)``."""
        return self.admit_stage(n_stages, stage, server_id=server_id,
                                worker_id=worker_id, now=now,
                                deadline=deadline).materialize()

    def load_group(self, n_stages: int, *, servers=None, now: float = 0.0,
                   worker_ids=None, deadline: float = math.inf,
                   model_name: Optional[str] = None):
        """Cold-start a whole pipeline group: admit all stage flows first
        (so stages placed on the same server contend for its NIC), then
        materialize each. Returns ``(stage_params_list, ColdStartReport)``.
        """
        servers = list(servers or ["local"] * n_stages)
        worker_ids = list(worker_ids
                          or [f"stage{i}" for i in range(n_stages)])
        pending = [self.admit_stage(n_stages, i, server_id=servers[i],
                                    worker_id=worker_ids[i], now=now,
                                    deadline=deadline)
                   for i in range(n_stages)]
        params, records = [], []
        for p in pending:
            sp, rec = p.materialize()
            params.append(sp)
            records.append(rec)
        report = ColdStartReport(model_name or self.store.manifest.model,
                                 n_stages, self.flags, records)
        return params, report


class _PendingStage:
    """A stage whose fetch flow is admitted but not yet materialized."""

    def __init__(self, loader: StreamedStageLoader, n_stages: int,
                 stage: int, server_id: str, start: float, spans, flow):
        self.loader = loader
        self.n_stages = n_stages
        self.stage = stage
        self.server_id = server_id
        self.start = start
        self.spans = spans
        self.flow = flow

    def materialize(self):
        """Phase 2: resolve the fetch on the simulated clock and stream
        the tensors — each chunk range is *actually read* from the tier
        and copied onto the loader's device into the stage's param
        subtree; its fetch/load instants come from the flow's measured
        byte-arrival profile."""
        ld = self.loader
        flags, spans = ld.flags, dict(self.spans)
        flow = ld.schedule.resolve(self.flow)
        plan = ld.store.stage_plan(self.n_stages, self.stage)
        cuda_end = spans["cuda"][1]
        lib_end = spans["lib"][1]

        fetch_end = flow.end
        load_begin = max(cuda_end, flow.start)
        cursor = load_begin if flags.stream \
            else max(fetch_end, load_begin)
        leaves = {}
        tensors: List[TensorSpan] = []
        cum = 0
        for sc in plan:
            arrive_begin = flow.time_at_bytes(cum)
            cum += sc.length
            arrive_end = flow.time_at_bytes(cum)
            with telemetry.span("load.read"):
                data = ld.store.read_range(sc.chunk, sc.offset, sc.length,
                                           tier=ld.tier_name)
            with telemetry.span("load.copy"):
                leaves[sc.chunk.path] = to_device(data, sc.chunk.dtype,
                                                  sc.shape, ld.device)
            telemetry.count("load.bytes", data.nbytes)
            if flags.stream:
                # DMA chases the arrival stream: it can start on the
                # tensor's first byte and finishes no earlier than its
                # last byte lands (and no faster than the PCIe leg)
                t0 = max(cursor, arrive_begin)
                t1 = max(arrive_end, t0 + sc.length / ld.load_bw)
            else:
                t0 = cursor
                t1 = t0 + sc.length / ld.load_bw
            tensors.append(TensorSpan(sc.chunk.key, sc.length,
                                      arrive_begin, arrive_end, t0, t1))
            cursor = t1
        load_end = max(cursor, fetch_end) if not tensors else cursor
        spans["fetch"] = (flow.start, fetch_end)
        spans["load"] = (load_begin, load_end)
        ready = max(load_end, lib_end)
        assert all(s0 <= s1 + 1e-12 for s0, s1 in spans.values())
        timeline = WorkerTimeline(ready=ready, spans=spans)
        record = StageLoadRecord(self.stage, self.n_stages, self.server_id,
                                 ld.tier_name, int(flow.size), timeline,
                                 tensors)
        return unflatten_paths(leaves), record
