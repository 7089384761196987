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

The copy leg depends on the device. On the CPU each range is one copy
(``to_device``). On the card a stage's ranges stream through a ring of
page-locked host slots (``ring_plan``): the host fills the next slot from
the tier's buffer while the slot before it goes to the leaf's tensor on a
copy stream, and a slot is filled again only once the event after its
last DMA has passed. There ``load.copy`` spans each range's fill and
enqueue, and one more spans the stage's wait for the copy stream, so the
leaves ``materialize()`` hands back are ready for any stream;
``load.staged_bytes`` counts the bytes sent through the ring and
``load.slot_waits`` the fills that found their slot's DMA unfinished.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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


# The ring: on an H100's host the fill of a pinned slot from pageable
# memory sets the pace, not the DMA (42-50 GB/s alone), and it is fastest
# into a ring small enough to stay in the host's cache: 2 x 16 MiB moved
# 31 GB/s, 4 x 16 or 2 x 64 MiB 18-20 (PERF.md §6).
SLOT_BYTES = 16 << 20
N_SLOTS = 2


def ring_plan(lengths: Sequence[int], slot_bytes: int
              ) -> List[List[Tuple[int, int, int, int]]]:
    """Where the bytes of ranges of ``lengths`` go through a ring of
    slots of ``slot_bytes``: per range, its pieces ``(fill, at, offset,
    n)``, the ``n`` bytes from ``offset`` in the range copied to byte
    ``at`` of the ``fill``-th slot filled. Ranges are packed back to back
    in order: one longer than a slot spans consecutive fills, short ones
    share a fill."""
    plan, fill, at = [], 0, 0
    for length in lengths:
        pieces, off = [], 0
        while off < length:
            if at == slot_bytes:
                fill, at = fill + 1, 0
            n = min(length - off, slot_bytes - at)
            pieces.append((fill, at, off, n))
            off += n
            at += n
        plan.append(pieces)
    return plan


class _Ring:
    """``N_SLOTS`` page-locked host slots of ``SLOT_BYTES``, a copy stream
    onto one card, and for each slot the event recorded after its last
    DMA. One per card per process (``_ring``): every cold start reuses
    it, so the pinned memory is allocated once and is the ring alone."""

    def __init__(self, device: torch.device):
        buf = torch.empty(N_SLOTS * SLOT_BYTES, dtype=torch.uint8,
                          pin_memory=True)
        self.slots = [buf[i * SLOT_BYTES:(i + 1) * SLOT_BYTES]
                      for i in range(N_SLOTS)]
        self.drained = [torch.cuda.Event() for _ in range(N_SLOTS)]
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()


_RINGS: Dict[torch.device, _Ring] = {}


def _ring(device: torch.device) -> _Ring:
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _RINGS:
        _RINGS[device] = _Ring(device)
    return _RINGS[device]


class _RingStage:
    """One stage's ranges, in plan order, through the card's ring: each
    range's pieces are filled into the slots on the host and sent on the
    copy stream into the leaf's tensor, allocated once on the card. The
    ring is held from ``__enter__`` to ``__exit__``, which waits for the
    copy stream (one more ``load.copy`` span)."""

    def __init__(self, device: torch.device, lengths: Sequence[int]):
        self.device = device
        self.ring = _ring(device)
        self.plan = iter(ring_plan(lengths, SLOT_BYTES))
        self.fill = None

    def __enter__(self):
        self.ring.lock.acquire()
        # the leaves' memory may come from tensors whose last readers are
        # still queued on the allocating stream
        self.ring.stream.wait_stream(torch.cuda.current_stream(self.device))
        return self

    def send(self, data: np.ndarray, dtype: str, shape) -> torch.Tensor:
        out = torch.empty(shape, dtype=torch_dtype(dtype), device=self.device)
        dst = out.view(-1).view(torch.uint8)
        src = torch.from_numpy(data.view(np.uint8))
        ring = self.ring
        for fill, at, off, n in next(self.plan):
            slot = fill % N_SLOTS
            if fill != self.fill:
                self._close()
                if not ring.drained[slot].query():
                    telemetry.count("load.slot_waits")
                    ring.drained[slot].synchronize()
                self.fill = fill
            ring.slots[slot][at:at + n].copy_(src[off:off + n])
            with torch.cuda.stream(ring.stream):
                dst[off:off + n].copy_(ring.slots[slot][at:at + n],
                                       non_blocking=True)
        telemetry.count("load.staged_bytes", data.nbytes)
        return out

    def _close(self):
        """The current fill's last DMA is queued: mark its slot."""
        if self.fill is not None:
            self.ring.drained[self.fill % N_SLOTS].record(self.ring.stream)

    def __exit__(self, *exc):
        try:
            with telemetry.span("load.copy"):
                self._close()
                self.ring.stream.synchronize()
        finally:
            self.ring.lock.release()
        return False


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
        ring = (_RingStage(ld.device, [sc.length for sc in plan])
                if ld.device.type == "cuda" else None)
        with ring or contextlib.nullcontext():
            for sc in plan:
                arrive_begin = flow.time_at_bytes(cum)
                cum += sc.length
                arrive_end = flow.time_at_bytes(cum)
                with telemetry.span("load.read"):
                    data = ld.store.read_range(sc.chunk, sc.offset,
                                               sc.length, tier=ld.tier_name)
                with telemetry.span("load.copy"):
                    leaves[sc.chunk.path] = (
                        to_device(data, sc.chunk.dtype, sc.shape, ld.device)
                        if ring is None
                        else ring.send(data, sc.chunk.dtype, sc.shape))
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
