"""Tiered model store + the simulated-clock fetch schedule (a port of the
reference's ``store/store.py``; numpy only, the tensors come in through
``manifest.build_manifest``).

``ModelStore`` answers "give me these bytes of that chunk" from one of a
set of *tiers* — local disk, a peer server's host cache, a remote
registry — each with a configured bandwidth. The bytes are real (read
from disk or an in-memory mirror); the *transfer time* is accounted on a
simulated clock by ``FetchSchedule``, which consumes the Algorithm-2
``ContentionTracker`` fair shares so concurrent cold starts on one
server contend exactly like the paper says they do (Eq. 4: every fetch
completion is a bandwidth-change event; the tracker's iterative settle
provides the per-interval share).

A fetch flow's rate at any instant is ``min(tier_bandwidth, fair_share)``.
Tier-capped flows consume less than their fair share; the tracker's Eq. 4
bookkeeping then retires them early, which redistributes the slack to the
uncapped survivors — the physical behaviour of a flow bottlenecked away
from the NIC.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.placement import ContentionTracker
from repro_torch.core.types import GB, Gbps, ServerSpec
from repro_torch.store.manifest import (CHUNK_DIR, ChunkRecord, Manifest,
                                        build_manifest, load_manifest,
                                        np_dtype, save_model)

# Default tier bandwidths (bytes/s): local NVMe readback, a peer server's
# host cache over the 16 Gbps testbed NIC, a remote object registry.
LOCAL_BW = 12e9
PEER_BW = 16 * Gbps
REMOTE_BW = 2 * Gbps

_DONE_EPS = 1e-6


# --------------------------------------------------------------------- tiers
class StoreTier:
    """One source of model bytes: a name, a bandwidth for the simulated
    transfer leg, and a byte-range reader. A read returns a writable
    bytes-like buffer, so the loader builds tensors on it without a copy
    or a read-only warning."""

    def __init__(self, name: str, bandwidth: float):
        self.name = name
        self.bandwidth = float(bandwidth)

    def read(self, chunk: ChunkRecord, offset: int, length: int):
        raise NotImplementedError


class DiskTier(StoreTier):
    """Chunks on a filesystem — used for local disk, and (at a different
    bandwidth) as the backing of peer / remote-registry tiers."""

    def __init__(self, name: str, root: str, bandwidth: float):
        super().__init__(name, bandwidth)
        self.root = root

    def read(self, chunk: ChunkRecord, offset: int, length: int) -> bytearray:
        path = os.path.join(self.root, CHUNK_DIR, chunk.file)
        data = bytearray(length)
        with open(path, "rb") as f:
            f.seek(offset)
            got = f.readinto(data)
        if got != length:
            raise IOError(f"short read of {chunk.file}: wanted {length} "
                          f"bytes at {offset}, got {got}")
        return data


class MemoryTier(StoreTier):
    """Raw chunk bytes held in host memory — the ``from_params`` path
    (and the model of a warm peer's host cache when given a finite bw).
    The blobs are flat uint8 arrays (where the reference keeps ``bytes``),
    so a range read is a view, not a copy of a multi-GiB chunk."""

    def __init__(self, name: str, blobs: Dict[str, np.ndarray],
                 bandwidth: float = math.inf):
        super().__init__(name, bandwidth)
        self._blobs = blobs

    def read(self, chunk: ChunkRecord, offset: int,
             length: int) -> np.ndarray:
        return self._blobs[chunk.file][offset:offset + length]


class AliasTier(StoreTier):
    """A placement of the same bytes at a different bandwidth: reads are
    served by the backing tier (whatever it hands back: ``bytearray`` from
    disk, a ``uint8`` view from memory), only the simulated transfer leg
    differs. This is what Alg. 1 proactive model distribution creates —
    'the model is now resident on a nearby server group' without
    duplicating data."""

    def __init__(self, name: str, base: StoreTier, bandwidth: float):
        super().__init__(name, bandwidth)
        self.base = base

    def read(self, chunk: ChunkRecord, offset: int, length: int):
        return self.base.read(chunk, offset, length)


# ------------------------------------------------------------ fetch schedule
@dataclass
class FetchFlow:
    """One in-flight stage fetch on the simulated clock. ``segments`` is
    the piecewise-constant rate profile the fluid model produced — enough
    to answer "when had byte k arrived?" at tensor granularity."""
    server_id: str
    worker_id: str
    size: float
    cap: float
    start: float
    pending: float = 0.0
    segments: List[Tuple[float, float, float]] = field(default_factory=list)
    end: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.end is not None

    @property
    def seconds(self) -> float:
        assert self.end is not None
        return self.end - self.start

    def time_at_bytes(self, nbytes: float) -> float:
        """Arrival instant of the ``nbytes``-th byte (cumulative)."""
        if nbytes <= 0:
            return self.start
        assert self.done, "resolve the flow first"
        cum = 0.0
        for t0, t1, rate in self.segments:
            got = rate * (t1 - t0)
            if cum + got >= nbytes - _DONE_EPS:
                return t0 + (nbytes - cum) / rate if rate > 0 else t1
            cum += got
        return self.end


@dataclass
class _ServerQueue:
    clock: float = 0.0
    flows: List[FetchFlow] = field(default_factory=list)


class FetchSchedule:
    """Simulated-clock fluid model of concurrent cold-start fetches.

    Admissions register with the ``ContentionTracker`` (so Algorithm 2's
    Eq. 3 admission checks see the load) and each event interval's share
    comes from ``tracker.fair_share``; flow completions are reported back
    as bandwidth-change events. Contention is modeled among flows that
    coexist *before resolution* — admit every concurrent flow first,
    then resolve (``StreamedStageLoader.load_group`` does this for the
    stages of one cold start). Resolved flows are frozen history: a
    fetch admitted after another was resolved runs against an idle NIC,
    not retroactively alongside it.
    """

    def __init__(self, tracker: ContentionTracker):
        self.tracker = tracker
        self._queues: Dict[str, _ServerQueue] = {}

    @staticmethod
    def single(bandwidth: float, server_id: str = "local") -> "FetchSchedule":
        """A standalone one-server schedule (store unit tests, loaders
        outside a cluster): NIC bandwidth == the given bandwidth."""
        spec = ServerSpec(server_id, float(bandwidth), 12e9, 1024 * GB)
        return FetchSchedule(ContentionTracker({server_id: spec}))

    # ------------------------------------------------------------- internals
    def _queue(self, server_id: str) -> _ServerQueue:
        return self._queues.setdefault(server_id, _ServerQueue())

    def _step(self, q: _ServerQueue, server_id: str):
        """Advance to the next completion event under the current shares."""
        t = q.clock
        share = self.tracker.fair_share(server_id, t)
        rates = [min(f.cap, share) for f in q.flows]
        dt = min(f.pending / r if r > 0 else math.inf
                 for f, r in zip(q.flows, rates))
        assert math.isfinite(dt), "stalled fetch flow (zero bandwidth)"
        t1 = t + dt
        # a residual below the clock's float resolution (t + dt == t)
        # cannot advance time: finish the minimal flows right here
        # instead of spinning
        force = t1 <= t
        still: List[FetchFlow] = []
        for f, r in zip(q.flows, rates):
            if t1 > t:
                f.segments.append((t, t1, r))
            f.pending -= r * dt
            if f.pending <= _DONE_EPS or \
                    (force and r > 0
                     and f.pending / r <= dt * (1 + 1e-9) + 1e-18):
                f.end = t1
                self.tracker.complete(server_id, f.worker_id, t1)
            else:
                still.append(f)
        q.flows = still
        q.clock = t1

    # --------------------------------------------------------------- public
    def admit(self, server_id: str, worker_id: str, nbytes: float,
              now: float = 0.0, cap: float = math.inf,
              deadline: float = math.inf) -> FetchFlow:
        """Start a fetch of ``nbytes`` on ``server_id``'s NIC at ``now``,
        capped at the source tier's bandwidth. An idle server (no active
        flows) accepts any ``now`` — its NIC has no history to preserve,
        so a later cold start's clock restarts at its own ``now``; while
        flows are in flight the start is clamped to the frozen event
        clock (resolved history cannot be rewritten)."""
        q = self._queue(server_id)
        if not q.flows:
            q.clock = now
        start = max(now, q.clock)
        flow = FetchFlow(server_id, worker_id, float(nbytes), float(cap),
                         start, pending=float(nbytes))
        if nbytes <= 0:
            flow.end = start
            return flow
        self.tracker.admit(server_id, worker_id, nbytes, deadline, start)
        q.flows.append(flow)
        return flow

    def resolve(self, flow: FetchFlow) -> FetchFlow:
        """Run the fluid model until ``flow`` completes."""
        q = self._queue(flow.server_id)
        while not flow.done:
            self._step(q, flow.server_id)
        return flow

    def transfer(self, server_id: str, worker_id: str, nbytes: float,
                 now: float = 0.0, cap: float = math.inf) -> FetchFlow:
        """Admit + resolve in one call (single transfers: consolidation's
        weight fill-in, KV migration)."""
        return self.resolve(self.admit(server_id, worker_id, nbytes, now,
                                       cap))


# ----------------------------------------------------------------- the store
class ModelStore:
    """A chunked model plus the ordered tiers its bytes can come from
    (fastest first). ``tier(name)`` / ``source`` pick where a fetch is
    served from; the byte content is identical across tiers — only the
    simulated transfer bandwidth differs."""

    def __init__(self, manifest: Manifest, tiers: List[StoreTier]):
        assert tiers, "a ModelStore needs at least one tier"
        self.manifest = manifest
        self.tiers = list(tiers)

    # ---------------------------------------------------------- constructors
    @staticmethod
    def open(directory: str, local_bw: float = LOCAL_BW,
             peer_bw: Optional[float] = PEER_BW,
             remote_bw: Optional[float] = REMOTE_BW) -> "ModelStore":
        """Open an on-disk store written by ``save_model``. The same chunk
        files back all three tiers; peer/remote model fetching the bytes
        over the network at their configured bandwidths."""
        manifest = load_manifest(directory)
        tiers: List[StoreTier] = [DiskTier("local", directory, local_bw)]
        if peer_bw is not None:
            tiers.append(DiskTier("peer", directory, peer_bw))
        if remote_bw is not None:
            tiers.append(DiskTier("remote", directory, remote_bw))
        return ModelStore(manifest, tiers)

    @staticmethod
    def save(directory: str, model, params, degrees=None,
             **open_kw) -> "ModelStore":
        save_model(directory, model, params, degrees)
        return ModelStore.open(directory, **open_kw)

    @staticmethod
    def from_params(model, params, degrees=None,
                    bandwidth: float = math.inf) -> "ModelStore":
        """The in-memory path: chunk the live tree into host-memory blobs
        (one 'memory' tier). Default bandwidth is infinite — transfer time
        is then bounded only by the NIC fair share."""
        manifest, arrays = build_manifest(model, params, degrees)
        blobs = {fname: arr.reshape(-1).view(np.uint8)
                 for fname, arr in arrays.items()}
        return ModelStore(manifest, [MemoryTier("memory", blobs, bandwidth)])

    # --------------------------------------------------------------- queries
    @property
    def total_bytes(self) -> int:
        return self.manifest.total_bytes

    def stage_bytes(self, s: int, stage: int) -> int:
        return self.manifest.stage_bytes(s, stage)

    def stage_plan(self, s: int, stage: int):
        return self.manifest.stage_plan(s, stage)

    def tier(self, name: Optional[str] = None) -> StoreTier:
        if name is None:
            return self.tiers[0]
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier {name!r} (have "
                       f"{[t.name for t in self.tiers]})")

    # ------------------------------------------------------ tier placement
    def has_tier(self, name: str) -> bool:
        return any(t.name == name for t in self.tiers)

    def fastest_tier(self) -> StoreTier:
        return max(self.tiers, key=lambda t: t.bandwidth)

    def add_tier(self, tier: StoreTier) -> StoreTier:
        """Register a tier, keeping the list sorted fastest-first (so the
        default ``tier(None)`` pick is the best placement we have)."""
        if self.has_tier(tier.name):
            raise ValueError(f"tier {tier.name!r} already exists")
        self.tiers.append(tier)
        self.tiers.sort(key=lambda t: -t.bandwidth)
        return tier

    def place(self, name: str, bandwidth: float,
              source: Optional[str] = None) -> StoreTier:
        """Explicit tier placement (Alg. 1 proactive distribution): make
        the model's bytes available under tier ``name`` at ``bandwidth``,
        backed by ``source`` (default: the current slowest tier — the
        authoritative copy). Re-placing an existing name retunes its
        bandwidth in place; the list stays sorted fastest-first."""
        if self.has_tier(name):
            t = self.tier(name)
            t.bandwidth = float(bandwidth)
            self.tiers.sort(key=lambda t: -t.bandwidth)
            return t
        base = self.tier(source) if source is not None else \
            min(self.tiers, key=lambda t: t.bandwidth)
        return self.add_tier(AliasTier(name, base, bandwidth))

    def drop_tier(self, name: str):
        """Un-place a tier (scale-to-zero of a placement). The last tier
        can never be dropped — the model must stay fetchable."""
        t = self.tier(name)
        if len(self.tiers) == 1:
            raise ValueError("cannot drop the only tier")
        for other in self.tiers:
            if other is not t and isinstance(other, AliasTier) \
                    and other.base is t:
                raise ValueError(
                    f"tier {name!r} still backs placement {other.name!r}")
        self.tiers.remove(t)

    # ---------------------------------------------------------------- reads
    def read_range(self, chunk: ChunkRecord, offset: int, length: int,
                   tier: Optional[str] = None) -> np.ndarray:
        """Materialize a byte range of a chunk as a flat host array
        (bfloat16 as its raw uint16 words)."""
        data = self.tier(tier).read(chunk, offset, length)
        return np.frombuffer(data, dtype=np_dtype(chunk.dtype))
