"""Worker-level overlapping (§5): the cold-start stage timeline.

``worker_timeline`` composes the six stages of Fig. 1 under the optimization
flags of Fig. 9 (+Prefetch / +Stream / +Overlap); ``group_ttft`` adds the
pipeline-level prefill terms. The cluster simulator supplies
contention-accurate fetch durations; the analytic callers use bytes/bw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from repro_torch.core.types import TimingProfile


@dataclass(frozen=True)
class OverlapFlags:
    """Which worker-level optimizations are on (Fig. 9's ablation axis)."""
    prefetch: bool = True      # node-level prefetcher: fetch starts at t=0
    stream: bool = True        # fetch->load pipelined at tensor granularity
    overlap_load: bool = True  # accel-ctx first; lib load || model load

    @staticmethod
    def none() -> "OverlapFlags":
        return OverlapFlags(False, False, False)

    @staticmethod
    def all() -> "OverlapFlags":
        return OverlapFlags(True, True, True)


@dataclass
class WorkerTimeline:
    ready: float
    spans: Dict[str, Tuple[float, float]] = field(default_factory=dict)


def worker_timeline(t: TimingProfile, fetch_seconds: float,
                    load_seconds: float,
                    flags: OverlapFlags = OverlapFlags.all(),
                    start: float = 0.0) -> WorkerTimeline:
    """Absolute stage spans for one cold-start worker (relative to `start`).

    Rules:
      * fetch begins at t=0 with prefetch, else after runtime init.
      * without overlap_load the runtime path is cc -> lib -> cuda; with it
        cc -> cuda (prioritized) and lib runs parallel to model loading.
      * loading needs the device context; with stream it consumes tensors as
        they arrive, so load_end = max(fetch_end, load_begin + load).
      * inference additionally needs libraries: ready = max(load_end, lib_end)
    """
    spans: Dict[str, Tuple[float, float]] = {}
    cc_end = start + t.t_cc
    spans["container"] = (start, cc_end)

    if flags.overlap_load:
        cuda_end = cc_end + t.t_cu
        lib_end = cuda_end + t.t_l          # runs concurrent with loading
        spans["cuda"] = (cc_end, cuda_end)
        spans["lib"] = (cuda_end, lib_end)
    else:
        lib_end = cc_end + t.t_l
        cuda_end = lib_end + t.t_cu
        spans["lib"] = (cc_end, lib_end)
        spans["cuda"] = (lib_end, cuda_end)

    if flags.prefetch:
        fetch_start = start
    else:
        # classic workflow: fetch only after the full runtime init,
        # whichever order (lib/cuda) the flags put it in
        fetch_start = max(lib_end, cuda_end)
    fetch_end = fetch_start + fetch_seconds
    spans["fetch"] = (fetch_start, fetch_end)

    load_begin = max(cuda_end, fetch_start)
    if flags.stream:
        load_end = max(fetch_end, load_begin + load_seconds)
    else:
        load_end = max(fetch_end, load_begin) + load_seconds
    spans["load"] = (load_begin, load_end)

    ready = max(load_end, lib_end)
    assert all(s0 <= s1 for s0, s1 in spans.values())
    if not flags.prefetch:
        # fetch must not overlap ANY runtime-init stage span: the classic
        # workflow downloads only once container + lib + cuda are all
        # done. Checked against the recorded spans (not the locals that
        # defined fetch_start) so a future reordering of the init stages
        # can't silently start the fetch early.
        for stage in ("container", "lib", "cuda"):
            assert spans["fetch"][0] >= spans[stage][1], \
                f"no-prefetch fetch overlaps runtime init stage {stage!r}"
    assert ready >= max(s1 for _, s1 in spans.values()) - 1e-12
    return WorkerTimeline(ready=ready, spans=spans)


def group_ttft(worker_ready: Tuple[float, ...], s: int, w: int,
               t: TimingProfile) -> float:
    """First token time for a pipeline group: slowest worker + prefill chain
    (full-memory worker: t_p/s per stage; low-memory: t_p) + s activation
    hops (Eq. 1/5 prefill terms)."""
    prefill = t.t_p * (s - w + w / s) + t.t_n * s if s > 1 else t.t_p
    return max(worker_ready) + prefill


def group_tpot(s: int, w: int, t: TimingProfile) -> float:
    if s == 1:
        return t.t_d
    return t.t_d * (s - w + w / s) + t.t_n * s
