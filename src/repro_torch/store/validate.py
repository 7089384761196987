"""Cross-check the measured (executed) cold-start timeline against the
analytic ``worker_timeline`` under matched bandwidths (a copy of the
reference's ``store/validate.py``; the loader takes a ``device``).

This is the bridge the repro was missing: ``core.coldstart`` predicts the
Fig. 9 spans from aggregate (bytes, bandwidth) pairs; the
``StreamedStageLoader`` *executes* the same schedule tensor-by-tensor.
Under equal bandwidths the two must agree — exactly for the
container/lib/cuda stubs and the fetch span, and within a small relative
tolerance (one tensor's worth of pipeline residual) for the streamed
load span and readiness.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.coldstart import OverlapFlags, WorkerTimeline, \
    worker_timeline
from repro_torch.core.types import TimingProfile
from repro_torch.store.loader import StageLoadRecord, StreamedStageLoader
from repro_torch.store.store import FetchSchedule, ModelStore

DEFAULT_TOL = 0.05                   # the 5% acceptance bound


def _rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-9)


@dataclass
class StageCrossCheck:
    stage: int
    measured: StageLoadRecord
    analytic: WorkerTimeline

    @property
    def ready_err(self) -> float:
        return _rel_err(self.measured.timeline.ready, self.analytic.ready)

    def span_errs(self) -> dict:
        out = {}
        for name, (a0, a1) in self.analytic.spans.items():
            m0, m1 = self.measured.timeline.spans[name]
            scale = max(a1 - a0, a1, 1e-9)
            out[name] = max(abs(m0 - a0), abs(m1 - a1)) / scale
        return out

    @property
    def max_err(self) -> float:
        return max(self.ready_err, *self.span_errs().values())

    def to_json(self) -> dict:
        return {
            "stage": self.stage,
            "measured_ready": self.measured.timeline.ready,
            "analytic_ready": self.analytic.ready,
            "ready_err": self.ready_err,
            "span_errs": self.span_errs(),
            "measured_spans": {k: list(v) for k, v
                               in self.measured.timeline.spans.items()},
            "analytic_spans": {k: list(v) for k, v
                               in self.analytic.spans.items()},
        }


def crosscheck_stages(store: ModelStore, s: int, *,
                      timings: Optional[TimingProfile] = None,
                      flags: OverlapFlags = OverlapFlags.all(),
                      nic_bytes_per_s: float,
                      load_bytes_per_s: float,
                      tier: Optional[str] = None,
                      start: float = 0.0,
                      device=None) -> List[StageCrossCheck]:
    """Run the real loader for every stage of an s-way cold start — one
    uncontended server per stage — and pair each measured record with the
    analytic ``worker_timeline`` fed the *same* byte counts and
    bandwidths. The analytic fetch bandwidth is ``min(nic, tier)``, which
    is what a single flow on an idle NIC gets. The stage params land on
    ``device`` (default: the card) and are dropped."""
    timings = timings or TimingProfile()
    checks: List[StageCrossCheck] = []
    tier_bw = store.tier(tier).bandwidth
    eff_bw = min(nic_bytes_per_s, tier_bw)
    for stage in range(s):
        sched = FetchSchedule.single(nic_bytes_per_s,
                                     server_id=f"xsrv{stage}")
        loader = StreamedStageLoader(store, sched, timings, flags,
                                     load_bytes_per_s=load_bytes_per_s,
                                     tier=tier, device=device)
        _, rec = loader.load_stage(s, stage, server_id=f"xsrv{stage}",
                                   worker_id=f"xchk{stage}", now=start)
        nbytes = store.stage_bytes(s, stage)
        ana = worker_timeline(timings, nbytes / eff_bw,
                              nbytes / load_bytes_per_s, flags, start)
        checks.append(StageCrossCheck(stage, rec, ana))
    return checks


def assert_within(checks: List[StageCrossCheck],
                  tol: float = DEFAULT_TOL) -> float:
    worst = max(c.max_err for c in checks)
    assert worst <= tol, (
        f"measured cold-start spans drifted {worst:.1%} from the analytic "
        f"worker_timeline (> {tol:.0%}): "
        f"{[(c.stage, c.span_errs()) for c in checks]}")
    return worst
