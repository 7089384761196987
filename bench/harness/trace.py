"""The traced run: ``torch.profiler`` over the window (device activity
only), its events mapped onto the host clock, the merged busy intervals,
and the breakdown of device time and of idle gaps by the host span they
fall in.

The profiler's timestamps are on the wall clock; they are tied to the
host's ``perf_counter`` by the wall clock read beside it, and refined by a
marker: the card is synchronised, both clocks read, and
``torch.cuda._sleep`` launched; its kernel's start in the trace is that
instant (to the launch latency, microseconds). A profile may miss the
marker launched as it starts; the wall clock then maps alone."""

from __future__ import annotations

import bisect
import time
from typing import List, Tuple

import torch

MARK_CYCLES = 1000


def _events(prof):
    """(name, start_ns, end_ns) of every device event of a finished
    profile."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
        return out
    except AttributeError:
        pass
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tr = e.time_range
            out.append((e.name, int(tr.start * 1000), int(tr.end * 1000)))
    return out


class Tracer:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.marks: List[float] = []
        self.walls: List[float] = []

    def warm(self):
        """One short profile in set-up, so that starting the window's
        costs no profiler initialisation."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(16, device=self.device).add_(1)
            torch.cuda.synchronize()

    def _mark(self):
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        self.walls.append(time.time())
        torch.cuda._sleep(MARK_CYCLES)

    def start(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()

    def abort(self):
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None

    def stop(self, rec):
        """Close the profile and fill ``rec``'s device events and busy
        intervals (host clock, clipped to the window)."""
        self._mark()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        evs = _events(self.prof)
        self.prof = None
        # the profiler's clock is the wall clock: map by it, then refine by
        # the first marker found within 50 ms of a host mark
        offset = self.walls[0] - self.marks[0]
        spins = sorted(s for n, s, _ in evs if "spin" in n)
        found = 0
        for s in spins:
            for h, w in zip(self.marks, self.walls):
                if abs(s * 1e-9 - w) < 0.05:
                    if not found:
                        offset = s * 1e-9 - h
                    found += 1
                    break
        rec.extra["clock_marks_found"] = float(found)
        rec.extra["trace_events"] = float(len(evs))
        if evs:
            rec.extra["trace_first_s"] = min(s for _, s, _ in evs) * 1e-9 \
                - offset - rec.t_open
            rec.extra["trace_last_s"] = max(e for _, _, e in evs) * 1e-9 \
                - offset - rec.t_open
        out = []
        for name, s, e in evs:
            if "spin" in name:
                continue
            a, b = s * 1e-9 - offset, e * 1e-9 - offset
            a, b = max(a, rec.t_open), min(b, rec.t_close)
            if b > a:
                out.append((name, a, b))
        out.sort(key=lambda x: x[1])
        rec.device_events = out
        rec.busy = merge([(a, b) for _, a, b in out])
        rec.traced = True
        rec.extra["trace_process_s"] = time.perf_counter() - t0


def merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_in(busy: List[Tuple[float, float]], t0: float, t1: float) -> float:
    """Seconds of [t0, t1) covered by the merged intervals ``busy``."""
    starts = [a for a, _ in busy]
    i = max(0, bisect.bisect_right(starts, t0) - 1)
    tot = 0.0
    while i < len(busy) and busy[i][0] < t1:
        a, b = busy[i]
        tot += max(0.0, min(b, t1) - max(a, t0))
        i += 1
    return tot


def span_at(spans, t: float) -> str:
    """The label of the innermost host span holding ``t`` (spans are
    recorded in order of their ends; the shortest one holding t wins)."""
    best, width = "other", float("inf")
    for label, a, b in spans:
        if a <= t < b and b - a < width:
            best, width = label, b - a
    return best


def breakdown(rec, top: int = 10) -> dict:
    """The device operations that took most time, and the idle seconds by
    the host span the host was inside (summed over the window's gaps)."""
    by_op = {}
    for name, a, b in rec.device_events:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda x: -x[1])[:top]
    gaps = []
    prev = rec.t_open
    for a, b in rec.busy + [(rec.t_close, rec.t_close)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    spans = sorted(rec.spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    idle = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        hi = bisect.bisect_right(starts, mid)
        label = span_at(spans[max(0, hi - 8):hi], mid)
        idle[label] = idle.get(label, 0.0) + (b - a)
    gl = sorted(idle.items(), key=lambda x: -x[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gl]}
