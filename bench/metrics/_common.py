"""Shared arithmetic of the metric readers (not a metric)."""

from __future__ import annotations

import re


def window_steps(rec):
    return [s for s in rec.steps if rec.in_window(s.t0)]


def kernel_seconds(rec, names) -> float:
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return sum(b - a for n, a, b in rec.device_events if pat.search(n))


def call_bound_seconds(rec, family: str) -> float:
    from bench.frozen.peaks import bound_s
    return sum(bound_s(nb, fl) for t, fam, nb, fl in rec.calls
               if fam == family and rec.in_window(t))


def roofline_pct(rec, family: str, names):
    """Share of the bound: the least time the calls' own work needs, over
    the device time of the kernels that ran it. None without a trace or
    without such a launch."""
    if not rec.traced:
        return None
    dev = kernel_seconds(rec, names)
    bound = call_bound_seconds(rec, family)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev


def idle_pct(rec):
    if not rec.traced or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in rec.busy) / rec.window_s)
