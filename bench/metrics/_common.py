"""Shared arithmetic of the metric readers (not a metric)."""

from __future__ import annotations

import bisect
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


# The port's own spans and counters (``repro_torch/telemetry.py``), which
# a traced run records in ``rec.port_spans`` and ``rec.counters``: the
# five phases that tile a serving step.
STEP_PHASES = ("engine.schedule", "runner.inputs", "runner.forward",
               "engine.sample", "engine.emit")


def step_phases(rec, spans) -> dict:
    """Mean ms a window step spends in each phase (the spans starting
    inside it), the phases' share of those steps' wall time, and the mean
    step wall time. Empty without a window step."""
    steps = window_steps(rec)
    if not steps:
        return {}
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    tot = dict.fromkeys(STEP_PHASES, 0.0)
    for st in steps:
        i = bisect.bisect_left(starts, st.t0)
        while i < len(spans) and spans[i][1] < st.t1:
            name, a, b = spans[i]
            if name in tot:
                tot[name] += b - a
            i += 1
    wall = sum(s.t1 - s.t0 for s in steps)
    out = {f"{n}_ms_per_step": 1e3 * v / len(steps) for n, v in tot.items()}
    out["phase_share_of_step"] = sum(tot.values()) / wall
    out["step_wall_ms"] = 1e3 * wall / len(steps)
    return out


def step_phase_ms(rec, phase: str):
    """Mean ms a window step spends in ``phase``; None without the port's
    spans or a window step."""
    if not rec.port_spans:
        return None
    return step_phases(rec, rec.port_spans).get(f"{phase}_ms_per_step")


def queue_wait_ms(rec, admissions):
    """Mean of admitted_t - submit_t over the (submit_t, admitted_t) of
    the requests submitted in the window and admitted before it closed."""
    w = [a - s for s, a in admissions
         if s is not None and rec.in_window(s)
         and a is not None and a < rec.t_close]
    return 1e3 * sum(w) / len(w) if w else None


def host_syncs_per_step(rec, counts):
    steps = window_steps(rec)
    return counts["host_sync"] / len(steps) if steps else None


def load_copy_gbps(spans, counts):
    s = sum(b - a for n, a, b in spans if n == "load.copy")
    return counts["load.bytes"] / s / 1e9 if s > 0 else None
