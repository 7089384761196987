"""One run of one cell with the port's own telemetry on: the serving step
and the cold start put down to the phases the port records
(``repro_torch/telemetry.py``):

    python3 bench/tools/phases.py --workload <cell> --seed <n> \\
        [--seconds 51] [--trace 0|1] [--telemetry 0|1]

The run is ``bench/run.py``'s (``cell_run.run``: set-up, the window, the
comparison with the reference), with two additions around its window
drivers: ``telemetry.enable()`` as the window opens (``--telemetry 1``,
the default), and ``telemetry.drain()`` as it closes. The drained spans
join the harness's own in the record, so that under ``--trace 1`` the
breakdown puts each idle gap of the card down to the step's phase it
fell in (``engine.schedule``, ``runner.inputs``, ``runner.forward``,
``engine.sample``, ``engine.emit``) or to the cold start's
(``coldstart.plan``, ``load.read``, ``load.copy``, ``engine.build``).

Prints one JSON line: ``correct``, the cell's metrics (per-layer under
``--trace 1``, end-to-end otherwise), the breakdown (traced), and
``phases``: the mean milliseconds a window step spends in each phase,
the phases' share of the steps' wall time, the mean step wall time, the
host syncs a step, the queue wait of the window's requests (submit to
first slot, from ``RequestMetrics``' stamps), the share of the steps
whose prefill took the whole per-step budget, the ``load.copy`` rate, the
mean ``engine.build`` and ``coldstart.plan`` seconds, and the share of
the idle seconds left under the harness's ``step`` label.

``--telemetry 0`` runs the same with the spans off, for the cost of
having them on. ``bench/run.py`` never switches telemetry on: this tool
is no part of a cell's result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
STEP_PHASES = ("engine.schedule", "runner.inputs", "runner.forward",
               "engine.sample", "engine.emit")


def _steps(rec):
    return [s for s in rec.steps if rec.in_window(s.t0)]


def step_phases(rec, spans) -> dict:
    """Mean ms a window step spends in each phase (the spans starting
    inside it), the phases' share of those steps' wall time, and the mean
    step wall time. Empty without a window step."""
    steps = _steps(rec)
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


def queue_wait_ms(rec, metrics):
    """Mean of admitted_t - submit_t over the requests submitted in the
    window and admitted before it closed."""
    w = [m.admitted_t - m.submit_t for m in metrics
         if m.submit_t is not None and rec.in_window(m.submit_t)
         and m.admitted_t is not None and m.admitted_t < rec.t_close]
    return 1e3 * sum(w) / len(w) if w else None


def budget_step_share(rec, chunk):
    """The share of the window steps whose prefill took the whole
    per-step budget (``prefill_chunk`` prompt tokens): admissions wait
    behind those."""
    steps = _steps(rec)
    if not steps or not chunk:
        return None
    return sum(s.prefill_tokens >= chunk for s in steps) / len(steps)


def host_syncs_per_step(rec, counts):
    steps = _steps(rec)
    return counts["host_sync"] / len(steps) if steps else None


def load_copy_gbps(spans, counts):
    s = sum(b - a for n, a, b in spans if n == "load.copy")
    return counts["load.bytes"] / s / 1e9 if s > 0 else None


def mean_span_s(spans, name):
    s = [b - a for n, a, b in spans if n == name]
    return sum(s) / len(s) if s else None


def step_idle_share(breakdown: dict):
    """The share of the idle seconds the breakdown leaves under the
    harness's own ``step`` span (its ten largest labels)."""
    idle = dict(breakdown.get("idle_gaps", []))
    tot = sum(idle.values())
    return idle.get("step", 0.0) / tot if tot > 0 else None


def _instrument(prog: dict, on: bool):
    """``cell_run``'s two window drivers, with telemetry switched on as
    the window opens and drained as it closes (into ``prog``: the spans,
    the counters' change over the window and, for an open loop, the
    ``RequestMetrics`` of every request the engine holds)."""
    from bench.harness import cell_run
    from repro_torch import telemetry

    def opened(on_open):
        def run():
            if on:
                telemetry.drain()
                telemetry.enable()
            prog["c0"] = telemetry.counters()
            on_open()
        return run

    def closed():
        telemetry.disable()
        spans, counts = telemetry.drain()
        prog["spans"] = spans
        prog["counts"] = {k: v - prog["c0"].get(k, 0)
                          for k, v in counts.items()}

    open_loop, cold_bursts = cell_run.open_loop, cell_run.cold_bursts

    def open_loop_on(ep, loop, schedule, t_open, window_s, on_open):
        try:
            return open_loop(ep, loop, schedule, t_open, window_s,
                             opened(on_open))
        finally:
            closed()
            eng = ep.engine
            prog["metrics"] = [r.metrics for r in
                               eng.finished + eng.active()
                               + list(eng.scheduler.waiting)
                               + list(eng.scheduler.preempted)]

    def cold_bursts_on(front, name, engine_kw, loop, bursts, t_open,
                       window_s, on_open, **kw):
        try:
            return cold_bursts(front, name, engine_kw, loop, bursts, t_open,
                               window_s, opened(on_open), **kw)
        finally:
            closed()

    cell_run.open_loop, cell_run.cold_bursts = open_loop_on, cold_bursts_on


def measure(root, workload: str, seed: int, seconds: float, trace: bool,
            on: bool, device, t_start: float, guard) -> dict:
    from bench.harness import cell_run
    from bench.harness.spec import load_cell
    cell = load_cell(root, workload)
    prog = {"metrics": []}
    saved = cell_run.open_loop, cell_run.cold_bursts
    _instrument(prog, on)
    try:
        rec, checks, dev, _ = cell_run.run(cell, seed, seconds, trace,
                                           device, t_start, guard)
    finally:
        cell_run.open_loop, cell_run.cold_bursts = saved
    spans, counts = prog["spans"], prog["counts"]
    rec.spans.extend(s for s in spans if rec.in_window(s[1]))
    out = cell_run.result(cell, rec, checks, dev, trace)
    ph = step_phases(rec, spans)
    ph.update(queue_wait_ms=queue_wait_ms(rec, prog["metrics"]),
              budget_step_share=budget_step_share(
                  rec, cell.arch["engine"].get("prefill_chunk")),
              host_syncs_per_step=host_syncs_per_step(rec, counts),
              load_copy_gbps=load_copy_gbps(spans, counts),
              engine_build_s=mean_span_s(spans, "engine.build"),
              coldstart_plan_s=mean_span_s(spans, "coldstart.plan"),
              window_steps=len(_steps(rec)), counts=counts)
    if "breakdown" in out:
        ph["step_idle_share"] = step_idle_share(out["breakdown"])
    out.update(workload=workload, seed=seed, telemetry=int(on),
               trace=int(trace), phases=ph, extra=rec.extra)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--telemetry", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from bench.run import guard
    try:
        import repro_torch.telemetry  # noqa: F401
    except ImportError:
        print("phases: this checkout's repro_torch has no telemetry",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("phases: no CUDA card", file=sys.stderr)
        return 2
    guard()
    out = measure(ROOT, args.workload, args.seed, args.seconds,
                  bool(args.trace), bool(args.telemetry), "cuda", T_START,
                  guard)
    guard()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
