"""One run of one cell with the port's own telemetry on: the serving step
and the cold start put down to the phases the port records
(``repro_torch/telemetry.py``):

    python3 bench/tools/phases.py --workload <cell> --seed <n> \\
        [--seconds 51] [--trace 0|1] [--telemetry 0|1]

The run is ``bench/run.py``'s (``cell_run.run``: set-up, the window, the
comparison with the reference). A traced run of the benchmark already
has the port's telemetry on over its window (``rec.port_spans``,
``rec.counters``, ``rec.admissions``) and its breakdown puts each idle
gap of the card down to the step's phase it fell in (``engine.schedule``,
``runner.inputs``, ``runner.forward``, ``engine.sample``,
``engine.emit``) or to the cold start's (``coldstart.plan``,
``load.read``, ``load.copy``, ``engine.build``). This tool also switches
it on in an untraced run (``--trace 0 --telemetry 1``), or off in a
traced one (``--telemetry 0``), for the cost of the spans.

Prints one JSON line: ``correct``, the cell's metrics (per-layer under
``--trace 1``, end-to-end otherwise), the breakdown (traced), and
``phases``: the mean milliseconds a window step spends in each phase,
the phases' share of the steps' wall time, the mean step wall time, the
host syncs a step, the queue wait of the window's requests (submit to
first slot, from ``RequestMetrics``' stamps), the share of the steps
whose prefill took the whole per-step budget, the ``load.copy`` rate, the
mean ``engine.build`` and ``coldstart.plan`` seconds, and the share of
the idle seconds left under the harness's ``step`` label."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def budget_step_share(rec, chunk):
    """The share of the window steps whose prefill took the whole
    per-step budget (``prefill_chunk`` prompt tokens): admissions wait
    behind those."""
    from bench.metrics._common import window_steps
    steps = window_steps(rec)
    if not steps or not chunk:
        return None
    return sum(s.prefill_tokens >= chunk for s in steps) / len(steps)


def mean_span_s(spans, name):
    s = [b - a for n, a, b in spans if n == name]
    return sum(s) / len(s) if s else None


def step_idle_share(breakdown: dict):
    """The share of the idle seconds the breakdown leaves under the
    harness's own ``step`` span (its ten largest labels)."""
    idle = dict(breakdown.get("idle_gaps", []))
    tot = sum(idle.values())
    return idle.get("step", 0.0) / tot if tot > 0 else None


def measure(root, workload: str, seed: int, seconds: float, trace: bool,
            on: bool, device, t_start: float, guard) -> dict:
    from bench.harness import cell_run
    from bench.harness.spec import load_cell
    from bench.metrics._common import (host_syncs_per_step, load_copy_gbps,
                                       queue_wait_ms, step_phases,
                                       window_steps)
    cell = load_cell(root, workload)
    rec, checks, dev, _ = cell_run.run(cell, seed, seconds, trace, device,
                                       t_start, guard, port_telemetry=on)
    spans, counts = rec.port_spans, rec.counters
    out = cell_run.result(cell, rec, checks, dev, trace)
    ph = step_phases(rec, spans)
    ph.update(queue_wait_ms=queue_wait_ms(rec, rec.admissions),
              budget_step_share=budget_step_share(
                  rec, cell.arch["engine"].get("prefill_chunk")),
              host_syncs_per_step=(host_syncs_per_step(rec, counts)
                                   if counts else None),
              load_copy_gbps=load_copy_gbps(spans, counts),
              engine_build_s=mean_span_s(spans, "engine.build"),
              coldstart_plan_s=mean_span_s(spans, "coldstart.plan"),
              window_steps=len(window_steps(rec)), counts=counts)
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
