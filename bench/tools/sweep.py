"""The knee of a serving cell: its traffic offered at several fixed rates
in one process, each on a fresh engine over the same weights, with the
backlog and the rates read per window:

    python3 bench/tools/sweep.py --workload <cell> --rates 1,2,3 \\
        [--seconds 30] [--seed N]

One JSON line a rate: offered and completed tokens/s, ttft_p75_s,
tpot_p75_ms, and the queue (``num_queued``) over the window's first and
last fifths. The knee is the highest rate whose queue does not grow; a
cell offers about four fifths of it (``rate_per_s`` in its cell file)."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=2**31 + 1)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.endpoint import ServingEndpoint
    from repro_torch.serving.engine import Engine
    from bench.frozen.stats import mean
    from bench.harness import traffic as T
    from bench.harness import weights as W
    from bench.harness.cell_run import _warm, engine_kw
    from bench.harness.drive import Loop, open_loop, release
    from bench.harness.record import Record
    from bench.harness.spec import load_cell, port_config
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    arch = cell.arch
    weights = W.make(arch, args.seed, "cuda")
    reads = {m.name: m.read for m in cell.end_to_end}
    for rate in (float(r) for r in args.rates.split(",")):
        ep = ServingEndpoint(Engine(port_config(arch), [weights],
                                    device="cuda",
                                    fused=arch["engine"].get("fused", False),
                                    **engine_kw(arch)))
        _warm(ep, SamplingParams, cell.traffic, arch, args.seed)
        rec = Record(time.perf_counter())
        loop = Loop(rec, SamplingParams)
        sched = T.open_loop(cell.traffic, rate, args.seconds, args.seed,
                            arch["vocab_size"])
        rec.t_open = time.perf_counter() + float(cell.traffic["ramp_s"])
        rec.t_close = rec.t_open + args.seconds
        open_loop(ep, loop, sched, rec.t_open, args.seconds)
        w = [s for s in rec.steps if rec.in_window(s.t0)]
        fifth = max(1, len(w) // 5)
        offered = sum(q.max_new for q in sched
                      if 0 <= q.arrival < args.seconds) / args.seconds
        out = {"workload": cell.name, "rate_per_s": rate,
               "offered_tok_s": offered,
               "queued_first_fifth": mean(s.num_queued for s in w[:fifth]),
               "queued_last_fifth": mean(s.num_queued for s in w[-fifth:]),
               "steps": len(w),
               "step_ms_mean": 1e3 * mean(s.t1 - s.t0 for s in w)}
        for name in ("output_tok_s", "ttft_p75_s", "tpot_p75_ms"):
            if name in reads:
                out[name] = reads[name](rec)
        print(json.dumps(out), flush=True)
        ep = None
        release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
