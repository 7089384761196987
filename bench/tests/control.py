"""The control of a cell's correctness check, and the program's readings
beside it, on several seeds in one process:

    python3 bench/tests/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds S] [--out FILE]

For each seed it runs the cell as the benchmark does (its window at the
cell's own load) and reads, over the checked sample: the program's
reading, the widest gap by which a served token's reference logit lies
below the reference's best; and the control's, the same gap for the
token that the reference computed with float8 (e4m3) products puts
first at each of those positions; each as the widest gap, the mean gap
and the share of tokens parted from the reference's best. One JSON line
a seed. The benchmark's
own runs never run the control; ``test_bench_control.py`` runs this on
the card."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def readings(cell, seed: int, seconds: float, device, guard, t_start):
    from bench.harness import cell_run
    from bench.harness import check as C
    rec, checks, dev, kept = cell_run.run(cell, seed, seconds, False, device,
                                          t_start, guard, keep=True)
    prog, ctrl = [], []
    for r in kept["picked"]:
        g, gq = C.gaps(cell.arch, kept["weights"], kept["prompts"][r.idx],
                       r.tokens, quant="fp8")
        prog.append(g)
        ctrl.append(gq)
    return {"workload": cell.name, "seed": seed,
            "program": C.summary(prog), "control": C.summary(ctrl),
            "tokens": sum(len(r.tokens) for r in kept["picked"]),
            "requests": len(kept["picked"]),
            "correct": C.passed(checks), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from bench.harness.spec import load_cell
    from bench.run import guard
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or float(bench["run_seconds"])
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        out = readings(cell, int(s), seconds, "cuda", guard, t0)
        out["seconds"] = time.perf_counter() - t0
        line = json.dumps(out)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
