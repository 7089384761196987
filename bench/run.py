"""The port's benchmark, one run of one cell:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It loads the cell (``BENCHMARK.json`` and the
files it names), makes the weights on the card from the seed, warms the
cell's shapes, measures for ``--seconds``, compares a sample of what the
window served with the plain float32 reference, and prints one JSON line:
the cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
from a ``torch.profiler`` trace of the window (``--trace 1``).

It refuses to run (exit 2, no result) without a card or with fewer cards
than the cell asks for, and fails (exit 3, no result) if a module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX
package) is loaded at start-up, after the first step, or when the window
has closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None):
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def guard():
    bad = forbidden_loaded()
    if bad:
        print(f"run refused: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr, flush=True)
        sys.exit(3)


def main(argv=None, device: str = "cuda") -> int:
    """The command. ``device`` is the card's; the tests give ``"cpu"``,
    which skips the look for a card and runs the rest on the CPU."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard()
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from bench.harness import cell_run
    from bench.harness.spec import load_cell
    cell = load_cell(ROOT, args.workload)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"run refused: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    guard()
    rec, checks, dev, _ = cell_run.run(cell, args.seed, args.seconds,
                                       bool(args.trace), device, T_START,
                                       guard)
    out = cell_run.result(cell, rec, checks, dev, bool(args.trace))
    if rec.extra:
        print("record " + json.dumps(rec.extra), file=sys.stderr)
    guard()
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
