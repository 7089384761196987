"""Time the two decode kernels' tensor-core launch at the serving shapes.

Builds the kernels of a source tree (``--src``, default this checkout's
``src``), prints what ptxas reports for the decode kernels (registers,
spills, shared memory), then times ``paged_decode_attention`` and
``decode_attention`` (bf16, hd 128) with ``chip_smoke.py``'s timer (CUDA
events, median, L2 flushed before each; ``ms`` with the card held through
the enqueue, ``ms_host_gap`` without) at

- ``main``: kv_len 1,024/777/300/1, granite-3-8b's heads (Hq 32, Hkv 8);
- ``engine``: kv_len 316/273/428/206 (the serve's decode step), the same
  heads;
- ``g1``: kv_len 1,024/777/300/1 at qwen2-moe-a2.7b's heads (16 over 16);
- ``empty``: kv_len 0 in every row, granite's heads: what a launch costs
  with no key to read (the launch, the prologue, the cluster barrier and
  the rows written as 0);

each under the engine's table of 65 pages of 16 (paged) and strips of
1,024 rows (contiguous). Where the tree's wrapper has them
(``CLUSTER_MAX``), each shape is timed at each largest cluster size of
``--clusters``, and each line says what the launch took
(``LAST_LAUNCH``).
Checking is the card tests' job (``pytest --noconftest -m cuda -k decode
tests/test_torch_cuda.py``). To compare two trees on one card, run it on
each tree's ``src`` in one command, in turns.

    python3 tools/decode_probe.py [--src DIR] [--reps N] [--clusters 8,4]

Prints one JSON line a (kernel, shape, variant). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"main": ([1024, 777, 300, 1], 32, 8),
          "engine": ([316, 273, 428, 206], 32, 8),
          "g1": ([1024, 777, 300, 1], 16, 16),
          "empty": ([0, 0, 0, 0], 32, 8)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--clusters", default="8",
                    help="comma-separated cluster sizes to time (where the "
                         "tree's wrapper takes one)")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kda

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(args.src, sys.version.split()[0], torch.__version__,
          torch.version.cuda, smi, flush=True)
    _build.build_all()
    for lib in ("paged_decode_attention", "decode_attention"):
        log = _build.lib_path(lib).with_suffix(".log").read_text()
        regs = re.findall(r"_Z\w*?(decode_\w*?kernel)\w*?[\s\S]*?(\d+) bytes "
                          r"spill stores[\s\S]*?Used (\d+) registers", log)
        print(json.dumps({"ptxas": lib, "kernels": sorted(
            {(k, int(s), int(r)) for k, s, r in regs})}), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    tunable = hasattr(kda, "CLUSTER_MAX")
    variants = [("tree", None)]
    if tunable:
        variants = [(f"C{c}", int(c)) for c in args.clusters.split(",")]
    for shape, (lens, hq, hkv) in SHAPES.items():
        b = len(lens)
        n_pages = b * cs.ENGINE_TABLE + 1
        tables = torch.randperm(n_pages - 1, generator=g,
                                device="cuda").reshape(
            b, cs.ENGINE_TABLE).to(torch.int32)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = randn(b, 1, hq, cs.HD)
        kp, vp = (randn(n_pages, cs.BS, hkv, cs.HD) for _ in range(2))
        kc, vc = (randn(b, cs.ENGINE_S, hkv, cs.HD) for _ in range(2))
        for name, fn in (
                ("paged_decode_attention",
                 lambda: kda.paged_decode_attention(q, kp, vp, tables, kl)),
                ("decode_attention",
                 lambda: kda.decode_attention(q, kc, vc, kl))):
            for label, cluster in variants:
                saved = kda.CLUSTER_MAX if tunable else None
                if cluster is not None:
                    kda.CLUSTER_MAX = cluster
                try:
                    rec = {"kernel": name, "shape": shape, "kv_len": lens,
                           "heads": [hq, hkv], "variant": label,
                           **cs.kernel_ms(torch, fn, args.reps, flush)}
                    if tunable:
                        rec["launch"] = cs.decode_stats(torch, name, fn)
                finally:
                    if saved:
                        kda.CLUSTER_MAX = saved
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
