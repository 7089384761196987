"""Print the flash kernel's registers and spills, and time it beside SDPA.

Builds the kernels of a source tree (``--src``, default this checkout's
``src``) and prints what ptxas reports for the flash kernels: registers at
entry, spills, and its C75xx warnings (wgmma serialised). Then times flash
at the prefill shapes below with ``chip_smoke.py``'s timers (CUDA events,
medians, L2 flushed before each): ``ms`` with the card held through the
enqueue, ``ms_host_gap`` without the hold (the wrapper's host-side work
included), beside one SDPA call. Checking the kernel is the card tests'
job (``pytest --noconftest -m cuda -k flash tests/test_torch_cuda.py``).
To compare two versions on one card, run it on each tree's ``src`` in one
command.

    python3 tools/flash_probe.py [--src DIR] [--out DIR]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, S, Hq, Hkv) of the timed causal prefills at hd 128: granite-3-8b's
# serving prefill (G 4) and the same at G 1 (qwen2-moe-a2.7b's 16 heads),
# its train step, a tp = 2 rank of its 32k prefill, the 32k prefill
TIMED = ((1, 412, 32, 8), (1, 412, 16, 16), (1, 4096, 32, 8),
         (1, 8192, 16, 16), (2, 32768, 32, 8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None,
                    help="directory for the flash build log")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(args.src, sys.version.split()[0], torch.__version__,
          torch.version.cuda, smi, flush=True)
    _build.build_all()
    log = _build.lib_path("flash_attention").with_suffix(".log").read_text()
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "flash_build.log").write_text(log)
    kernel = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S*flash\w*kernel\S*)'",
                      line)
        if m:
            kernel = m[1]
        if kernel and ("registers" in line or "spill" in line
                       or "C75" in line):
            print(kernel[:60], line.strip()[:160])

    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for b, s, hq, hkv in TIMED:
        q = torch.randn((b, s, hq, 128), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((b, s, hkv, 128), generator=g,
                            device="cuda").bfloat16() for _ in range(2))
        reps = 5 if s > 8192 else 50
        rec = cs.kernel_ms(torch, lambda: kfa.flash_attention(q, k, v), reps,
                           flush)
        sdpa = cs.time_ms(torch, cs.sdpa_flash(torch, q, k, v), reps,
                          flush=flush)
        flops = 4 * b * hq * 128 * s * (s + 1) // 2
        tile = (cs.flash_stats(torch, lambda: kfa.flash_attention(q, k, v),
                               flops, rec["ms"])["tile_rows"]
                if hasattr(kfa, "TILE_LAUNCHES") else "not reported")
        print(f"TIME B {b} S {s} Hq {hq} Hkv {hkv} tile {tile}: "
              f"{rec['ms']:.4f} ms ({flops / rec['ms'] / 1e9:.1f} TFLOP/s), "
              f"without the hold {rec['ms_host_gap']:.4f} ms, SDPA "
              f"{sdpa:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
