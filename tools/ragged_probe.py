"""Time the ragged kernel's two tensor-core kernels apart, beside paged decode.

Builds the kernels of a source tree (``--src``, default this checkout's
``src``), prints what ptxas reports for the ragged kernels (registers,
spills), then, at granite-3-8b's attention (Hq 32, Hkv 8, hd 128, page 16;
G 1: 16 q over 16 kv heads) on ``chip_smoke.py``'s batches:

- the whole launch with ``chip_smoke.py``'s timer (CUDA events, median,
  L2 flushed before each, the card held through the enqueue): ``ms``;
- one launch under ``torch.profiler``: each kernel's device ms (the
  decode runs' split, the spans; with the spans launched beside the
  split, theirs counts from their start, waiting included);
- at the decode-only step, ``paged_decode_attention`` on the same rows.

Batches: the fused decode-only step (kv_len 1,024/777/300/1), the mixed
batch (two chunks with history and those four decode rows), the mixed
batch at G 1, and one 412-token chunk (``Model.prefill``'s layout), each
over bf16 and int8 pages. Checking is the card tests' job (``pytest
--noconftest -m cuda -k ragged tests/test_torch_cuda.py``). To compare two
versions on one card, run it on each tree's ``src`` in one command.

    python3 tools/ragged_probe.py [--src DIR] [--reps N] [--cases A,B]

Prints one JSON line a case. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HQ, HKV, HD, BS = 32, 8, 128, 16
G1_HEADS = 16
PREFILL = [(0, 412)]


def profile(torch, fn, n=10):
    """Device ms of each kernel a call of ``fn()``, averaged over ``n``
    calls after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"\w+_kernel", e.key)
            name = m.group(0) if m else e.key[:40]
            kern[name] = kern.get(name, 0.0) + e.device_time_total / 1e3 / n
    return kern


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cases", default=None,
                    help="comma-separated case labels to run (default all)")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import ragged_attention as kra
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(args.src, sys.version.split()[0], torch.__version__,
          torch.version.cuda, smi, flush=True)
    _build.build_all()
    log = _build.lib_path("ragged_paged_attention").with_suffix(
        ".log").read_text()
    regs = re.findall(r"_Z\w*?(ragged_\w+?_kernel)\w*?[\s\S]*?(\d+) bytes "
                      r"spill stores[\s\S]*?Used (\d+) registers", log)
    print(json.dumps({"ptxas": sorted({(k, int(s), int(r))
                                        for k, s, r in regs})}), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = [("decode-only", HQ, HKV, cs.DECODE_SPECS),
             ("mixed", HQ, HKV, cs.MIXED_SPECS),
             ("mixed G1", G1_HEADS, G1_HEADS, cs.MIXED_SPECS),
             ("prefill 412", HQ, HKV, PREFILL)]
    want = args.cases.split(",") if args.cases else None
    for label, hq, hkv, specs in cases:
        if want and label not in want:
            continue
        q, k32, v32, tb, row, pos = cs.ragged_batch(
            torch, hq, hkv, HD, BS, torch.bfloat16, 5, specs)
        kq, ks, kz = ref.quantize_kv(k32)
        vq, vs, vz = ref.quantize_kv(v32)
        quant = {"k_scale": ks, "k_zero": kz, "v_scale": vs, "v_zero": vz}
        for pages, k, v, kvq in (("bf16", k32.bfloat16(), v32.bfloat16(),
                                  None), ("int8", kq, vq, quant)):
            def launch():
                return kra.ragged_paged_attention(q, k, v, tb, row, pos,
                                                  kv_quant=kvq)
            rec = {"case": label, "pages": pages,
                   "ms": cs.time_ms(torch, launch, args.reps, flush=flush)}
            rec["kernels_ms"] = profile(torch, launch)
            if label == "decode-only" and pages == "bf16":
                first = torch.nonzero(pos >= 0).flatten()
                qd = q[first][:, None].contiguous()
                kl = (pos[first] + 1).to(torch.int32)
                rec["paged_decode_ms"] = cs.time_ms(
                    torch, lambda: kda.paged_decode_attention(qd, k, v, tb,
                                                              kl),
                    args.reps, flush=flush)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
