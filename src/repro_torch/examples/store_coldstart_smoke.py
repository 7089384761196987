"""Smoke: cold-start a tiny model through the on-disk ModelStore.

Deploys a smoke model into a real chunked store on disk, cold-starts a
pipeline group whose stage weights are *streamed* out of it, serves a
few greedy tokens, and verifies bit-exactness against an in-memory
engine built from the same params; then cross-checks the measured
per-stage timeline against the analytic one for every OverlapFlags
ablation step. The twin of the reference's
``examples/store_coldstart_smoke.py`` on the slot-contiguous layout (the
reference's default; the port's is paged, so it is asked for). The
reference writes its record to ``BENCH_coldstart_timeline.json``; the
twin writes one only where ``--out`` names a file, never the
reference's.

    PYTHONPATH=src python -m repro_torch.examples.store_coldstart_smoke \
        [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import GB, ModelProfile, SLO, ServerSpec, TimingProfile
from repro_torch.core.coldstart import OverlapFlags
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServerlessFrontend, ServingEndpoint
from repro_torch.serving.engine import Engine
from repro_torch.store import assert_within, crosscheck_stages

PROMPT = [11, 42, 7, 13, 5]


def main(device=None, params=None, store_dir=None, out=None):
    """The smoke on ``device`` (default: the card) with ``params``
    (default: drawn from a generator seeded with 0) deployed into a store
    at ``store_dir`` (default: a fresh temporary directory, deleted
    after). Writes the record to ``out`` where given. Returns it."""
    dev = resolve_device(device)
    cfg = smoke_variant(get_config("granite-3-8b"))
    if params is None:
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
    own_dir = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="store-smoke-")
    try:
        record = _run(cfg, params, dev, store_dir)
    finally:
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    if out is not None:
        with open(out, "w") as f:
            json.dump(record, f, indent=2)
        print(f"wrote {out}")
    return record


def _run(cfg, params, dev, store_dir):
    front = ServerlessFrontend({f"srv{i}": ServerSpec(f"srv{i}", 2e9, 12e9,
                                                      24 * GB)
                                for i in range(4)}, device=dev)
    store = front.deploy(cfg, params, ModelProfile(
        cfg.name, int(12.5 * GB), TimingProfile(), SLO(ttft=7.5, tpot=0.2)),
        store_dir=store_dir)
    print(f"store: {store.total_bytes} bytes in "
          f"{len(store.manifest.chunks)} chunks at {store_dir}")

    ep = front.cold_start(cfg.name, min_stages=2, max_batch=2, max_seq=64,
                          paged=False)
    report = ep.cold_start_timeline
    print(f"cold start: s={ep.n_stages}, streamed {report.total_bytes} "
          f"bytes, measured ready={report.ready:.3f}s")

    tokens = [ev.token for ev in ep.generate(PROMPT,
                                             SamplingParams(max_new=8))]
    ref = ServingEndpoint(Engine(cfg, [params], max_batch=2, max_seq=64,
                                 paged=False, device=dev))
    want = [ev.token for ev in ref.generate(PROMPT,
                                            SamplingParams(max_new=8))]
    if tokens != want:
        raise AssertionError(f"store-streamed weights diverged: {tokens} "
                             f"!= {want}")
    print(f"OK: first {len(tokens)} greedy tokens bit-exact with the "
          f"in-memory engine: {tokens}")

    # measured-vs-analytic cross-check over the Fig. 9 ablation axis
    nic = store.total_bytes / 8.0
    ablation = {}
    for name, flags in [("none", OverlapFlags.none()),
                        ("+prefetch", OverlapFlags(True, False, False)),
                        ("+stream", OverlapFlags(True, True, False)),
                        ("+overlap", OverlapFlags.all())]:
        checks = crosscheck_stages(store, min(2, cfg.n_periods), flags=flags,
                                   nic_bytes_per_s=nic,
                                   load_bytes_per_s=4 * nic, device=dev)
        worst = assert_within(checks, 0.05)
        ablation[name] = {"worst_err": worst,
                          "stages": [c.to_json() for c in checks]}
        print(f"  {name:10s} measured==analytic within {worst:.2%}")
    return {"model": cfg.name, "device": str(dev),
            "store_bytes": store.total_bytes,
            "cold_start": report.to_json(), "tokens": tokens,
            "tokens_bit_exact": True, "ablation_crosscheck": ablation}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the record (JSON) to this file")
    args = ap.parse_args()
    main(args.device, out=args.out)
