"""Pipeline-consolidation deep dive (paper §6, Fig. 13): serve one long
generation on a pipeline, scale DOWN mid-flight, and show the per-token
latency profile before and after the KV migration. Uses the endpoint API
on jamba-v0.1-52b's smoke variant — the hybrid migrates attention K/V
*and* the Mamba conv and SSM states — and the swap happens behind the
stable ServingEndpoint handle. The twin of the reference's
``examples/consolidation_demo.py`` on the slot-contiguous layout (the
reference's default; the port's is paged, so it is asked for).

    PYTHONPATH=src python -m repro_torch.examples.consolidation_demo \
        [--device cpu]
"""

from __future__ import annotations

import time

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.examples import cli_device
from repro_torch.models.common import tree_leaves
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServingEndpoint
from repro_torch.serving.engine import Engine
from repro_torch.serving.migration import gather_stage_caches

PROMPT = list(range(2, 18))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None, params=None):
    """The demo on ``device`` (default: the card) with ``params`` (default:
    drawn from a generator seeded with 0). Returns the request and the
    per-step wall times before and after the scale-down."""
    dev = resolve_device(device)
    cfg = smoke_variant(get_config("jamba-v0.1-52b"))
    model = Model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)

    n_stages = 4 if cfg.n_periods >= 4 else 2
    stage_params = [model.slice_stage_params(params, n_stages, i)
                    for i in range(n_stages)]
    print(f"{cfg.name}: {cfg.n_layers} layers in {n_stages} stages; "
          f"per-stage fetch bytes: "
          f"{[model.stage_bytes(n_stages, i) for i in range(n_stages)]}")

    ep = ServingEndpoint(Engine(cfg, stage_params, max_batch=2, max_seq=96,
                                paged=False, device=dev))
    req = ep.submit(PROMPT, SamplingParams(max_new=24))

    lat = []
    for _ in range(8):
        t0 = time.perf_counter()
        ep.step()
        _sync(dev)
        lat.append(time.perf_counter() - t0)
    print(f"pipeline tokens: {req.generated}")
    print(f"pipeline per-step wall: {[f'{x * 1e3:.0f}ms' for x in lat]}")

    t0 = time.perf_counter()
    gathered = gather_stage_caches([w.cache for w in ep.engine.workers])
    _sync(dev)
    mig_wall = time.perf_counter() - t0
    n_bytes = sum(x.numel() * x.element_size()
                  for x in tree_leaves(gathered))
    print(f"KV+state migration: {n_bytes / 1e6:.2f} MB gathered in "
          f"{mig_wall * 1e3:.1f} ms")

    ep.consolidate(params)               # same handle, standalone engine
    lat2 = []
    while req.generated and not req.done:
        t0 = time.perf_counter()
        ep.step()
        _sync(dev)
        lat2.append(time.perf_counter() - t0)
        if len(lat2) > 40:
            break
    print(f"standalone tokens: {req.generated}")
    print(f"standalone per-step wall: "
          f"{[f'{x * 1e3:.0f}ms' for x in lat2[:8]]}")

    # correctness: the full run must equal a never-pipelined run
    ref = ServingEndpoint(Engine(cfg, [params], max_batch=2, max_seq=96,
                                 paged=False, device=dev))
    r2 = ref.submit(PROMPT, SamplingParams(max_new=24))
    ref.run()
    if r2.generated != req.generated:
        raise AssertionError(f"scale-down changed the generation: "
                             f"{req.generated} != {r2.generated}")
    print("OK: scale-down preserved the generation exactly "
          f"(ttft={req.metrics.ttft_steps} steps, "
          f"tpot-proxy={req.metrics.tpot_steps:.2f} steps/token)")
    return {"request": req, "pipeline_step_s": lat,
            "standalone_step_s": lat2, "migration_bytes": n_bytes,
            "n_stages": n_stages}


if __name__ == "__main__":
    main(cli_device(__doc__))
