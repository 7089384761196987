"""Quickstart: hydra cold start end to end, against one API.

The ServerlessFrontend runs Alg. 1 and hands back a ServingEndpoint; the
endpoint serves, then consolidates (§6.2) behind the same handle — the
client never sees the pipeline group dissolve. The twin of the
reference's ``examples/quickstart.py`` on the slot-contiguous layout (the
reference's default; the port's is paged, so it is asked for).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import GB, Gbps, ModelProfile, ServerSpec, SLO, \
    TimingProfile
from repro_torch.device import resolve_device
from repro_torch.examples import cli_device
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServerlessFrontend, ServingEndpoint
from repro_torch.serving.engine import Engine

PROMPT = [11, 42, 7, 13, 5]


def main(device=None, params=None, cfg=None):
    """The quickstart on ``device`` (default: the card) with ``params``
    (default: drawn from a generator seeded with 0) of ``cfg`` (default:
    granite-3-8b's smoke variant). Returns the endpoint, the request and
    its tokens before consolidation."""
    dev = resolve_device(device)
    cfg = cfg or smoke_variant(get_config("granite-3-8b"))
    if params is None:
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev)

    front = ServerlessFrontend({f"srv{i}": ServerSpec(f"srv{i}", 16 * Gbps,
                                                      12e9, 24 * GB)
                                for i in range(4)}, device=dev)
    front.deploy(cfg, params, ModelProfile(
        cfg.name, int(12.5 * GB),        # pretend it's the real Llama2-7B
        TimingProfile(), SLO(ttft=7.5, tpot=0.2)))

    ep = front.cold_start(cfg.name, min_stages=2, max_batch=2, max_seq=64,
                          paged=False)
    print(f"Alg.1 scheme: s={ep.scheme.s} w={ep.scheme.w} "
          f"servers={ep.scheme.servers} -> {ep.n_stages}-stage pipeline, "
          f"pred_ttft={ep.scheme.predicted_ttft:.2f}s "
          f"slo_ok={ep.scheme.slo_ok}")

    req = ep.submit(PROMPT, SamplingParams(max_new=12))
    for _ in range(5):
        ep.step()
    before = list(req.generated)
    print(f"tokens before consolidation: {before}")
    ep.consolidate(front.full_params(cfg.name))   # §6.2, same handle
    ep.run()
    print(f"tokens after consolidation:  {req.generated} "
          f"({req.finish_reason.value}, ttft={req.metrics.ttft_steps} steps)")

    ref = ServingEndpoint(Engine(cfg, [params], max_batch=2, max_seq=64,
                                 paged=False, device=dev))
    tokens = [ev.token for ev in ref.generate(PROMPT,
                                              SamplingParams(max_new=12))]
    if tokens != req.generated:
        raise AssertionError(f"consolidation changed the output: "
                             f"{req.generated} != {tokens}")
    print("OK: endpoint output == single-worker reference across "
          "consolidation")
    return {"endpoint": ep, "request": req, "before": before,
            "frontend": front}


if __name__ == "__main__":
    main(cli_device(__doc__))
