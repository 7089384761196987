"""Streaming + sampling demo of the request-lifecycle API.

Three concurrent requests with different decode policies — greedy,
seeded temperature/top-k sampling, and a stop-token request — stream
token events out of one engine step loop. Shows per-request finish
reasons and step-metrics at the end. The twin of the reference's
``examples/streaming_demo.py``.

    PYTHONPATH=src python -m repro_torch.examples.streaming_demo \
        [--device cpu]
"""

from __future__ import annotations

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.examples import cli_device
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServingEndpoint
from repro_torch.serving.engine import Engine

PROMPT = [5, 7, 9, 11]


def main(device=None, params=None):
    """The demo on ``device`` (default: the card) with granite-3-8b's
    smoke variant and ``params`` (default: drawn from a generator seeded
    with 0). Returns the greedy probe and the three requests by name."""
    dev = resolve_device(device)
    cfg = smoke_variant(get_config("granite-3-8b"))
    if params is None:
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
    ep = ServingEndpoint(Engine(cfg, [params], max_batch=4, max_seq=64,
                                paged=False, device=dev))

    # learn the greedy stream once so the stop-token demo is sure to hit
    probe = [ev.token for ev in ep.generate(PROMPT,
                                            SamplingParams(max_new=8))]

    reqs = {
        "greedy ": ep.submit(PROMPT, SamplingParams(max_new=8)),
        "sampled": ep.submit(PROMPT,
                             SamplingParams(max_new=8, temperature=0.8,
                                            top_k=8, seed=1234)),
        "stopped": ep.submit(PROMPT,
                             SamplingParams(max_new=8,
                                            stop_tokens=(probe[3],))),
    }
    stop_at = probe.index(probe[3])      # stop fires at first occurrence
    while ep.has_work():
        out = ep.step()
        for ev in out.events:
            fin = f"  <- {ev.finish_reason.value}" if ev.finish_reason \
                else ""
            print(f"step {out.step}: rid={ev.rid} token={ev.token}{fin}")

    for name, r in reqs.items():
        m = r.metrics
        print(f"{name}: {r.generated} finish={r.finish_reason.value} "
              f"ttft={m.ttft_steps} queue={m.queue_steps} "
              f"decode_steps={m.decode_steps}")

    if reqs["greedy "].generated != probe:
        raise AssertionError("the greedy request left the probe's stream")
    if reqs["stopped"].generated != probe[:stop_at + 1]:
        raise AssertionError("the stop token did not truncate the stream")
    if reqs["sampled"].generated == probe:
        raise AssertionError("sampling reproduced the greedy stream")
    print("OK: streaming order, stop-token truncation, and sampling diverge "
          "as expected")
    return {"probe": probe, "requests": reqs}


if __name__ == "__main__":
    main(cli_device(__doc__))
