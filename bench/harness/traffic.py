"""The one traffic generator: it reads a mix's file of parameters and
gives the requests of a run.

Every seed gets the same sizes and gaps in the same order, drawn once from
the mix's ``shape_seed``; the run's seed draws the prompt ids (and the
weights), so two seeds offer the same work. (An order drawn from the run's
seed made a window's tails a draw of its bursts: on one H100,
summarization's p90 TTFT spread 0.70-0.85 of its median over six seeds.)

* ``open_loop``: Gamma gaps at ``rate_per_s`` (the cell's own file) and
  ``cv``, scaled so that the ramp (``ramp_s`` before the window opens at
  time 0) and the window each hold exactly rate x length arrivals;
  lognormal prompt and output lengths.
* ``cold_bursts``: groups of ``burst`` requests, each group arriving at a
  model scaled to zero once the group before it is served.

Outputs have a fixed length a request (``max_new``), greedy, with no EOS
and no stop tokens."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from bench.frozen.arrivals import gamma_gaps, lognormal_lengths


@dataclass
class Req:
    idx: int
    arrival: float              # seconds from the window's opening
    prompt: List[int]
    max_new: int


def _lengths(rng, traffic: dict, n: int):
    p, o = traffic["prompt"], traffic["output"]
    prompts = lognormal_lengths(rng, p["mean"], p["sigma"], p["min"],
                                p["max"], n)
    outputs = lognormal_lengths(rng, o["mean"], o["sigma"], o["min"],
                                o["max"], n)
    return prompts, outputs


def _run_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) % (1 << 63))


def _prompt(rng, n: int, vocab: int) -> List[int]:
    return [int(x) for x in rng.integers(0, vocab, int(n))]


def _span(shape_rng, traffic: dict, rate: float, span_s: float):
    """The fixed set of one span: ``round(rate * span_s)`` Gamma gaps
    scaled to sum to the span exactly, and as many sizes."""
    n = max(1, int(round(rate * span_s)))
    prompts, outputs = _lengths(shape_rng, traffic, n)
    gaps = gamma_gaps(shape_rng, rate, float(traffic["cv"]), n)
    return gaps * (span_s / gaps.sum()), prompts, outputs


def open_loop(traffic: dict, rate: float, window_s: float, seed: int,
              vocab: int) -> List[Req]:
    """Requests arriving in [-ramp_s, window_s), earliest first. The ramp
    and the window each offer a fixed sequence of gaps and sizes drawn
    from the mix's ``shape_seed``: exactly ``round(rate * span)`` requests
    in each, whatever the seed, which draws the ids."""
    shape_rng = np.random.default_rng(int(traffic["shape_seed"]))
    ramp = float(traffic["ramp_s"])
    spans = [(0.0, _span(shape_rng, traffic, rate, window_s))]
    if ramp > 0:
        spans.insert(0, (-ramp, _span(shape_rng, traffic, rate, ramp)))
    rng = _run_rng(seed)
    out: List[Req] = []
    for start, (gaps, prompts, outputs) in spans:
        n = len(gaps)
        t = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        for i in range(n):
            out.append(Req(len(out), float(t[i]),
                           _prompt(rng, prompts[i], vocab), int(outputs[i])))
    return out


def cold_bursts(traffic: dict, seed: int, vocab: int) -> List[List[Req]]:
    """``pool_bursts`` groups of ``burst`` requests; arrival times are
    set when each group arrives."""
    b, nb = int(traffic["burst"]), int(traffic["pool_bursts"])
    prompts, outputs = _lengths(
        np.random.default_rng(int(traffic["shape_seed"])), traffic, b * nb)
    rng = _run_rng(seed)
    return [[Req(g * b + j, math.nan, _prompt(rng, prompts[g * b + j],
                                              vocab),
                 int(outputs[g * b + j])) for j in range(b)]
            for g in range(nb)]


def warm_lengths(traffic: dict, chunk: int) -> List[int]:
    """Prompt lengths whose first prefill forward covers each power of
    two the mix's prompts reach (the runner buckets a prefill's tokens to
    a power of two), up to the prefill chunk."""
    top = min(int(traffic["prompt"]["max"]), chunk)
    out, n = [], 16
    while n < 2 * top:
        out.append(min(n, top))
        n *= 2
    return sorted(set(out))
