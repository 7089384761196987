"""Arrival and length arithmetic, frozen from the port's
``workloads/generator.py`` (``generate``): Gamma inter-arrival times of
shape 1/CV^2 and mean 1/rate, lengths lognormal around the paper's Table 2
means (``workloads/applications.py``; the generator takes the mean as the
lognormal's median, ``rng.lognormal(log(mean), sigma)``), clipped."""

from __future__ import annotations

import math

import numpy as np

# Table 2 of the paper: (mean prompt tokens, mean output tokens, dataset)
TABLE2 = {
    "chatbot": (315, 240, "ShareGPT"),
    "code": (150, 60, "HumanEval"),
    "summarization": (3000, 200, "LongBench"),
}


def gamma_gaps(rng: np.random.Generator, rate: float, cv: float,
               n: int) -> np.ndarray:
    """``n`` inter-arrival gaps (seconds): Gamma(k = 1/CV^2, scale =
    (1/rate)/k), as ``generate`` draws them."""
    shape = 1.0 / (cv * cv)
    scale = (1.0 / rate) / shape
    return rng.gamma(shape, scale, size=n)


def lognormal_lengths(rng: np.random.Generator, mean: float, sigma: float,
                      lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` lengths, ``int(lognormal(log(mean), sigma))`` clipped to
    [lo, hi], as ``generate`` draws prompt and output lengths."""
    raw = rng.lognormal(math.log(mean), sigma, size=n).astype(np.int64)
    return np.clip(raw, lo, hi)
