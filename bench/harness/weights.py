"""The weights, made by the benchmark from the seed, in the port's
parameter layout (nested dicts stacked over periods, keys as the port's
``lm_defs``), on the device, in the type they are served in.

Each leaf is drawn from one generator on the device, leaf by leaf in
the order of the architecture module's ``layout``, in pieces of at most
2^30 values along the period axis: the same seed gives the same bytes.
The module gives each leaf's std: in ``model``, matrices take N(0,
1/fan_in) (fan_in = the input width of the product), the embedding N(0,
1), or N(0, 1/hidden) where it is tied and so also the output head
(logits of the untied head's scale; the first norm rescales its input);
norms take 1 + N(0, std^2) (0.1) and biases N(0, 0.2^2), so every path
of the model moves the output."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from bench.harness.spec import architecture

_PIECE = 1 << 30


def seed_of(seed: int, salt: int = 0) -> int:
    return (int(seed) * 0x9E3779B1 + salt) % (1 << 63)


def layout(arch: dict) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str,
                                                      float]]:
    """path -> (shape, kind, std) of every leaf, in the drawing order: the
    configuration's architecture module's; kind is "matrix", "embed",
    "norm" or "bias"."""
    return architecture(arch).layout(arch)


def dtype_of(arch: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[arch["torch_dtype"]]


def leaves(arch: dict, seed: int, device) -> Iterator[Tuple[Tuple[str, ...],
                                                           torch.Tensor]]:
    """(path, tensor) for every leaf, in order, drawn from the seed."""
    dev = torch.device(device)
    dt = dtype_of(arch)
    g = torch.Generator(device=dev).manual_seed(seed_of(seed))
    for path, (shape, kind, std) in layout(arch).items():
        t = torch.empty(shape, dtype=dt, device=dev)
        rows = max(1, _PIECE // max(1, math.prod(shape[1:])))
        for i in range(0, shape[0], rows):
            part = t[i:i + rows]
            part.normal_(0.0, 1.0, generator=g)
            part.mul_(std)
            if kind == "norm":
                part.add_(1.0)
        yield path, t


def nest(flat: Dict[Tuple[str, ...], torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def make(arch: dict, seed: int, device) -> dict:
    """The whole tree, nested as the port's parameters."""
    return nest(dict(leaves(arch, seed, device)))


def flat(tree: dict, prefix=()) -> Dict[Tuple[str, ...], torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
