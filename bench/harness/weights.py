"""The weights, made by the benchmark from the seed, in the port's
parameter layout (nested dicts stacked over periods, keys as the port's
``lm_defs``), on the device, in the type they are served in.

Each leaf is drawn from one generator on the device, leaf by leaf in
sorted-key order, in pieces of at most 2^30 values along the period
axis: the same seed gives the same bytes. Matrices take
N(0, 1/fan_in) (fan_in = the input width of the product), the embedding
N(0, 1), or N(0, 1/hidden) where it is tied and so also the output head
(logits of the untied head's scale; the first norm rescales its input),
norms 1 + N(0, 0.1^2) and biases N(0, 0.2^2), so every path of the model
moves the output."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

_PIECE = 1 << 30


def seed_of(seed: int, salt: int = 0) -> int:
    return (int(seed) * 0x9E3779B1 + salt) % (1 << 63)


def padded_vocab(arch: dict) -> int:
    return -(-arch["vocab_size"] // 256) * 256


def layout(arch: dict) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str,
                                                      float]]:
    """path -> (shape, kind, std) of every leaf; kind is "matrix",
    "embed", "norm" or "bias"."""
    d = arch["hidden_size"]
    hq = arch["num_attention_heads"]
    hkv = arch["num_key_value_heads"]
    hd = arch.get("head_dim") or d // hq
    p = arch["num_hidden_layers"]
    vp = padded_vocab(arch)
    tied = bool(arch["tie_word_embeddings"])
    out = {("embed", "tok"): ((vp, d), "embed",
                              1 / math.sqrt(d) if tied else 1.0),
           ("final_norm",): ((d,), "norm", 0.1)}
    if not tied:
        out[("lm_head",)] = ((d, vp), "matrix", 1 / math.sqrt(d))
    mix = ("blocks", "slot00", "mixer")
    for name, shape in (("w_q", (d, hq * hd)), ("w_k", (d, hkv * hd)),
                        ("w_v", (d, hkv * hd)), ("w_o", (hq * hd, d))):
        out[mix + (name,)] = ((p,) + shape, "matrix",
                              1 / math.sqrt(shape[0]))
    out[mix + ("norm",)] = ((p, d), "norm", 0.1)
    if arch["port"].get("qkv_bias"):
        for name, n in (("b_q", hq * hd), ("b_k", hkv * hd),
                        ("b_v", hkv * hd)):
            out[mix + (name,)] = ((p, n), "bias", 0.2)
    mlp = ("blocks", "slot00", "mlp")
    out[mlp + ("norm",)] = ((p, d), "norm", 0.1)
    if arch.get("num_experts"):
        e, eff = arch["num_experts"], arch["moe_intermediate_size"]
        sff = arch["shared_expert_intermediate_size"]
        out[mlp + ("router",)] = ((p, d, e), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_gate",)] = ((p, e, d, eff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_up",)] = ((p, e, d, eff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_down",)] = ((p, e, eff, d), "matrix",
                                  1 / math.sqrt(eff))
        out[mlp + ("shared_gate",)] = ((p, d, sff), "matrix",
                                       1 / math.sqrt(d))
        out[mlp + ("shared_up",)] = ((p, d, sff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("shared_down",)] = ((p, sff, d), "matrix",
                                       1 / math.sqrt(sff))
    else:
        ff = arch["intermediate_size"]
        out[mlp + ("w_gate",)] = ((p, d, ff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_up",)] = ((p, d, ff), "matrix", 1 / math.sqrt(d))
        out[mlp + ("w_down",)] = ((p, ff, d), "matrix", 1 / math.sqrt(ff))
    return dict(sorted(out.items()))


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
