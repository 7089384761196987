"""Shared model building blocks: ParamDef trees, RMSNorm, RoPE, init, the
training loss.

Params are plain nested dicts of tensors keyed like the reference's
pytrees, so ``convert.params_from_numpy`` maps one onto the other leaf for
leaf."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import resolve

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def as_dtype(dt) -> torch.dtype:
    """A dtype given by name (``cfg.dtype``, ``kv_dtype``) or as a torch
    dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    name = str(dt).replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dt!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Parameter definition trees.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names, one per dim
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float = 1.0                    # extra init scale (e.g. 1/sqrt(2L))

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested dict (anything not a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def map_defs(fn: Callable, defs):
    """Map ``fn`` over the ParamDefs of a def tree (the reference's name
    for ``tree_map`` over defs)."""
    return tree_map(fn, defs)


def tree_leaves(tree):
    """Leaves in sorted-key order, the order of ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in ``tree_leaves``
    order (dict keys come out sorted)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def init_params(defs, generator: torch.Generator, dtype, device=None):
    """Random-init a ParamDef tree into tensors on ``device`` (default: the
    card), drawn from ``generator`` leaf by leaf in the tree's order. The
    std rule is the reference's: ``scale / sqrt(fan_in)`` with fan_in the
    second-to-last dim (the last for vectors). A stacked leaf is drawn one
    period at a time, so the float32 draw never holds a whole stack."""
    dev = resolve_device(device)
    dt = as_dtype(dtype)

    def one(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        out = torch.empty(d.shape, dtype=dt, device=dev)
        parts = out if len(d.shape) == 3 else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev, dtype=torch.float32) * std)
        return out

    return tree_map(one, defs)


def param_specs(defs):
    """PartitionSpec tree (resolved under the active mesh rules)."""
    return map_defs(lambda d: resolve(d.axes), defs)


def param_structs(defs, dtype):
    """The params' shapes and dtype as tensors on the ``meta`` device (the
    reference's ``jax.ShapeDtypeStruct`` tree): no storage, no values."""
    dt = as_dtype(dtype)
    return map_defs(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                    defs)


def param_bytes(defs, bytes_per_param=2) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs)) \
        * bytes_per_param


def stack_defs(defs, n: int, axis_name: Optional[str] = None):
    """Prepend a stacking dim (e.g. periods) to every ParamDef in the tree."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.init,
                           d.scale),
        defs,
    )


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps: float):
    """Only the variance reduction runs in float32; the (B,S,d) tensors stay
    in the compute dtype, as in the reference."""
    dt = x.dtype
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * w.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * inv               # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """logits (..., V) float32-cast CE with optional z-loss; labels < 0
    masked."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
