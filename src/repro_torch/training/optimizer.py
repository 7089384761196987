"""AdamW with float32 state, optional ZeRO-1 (optimizer-state sharding over
the data axis) and bf16 gradient compression: the port of the reference's
``training/optimizer.py``.

Params, grads and states are nested dicts of tensors (the port's pytrees).
``apply_updates`` is functional, as the reference's: it returns new params
and a new state and leaves its inputs as they were. The step count, the
learning rate and the gradient norm stay float32 / int32 scalars on the
params' device, so a step never waits on the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding import PartitionSpec, resolve
from repro_torch.models.common import ParamDef, map_defs, tree_leaves, \
    tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def init_state(params):
    """Zero float32 moments beside each param leaf, and the step (int32)."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "mu": tree_map(f32, params),
        "nu": tree_map(f32, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def state_structs(param_structs):
    """``init_state``'s shapes and dtypes as tensors on the ``meta`` device:
    float32 moments beside each param leaf and the int32 step."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    return {
        "mu": tree_map(f32, param_structs),
        "nu": tree_map(f32, param_structs),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def state_specs(defs, zero1: bool = True):
    """Optimizer-state PartitionSpecs. ZeRO-1: each state additionally
    shards its first *physically replicated* dim over the data(+pod) axes.
    Input shardings must divide evenly, so only dims divisible by 32 (data x
    pod on the multi-pod mesh) qualify."""

    def spec(d: ParamDef):
        base = resolve(d.axes)
        parts = list(base) + [None] * (len(d.shape) - len(base))
        if zero1:
            used = set()
            for part in parts:
                if part is None:
                    continue
                used.update((part,) if isinstance(part, str) else part)
            if "data" not in used:
                for i, (part, dim) in enumerate(zip(parts, d.shape)):
                    if part is None and dim >= 32 and dim % 32 == 0:
                        parts[i] = ("pod", "data")
                        break
        return PartitionSpec(*parts)

    ps = map_defs(spec, defs)
    return {"mu": ps, "nu": ps, "step": PartitionSpec()}


def _schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine decay to 0.1 x lr, in float32 at the
    int32 ``step`` tensor, as the reference computes it."""
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step: the global gradient norm in float32, the clip, the
    moments in float32, each leaf's update cast back to its param's dtype.
    Returns (new params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = _schedule(cfg, step)

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p.float()
        new_p = pf - lr * (delta + cfg.weight_decay * pf)
        return new_p.to(p.dtype), mu, nu

    def upd_tree(p, g, mu, nu):
        if isinstance(p, dict):
            parts = {k: upd_tree(p[k], g[k], mu[k], nu[k]) for k in p}
            return tuple({k: v[i] for k, v in parts.items()}
                         for i in range(3))
        return upd(p, g, mu, nu)

    new_params, mu, nu = upd_tree(params, grads, state["mu"], state["nu"])
    return (new_params, {"mu": mu, "nu": nu, "step": step},
            {"grad_norm": gnorm, "lr": lr})
