"""Logical-axis sharding: models annotate tensors with *logical* axis names;
a rules table maps those to physical mesh axes. Outside a mesh context
everything is a no-op, so the same code runs on one card and on the
production (pod, data, model) mesh.

The port of the reference's ``distributed/sharding.py``. ``resolve`` is the
same pure function of the rules and returns the port's own
``PartitionSpec`` (a tuple, one entry per tensor dim, trailing ``None``s
dropped). ``spec_for`` maps it onto a
``torch.distributed.device_mesh.DeviceMesh`` as DTensor placements: a dim
whose entry names mesh axes gets ``Shard(dim)`` on each of them, every
other mesh dim ``Replicate()``. A dim sharded over several mesh axes is
split over them in mesh order, outer axis first, which is the order of a
JAX ``PartitionSpec`` tuple whenever its axes follow the mesh's (every
rule here does).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Sequence, Tuple, Union


# Default logical->physical translation for the production (data, model) mesh.
DEFAULT_RULES = {
    "batch": ("data",),
    "seq": None,            # activations: sequence replicated by default
    "act_seq": None,        # layer-boundary residual stream; train/prefill
                            # map this to 'model' (Megatron-style sequence
                            # parallelism) so saved activations shard 16-way
    "kv_seq": None,         # long-context decode overrides this to 'model' (SP)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ffn": "model",   # used instead of 'experts' when n_experts < TP
    "conv": None,
    "state": None,
    "dt_rank": None,
    "layers": None,
    "stage": "stage",       # only present on PP dry-run meshes
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of them. Compares as the tuple of its entries."""

    def __new__(cls, *parts: Union[None, str, Tuple[str, ...]]):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh, with the DTensor placements it comes to (one per
    mesh dim)."""
    mesh: object
    spec: PartitionSpec
    placements: tuple


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate a ``DeviceMesh`` (or None) + logical rules for
    ``constrain`` / ``spec_for``."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    # drop mappings to axes the mesh doesn't actually have
    if mesh is not None:
        names = set(mesh.mesh_dim_names or ())

        def _ok(ax):
            if ax is None:
                return None
            if isinstance(ax, str):
                return ax if ax in names else None
            kept = tuple(a for a in ax if a in names)
            return kept if kept else None

        merged = {k: _ok(v) for k, v in merged.items()}
    _CTX.rules = merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def current_mesh():
    return _CTX.mesh


def resolve(logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
    """Translate a tuple of logical axis names into a PartitionSpec."""
    rules = _CTX.rules
    parts, used = [], set()
    for name in logical_axes:
        ax = rules.get(name) if name else None
        # a physical axis may appear at most once in a spec
        if ax is not None:
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            flat = tuple(a for a in flat if a not in used)
            used.update(flat)
            ax = flat if len(flat) != 1 else flat[0]
            if isinstance(ax, tuple) and not ax:
                ax = None
        parts.append(ax)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on every
    mesh axis a dim's entry names, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for ax in ((part,) if isinstance(part, str) else part):
            out[names.index(ax)] = Shard(dim)
    return tuple(out)


def spec_for(logical_axes: Sequence[Optional[str]]):
    """NamedSharding for the active mesh (or None outside a mesh)."""
    mesh = _CTX.mesh
    if mesh is None:
        return None
    spec = resolve(logical_axes)
    return NamedSharding(mesh, spec, placements(mesh, spec))


def constrain(x, *logical_axes):
    """``x`` laid out by its logical axes under the active mesh (a DTensor
    redistributed, a plain tensor distributed); identity without one."""
    s = spec_for(logical_axes)
    if s is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(s.mesh, s.placements)
    return distribute_tensor(x, s.mesh, s.placements)
