"""Production meshes as ``torch.distributed`` ``DeviceMesh``es, the port of
the reference's ``launch/mesh.py``. Functions, not module constants, so
importing touches no process group.

A mesh of n ranks needs a default process group of at least n ranks in
which this process is one of the mesh's; the meshes are of the ``cpu``
device type (the dry run's tensors live on ``meta``). The dry run has no
such cluster: ``fake_world`` opens one of the ``fake`` backend
(collectives that move nothing, on tensors of any device, ``meta``
included), with this process as rank 0, and tears it down on exit.
"""

from __future__ import annotations

import contextlib
import math

import torch


def _mesh(shape, names):
    """Ranks 0 .. n-1 of the open process group laid out as ``shape``."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_pp_mesh(n_stages: int = 4):
    """Technique-representative mesh: a pipeline axis for the paper's
    cold-start groups, within one pod (256 ranks)."""
    return _mesh((n_stages, 256 // n_stages // 16, 16),
                 ("stage", "data", "model"))


def make_cpu_mesh():
    """A one-rank mesh for tests and examples."""
    return _mesh((1, 1), ("data", "model"))


def ensure_world(world_size: int):
    """``fake_world(world_size)``, or nothing where a process group of at
    least that size is open already (its owner tears it down)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"the open process group has "
                               f"{dist.get_world_size()} ranks, not "
                               f"{world_size}")
        return contextlib.nullcontext()
    return fake_world(world_size)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0, for the life of the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
