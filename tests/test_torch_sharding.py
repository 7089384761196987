"""The port's logical-axis sharding rules (``repro_torch.distributed.
sharding``): the reference's ``tests/test_sharding.py`` mirrored (the
hypothesis property kept), ``resolve`` equal to the reference's for every
ParamDef of every config under the default rules and an override, and
``spec_for`` on fake meshes of 256 ranks (``torch.distributed``'s ``fake``
backend; tensors on the ``meta`` device): each granite-3-8b leaf's local
shard is its shape divided by the mesh axes its spec names, and a ZeRO-1
state dim splits over pod x data."""

import jax
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.distributed import sharding as jsharding
from repro.models.model import build_model as jax_model
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (DEFAULT_RULES, P, constrain,
                                              current_mesh, placements,
                                              resolve, spec_for, use_mesh)
from repro_torch.models.common import ParamDef, tree_leaves
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt

OVERRIDE = {"act_seq": "model", "kv_seq": "model", "batch": ("pod", "data"),
            "embed": "data"}


@pytest.fixture(scope="module")
def world():
    """A fake process group of 256 ranks (this process is rank 0), torn
    down after the module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    yield
    dist.destroy_process_group()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# mirrors of tests/test_sharding.py
# ---------------------------------------------------------------------------


def test_resolve_outside_mesh_uses_defaults():
    # singleton physical-axis tuples normalize to the bare name
    assert resolve(("batch", "seq", "embed")) == P("data")
    assert resolve(("embed", "ffn")) == P(None, "model")


def test_resolve_dedupes_physical_axes():
    # act_seq and heads both -> 'model' under train rules: first wins
    with use_mesh(None, {"act_seq": "model"}):
        spec = resolve(("batch", "act_seq", "heads"))
    assert spec == P("data", "model")


def test_rules_dropped_for_missing_axes(world):
    mesh = _mesh((256,), ("data",))
    with use_mesh(mesh, None):
        # 'model' axis doesn't exist on this mesh -> mapped to None
        assert resolve(("embed", "ffn")) == P()
        assert current_mesh() is mesh
    assert current_mesh() is None


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert constrain(x, "batch", "embed") is x


@settings(max_examples=50, deadline=None)
@given(st.lists(st.sampled_from(sorted(DEFAULT_RULES)), min_size=1,
                max_size=5))
def test_resolve_never_reuses_axis(names):
    spec = resolve(tuple(names))
    used = []
    for part in spec:
        if part is None:
            continue
        used.extend((part,) if isinstance(part, str) else part)
    assert len(used) == len(set(used))
    assert tuple(spec) == tuple(jsharding.resolve(tuple(names)))


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def _axes(defs):
    return [d.axes for d in tree_leaves(defs)]


@pytest.mark.parametrize("rules", [None, OVERRIDE], ids=["default",
                                                         "override"])
def test_resolve_equals_reference_for_every_param(rules):
    n = 0
    for arch in jlist():
        tdefs = Model(get_config(arch)).defs
        jdefs = jax_model(jget(arch)).defs
        jaxes = [d.axes for d in jax.tree.leaves(
            jdefs, is_leaf=lambda x: hasattr(x, "axes"))]
        assert _axes(tdefs) == jaxes, arch
        with use_mesh(None, rules), jsharding.use_mesh(None, rules):
            for axes in jaxes:
                assert tuple(resolve(axes)) == \
                    tuple(jsharding.resolve(axes)), (arch, axes)
                n += 1
    assert n > 200


def test_state_specs_equal_reference():
    for arch in ("granite-3-8b", "grok-1-314b", "jamba-v0.1-52b",
                 "whisper-small"):
        t = opt.state_specs(Model(get_config(arch)).defs)
        from repro.training import optimizer as jopt
        j = jopt.state_specs(jax_model(jget(arch)).defs)
        js = jax.tree.leaves(j["mu"], is_leaf=lambda x: type(x).__name__ ==
                             "PartitionSpec")
        assert [tuple(s) for s in tree_leaves(t["mu"])] == \
            [tuple(s) for s in js], arch
        assert tuple(t["step"]) == ()


def _local(shape, spec, sizes):
    out = list(shape)
    for dim, part in enumerate(spec):
        for ax in (() if part is None else
                   (part,) if isinstance(part, str) else part):
            assert out[dim] % sizes[ax] == 0, (shape, spec)
            out[dim] //= sizes[ax]
    return tuple(out)


def test_spec_for_shards_granite_on_a_16x16_mesh(world):
    from torch.distributed.tensor import distribute_tensor
    mesh = _mesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    defs = tree_leaves(Model(get_config("granite-3-8b")).defs)
    sharded = 0
    with use_mesh(mesh, {"embed": None}):
        for d in defs:
            s = spec_for(d.axes)
            assert s.mesh is mesh and s.spec == resolve(d.axes)
            t = distribute_tensor(torch.empty(d.shape, device="meta"),
                                  mesh, s.placements)
            assert tuple(t.to_local().shape) == _local(d.shape, s.spec,
                                                       sizes), d
            sharded += any(p is not None for p in s.spec)
        # a plain tensor is distributed, a DTensor redistributed
        x = torch.empty((64, 4096), device="meta")
        y = constrain(x, "batch", "embed")
        assert tuple(y.to_local().shape) == (4, 4096)
        z = constrain(y, "batch", "heads")
        assert tuple(z.to_local().shape) == (4, 256)
    # every leaf but the norms (two a layer, the final one) is sharded
    assert sharded == len(defs) - 3


def test_zero1_dim_splits_over_pod_and_data(world):
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = _mesh((2, 16, 8), ("pod", "data", "model"))
    d = ParamDef((40, 4096, 12800), ("layers", "embed", "ffn"))
    with use_mesh(mesh):
        spec = opt.state_specs({"w": d})["mu"]["w"]
        assert tuple(spec) == (None, ("pod", "data"), "model")
        pl = placements(mesh, spec)
        assert pl == (Shard(1), Shard(1), Shard(2))
        t = distribute_tensor(torch.empty(d.shape, device="meta"), mesh, pl)
        assert tuple(t.to_local().shape) == (40, 128, 1600)
