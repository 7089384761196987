"""The port's launch package (``repro_torch.launch``: meshes, per-cell
specs, the ``meta`` dry run) and the shape-struct half of ``Model``, held
against the reference's ``launch/`` and ``Model``.

* Every ``(arch, kind)`` cell of ``tests/test_dryrun_cpu.py`` (its tiny
  shapes and VLM rule): the port's ``make_cell`` on a 1x1 mesh gives the
  reference's argument shapes and dtypes, in/out specs and ``donate``; its
  ``fn`` on ``meta`` gives the output shapes and dtypes of the reference's
  ``jax.eval_shape(fn, *args)``, traced outside any mesh (the reference's
  own compile of these cells is red on JAX 0.9); and it runs on real CPU
  tensors.
* granite-3-8b's three cells (and its manual-TP and pipelined prefills) on
  the production meshes: each argument leaf's bytes on one device are its
  shape divided by the sizes of the mesh axes the reference's spec for the
  same leaf names. The reference's specs come from a subprocess with 256
  host devices (``XLA_FLAGS``), time-limited.
* The policies that set the reference's modes (``skip``, ``kvapp``,
  ``manual_skip``) on granite-3-8b and qwen2-moe-a2.7b: the reference's
  shapes, specs and ``donate``, and its analytic FLOPs for the policy.
* ``rules_for``, the record's keys, the refusals, the CLI's directory, and
  ``structs``/``init_cache(as_structs=True)``/``cache_axes``/
  ``state_structs``/``cross_kv_structs`` for every registered config.

The meshes live in a ``fake`` process group of 512 ranks, opened for the
module and torn down after it.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_cpu_mesh as jcpu_mesh
from repro.launch.specs import make_cell as jmake_cell
from repro.launch.specs import rules_for as jrules_for
from repro.models import encdec as jencdec
from repro.models.model import build_model as jax_model
from repro.roofline.analysis import Roofline as JRoofline
from repro.training import optimizer as jopt
from repro_torch.configs import SHAPES, get_config, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_world, make_cpu_mesh, make_pp_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import make_cell, rules_for, shard_shape
from repro_torch.models import encdec
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-3-8b", "qwen2-moe-a2.7b", "jamba-v0.1-52b", "rwkv6-1.6b",
         "whisper-small", "llava-next-34b"]
KINDS = ["train", "prefill", "decode"]
TINY = {"train": ("train_tiny", "train", 32, 2),
        "prefill": ("prefill_tiny", "prefill", 32, 2),
        "decode": ("decode_tiny", "decode", 32, 2)}
GRANITE_POLICIES = [("train_4k", "baseline"), ("prefill_32k", "baseline"),
                    ("decode_32k", "baseline"), ("prefill_32k", "manual"),
                    ("prefill_32k", "ppipe")]
# the policies that name the reference's modes ("skip": causal_skip,
# "kvapp": the append decode mode), each on two archs: {policy: [(arch,
# shape)]}; manual TP refuses qwen2-moe's prefill in both packages, so its
# manual_skip cell is the train step's
MODE_CELLS = {
    "skip": [("granite-3-8b", "prefill_32k"),
             ("qwen2-moe-a2.7b", "prefill_32k")],
    "kvapp": [("granite-3-8b", "decode_32k"),
              ("qwen2-moe-a2.7b", "decode_32k")],
    "manual_skip": [("granite-3-8b", "prefill_32k"),
                    ("qwen2-moe-a2.7b", "train_4k")],
}
LIMIT_S = 180


@pytest.fixture(scope="module", autouse=True)
def world():
    with fake_world(512):
        yield


# ---------------------------------------------------------------------------
# trees of both packages as {path: leaf}
# ---------------------------------------------------------------------------


def _tflat(tree, prefix=""):
    if isinstance(tree, NamedSharding) or not isinstance(
            tree, (dict, tuple, list)):
        return {} if tree is None else {prefix: tree}
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_tflat(v, f"{prefix}/{k}"))
    return out


def _jflat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                    for k in path): leaf for path, leaf in leaves}


def _sig_t(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _tflat(tree).items()}


def _sig_j(tree):
    return {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _jflat(tree).items()}


def _spec(part):
    return tuple(p if not isinstance(p, tuple) else tuple(p) for p in part)


def _specs_t(tree):
    return {k: _spec(v.spec) for k, v in _tflat(tree).items()}


def _specs_j(tree):
    return {k: _spec(v.spec) for k, v in _jflat(tree).items()}


# ---------------------------------------------------------------------------
# the cells of tests/test_dryrun_cpu.py
# ---------------------------------------------------------------------------


def _tiny(arch, kind):
    jcfg = smoke(arch)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)),
                               capacity_factor=jcfg.capacity_factor)
    name, k, seq, batch = TINY[kind]
    if jcfg.family == "vlm" and kind != "decode":
        seq += jcfg.n_image_tokens
    return jcfg, tcfg, JShape(name, k, seq, batch), ShapeConfig(name, k, seq,
                                                               batch)


@pytest.fixture(scope="module")
def cells():
    """Both packages' tiny cells, built once: {(arch, kind): (reference's,
    port's)}."""
    out = {}
    for arch in ARCHS:
        for kind in KINDS:
            jcfg, tcfg, jshape, tshape = _tiny(arch, kind)
            out[arch, kind] = (
                jmake_cell(jcfg, jshape, jcpu_mesh(), remat="none"),
                make_cell(tcfg, tshape, make_cpu_mesh(), remat="none"))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_make_cell_matches_reference(arch, kind, cells):
    (_, jargs, jin, jout, jdon), (_, targs, tin, tout, tdon) = \
        cells[arch, kind]
    assert _sig_t(targs) == _sig_j(jargs)
    assert all(t.device.type == "meta" for t in _tflat(targs).values())
    assert _specs_t(tin) == _specs_j(jin)
    assert _specs_t(tout) == _specs_j(jout)
    assert tdon == jdon


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_cell_fn_on_meta_gives_reference_shapes(arch, kind, cells):
    (jfn, jargs, *_), (tfn, targs, *_) = cells[arch, kind]
    want = _sig_j(jax.eval_shape(jfn, *jargs))
    got = tfn(*targs)
    assert _sig_t(got) == want
    assert all(t.device.type == "meta" for t in _tflat(got).values())


def _real_args(tcfg, kind, targs):
    gen = torch.Generator().manual_seed(0)
    model = Model(tcfg)
    params = model.init(gen, device="cpu")

    def fill(t):
        if t.dtype == torch.int32:
            return torch.randint(0, tcfg.vocab, t.shape, dtype=torch.int32,
                                 generator=gen)
        return torch.randn(t.shape, generator=gen).to(t.dtype) * 0.02

    if kind == "train":
        return (params, opt.init_state(params),
                {k: fill(v) for k, v in targs[2].items()})
    if kind == "prefill":
        return params, {k: fill(v) for k, v in targs[1].items()}
    cache = _tflat(targs[1])
    b = targs[2].shape[0]
    real = model.init_cache(b, TINY[kind][2], device="cpu")
    if tcfg.is_encdec:
        real["cross"] = {k: fill(v) for k, v in targs[1]["cross"].items()}
    assert _sig_t(real) == _sig_t(targs[1]) and cache
    return (params, real, fill(targs[2]),
            torch.full((b, 1), 3, dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_cell_fn_runs_on_cpu(arch, kind, cells):
    _, (tfn, targs, *_) = cells[arch, kind]
    _, tcfg, _, _ = _tiny(arch, kind)
    out = tfn(*_real_args(tcfg, kind, targs))
    assert _sig_t(out) == _sig_t(tfn(*targs))
    for k, t in _tflat(out).items():
        assert t.device.type == "cpu", k
        if t.is_floating_point():
            assert torch.isfinite(t).all(), k


# ---------------------------------------------------------------------------
# granite-3-8b on the production meshes
# ---------------------------------------------------------------------------


def _reference_specs_main(out_path):
    """The reference's argument shapes and specs of granite-3-8b's cells on
    its production meshes (needs 256 host devices), as JSON."""
    from repro.distributed import manual_tp as jtp
    from repro.distributed import pp_spmd as jpp
    from repro.launch.mesh import make_pp_mesh as jpp_mesh
    from repro.launch.mesh import make_production_mesh as jprod_mesh
    cfg = jget("granite-3-8b")
    out = {}
    for shape_name, policy in GRANITE_POLICIES:
        shape = JSHAPES[shape_name]
        if policy == "manual":
            cell = jtp.make_manual_prefill(cfg, jprod_mesh(),
                                           shape.global_batch, shape.seq_len)
        elif policy == "ppipe":
            cell = jpp.make_pp_prefill(cfg, jpp_mesh(4), shape.global_batch,
                                       shape.seq_len)
        else:
            cell = jmake_cell(cfg, shape, jprod_mesh(), policy=policy)
        args, in_sh = _jflat(cell[1]), _jflat(cell[2])
        out[f"{shape_name}/{policy}"] = {
            k: [list(a.shape), np.dtype(a.dtype).itemsize,
                _jspec_json(in_sh[k].spec)] for k, a in args.items()}
    for policy, cells in MODE_CELLS.items():
        for arch, shape_name in cells:
            shape = JSHAPES[shape_name]
            mcfg = jget(arch)
            if "manual" in policy and shape.kind == "prefill":
                cell = jtp.make_manual_prefill(mcfg, jprod_mesh(),
                                               shape.global_batch,
                                               shape.seq_len)
            else:
                cell = jmake_cell(mcfg, shape, jprod_mesh(), policy=policy)
            out[f"{arch}/{shape_name}/{policy}"] = {
                "args": {k: [list(a.shape), np.dtype(a.dtype).name]
                         for k, a in _jflat(cell[1]).items()},
                "in": {k: _jspec_json(v.spec)
                       for k, v in _jflat(cell[2]).items()},
                "out": {k: _jspec_json(v.spec)
                        for k, v in _jflat(cell[3]).items()},
                "donate": list(cell[4])}
    Path(out_path).write_text(json.dumps(out))


def _jspec_json(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "specs.json"
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "HOME": str(out.parent),
           "TMPDIR": str(out.parent),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=256"}
    p = subprocess.run([sys.executable, __file__, str(out)], env=env,
                       capture_output=True, text=True, timeout=LIMIT_S)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(out.read_text())


def _axis_sizes(policy):
    if policy == "ppipe":
        return {"stage": 4, "data": 4, "model": 16}
    return {"data": 16, "model": 16}


def _want_bytes(shape, itemsize, spec, sizes):
    n = math.prod(shape)
    for part in spec:
        for ax in ([part] if isinstance(part, str) else (part or [])):
            n //= sizes[ax]
    return n * itemsize


@pytest.mark.parametrize("shape_name,policy", GRANITE_POLICIES)
def test_granite_device_bytes_follow_reference_specs(shape_name, policy,
                                                     reference_specs):
    from repro_torch.distributed import manual_tp, pp_spmd
    cfg = get_config("granite-3-8b")
    shape = SHAPES[shape_name]
    if policy == "manual":
        cell = manual_tp.make_manual_prefill(
            cfg, make_production_mesh(), shape.global_batch, shape.seq_len)
    elif policy == "ppipe":
        cell = pp_spmd.make_pp_prefill(cfg, make_pp_mesh(4),
                                       shape.global_batch, shape.seq_len)
    else:
        cell = make_cell(cfg, shape, make_production_mesh(), policy=policy)
    args, in_sh = _tflat(cell[1]), _tflat(cell[2])
    ref = reference_specs[f"{shape_name}/{policy}"]
    assert set(args) == set(ref)
    sizes = _axis_sizes(policy)
    total = 0
    for k, (shp, itemsize, spec) in ref.items():
        assert list(args[k].shape) == shp, k
        got = math.prod(shard_shape(args[k].shape, in_sh[k])) \
            * args[k].element_size()
        assert got == _want_bytes(shp, itemsize, spec, sizes), k
        total += got
    rec = dryrun.run_cell("granite-3-8b", shape_name, policy=policy,
                          verbose=False)
    assert rec["ok"] and rec["arg_bytes"] == total
    assert rec["temp_bytes"] is None and rec["peak_mem_gb"] is None
    assert rec["out_bytes"] > 0 and rec["collective_s"] > 0


def test_run_cell_record_has_reference_keys():
    row = JRoofline("a", "s", "m", 1, 1.0, 1.0, {}, 1.0, 1.0).row()
    want = set(row) | {"policy", "lower_s", "compile_s", "temp_bytes",
                       "arg_bytes", "out_bytes", "gen_code_bytes", "ok"}
    rec = dryrun.run_cell("granite-3-8b", "decode_32k", verbose=False)
    assert set(rec) == want
    assert rec["mesh"] == "16x16" and rec["chips"] == 256


@pytest.mark.parametrize("policy", ["skip", "kvapp", "manual_skip"])
def test_not_ported_policies_raise(policy, reference_specs, monkeypatch):
    """The policies that set the reference's modes raise nothing: on each
    arch of ``MODE_CELLS`` the cell's argument shapes and dtypes, in and
    out specs and ``donate`` equal the reference's for the same policy,
    ``run_cell`` gives a record whose analytic FLOPs are the reference's
    ``analyze`` for that policy, runs the cell under the policy's modes,
    and puts the modes back after it."""
    from repro.roofline.analysis import analyze as janalyze
    from repro_torch.distributed import manual_tp
    from repro_torch.kernels import ops
    inner, seen = dryrun._run_cell, []

    def spy(*a):
        seen.append((ops.attention_mode(), ops.decode_mode()))
        return inner(*a)

    monkeypatch.setattr(dryrun, "_run_cell", spy)
    want_modes = ("causal_skip" if "skip" in policy else "masked_full",
                  "append" if "kvapp" in policy else "scatter")
    for arch, shape_name in MODE_CELLS[policy]:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        if "manual" in policy and shape.kind == "prefill":
            cell = manual_tp.make_manual_prefill(
                cfg, make_production_mesh(), shape.global_batch,
                shape.seq_len)
        else:
            cell = make_cell(cfg, shape, make_production_mesh(),
                             policy=policy)
        ref = reference_specs[f"{arch}/{shape_name}/{policy}"]
        assert {k: [list(s), d] for k, (s, d) in _sig_t(cell[1]).items()} \
            == ref["args"], arch
        assert {k: [list(p) if isinstance(p, tuple) else p for p in v]
                for k, v in _specs_t(cell[2]).items()} == ref["in"], arch
        assert {k: [list(p) if isinstance(p, tuple) else p for p in v]
                for k, v in _specs_t(cell[3]).items()} == ref["out"], arch
        assert list(cell[4]) == ref["donate"], arch
        rec = dryrun.run_cell(arch, shape_name, policy=policy, verbose=False)
        assert rec["ok"] and rec["policy"] == policy
        assert seen.pop() == want_modes, arch
        assert (ops.attention_mode(), ops.decode_mode()) == \
            ("masked_full", "scatter")
        want = janalyze(arch, JSHAPES[shape_name], "16x16", 256, {},
                        object(), "", jget(arch), policy=policy).row()
        for key in ("flops_total", "model_flops"):
            assert rec[key] == pytest.approx(want[key], rel=1e-12), key
        base = dryrun.run_cell(arch, shape_name, verbose=False)
        assert (rec["flops_total"] < base["flops_total"]) == \
            ("skip" in policy and shape.kind != "decode")
    if policy == "manual_skip":      # manual TP refuses a MoE's prefill
        from repro.distributed import manual_tp as jtp
        assert not jtp.supports(jget("qwen2-moe-a2.7b"))
        with pytest.raises(ValueError, match="manual TP unsupported"):
            dryrun.run_cell("qwen2-moe-a2.7b", "prefill_32k", policy=policy,
                            verbose=False)


def test_main_writes_its_own_directory(tmp_path):
    assert Path(dryrun.OUT_DIR).resolve() == ROOT / "experiments" \
        / "dryrun_torch"
    dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k", "--out",
                 str(tmp_path), "--resume"])
    lines = (tmp_path / "16x16_baseline.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["ok"]


def test_meshes():
    m = make_production_mesh()
    assert tuple(m.shape) == (16, 16)
    assert m.mesh_dim_names == ("data", "model")
    m = make_production_mesh(multi_pod=True)
    assert tuple(m.shape) == (2, 16, 16)
    assert m.mesh_dim_names == ("pod", "data", "model")
    m = make_pp_mesh(4)
    assert tuple(m.shape) == (4, 4, 16)
    assert m.mesh_dim_names == ("stage", "data", "model")
    assert tuple(make_cpu_mesh().shape) == (1, 1)


@pytest.mark.parametrize("policy", ["baseline", "nosp", "manual", "ppipe"])
def test_rules_for_equals_reference(policy):
    for name in SHAPES:
        for arch in [None] + sorted(jlist()):
            jcfg = jget(arch) if arch else None
            tcfg = get_config(arch) if arch else None
            assert rules_for(SHAPES[name], policy, tcfg) == \
                jrules_for(JSHAPES[name], policy, jcfg), (name, arch)


# ---------------------------------------------------------------------------
# the shape-struct surface, every registered config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(jlist()))
def test_structs_equal_reference(arch):
    jm, tm = jax_model(jget(arch)), Model(get_config(arch))
    assert _sig_t(tm.structs()) == _sig_j(jm.structs())
    assert _sig_t(opt.state_structs(tm.structs())) == \
        _sig_j(jopt.state_structs(jm.structs()))
    assert _sig_t(tm.init_cache(2, 64, as_structs=True)) == \
        _sig_j(jm.init_cache(2, 64, as_structs=True))
    assert tm.cache_axes() == jm.cache_axes()
    assert all(t.device.type == "meta"
               for t in _tflat(tm.init_cache(2, 64, as_structs=True)).values())
    if tm.cfg.is_encdec:
        dt = tm.dtype
        assert _sig_t(encdec.cross_kv_structs(tm.cfg, 3, dt)) == \
            _sig_j(jencdec.cross_kv_structs(jm.cfg, 3, jm.cfg.dtype))


if __name__ == "__main__":
    _reference_specs_main(sys.argv[1])
