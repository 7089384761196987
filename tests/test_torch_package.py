"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package, no file of it imports either, and its entry points
default to the card instead of dropping to the CPU."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_import_leaves_jax_and_reference_unloaded():
    # a subprocess: conftest.py has already imported jax in this one
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'repro'"
        " or m.startswith('repro.')]\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[0])
    assert n >= 20, out.stdout
    # the walk covers the fleet slice: none of its modules loads either
    assert {"repro_torch.fleet", "repro_torch.fleet.frontend",
            "repro_torch.fleet.controller", "repro_torch.serving.simulation",
            "repro_torch.cluster", "repro_torch.cluster.cluster",
            "repro_torch.cluster.sim", "repro_torch.workloads",
            "repro_torch.workloads.applications",
            "repro_torch.workloads.generator",
            "repro_torch.configs.paper_models"} <= set(_modules())
    # and the distributed prefills and the dry run (every src/repro module
    # but kernels/pallas_compat.py now has its twin)
    assert {"repro_torch.distributed.manual_tp",
            "repro_torch.distributed.pp_spmd", "repro_torch.launch",
            "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun"} <= set(_modules())


def test_no_file_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{f.relative_to(SRC)} imports {n}"


@pytest.mark.parametrize("module", _modules())
def test_every_module_imports(module):
    importlib.import_module(module)


def _cfg():
    from repro_torch.configs import get_config, smoke_variant
    return smoke_variant(get_config("granite-3-8b"))


def test_default_device_is_the_card(monkeypatch):
    """Without CUDA the default raises; it never runs on the CPU."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.worker import StageWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, [params])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StageWorker(cfg, params, 1, 0, 2, 32, n_pages=5, page_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg).init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    from repro_torch.core import ServerSpec
    from repro_torch.serving.endpoint import ServerlessFrontend
    from repro_torch.store import (FetchSchedule, ModelStore,
                                   StreamedStageLoader)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServerlessFrontend({"s": ServerSpec("s", 1e9, 1e9, 1 << 30)})
    store = ModelStore.from_params(Model(cfg), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamedStageLoader(store, FetchSchedule.single(1e9))
    assert resolve_device("cpu") == torch.device("cpu")


def test_params_must_sit_on_the_engine_device():
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    cfg = _cfg()
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    params["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="stage params"):
        Engine(cfg, [params], device="cpu")


def test_cpu_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only: the plain version is
    reached through ops' dispatch on a CPU tensor, never by a fallback."""
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     ragged_attention, wkv6)

    q = torch.zeros(8, 4, 16)
    pages = torch.zeros(3, 4, 2, 16)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ragged_attention.ragged_paged_attention(q, pages, pages, tables,
                                                idx, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention.paged_decode_attention(
            q[:1, None], pages, pages, tables,
            torch.ones(1, dtype=torch.int32))
    cache = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_attention.decode_attention(q[:1, None], cache, cache,
                                          torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.flash_attention(q[None], cache, cache)
    x = torch.zeros(1, 3, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6.wkv6(x, x, x, x, torch.zeros(2, 16))


def test_not_ported_options_raise():
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine

    cfg = _cfg()
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    # kv_tier and the sanitizer are ported: the reference's refusals hold
    from repro_torch.router import KVBlockStore
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(cfg, [params], device="cpu", kv_tier=KVBlockStore())
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, [params], device="cpu", paged=False, sanitize=True)
    # an enc-dec model's defs build; the engine refuses it (the reference's
    # has no forward for it); attention (dense or MoE), rwkv and mamba are
    # served
    import dataclasses
    encdec = Model(dataclasses.replace(cfg, encoder_layers=2,
                                       n_audio_frames=8, pos_embed="learned",
                                       max_position=64))
    assert {"encoder", "enc_final_norm", "blocks"} <= set(encdec.defs)
    eparams = encdec.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        Engine(encdec.cfg, [eparams], device="cpu")
    for kw in ({"mixer_pattern": ("rwkv", "mamba")},
               {"mlp_pattern": ("moe",), "n_experts": 4, "top_k": 2,
                "expert_d_ff": 32}):
        assert Model(dataclasses.replace(cfg, **kw)).defs["blocks"]


def test_every_reference_config_is_registered_with_equal_fields():
    """The port copies every config the reference registers, field for
    field, and the smoke variants derive alike."""
    import dataclasses
    from repro.configs import get_config as jget
    from repro.configs import list_configs as jlist
    from repro.configs import smoke_variant as jsmoke
    from repro_torch.configs import get_config, list_configs, smoke_variant
    names = jlist()
    assert len(names) >= 13
    assert set(names) <= set(list_configs())
    for name in names:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget(name)), name
        assert dataclasses.asdict(smoke_variant(get_config(name))) == \
            dataclasses.asdict(jsmoke(jget(name))), name


# ---------------------------------------------------------------------------
# the training slice: roofline, sharding, training
# ---------------------------------------------------------------------------

TRAINING_MODULES = ["roofline/analytic.py", "roofline/analysis.py",
                    "distributed/sharding.py", "training/data.py",
                    "training/optimizer.py", "training/train_step.py",
                    "examples/train_small.py"]
LAUNCH_MODULES = ["distributed/manual_tp.py", "distributed/pp_spmd.py",
                  "launch/__init__.py", "launch/mesh.py", "launch/specs.py",
                  "launch/dryrun.py"]


def test_training_modules_leave_jax_and_reference_unloaded():
    code = ("import sys\n"
            "import repro_torch.training.train_step, "
            "repro_torch.roofline.analysis, "
            "repro_torch.distributed.sharding, "
            "repro_torch.examples.train_small\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules"
            "\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_launch_modules_leave_jax_and_reference_unloaded():
    """Importing the distributed prefills and the dry run loads neither
    JAX nor the reference, and opens no process group."""
    code = ("import sys\n"
            "import torch.distributed as dist\n"
            "import repro_torch.distributed.manual_tp, "
            "repro_torch.distributed.pp_spmd, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules"
            "\n"
            "assert not dist.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("rel", TRAINING_MODULES + LAUNCH_MODULES)
def test_lint_covers_the_training_modules(tmp_path, rel):
    """Each module lints clean; a KV byte formula added to it is flagged
    outside the blessed ``roofline/analytic.py``."""
    from repro_torch.analysis import lint
    path = PKG / rel
    assert lint.lint_file(str(path), rel) == []
    bad = tmp_path / "m.py"
    bad.write_text(path.read_text()
                   + "\nX = 2 * cfg.n_kv_heads * cfg.head_dim\n")
    want = [] if rel == "roofline/analytic.py" else ["kv-bytes-formula"]
    assert [f.rule for f in lint.lint_file(str(bad), rel)] == want


def _plain_inputs(seed=0):
    """Small inputs of the four serving kernels' plain versions, float32,
    the float ones requiring grad."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).requires_grad_()  # noqa
    hq, hkv, hd, bs = 4, 2, 16, 4
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    return {
        "ragged": (r(8, hq, hd), r(7, bs, hkv, hd), r(7, bs, hkv, hd),
                   tables, torch.tensor([0] * 4 + [1] * 4, dtype=torch.int32),
                   torch.tensor([0, 1, 2, 3, 5, 6, -1, -1],
                                dtype=torch.int32)),
        "paged": (r(2, 1, hq, hd), r(7, bs, hkv, hd), r(7, bs, hkv, hd),
                  tables, torch.tensor([5, 9], dtype=torch.int32)),
        "decode": (r(2, 1, hq, hd), r(2, 12, hkv, hd), r(2, 12, hkv, hd),
                   torch.tensor([5, 9], dtype=torch.int32)),
        "wkv6": (r(1, 5, 2, hd), r(1, 5, 2, hd), r(1, 5, 2, hd),
                 r(1, 5, 2, hd), r(2, hd)),
    }


def _serving_calls():
    from repro_torch.kernels import ops
    return {"ragged": ops.ragged_paged_attention,
            "paged": ops.paged_decode_attention,
            "decode": ops.decode_attention,
            "wkv6": lambda *a: ops.wkv6(*a)[0]}


@pytest.mark.parametrize("kernel", ["ragged", "paged", "decode", "wkv6"])
def test_serving_kernels_keep_autograd_on_the_cpu(kernel):
    """On CPU tensors each serving wrapper is its plain version: autograd
    flows through it to every float input, and no launch is counted."""
    from repro_torch.kernels import ops
    args = _plain_inputs()[kernel]
    ops.reset_launch_counts()
    out = _serving_calls()[kernel](*args)
    assert out.requires_grad
    float_in = [a for a in args if a.is_floating_point()]
    grads = torch.autograd.grad(out.square().sum(), float_in)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(bool(g.abs().sum() > 0) for g in grads)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("kernel", ["ragged", "paged", "decode", "wkv6"])
def test_serving_kernels_refuse_grad_on_the_card(kernel, monkeypatch):
    """Dispatch as on the card (``_on_card`` forced): an input that
    requires grad is refused before any kernel is reached; under
    ``no_grad`` the call goes on to the kernel's wrapper (which, given a CPU
    tensor, refuses it)."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    args = _plain_inputs()[kernel]
    with pytest.raises(ValueError, match="requires grad.*no backward"):
        _serving_calls()[kernel](*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        _serving_calls()[kernel](*args)


def _flash_on_card(monkeypatch):
    """Dispatch as on the card with the plain version standing in for the
    kernel (its launches counted), so ``_FlashFn`` runs on the CPU."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    def kernel(q, k, v, *, causal=True, q_offset=0):
        fa.LAUNCHES["flash_attention"] += 1
        return ref.mha_reference(q, k, v, causal=causal, q_offset=q_offset)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(fa, "flash_attention", kernel)
    ops.reset_launch_counts()
    return ops


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 3)])
def test_flash_fn_gradients_equal_the_plain_autograd(monkeypatch, causal,
                                                     q_offset):
    from repro_torch.kernels import ref
    ops = _flash_on_card(monkeypatch)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 5, 4, 16, generator=g).requires_grad_()
               for _ in range(3))
    k2, v2 = (torch.randn(2, 8, 4, 16, generator=g).requires_grad_()
              for _ in range(2))
    out = ops.flash_attention(q, k2, v2, causal=causal, q_offset=q_offset)
    dout = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k2, v2), dout)
    want = torch.autograd.grad(ref.mha_reference(
        q, k2, v2, causal=causal, q_offset=q_offset), (q, k2, v2), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    assert ops.body_counts()["flash_attention/backward_plain"] == 1
    assert ops.launch_counts()["flash_attention"] == 1
    # no grad wanted: the launch alone, no autograd node
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.launch_counts()["flash_attention"] == 2
    assert ops.body_counts()["flash_attention/backward_plain"] == 1


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_flash_fn_composes_with_remat(monkeypatch, remat):
    """A smoke granite's gradients through ``_FlashFn`` (the plain version
    standing in for the kernel) equal the plain path's for each remat
    mode; ``"full"`` launches the forward twice a layer, the backward once
    a layer."""
    import dataclasses
    from repro_torch.training.data import SyntheticTokens
    from repro_torch.training.train_step import loss_and_grads
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(_cfg(), n_layers=3)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = next(iter(SyntheticTokens(cfg, 2, 9, seed=0)))
    _, _, want = loss_and_grads(model, params, batch)
    ops = _flash_on_card(monkeypatch)
    _, _, got = loss_and_grads(model, params, batch, remat=remat)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    launches = ops.launch_counts()["flash_attention"]
    assert launches == (6 if remat != "none" else 3)
    assert ops.body_counts()["flash_attention/backward_plain"] == 3
