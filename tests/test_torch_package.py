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
