"""Cells are found by name from files alone; the configuration files map
onto the port's registered configurations; the weights' layout is the
port's."""

import json
from pathlib import Path

import pytest
import torch

from bench.harness import weights as W
from bench.harness.spec import load_cell, port_config
from bench.tests.fixture import CELLS, make_root

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_metrics(cell):
    c = load_cell(ROOT, cell)
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    moved = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
    for m in c.per_layer:
        assert moved[m.name] in names


def test_a_cell_added_by_new_files_alone_is_found(tmp_path):
    root = make_root(tmp_path)
    for name, (cfg, traffic, own) in CELLS.items():
        c = load_cell(root, name)
        assert c.config_name == cfg and c.traffic_name == traffic
        assert c.own == own
        assert {m.name for m in c.end_to_end} >= {"setup_s"}
    with pytest.raises(KeyError):
        load_cell(root, "no-such.cell")


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_configuration_file_is_the_port_config(cfg):
    from repro_torch.configs import get_config
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    arch = json.loads((ROOT / entry["file"]).read_text())
    assert arch["source"] == entry["source"]
    ours, port = port_config(arch), get_config(arch["port"]["name"])
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "qkv_bias", "n_experts", "top_k",
              "n_shared_experts", "expert_d_ff", "capacity_factor",
              "mlp_pattern", "mixer_pattern", "dtype"):
        assert getattr(ours, f) == getattr(port, f), f
    # where the port has the option, the file's (the source's) value runs
    assert ours.rope_theta == arch["rope_theta"]
    assert ours.norm_eps == arch["rms_norm_eps"]
    assert ours.tie_embeddings == arch["tie_word_embeddings"]
    for key in entry["reduced"]:
        assert arch["published"][key] != arch[key]


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_weights_layout_is_the_port_layout(cfg):
    from repro_torch.models.model import Model
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    arch = json.loads((ROOT / entry["file"]).read_text())
    structs = W.flat(Model(port_config(arch)).structs())
    ours = W.layout(arch)
    assert list(ours) == list(structs)
    for path, (shape, _, _) in ours.items():
        assert tuple(structs[path].shape) == shape, path


def test_weights_are_the_seed_s():
    from bench.tests.fixture import TINY_MOE
    a = W.make(TINY_MOE, 2**31 + 11, "cpu")
    b = W.make(TINY_MOE, 2**31 + 11, "cpu")
    c = W.make(TINY_MOE, 2**31 + 12, "cpu")
    fa, fb, fc = W.flat(a), W.flat(b), W.flat(c)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert not torch.equal(fa[("lm_head",)], fc[("lm_head",)])
    assert all(t.dtype == torch.bfloat16 for t in fa.values())
