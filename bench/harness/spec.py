"""A cell, assembled by name from the files of the checkout.

``BENCHMARK.json`` names the cell; its configuration file is the entry's
``file``; its traffic mix is ``bench/traffic/<traffic>.json``; its own
numbers (the offered rate, the correctness limits) are
``bench/cells/<workload>.json``; each metric is read by
``bench/metrics/<metric>.py``. Nothing here names a cell."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List


@dataclass
class Metric:
    name: str
    unit: str
    per_layer: bool
    read: Callable


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config_name: str
    arch: dict                  # the configuration file
    traffic_name: str
    traffic: dict               # the traffic mix file
    own: dict                   # bench/cells/<workload>.json
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reader(root: Path, name: str) -> Callable:
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root, workload: str) -> Cell:
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[w["config"]]
    cell = Cell(root=root, name=workload, chips=int(w["chips"]),
                config_name=cfg["name"], arch=_load_json(root / cfg["file"]),
                traffic_name=w["traffic"],
                traffic=_load_json(root / "bench" / "traffic"
                                   / f"{w['traffic']}.json"),
                own=_load_json(root / "bench" / "cells" / f"{workload}.json"))
    for m in bench["end_to_end"]:
        if _applies(m, workload):
            cell.end_to_end.append(Metric(m["name"], m["unit"], False,
                                          _reader(root, m["name"])))
    for m in bench["per_layer"]:
        if _applies(m, workload):
            cell.per_layer.append(Metric(m["name"], m["unit"], True,
                                         _reader(root, m["name"])))
    return cell


def port_config(arch: dict):
    """The port's ``ModelConfig`` for a configuration file: its Hugging
    Face keys, as run, mapped onto the port's fields, and the ``port``
    block for what those keys do not state."""
    from repro_torch.configs.base import ModelConfig
    port = arch["port"]
    kw = dict(name=port["name"], family=port["family"],
              n_layers=arch["num_hidden_layers"],
              d_model=arch["hidden_size"],
              n_heads=arch["num_attention_heads"],
              n_kv_heads=arch["num_key_value_heads"],
              vocab=arch["vocab_size"],
              rope_theta=float(arch["rope_theta"]),
              norm_eps=float(arch["rms_norm_eps"]),
              tie_embeddings=bool(arch["tie_word_embeddings"]),
              qkv_bias=bool(port.get("qkv_bias", False)),
              dtype=arch["torch_dtype"])
    if arch.get("head_dim"):
        kw["head_dim"] = arch["head_dim"]
    if arch.get("num_experts"):
        eff = arch["moe_intermediate_size"]
        kw.update(d_ff=eff, n_experts=arch["num_experts"],
                  top_k=arch["num_experts_per_tok"], expert_d_ff=eff,
                  n_shared_experts=arch["shared_expert_intermediate_size"]
                  // eff,
                  capacity_factor=float(port["capacity_factor"]),
                  expert_sharding=port.get("expert_sharding", "expert"),
                  mlp_pattern=("moe",))
    else:
        kw["d_ff"] = arch["intermediate_size"]
    return ModelConfig(**kw)
