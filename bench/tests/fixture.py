"""A checkout of the benchmark in a temporary directory with tiny cells
added by new files alone (configurations, traffic mixes, cell files and
entries in a new ``BENCHMARK.json``), for the CPU tests."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_DENSE = {
    "source": "test fixture", "model_type": "granite", "hidden_act": "silu",
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 500, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "port": {"name": "tiny-dense", "family": "dense", "qkv_bias": False},
    "engine": {"paged": True, "fused": False, "block_size": 16,
               "prefill_chunk": 64, "max_batch": 4, "max_seq": 256},
}
TINY_MOE = {
    "source": "test fixture", "model_type": "qwen2_moe",
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "head_dim": 16, "vocab_size": 500,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "moe_intermediate_size": 32, "shared_expert_intermediate_size": 64,
    "num_experts_per_tok": 2, "num_experts": 4, "norm_topk_prob": True,
    "port": {"name": "tiny-moe", "family": "moe", "qkv_bias": True,
             "capacity_factor": 4.0, "expert_sharding": "expert"},
    "engine": {"paged": True, "fused": False, "block_size": 16,
               "prefill_chunk": 64, "max_batch": 4, "max_seq": 256},
}
TINY_CHAT = {
    "kind": "open_loop", "prompt": {"mean": 24, "sigma": 0.6, "min": 8,
                                    "max": 96},
    "output": {"mean": 8, "sigma": 0.6, "min": 4, "max": 16},
    "cv": 2.0, "ramp_s": 0.5, "shape_seed": 5,
}
TINY_COLD = {
    "kind": "cold_bursts", "prompt": {"mean": 24, "sigma": 0.6, "min": 8,
                                      "max": 64},
    "output": {"mean": 6, "sigma": 0.6, "min": 4, "max": 12},
    "burst": 2, "pool_bursts": 64, "shape_seed": 6,
    "server": {"id": "card0", "nic_gbps": 16, "pcie_bytes_per_s": 12e9,
               "hbm_gb": 80},
    "slo": {"ttft_s": 7.5, "tpot_s": 0.084},
}
CELLS = {
    "tiny-dense.tiny-chat": ("tiny-dense", "tiny-chat",
                             {"rate_per_s": 6.0,
                              "correct": {"sample": 4,
                                          "max_logit_gap": 0.02}}),
    "tiny-moe.tiny-chat": ("tiny-moe", "tiny-chat",
                           {"rate_per_s": 6.0,
                            "correct": {"sample": 4, "max_logit_gap": 0.02}}),
    "tiny-dense.tiny-cold": ("tiny-dense", "tiny-cold",
                             {"correct": {"sample": 4,
                                          "max_logit_gap": 0.02}}),
}


def _write(path: Path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    """The repository's benchmark copied into ``tmp`` and the tiny cells
    added: new files, and new entries in the copy of BENCHMARK.json."""
    for sub in ("metrics", "configs", "traffic", "cells"):
        shutil.copytree(ROOT / "bench" / sub, tmp / "bench" / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    _write(tmp / "bench/configs/tiny-dense.json", TINY_DENSE)
    _write(tmp / "bench/configs/tiny-moe.json", TINY_MOE)
    _write(tmp / "bench/traffic/tiny-chat.json", TINY_CHAT)
    _write(tmp / "bench/traffic/tiny-cold.json", TINY_COLD)
    for name in ("tiny-dense", "tiny-moe"):
        bench["configs"].append({"name": name, "source": "test fixture",
                                 "file": f"bench/configs/{name}.json",
                                 "reduced": [], "why": "CPU test"})
    for cell, (cfg, traffic, own) in CELLS.items():
        _write(tmp / "bench/cells" / f"{cell}.json", own)
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU test"})
        kind = TINY_COLD if traffic == "tiny-cold" else TINY_CHAT
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" not in m:
                continue
            serve = "qwen2-moe-a2.7b.chatbot" in m["workloads"]
            cold = "granite-3-8b.coldstart-code" in m["workloads"]
            if (kind is TINY_CHAT and serve) or (kind is TINY_COLD and cold):
                m["workloads"].append(cell)
    _write(tmp / "BENCHMARK.json", bench)
    return tmp
