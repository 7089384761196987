"""A new architecture comes into the benchmark by new files alone: in a
copy of the tree, an architecture module of its own (two layer slots a
period, a dense MLP then sparse experts, which ``model`` cannot lay
out), its configuration, traffic mix and cell files, and a metric that
reads a kernel family its module costs. ``bench/run.py`` runs the cell
on the CPU (the look for a card skipped), and no file of the harness
differs from the tree's."""

import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench.tests.fixture import TINY_CHAT, TINY_MOE

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent / "newarch"
CELL = "tiny-alternating.alt-chat"
ALTERNATING = dict(TINY_MOE, num_hidden_layers=4, decoder_sparse_step=2,
                   reference="alternating",
                   port=dict(TINY_MOE["port"], name="tiny-alternating"))


def _copy_with_new_files(tmp: Path) -> Path:
    root = tmp / "tree"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "bench"
    shutil.copy(HERE / "alternating.py", b / "reference" / "alternating.py")
    shutil.copy(HERE / "fixture_ragged_bytes.py",
                b / "metrics" / "fixture_ragged_bytes.py")
    (b / "configs" / "tiny-alternating.json").write_text(
        json.dumps(ALTERNATING))
    (b / "traffic" / "alt-chat.json").write_text(json.dumps(TINY_CHAT))
    (b / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"rate_per_s": 6.0, "correct": {"sample": 4,
                                        "max_logit_gap": 0.02}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-alternating",
                             "source": "test fixture",
                             "file": "bench/configs/tiny-alternating.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-alternating",
                               "traffic": "alt-chat", "chips": 1,
                               "why": "CPU test"})
    for m in bench["end_to_end"]:
        if "qwen2-moe-a2.7b.chatbot" in m.get("workloads", []):
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "fixture_ragged_bytes", "unit": "B",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "kernels", "moves": "output_tok_s",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _run_on_the_cpu(root: Path, trace: int) -> dict:
    argv = ["--workload", CELL, "--seed", str(2**31 + 41), "--seconds",
            "3", "--trace", str(trace)]
    code = ("import sys, torch; torch.set_num_threads(2); "
            "sys.path[:0] = [%r, %r]; from bench import run; "
            "sys.exit(run.main(%r, device='cpu'))"
            % (str(root), str(ROOT / "src"), argv))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _harness_differs(root: Path):
    ours, theirs = ROOT / "bench" / "harness", root / "bench" / "harness"
    names = sorted(p.name for p in ours.glob("*.py"))
    assert names == sorted(p.name for p in theirs.glob("*.py"))
    return [n for n in names
            if not filecmp.cmp(ours / n, theirs / n, shallow=False)]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_architecture_runs_from_new_files_alone(tmp_path, trace):
    root = _copy_with_new_files(tmp_path)
    out = _run_on_the_cpu(root, trace)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["checked_tokens"]["value"] > 0
    if trace:
        assert out["metrics"]["fixture_ragged_bytes"]["value"] > 0
    else:
        assert {"setup_s", "output_tok_s"} <= set(out["metrics"])
    assert _harness_differs(root) == []
