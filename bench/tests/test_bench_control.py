"""The control: the reference in float8 products, put in the program's
place, reads far wider gaps than the program. On the CPU at a tiny size;
on the card at a cell's own size (``control.py``), marked ``cuda``."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench.harness.spec import load_cell
from bench.run import guard
from bench.tests.control import readings
from bench.tests.fixture import make_root

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", ["tiny-dense.tiny-chat",
                                  "tiny-moe.tiny-chat"])
def test_control_reads_wider_than_the_program_tiny(tmp_path, cell):
    c = load_cell(make_root(tmp_path), cell)
    limit = c.own["correct"]["max_logit_gap"]
    failed = 0
    for seed in (1, 2, 3):
        out = readings(c, seed, 3.0, "cpu", guard, time.perf_counter())
        assert out["correct"]
        assert out["program"]["max_logit_gap"] <= limit
        failed += out["control"]["max_logit_gap"] > limit
    # a few dozen tokens a seed at this size: the control parts from the
    # reference on most seeds, not on every one
    assert failed >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_each_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lims = load_cell(ROOT, cell).own["correct"]
    out = subprocess.run([sys.executable, "bench/tests/control.py",
                          "--workload", cell, "--seeds", "11,12,13"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        r = json.loads(line)
        compared = [k for k in ("max_logit_gap", "mean_logit_gap")
                    if k in lims]
        assert all(r["program"][k] <= lims[k] for k in compared), r
        assert any(r["control"][k] > lims[k] for k in compared), r
