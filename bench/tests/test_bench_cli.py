"""The command refuses to run without what a cell needs, and prints no
result then."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "qwen2-moe-a2.7b.chatbot", "--seed", str(2**31 + 3),
        "--seconds", "2"]


def _no_card():
    import torch
    return not torch.cuda.is_available()


def test_no_card_no_result():
    if not _no_card():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "bench/run.py"] + ARGS,
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout == ""


def test_only_the_benchmark_files_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py"] + ARGS,
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
