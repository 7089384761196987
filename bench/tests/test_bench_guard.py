"""The import check: top-level names compared whole, and the run fails
when one is loaded."""

import os
import subprocess
import sys
from pathlib import Path

from bench.run import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]


def test_whole_top_level_names():
    assert forbidden_loaded(["repro_torch", "repro_torch.serving",
                             "numpy", "jaxtyping", "reprox"]) == []
    assert forbidden_loaded(["repro.models", "jax._src", "jaxlib",
                             "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_the_harness_and_the_port_load_none(tmp_path):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import bench.run as r, bench.harness.cell_run, "
            "bench.harness.spec, bench.reference.model\n"
            "import repro_torch.serving.endpoint, repro_torch.serving.engine\n"
            "print(r.forbidden_loaded())\n") % (str(ROOT / "src"), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_with_jax_loaded_fails(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import jax\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                          "--workload", "qwen2-moe-a2.7b.chatbot", "--seed",
                          "1", "--seconds", "1"], capture_output=True,
                         text=True, env=env, cwd=tmp_path)
    assert out.returncode == 3
    assert "jax" in out.stderr
    assert out.stdout == ""
