"""The port's example twins (``repro_torch.examples``) on the CPU: each
``main(device="cpu")`` passes its own checks on weights drawn from a
seeded ``torch.Generator``; and on the weights of the reference's example
(its module globals after ``runpy``, converted), each twin prints the
reference example's greedy tokens exactly. The quickstart is also held
through ``tests/test_torch_coldstart.py::_quickstart``, its scheme and
tokens equal to the reference's. The reference's store smoke writes its
``BENCH_coldstart_timeline.json`` into the working directory, so it runs
from a temporary one.
"""

import dataclasses
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import smoke
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_numpy
from repro_torch.examples import (consolidation_demo, quickstart,
                                  store_coldstart_smoke, streaming_demo)
from test_torch_coldstart import _quickstart

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _reference(name, cwd, monkeypatch):
    """Run the reference's ``examples/<name>.py`` and return its globals,
    with its params converted for the port."""
    monkeypatch.chdir(cwd)
    g = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="reference")
    g["tparams"] = params_from_numpy(jax.tree.map(np.asarray, g["params"]),
                                     "cpu")
    return g


@pytest.mark.parametrize("twin", [quickstart, streaming_demo,
                                  consolidation_demo, store_coldstart_smoke],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_twin_passes_its_checks_on_the_cpu(twin, capsys):
    twin.main(device="cpu")
    assert "OK:" in capsys.readouterr().out


def test_quickstart_twin_equals_reference(tmp_path, monkeypatch):
    """On the reference example's weights the twin's stream (before and
    after consolidation) is the reference example's, and so is
    ``_quickstart``'s JAX side at the same config; the scheme equals."""
    g = _reference("quickstart", tmp_path, monkeypatch)
    out = quickstart.main(device="cpu", params=g["tparams"])
    assert list(out["request"].generated) == list(g["req"].generated)
    assert len(out["before"]) == 6
    j = _quickstart("jax", g["params"], cfgs=(smoke("granite-3-8b"),
                                              out["endpoint"].cfg))
    assert dataclasses.asdict(out["endpoint"].scheme) == \
        dataclasses.asdict(j["ep"].scheme)
    assert out["before"] == j["before"]
    assert list(out["request"].generated) == list(j["req"].generated)


def test_streaming_twin_equals_reference(tmp_path, monkeypatch):
    """The greedy probe and the stop-token stream equal the reference
    example's (the seeded sampled stream is the port's own sampler's)."""
    g = _reference("streaming_demo", tmp_path, monkeypatch)
    out = streaming_demo.main(device="cpu", params=g["tparams"])
    assert out["probe"] == list(g["probe"])
    for name in ("greedy ", "stopped"):
        assert list(out["requests"][name].generated) == \
            list(g["reqs"][name].generated)
    assert out["requests"]["stopped"].finish_reason.value == "stop_token"


def test_consolidation_twin_equals_reference(tmp_path, monkeypatch):
    """The same stages (2: the smoke jamba has one period), the same
    stream across the scale-down, and the same gathered bytes."""
    g = _reference("consolidation_demo", tmp_path, monkeypatch)
    out = consolidation_demo.main(device="cpu", params=g["tparams"])
    assert out["n_stages"] == g["n_stages"] == 2
    assert list(out["request"].generated) == list(g["req"].generated)
    assert out["migration_bytes"] == g["n_bytes"]


def test_store_smoke_twin_equals_reference(tmp_path, monkeypatch):
    """The same store size, the same greedy tokens, and the cold-start
    record (simulated clock) to 1e-9 s of the reference's."""
    ref_dir, out_file = tmp_path / "ref", tmp_path / "port.json"
    ref_dir.mkdir()
    g = _reference("store_coldstart_smoke", ref_dir, monkeypatch)
    rec = store_coldstart_smoke.main(device="cpu", params=g["tparams"],
                                     store_dir=str(tmp_path / "store"),
                                     out=str(out_file))
    assert out_file.exists()
    assert (ref_dir / "BENCH_coldstart_timeline.json").exists()
    assert rec["store_bytes"] == g["store"].total_bytes
    assert rec["tokens"] == list(g["tokens"])
    want = g["report"].to_json()
    assert rec["cold_start"]["total_bytes"] == want["total_bytes"]
    assert abs(rec["cold_start"]["ready"] - want["ready"]) <= 1e-9
    assert set(rec["ablation_crosscheck"]) == {"none", "+prefetch",
                                               "+stream", "+overlap"}


def test_twins_default_to_the_card():
    """Without ``device`` a twin asks for the card, and raises where there
    is none (it never drops to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main()
