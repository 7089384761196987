"""A whole run of each kind of cell at a tiny size on the CPU, the look
for a card skipped: the window, the metrics, the comparison."""

import time

import pytest

from bench.harness import cell_run
from bench.harness import weights as W
from bench.harness.spec import load_cell
from bench.run import guard
from bench.tests.fixture import make_root


def run_cpu(root, cell, seed=2**31 + 21, seconds=3.0, keep=False):
    c = load_cell(root, cell)
    rec, checks, dev, kept = cell_run.run(c, seed, seconds, False, "cpu",
                                          time.perf_counter(), guard,
                                          keep=keep)
    return c, rec, checks, dev, kept


@pytest.mark.parametrize("cell", ["tiny-dense.tiny-chat",
                                  "tiny-moe.tiny-chat",
                                  "tiny-dense.tiny-cold"])
def test_tiny_cell_end_to_end(tmp_path, cell):
    c, rec, checks, dev, _ = run_cpu(make_root(tmp_path), cell)
    out = cell_run.result(c, rec, checks, dev, False)
    assert out["correct"] is True, checks
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m.name for m in c.end_to_end}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert checks["checked_tokens"]["value"] > 0
    mem = out["memory"]
    assert 0 < mem["kv_live_peak_bytes"] <= mem["kv_pool_bytes"]
    assert mem["weights_bytes"] == sum(
        t.numel() * t.element_size()
        for t in W.flat(W.make(c.arch, 0, "cpu")).values())
    if "cold" in cell:
        assert rec.cold and all(c.t_first_token for c in rec.cold)
        assert checks["weights_mismatched_leaves"]["value"] == 0
