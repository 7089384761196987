"""A whole run of each kind of cell at a tiny size on the CPU, the look
for a card skipped: the window, the metrics, the comparison; traced, the
calls and FLOPs the parent's counter recorded, and the port's own spans
and counters (no profile is taken on the CPU)."""

import time
from contextlib import contextmanager

import pytest

from bench.harness import cell_run
from bench.harness import weights as W
from bench.harness.calls import CallCounter
from bench.harness.record import Record
from bench.harness.spec import load_cell
from bench.run import guard
from bench.tests import parent_frozen as parent
from bench.tests.fixture import make_root

TINY = ["tiny-dense.tiny-chat", "tiny-moe.tiny-chat", "tiny-dense.tiny-cold"]
SERVE_SPANS = ("queue_wait_ms.serve", "schedule_ms_per_step.serve",
               "dispatch_ms_per_step.serve", "sample_ms_per_step.serve",
               "host_syncs_per_step.serve")


def run_cpu(root, cell, seed=2**31 + 21, seconds=3.0, keep=False,
            trace=False):
    c = load_cell(root, cell)
    rec, checks, dev, kept = cell_run.run(c, seed, seconds, trace, "cpu",
                                          time.perf_counter(), guard,
                                          keep=keep)
    return c, rec, checks, dev, kept


@pytest.mark.parametrize("cell", TINY)
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


class _BothCounters:
    """The harness's call counter and the parent's on one run, the
    parent's recording into a record of its own."""

    def __init__(self, arch, rec):
        self.new = CallCounter(arch, rec)
        self.shadow = Record(0.0)
        self.old = parent.CallCounter(arch, self.shadow)

    @property
    def on(self):
        return self.new.on

    @on.setter
    def on(self, value):
        self.new.on = self.old.on = value

    def wrap_runner(self, runner):
        self.new.wrap_runner(runner)
        self.old.wrap_runner(runner)

    @contextmanager
    def ops_wrapped(self):
        with self.new.ops_wrapped(), self.old.ops_wrapped():
            yield


@pytest.mark.parametrize("cell", TINY)
def test_traced_tiny_cell_records_what_the_parent_did(tmp_path, monkeypatch,
                                                      cell):
    made = []

    def both(arch, rec):
        made.append(_BothCounters(arch, rec))
        return made[-1]
    monkeypatch.setattr(cell_run, "CallCounter", both)
    _, rec, checks, _, _ = run_cpu(make_root(tmp_path), cell, trace=True)
    shadow = made[0].shadow
    assert rec.model_flops and rec.calls
    assert [f for _, f in rec.model_flops] == \
        [f for _, f in shadow.model_flops]
    assert [c[1:] for c in rec.calls] == [c[1:] for c in shadow.calls]
    assert {c[1] for c in rec.calls} == {"ragged", "paged_decode"}


@pytest.mark.parametrize("cell", ["tiny-dense.tiny-chat",
                                  "tiny-dense.tiny-cold"])
def test_traced_tiny_cell_reads_the_port_telemetry(tmp_path, cell):
    from repro_torch import telemetry
    c, rec, checks, dev, _ = run_cpu(make_root(tmp_path), cell, trace=True)
    assert telemetry._ON is False
    assert any(n == "runner.forward" and rec.in_window(a)
               for n, a, _ in rec.port_spans)
    assert all(rec.t_open <= a for _, a, _ in rec.port_spans)
    out = cell_run.result(c, rec, checks, dev, True)
    assert out["correct"] is True, checks
    got = set(out["metrics"])
    if "cold" in cell:
        loaded = sum(cr.bytes for cr in rec.cold)
        assert loaded > 0 and rec.counters["load.bytes"] == loaded
        assert "load_copy_gbps.coldstart" in got
    else:
        assert rec.admissions and rec.counters["host_sync"] > 0
        assert set(SERVE_SPANS) <= got
        assert all(out["metrics"][m]["value"] > 0 for m in SERVE_SPANS
                   if m != "queue_wait_ms.serve")


@pytest.mark.parametrize("cell", ["tiny-dense.tiny-chat",
                                  "tiny-dense.tiny-cold"])
def test_untraced_run_leaves_telemetry_off(tmp_path, monkeypatch, cell):
    from repro_torch import telemetry
    enabled = []
    monkeypatch.setattr(telemetry, "enable", lambda: enabled.append(1))
    assert telemetry._ON is False
    _, rec, checks, _, _ = run_cpu(make_root(tmp_path), cell)
    assert enabled == [] and telemetry._ON is False
    assert rec.port_spans == [] and rec.counters == {}
    assert rec.admissions == []
