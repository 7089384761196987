"""``bench/tools/phases.py``: its readings on records built by hand, the
breakdown's labels once the port's phases join the harness's spans, and
a whole run of each kind of tiny cell on the CPU with telemetry on."""

import time

import pytest

from bench.harness import cell_run
from bench.harness.record import Record, StepRec
from bench.harness.trace import breakdown
from bench.metrics import _common as M
from bench.run import guard
from bench.tests.fixture import make_root
from bench.tools import phases as P


def rec_steps():
    rec = Record(t_start=0.0, t_open=10.0, t_close=20.0)
    rec.steps = [StepRec(9.0, 10.5, 0, 1, 0),      # begins before: out
                 StepRec(11.0, 12.0, 0, 1, 0),
                 StepRec(13.0, 14.0, 0, 1, 0)]
    return rec


SPANS = [("engine.schedule", 9.1, 9.2), ("runner.forward", 9.2, 10.4),
         ("engine.schedule", 11.0, 11.1), ("runner.inputs", 11.1, 11.2),
         ("runner.forward", 11.2, 11.6), ("engine.sample", 11.6, 11.9),
         ("engine.emit", 11.9, 12.0),
         ("engine.schedule", 13.0, 13.2), ("runner.forward", 13.2, 13.8),
         ("load.copy", 15.0, 15.5), ("load.copy", 16.0, 16.5)]


def test_step_phases_over_the_window_steps():
    ph = M.step_phases(rec_steps(), SPANS)
    assert ph["engine.schedule_ms_per_step"] == pytest.approx(150.0)
    assert ph["runner.forward_ms_per_step"] == pytest.approx(500.0)
    assert ph["runner.inputs_ms_per_step"] == pytest.approx(50.0)
    assert ph["engine.sample_ms_per_step"] == pytest.approx(150.0)
    assert ph["engine.emit_ms_per_step"] == pytest.approx(50.0)
    assert ph["step_wall_ms"] == pytest.approx(1000.0)
    assert ph["phase_share_of_step"] == pytest.approx(0.9)
    assert M.step_phases(Record(0.0, 10.0, 20.0), SPANS) == {}


def test_queue_wait_over_window_requests_admitted_in_it():
    got = M.queue_wait_ms(rec_steps(), [
        (9.0, 11.0),         # submitted before the window: out
        (11.0, 11.05),       # 50 ms
        (12.0, 12.15),       # 150 ms
        (18.0, 21.0),        # admitted after the close: out
        (19.0, None),        # still waiting: out
    ])
    assert got == pytest.approx(100.0)
    assert M.queue_wait_ms(rec_steps(), []) is None


def test_counters_and_spans_per_window():
    counts = {"host_sync": 10, "load.bytes": 3_000_000_000}
    assert M.host_syncs_per_step(rec_steps(), counts) == pytest.approx(5.0)
    assert M.load_copy_gbps(SPANS, counts) == pytest.approx(3.0)
    assert M.load_copy_gbps(SPANS[:3], counts) is None
    assert P.mean_span_s(SPANS, "load.copy") == pytest.approx(0.5)
    assert P.mean_span_s(SPANS, "engine.build") is None
    assert P.step_idle_share({"idle_gaps": [["runner.forward", 3.0],
                                            ["step", 1.0]]}) == 0.25
    assert P.step_idle_share({"idle_gaps": []}) is None
    rec = rec_steps()
    rec.steps[1].prefill_tokens = 64
    assert P.budget_step_share(rec, 64) == 0.5
    assert P.budget_step_share(rec, None) is None


def test_breakdown_labels_a_gap_by_the_phase_inside_the_step():
    """The harness's ``step`` span holds the port's phases: an idle gap
    inside a phase goes to the phase, one between phases to ``step``."""
    rec = Record(t_start=0.0, t_open=0.0, t_close=10.0)
    rec.spans = [("step", 1.0, 5.0)]
    rec.spans += [("engine.schedule", 1.0, 1.5), ("runner.inputs", 1.5, 2.0),
                  ("runner.forward", 2.0, 3.5), ("engine.sample", 3.6, 4.5),
                  ("engine.emit", 4.5, 5.0)]
    rec.busy = [(0.0, 1.2), (1.4, 2.1), (2.3, 3.54), (3.56, 10.0)]
    gaps = dict(breakdown(rec)["idle_gaps"])
    assert gaps == pytest.approx({"engine.schedule": 0.2,
                                  "runner.forward": 0.2, "step": 0.02})
    # a traced run keeps the port's spans apart: the same labels
    rec.port_spans, rec.spans = rec.spans[1:], rec.spans[:1]
    assert dict(breakdown(rec)["idle_gaps"]) == pytest.approx(gaps)


@pytest.mark.parametrize("cell", ["tiny-dense.tiny-chat",
                                  "tiny-dense.tiny-cold"])
def test_tiny_cell_with_telemetry_on(tmp_path, cell):
    from repro_torch import telemetry
    drivers = cell_run.open_loop, cell_run.cold_bursts
    out = P.measure(make_root(tmp_path), cell, 2**31 + 23, 3.0, False, True,
                    "cpu", time.perf_counter(), guard)
    assert (cell_run.open_loop, cell_run.cold_bursts) == drivers
    assert telemetry.span("x") is telemetry._OFF
    assert out["correct"] is True
    ph = out["phases"]
    assert ph["window_steps"] > 0
    assert ph["phase_share_of_step"] > 0.9
    assert ph["runner.forward_ms_per_step"] > 0
    assert ph["host_syncs_per_step"] >= 3
    if "cold" in cell:
        assert ph["load_copy_gbps"] > 0 and ph["engine_build_s"] > 0
        assert ph["coldstart_plan_s"] > 0
    else:
        assert ph["queue_wait_ms"] >= 0
        assert ph["load_copy_gbps"] is None
