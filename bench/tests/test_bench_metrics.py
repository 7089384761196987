"""The metric readers on records built by hand."""

import importlib.util
from pathlib import Path

import pytest

from bench.harness.record import ColdRec, Record, ReqRec, StepRec
from bench.harness.trace import breakdown, busy_in, merge

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rec10():
    rec = Record(t_start=0.0, t_open=10.0, t_close=20.0)
    # arrived in the ramp: its window tokens count, its TTFT does not
    rec.requests.append(ReqRec(0, 5.0, 10, 3, token_times=[9.0, 10.5, 11.0],
                               done_at=11.0))
    # in the window, served: TTFT 1.0, TPOT (14 - 12) / 4 = 0.5 s
    rec.requests.append(ReqRec(1, 11.0, 10, 5,
                               token_times=[12.0, 12.5, 13.0, 13.5, 14.0],
                               done_at=14.0))
    # in the window, no token by the close: censored at 20 - 18 = 2.0
    rec.requests.append(ReqRec(2, 18.0, 10, 5))
    # refused: counts at its wait so far, 20 - 19 = 1.0
    rec.requests.append(ReqRec(3, 19.0, 10, 5, failed=True))
    # arrives at the close: outside the window
    rec.requests.append(ReqRec(4, 20.0, 10, 5, token_times=[20.5]))
    return rec


def test_ttft_p75_counts_every_arrival_censored_at_the_close():
    # waits 1.0, 2.0, 1.0 -> p75 by interpolation = 1.0 + 0.5 * 1.0
    assert reader("ttft_p75_s")(rec10()) == pytest.approx(1.5)


def test_tpot_over_requests_finished_in_the_window():
    # request 0: (11 - 9) / 2 = 1000 ms; request 1: 500 ms -> p75 = 875
    assert reader("tpot_p75_ms")(rec10()) == pytest.approx(875.0)


def test_output_rate_is_the_window_tokens_over_its_seconds():
    # window tokens: 10.5, 11.0 and the five of request 1
    assert reader("output_tok_s")(rec10()) == pytest.approx(7 / 10.0)


def test_setup_is_start_to_the_opening():
    assert reader("setup_s")(rec10()) == pytest.approx(10.0)


def test_cold_ttft_mean_over_cold_arrivals():
    rec = Record(t_start=0.0, t_open=0.0, t_close=10.0)
    rec.requests += [ReqRec(0, 1.0, 5, 2, cold=True, token_times=[3.5]),
                     ReqRec(1, 1.0, 5, 2, cold=True, token_times=[3.5]),
                     ReqRec(2, 9.0, 5, 2, cold=True, token_times=[12.0]),
                     ReqRec(3, 0.5, 5, 2, cold=False, token_times=[0.6])]
    assert reader("cold_ttft_s")(rec) == pytest.approx((2.5 + 2.5 + 3) / 3)


def test_cold_start_layer_readers():
    rec = Record(t_start=0.0, t_open=0.0, t_close=10.0)
    rec.cold.append(ColdRec(1.0, 1.1, 4.1, materialize_s=2.5, bytes=5e9))
    rec.cold.append(ColdRec(5.0, 5.2, 7.2, materialize_s=1.5, bytes=5e9))
    assert reader("load_gbps.coldstart")(rec) == pytest.approx(10 / 4.0)
    assert reader("engine_build_s.coldstart")(rec) == pytest.approx(0.5)


def test_step_counters():
    rec = rec10()
    rec.steps += [StepRec(9.0, 9.5, 7, 1, 0), StepRec(10.0, 10.1, 2, 3, 10),
                  StepRec(12.0, 12.3, 4, 5, 0)]
    assert reader("queued_mean.serve")(rec) == pytest.approx(3.0)
    assert reader("decode_rows_mean.serve")(rec) == pytest.approx(4.0)


def traced():
    rec = Record(t_start=0.0, t_open=10.0, t_close=20.0)
    rec.traced = True
    rec.device_events = [("void ragged_span_kernel<x>(int)", 10.0, 10.5),
                         ("ragged_split_kernel", 10.5, 11.0),
                         ("decode_cluster_kernel<2>", 12.0, 14.0),
                         ("gemm", 13.0, 15.0)]
    rec.busy = merge([(a, b) for _, a, b in rec.device_events])
    rec.steps = [StepRec(10.0, 12.0, 0, 1, 0), StepRec(12.0, 16.0, 0, 1, 0)]
    rec.spans = [("step", 10.0, 12.0), ("step", 12.0, 16.0),
                 ("wait", 16.0, 20.0)]
    # bounds: 0.5 s of ragged work over 1.0 device s; 1 s over 2 s
    rec.calls = [(10.0, "ragged", 3.35e12 * 0.5, 0.0),
                 (12.0, "paged_decode", 0.0, 989e12 * 1.0),
                 (25.0, "paged_decode", 0.0, 989e12 * 5.0)]
    rec.model_flops = [(11.0, 989e12 * 2.0), (21.0, 989e12 * 100.0)]
    return rec


def test_idle_busy_and_host_share():
    rec = traced()
    assert rec.busy == [(10.0, 11.0), (12.0, 15.0)]
    assert busy_in(rec.busy, 10.5, 13.0) == pytest.approx(1.5)
    assert reader("device_idle.serve")(rec) == pytest.approx(60.0)
    # step 1: 2 s wall, 1 s busy; step 2: 4 s wall, 3 s busy
    assert reader("host_ms_per_step.serve")(rec) == pytest.approx(1000.0)


def test_rooflines_and_mfu():
    rec = traced()
    assert reader("ragged_paged_attention_roofline")(rec) == \
        pytest.approx(50.0)
    assert reader("paged_decode_attention_roofline")(rec) == \
        pytest.approx(50.0)
    assert reader("mfu.serve")(rec) == pytest.approx(20.0)


def test_readers_are_silent_without_a_trace():
    rec = rec10()
    for name in ("device_idle.serve", "host_ms_per_step.serve", "mfu.serve",
                 "ragged_paged_attention_roofline",
                 "paged_decode_attention_roofline", "load_gbps.coldstart"):
        assert reader(name)(rec) is None


def test_breakdown_labels_idle_by_host_span():
    out = breakdown(traced())
    assert out["device_ops"][0][0] in ("decode_cluster_kernel<2>", "gemm")
    # a gap goes to the span holding its midpoint: 11-12 to the first
    # step, 15-20 to the wait
    idle = dict(out["idle_gaps"])
    assert idle["wait"] == pytest.approx(5.0)
    assert idle["step"] == pytest.approx(1.0)
