"""The port's wall-clock telemetry (``repro_torch/telemetry.py``) on a tiny
engine on the CPU: off by default and then silent; on, a serving step is
tiled by its five flat phases on every path (paged, fused, a chunked
prefill beside a decode); ``drain`` empties the buffer; the request
stamps are ordered; a cold start from a ``ModelStore.from_params`` store
spans each planned range's read and copy, and sends nothing through the
card's ring of pinned slots; ``host_sync`` counts a decode step's uploads
and logit reads."""

import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch import telemetry
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import GB, Gbps, ModelProfile, ServerSpec, SLO
from repro_torch.core import TimingProfile
from repro_torch.kernels import ops
from repro_torch.models.model import Model
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.endpoint import ServerlessFrontend
from repro_torch.serving.engine import Engine

SRC = Path(__file__).resolve().parents[1] / "src"
PHASES = {"engine.schedule", "runner.inputs", "runner.forward",
          "engine.sample", "engine.emit"}
KW = dict(max_batch=3, max_seq=64, block_size=8, device="cpu")


@pytest.fixture(scope="module")
def granite():
    cfg = smoke_variant(get_config("granite-3-8b"))
    return cfg, Model(cfg).init(device="cpu")


@pytest.fixture
def on():
    """Telemetry on for the test, with an empty buffer; off after."""
    telemetry.drain()
    telemetry.enable()
    try:
        yield
    finally:
        telemetry.disable()
        telemetry.drain()


def _flat_in_order(spans):
    for (_, a0, a1), (_, b0, _) in zip(spans, spans[1:]):
        assert a0 <= a1 <= b0


def test_now_is_perf_counter():
    assert telemetry.now is time.perf_counter


def test_off_by_default():
    code = ("from repro_torch import telemetry as t\n"
            "assert not t._ON\n"
            "assert t.span('x') is t._OFF\n"
            "with t.span('x'):\n"
            "    pass\n"
            "assert t.drain()[0] == []\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_off_records_nothing(granite):
    cfg, params = granite
    telemetry.drain()
    eng = Engine(cfg, [params], **KW)
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_new=3))
    eng.run()
    assert telemetry.span("engine.step") is telemetry._OFF
    assert telemetry.drain()[0] == []
    assert telemetry._SPANS == []


def test_drain_empties_the_buffer(on):
    with telemetry.span("a"):
        pass
    spans, counts = telemetry.drain()
    assert [s[0] for s in spans] == ["a"]
    assert set(ops.launch_counts()) <= set(counts)
    assert {"host_sync", "upload_bytes", "load.bytes", "load.staged_bytes",
            "load.slot_waits"} <= set(counts)
    assert telemetry.drain()[0] == []


@pytest.mark.parametrize("kw", [{}, {"fused": True}, {"prefill_chunk": 4}],
                         ids=["paged", "fused", "chunked-prefill"])
def test_step_is_tiled_by_the_five_phases(granite, on, kw):
    """One step holding a prefill (a chunk of one under ``prefill_chunk``)
    beside a decode: exactly the five phase names, flat and in order,
    covering at least 95% of the step's wall time."""
    cfg, params = granite
    eng = Engine(cfg, [params], **KW, **kw)
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_new=8))
    eng.step()
    eng.submit(list(range(1, 12)), SamplingParams(max_new=4))
    telemetry.drain()
    t0 = time.perf_counter()
    eng.step()
    t1 = time.perf_counter()
    spans, _ = telemetry.drain()
    assert {n for n, _, _ in spans} == PHASES
    assert spans[0][0] == "engine.schedule"
    _flat_in_order(spans)
    assert spans[0][1] >= t0 and spans[-1][2] <= t1
    assert sum(b - a for _, a, b in spans) >= 0.95 * (t1 - t0)


def test_decode_step_phases(granite, on):
    cfg, params = granite
    eng = Engine(cfg, [params], **KW)
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_new=8))
    eng.step()
    telemetry.drain()
    eng.step()
    assert [n for n, _, _ in telemetry.drain()[0]] == [
        "engine.schedule", "runner.inputs", "runner.forward",
        "engine.sample", "engine.emit"]


@pytest.mark.parametrize("kw", [{}, {"fused": True}], ids=["paged", "fused"])
def test_request_stamps_are_ordered(granite, kw):
    cfg, params = granite
    eng = Engine(cfg, [params], **KW, **kw)
    t0 = telemetry.now()
    reqs = [eng.submit(p, SamplingParams(max_new=4)) for p in
            ([1, 2, 3, 4, 5], [9, 8, 7], [3, 1, 4, 1, 5, 9, 2], [11, 12])]
    assert reqs[3].metrics.admitted_t is None
    eng.run()
    for r in reqs:
        m = r.metrics
        assert t0 <= m.submit_t <= m.admitted_t <= m.first_token_t \
            <= m.finish_t <= telemetry.now()
    # the fourth waited for a slot (max_batch 3)
    assert reqs[3].metrics.admitted_t >= reqs[0].metrics.finish_t


def test_cold_start_spans_each_planned_range(granite, on):
    cfg, params = granite
    front = ServerlessFrontend({"srv0": ServerSpec("srv0", 16 * Gbps, 12e9,
                                                   24 * GB)}, device="cpu")
    store = front.deploy(cfg, params, ModelProfile(cfg.name, GB,
                                                   TimingProfile(),
                                                   SLO(60.0, 1.0)))
    before = telemetry.counters()
    telemetry.drain()
    pend = front.begin_cold_start(cfg.name, max_seq=32, block_size=8)
    pend.finish()
    spans, counts = telemetry.drain()
    n = pend.n_stages
    ranges = sum(len(store.stage_plan(n, i)) for i in range(n))
    names = [s[0] for s in spans]
    assert names[0] == "coldstart.plan" and names[-1] == "engine.build"
    assert names[1:-1] == ["load.read", "load.copy"] * ranges
    _flat_in_order(spans)
    assert counts["load.bytes"] - before["load.bytes"] == sum(
        store.stage_bytes(n, i) for i in range(n))
    # the CPU copies each range itself: nothing goes through the card's ring
    for name in ("load.staged_bytes", "load.slot_waits"):
        assert counts[name] == before[name]


def test_host_sync_counts_a_decode_steps_uploads_and_reads(granite):
    """A decode step over one greedy and one sampled row: the tokens and
    positions uploads, the block table's when a row changed, the greedy
    rows' one ``tolist`` and the sampled row's read."""
    cfg, params = granite
    eng = Engine(cfg, [params], **KW)
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_new=8))
    eng.submit([9, 8, 7], SamplingParams(max_new=8, temperature=0.7,
                                          seed=3))
    eng.step()
    for _ in range(2):
        table = eng.runner._bt_dev is None
        c0 = telemetry.counters()
        eng.step()
        c1 = telemetry.counters()
        assert c1["host_sync"] - c0["host_sync"] == 2 + table + 2
        assert c1["upload_bytes"] - c0["upload_bytes"] == \
            2 * 3 * 4 + table * eng.runner._bt.nbytes
