import json
from pathlib import Path

import numpy as np
import pytest

from bench.harness import traffic as T

ROOT = Path(__file__).resolve().parents[2]


def _mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("mix", ["chatbot"])
def test_open_loop_same_seed_same_requests(mix):
    t = _mix(mix)
    a = T.open_loop(t, 2.0, 45.0, 2**31 + 7, 49155)
    b = T.open_loop(t, 2.0, 45.0, 2**31 + 7, 49155)
    assert [(r.arrival, r.prompt, r.max_new) for r in a] == \
        [(r.arrival, r.prompt, r.max_new) for r in b]


@pytest.mark.parametrize("mix", ["chatbot"])
def test_open_loop_seeds_offer_one_schedule(mix):
    t = _mix(mix)
    a = T.open_loop(t, 1.5, 45.0, 1, 49155)
    b = T.open_loop(t, 1.5, 45.0, 2**31 + 2, 49155)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert [(r.arrival, len(r.prompt), r.max_new) for r in a] == \
        [(r.arrival, len(r.prompt), r.max_new) for r in b]
    for part in (lambda r: r.arrival < 0, lambda r: r.arrival >= 0):
        pa = [r for r in a if part(r)]
        pb = [r for r in b if part(r)]
        assert sorted(len(r.prompt) for r in pa) == \
            sorted(len(r.prompt) for r in pb)
        assert sorted(r.max_new for r in pa) == sorted(r.max_new for r in pb)
    assert sum(r.arrival >= 0 for r in a) == round(1.5 * 45.0)
    assert sum(r.arrival < 0 for r in a) == round(1.5 * t["ramp_s"])
    lo, hi = t["prompt"]["min"], t["prompt"]["max"]
    for r in a + b:
        assert lo <= len(r.prompt) <= hi
        assert t["output"]["min"] <= r.max_new <= t["output"]["max"]
        assert -t["ramp_s"] <= r.arrival < 45.0
    assert a[0].arrival == b[0].arrival == -t["ramp_s"]


def test_open_loop_mean_rate_and_cv():
    t = dict(_mix("chatbot"), ramp_s=0.0)
    rs = T.open_loop(t, 4.0, 2000.0, 3, 100)
    gaps = np.diff([r.arrival for r in rs])
    assert len(rs) == 8000
    assert 1.6 < gaps.std() / gaps.mean() < 2.4


def test_cold_bursts_same_seed_and_shape():
    t = _mix("coldstart-code")
    a = T.cold_bursts(t, 99, 49155)
    b = T.cold_bursts(t, 99, 49155)
    assert len(a) == t["pool_bursts"]
    assert all(len(g) == t["burst"] for g in a)
    assert [[(r.prompt, r.max_new) for r in g] for g in a] == \
        [[(r.prompt, r.max_new) for r in g] for g in b]
    c = T.cold_bursts(t, 100, 49155)
    assert [[(len(r.prompt), r.max_new) for r in g] for g in a] == \
        [[(len(r.prompt), r.max_new) for r in g] for g in c]
    assert [r.prompt for g in a for r in g] != \
        [r.prompt for g in c for r in g]


def test_warm_lengths_cover_the_buckets():
    assert T.warm_lengths({"prompt": {"max": 512}}, 1024) == \
        [16, 32, 64, 128, 256, 512]
    assert T.warm_lengths({"prompt": {"max": 3584}}, 1024) == \
        [16, 32, 64, 128, 256, 512, 1024]
    assert T.warm_lengths({"prompt": {"max": 96}}, 64) == [16, 32, 64]
