"""The port's roofline terms (``repro_torch.roofline``): the reference's
``tests/test_roofline.py`` mirrored on its own HLO strings, the
terms-and-dominance test restated with the H100's peaks, and the analytic
model equal to the reference's, float for float, for every config and
every shape of ``SHAPES``."""

import dataclasses
import math

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import list_configs as jlist
from repro.roofline import analytic as janalytic
from repro.roofline import analysis as janalysis
from repro_torch.configs import SHAPES, get_config
from repro_torch.roofline import analytic
from repro_torch.roofline.analysis import (BF16_FLOPS, HBM_BYTES_PER_S,
                                           LINK_BYTES_PER_S, Roofline,
                                           analyze, collective_bytes,
                                           model_flops)

SYNTH_HLO = """
HloModule jit_step

%loop_body.1 (p: (s32[], bf16[8,128])) -> (s32[], bf16[8,128]) {
  %ar = bf16[8,128]{1,0} all-reduce(%x), replica_groups={}
  ROOT %t = (s32[], bf16[8,128]) tuple(%i, %ar)
}

%loop_cond.1 (p: (s32[], bf16[8,128])) -> pred[] {
  %limit = s32[] constant(40)
  ROOT %cmp = pred[] compare(%i, %limit), direction=LT
}

ENTRY %main (a: bf16[8,128]) -> bf16[8,128] {
  %ag = bf16[16,128]{1,0} all-gather(%a), dimensions={0}
  %w = (s32[], bf16[8,128]) while(%init), condition=%loop_cond.1, body=%loop_body.1
  ROOT %out = bf16[8,128] get-tuple-element(%w), index=1
}
"""

DONE_HLO = """
ENTRY %main (a: bf16[4,4]) -> bf16[4,4] {
  %s = bf16[4,4] all-reduce-start(%a)
  %d = bf16[4,4] all-reduce-done(%s)
}
"""


def test_collective_parser_multiplies_loop_bodies():
    out = collective_bytes(SYNTH_HLO)
    assert out["all-gather"] == 16 * 128 * 2
    # the all-reduce sits in a body executed 40x
    assert out["all-reduce"] == 40 * 8 * 128 * 2
    assert out == janalysis.collective_bytes(SYNTH_HLO)


def test_collective_parser_ignores_done():
    out = collective_bytes(DONE_HLO)
    assert out["all-reduce"] == 4 * 4 * 2
    assert out == janalysis.collective_bytes(DONE_HLO)


def test_model_flops_conventions():
    cfg = get_config("granite-3-8b")
    n = cfg.active_param_count()
    assert model_flops(cfg, SHAPES["train_4k"]) == 6.0 * n * 256 * 4096
    assert model_flops(cfg, SHAPES["decode_32k"]) == 2.0 * n * 128


def test_moe_uses_active_params():
    moe = get_config("qwen2-moe-a2.7b")
    assert model_flops(moe, SHAPES["train_4k"]) < \
        6.0 * moe.param_count() * 256 * 4096


def test_analytic_flops_close_to_6nd():
    """For a dense model, analytic train flops should be within ~2x of the
    6*N*D convention (4/3 remat factor + attention + vocab head)."""
    cfg = get_config("granite-3-8b")
    shape = SHAPES["train_4k"]
    ours = analytic.step_flops(cfg, shape) * 4.0
    canon = model_flops(cfg, shape)
    assert 0.8 < ours / canon < 2.5, ours / canon


def test_roofline_terms_and_dominance():
    """The reference's case at the H100's peaks: one second of compute, two
    of HBM traffic, one of link traffic."""
    r = Roofline("a", "s", "m", 256, flops_total=BF16_FLOPS * 256,
                 bytes_per_device=HBM_BYTES_PER_S * 2,
                 coll_bytes_per_device={"all-reduce": LINK_BYTES_PER_S},
                 peak_memory_per_device=1 << 30,
                 model_flops_total=BF16_FLOPS * 128)
    assert math.isclose(r.compute_s, 1.0)
    assert math.isclose(r.memory_s, 2.0)
    assert math.isclose(r.collective_s, 1.0)
    assert r.dominant == "memory"
    assert math.isclose(r.roofline_fraction, 0.25)
    assert (BF16_FLOPS, HBM_BYTES_PER_S) == (989e12, 3.35e12)


@pytest.mark.parametrize("arch", jlist())
def test_analytic_terms_equal_reference(arch):
    """Every term, float for float, for each shape of ``SHAPES``; the KV
    bytes also per page dtype; the collectives on both the default and a
    4 x 64 split."""
    jcfg, cfg = jget(arch), get_config(arch)
    assert sorted(SHAPES) == sorted(JSHAPES)
    for name in sorted(JSHAPES):
        js, ts = JSHAPES[name], SHAPES[name]
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        for skip in (False, True):
            assert analytic.step_flops(cfg, ts, causal_skip=skip) == \
                janalytic.step_flops(jcfg, js, causal_skip=skip)
        pbytes = cfg.size_bytes()
        assert pbytes == jcfg.size_bytes()
        for chips in (1, 256):
            for kvd in (None, "int8"):
                got = analytic.hbm_bytes_per_device(
                    cfg, ts, chips, pbytes, 4.0, kv_dtype=kvd)
                want = janalytic.hbm_bytes_per_device(
                    jcfg, js, chips, pbytes, 4.0, kv_dtype=kvd)
                assert got == want, (name, chips, kvd)
            for data, model in ((16, 16), (4, 64)):
                got = analytic.collective_bytes_per_device(
                    cfg, ts, chips, pbytes, data=data, model=model)
                want = janalytic.collective_bytes_per_device(
                    jcfg, js, chips, pbytes, data=data, model=model)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.total == want.total
    for kvd in (None, "int8", "bfloat16"):
        assert analytic.kv_token_bytes(cfg, kvd) == \
            janalytic.kv_token_bytes(jcfg, kvd)


def test_analyze_takes_the_ports_dicts():
    """``analyze`` on the port's cost and memory dicts: the reference's
    flops, bytes, collectives and model flops; the terms at the H100's
    peaks."""
    cfg, shape = get_config("granite-3-8b"), SHAPES["train_4k"]
    r = analyze("granite-3-8b", shape, "16x16", 256,
                {"flops": 1.0, "bytes accessed": 2.0},
                {"temp_bytes": 3, "argument_bytes": 4}, SYNTH_HLO, cfg)
    assert r.flops_total == analytic.step_flops(cfg, shape) * 4.0
    assert r.bytes_per_device == analytic.hbm_bytes_per_device(
        cfg, shape, 256, cfg.size_bytes(), 4.0)
    assert r.coll_bytes_per_device == collective_bytes(SYNTH_HLO)
    assert r.peak_memory_per_device == 7
    assert (r.xla_flops_per_device, r.xla_bytes_per_device) == (1.0, 2.0)
    assert r.compute_s == r.flops_total / (256 * BF16_FLOPS)
    assert r.row()["dominant"] == r.dominant
