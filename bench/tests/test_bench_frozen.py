import numpy as np
import pytest

from bench.frozen import flops as F
from bench.frozen import peaks as P
from bench.frozen.stats import mean, percentile

ARCH = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
        "head_dim": 4, "intermediate_size": 16, "num_hidden_layers": 3,
        "vocab_size": 10}
MOE = dict(ARCH, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=6, shared_expert_intermediate_size=12)


def test_token_flops_by_hand():
    # proj 2*8*8 + 2*2*8*4 + 2*8*8 = 384; attn 4*5*2*4 = 160;
    # mlp 6*8*16 = 768; 3 layers; head 2*8*10 = 160
    assert F.token_flops(ARCH, 5, False) == 3 * (384 + 160 + 768)
    assert F.token_flops(ARCH, 5, True) == 3 * (384 + 160 + 768) + 160


def test_moe_counts_routed_experts_not_the_buffer():
    # mlp: 6*2*8*6 routed + 2*8*4 router + 6*8*12 shared
    assert F.token_flops(MOE, 0, False) == 3 * (384 + 576 + 64 + 576)


def test_span_flops_is_the_sum_over_tokens():
    want = sum(F.token_flops(ARCH, p + 1, False) for p in range(7, 12))
    want += 2 * 8 * 10
    assert F.span_flops(ARCH, 7, 5, True) == pytest.approx(want)


def test_ragged_call_cost_by_hand():
    # q and out: 2*16 rows*2 heads*4*2 bytes = 512; table 2*3*4 = 24;
    # row and pos 2*16*4 = 128; K/V rows (3+5)+(0+2) = 10 * 2*1*4*2 = 160
    nb, fl = F.ragged_call_cost(ARCH, 16, 2, 3, [(3, 5), (0, 2)], 2)
    assert nb == 512 + 24 + 128 + 160
    # QK+PV 4*2*4 = 32 per key: (5*3 + 15) + (0 + 3) = 33 keys
    assert fl == 32 * 33


def test_decode_call_cost_by_hand():
    nb, fl = F.decode_call_cost(ARCH, [5, 1, 1], 4, 2)
    assert nb == 2 * 3 * 2 * 4 * 2 + 3 * 4 * 4 + 3 * 4 + 7 * 2 * 4 * 2
    assert fl == 32 * 7


def test_bound_is_the_larger_term():
    assert P.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert P.bound_s(0, 989e12) == pytest.approx(1.0)
    assert P.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 101])
def test_percentile_matches_numpy(n):
    xs = np.random.default_rng(n).random(n)
    for q in (0, 50, 90, 95, 100):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert mean(xs) == pytest.approx(xs.mean())
