"""The plain reference equals the port's CPU forward on the same weights
at a tiny size, in float32 (the only check that reads the port's model:
it shows that the two compute one function)."""

import dataclasses

import pytest
import torch

from bench.harness import weights as W
from bench.harness.spec import port_config
from bench.reference import model as ref
from bench.tests.fixture import TINY_DENSE, TINY_MOE


def port_logits(arch, params, tokens):
    from repro_torch.models import transformer
    cfg = dataclasses.replace(port_config(arch), dtype="float32")
    tok = torch.as_tensor([tokens], dtype=torch.int32)
    pos = torch.arange(len(tokens), dtype=torch.int32)[None]
    x = transformer.embed(cfg, params, tok, pos, dtype=torch.float32)
    x, _, _ = transformer.run_blocks(cfg, params["blocks"], x, pos)
    return transformer.head(cfg, params, x)[0, :, :cfg.vocab]


@pytest.mark.parametrize("arch", [TINY_DENSE, TINY_MOE,
                                  dict(TINY_DENSE, tie_word_embeddings=True)],
                         ids=["dense", "moe", "dense-tied"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_equals_port_forward(arch, seed):
    arch = dict(arch, torch_dtype="float32")
    params = W.make(arch, seed, "cpu")
    tokens = [int(t) for t in torch.randint(0, arch["vocab_size"], (40,),
                                            generator=torch.Generator()
                                            .manual_seed(seed))]
    want = port_logits(arch, params, tokens)
    rows = list(range(len(tokens)))
    got = ref.logits_at(arch, params, tokens, rows)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=1e-4)


def test_fp8_control_departs_from_the_reference():
    arch = dict(TINY_DENSE, torch_dtype="float32")
    params = W.make(arch, 7, "cpu")
    tokens = list(range(1, 30))
    a = ref.logits_at(arch, params, tokens, [28])
    b = ref.logits_at(arch, params, tokens, [28], quant="fp8")
    err = (a - b).abs().max().item()
    assert 1e-3 < err < 1.0
