"""The architecture module of both configuration files (``model``)
computes what the harness computed before it dispatched to modules
(``parent_frozen.py``): the port's config, the layout, the weights drawn
from a seed, the reference's logits with and without the control, the
FLOPs, the attention call costs and the memory count. And a prefill is
counted once, whichever way the runner runs it."""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench.frozen import flops as F
from bench.harness import weights as W
from bench.harness.calls import CallCounter
from bench.harness.cell_run import memory_held
from bench.harness.record import Record, StepRec
from bench.harness.spec import architecture, port_config
from bench.tests import parent_frozen as parent

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FILES = {c["name"]: c["file"] for c in BENCH["configs"]}


def _arch(cfg: str) -> dict:
    return json.loads((ROOT / FILES[cfg]).read_text())


def _small(cfg: str) -> dict:
    """The configuration file at widths the CPU draws in a moment, every
    key that chooses a path (tie, biases, experts, shared experts) as it
    is."""
    arch = _arch(cfg)
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    small = dict(arch, hidden_size=64, intermediate_size=96,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=4 * hkv // hq, vocab_size=300)
    if arch.get("num_experts"):
        eff = arch["moe_intermediate_size"]
        small.update(num_experts=6, num_experts_per_tok=2,
                     moe_intermediate_size=32,
                     shared_expert_intermediate_size=32
                     * (arch["shared_expert_intermediate_size"] // eff))
    return small


@pytest.mark.parametrize("cfg", sorted(FILES))
def test_port_config_is_the_parents(cfg):
    arch = _arch(cfg)
    assert architecture(arch).__name__ == "bench.reference.model"
    assert dataclasses.asdict(port_config(arch)) == \
        dataclasses.asdict(parent.port_config(arch))


@pytest.mark.parametrize("cfg", sorted(FILES))
def test_layout_is_the_parents(cfg):
    arch = _arch(cfg)
    assert list(W.layout(arch).items()) == list(parent.layout(arch).items())


@pytest.mark.parametrize("cfg", sorted(FILES))
def test_weights_are_the_parents(cfg):
    arch = _small(cfg)
    seed = 2**31 + 77
    ours = list(W.leaves(arch, seed, "cpu"))
    theirs = list(parent.leaves(arch, seed, "cpu"))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("quant", [None, "fp8"])
@pytest.mark.parametrize("cfg", sorted(FILES))
def test_reference_logits_are_the_parents(cfg, quant):
    arch = _small(cfg)
    weights = W.make(arch, 5, "cpu")
    tokens = [int(t) for t in torch.randint(
        0, arch["vocab_size"], (37,), generator=torch.Generator()
        .manual_seed(9))]
    rows = list(range(20, 37))
    ours = architecture(arch).logits_at(arch, weights, tokens, rows,
                                        quant=quant)
    theirs = parent.logits_at(arch, weights, tokens, rows, quant=quant)
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("cfg", sorted(FILES))
def test_flops_are_the_parents(cfg):
    arch, m = _arch(cfg), architecture(_arch(cfg))
    for ctx, logits in ((1, True), (517, False), (4096, True)):
        assert m.token_flops(arch, ctx, logits) == \
            F.token_flops(arch, ctx, logits)
    for pos0, n, logits in ((0, 412, True), (300, 1, True), (7, 64, False)):
        assert m.span_flops(arch, pos0, n, logits) == \
            F.span_flops(arch, pos0, n, logits)


@pytest.mark.parametrize("cfg", sorted(FILES))
def test_attention_call_costs_are_the_parents(cfg):
    arch = _arch(cfg)
    calls = architecture(arch).CALLS
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    hd = arch["hidden_size"] // hq
    ctx = SimpleNamespace(spans=[(0, 412), (300, 1), (17, 1)],
                          kv_lens=[318, 1, 45, 1])
    for kv_dtype in (torch.bfloat16, torch.int8):
        pages = torch.empty((33, 16, hkv, hd), dtype=kv_dtype, device="meta")
        q = torch.empty((512, hq, hd), dtype=torch.bfloat16, device="meta")
        tables = torch.empty((64, 65), dtype=torch.int32, device="meta")
        row = pos = torch.empty((512,), dtype=torch.int32, device="meta")
        got = calls["ragged_paged_attention"](arch, ctx, q, pages, pages,
                                              tables, row, pos,
                                              kv_quant=None)
        want = F.ragged_call_cost(arch, 512, 64, 65, ctx.spans,
                                  pages.element_size(), 2)
        assert got == ("ragged",) + want
        qd = torch.empty((3, 1, hq, hd), dtype=torch.bfloat16, device="meta")
        kv_len = torch.empty((3,), dtype=torch.int32, device="meta")
        got = calls["paged_decode_attention"](arch, ctx, qd, pages, pages,
                                              tables[:3], kv_len)
        want = F.decode_call_cost(arch, ctx.kv_lens[:3], 65,
                                  pages.element_size(), 2)
        assert got == ("paged_decode",) + want


@pytest.mark.parametrize("cfg", sorted(FILES))
def test_memory_held_is_the_parents(cfg):
    arch = _arch(cfg)
    rec = Record(t_start=0.0, t_open=10.0, t_close=20.0)
    rec.steps = [StepRec(9.0, 9.5, 0, 1, 0, kv_blocks=900),   # before: out
                 StepRec(10.0, 10.1, 0, 1, 0, kv_blocks=69),
                 StepRec(12.0, 12.3, 0, 1, 0, kv_blocks=75)]
    stats = {"total_blocks": 16448, "free_blocks": 16373}
    assert memory_held(arch, rec, stats) == \
        parent.memory_held(arch, rec, stats["total_blocks"])


class _Runner:
    """A runner whose prefill goes through ``forward_batch`` (the ragged
    step of an attention-only model) or through the stage workers (a
    recurrent mixer, a prefix)."""
    max_batch = 4

    def __init__(self, batched: bool):
        self.batched = batched

    def forward_batch(self, segments):
        return "ragged"

    def decode(self, reqs, skip_slots=()):
        return "decode"

    def prefill(self, slot, tokens, start, n, prefix_embeds=None):
        if self.batched:
            return self.forward_batch([(slot, list(tokens), start)])
        return "workers"


@pytest.mark.parametrize("batched", [True, False])
def test_a_prefill_is_counted_once(batched):
    arch = _arch("granite-3-8b")
    rec = Record(0.0)
    counter = CallCounter(arch, rec)
    runner = _Runner(batched)
    counter.wrap_runner(runner)
    counter.on = True
    runner.prefill(2, list(range(100)), 0, 100)
    runner.forward_batch([(0, [1, 2, 3], 40), (1, [4], 9)])
    runner.decode([SimpleNamespace(pos_next=70)])
    assert [f for _, f in rec.model_flops] == [
        F.span_flops(arch, 0, 100, True),
        F.span_flops(arch, 40, 3, True) + F.span_flops(arch, 9, 1, True),
        F.token_flops(arch, 71, True)]
    assert counter.spans == [(40, 3), (9, 1)]
    assert counter.kv_lens == [71, 1, 1, 1]
