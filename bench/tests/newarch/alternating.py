"""A test's architecture module, brought to a copy of the benchmark by
new files alone (``test_bench_new_arch.py`` copies it to
``bench/reference/alternating.py``): a decoder whose period holds two
attention layers, the first with a dense MLP and the second with sparse
experts (``decoder_sparse_step`` 2, the port's ``mlp_pattern`` ("dense",
"moe")), which the ``model`` module cannot lay out. It is built from
``model``'s pieces, and costs its ragged attention calls under a kernel
family of its own, ``fixture_ragged``."""

from __future__ import annotations

import dataclasses

from bench.frozen import flops as F
from bench.reference import model as base

SLOTS = (("slot00", False), ("slot01", True))       # (slot, sparse MLP)


def _periods(arch: dict) -> int:
    return arch["num_hidden_layers"] // len(SLOTS)


def port_config(arch: dict):
    return dataclasses.replace(base.port_config(arch),
                               d_ff=arch["intermediate_size"],
                               mixer_pattern=("attn", "attn"),
                               mlp_pattern=("dense", "moe"))


def layout(arch: dict):
    p = _periods(arch)
    out = base.embedding_leaves(arch)
    for slot, sparse in SLOTS:
        out.update(base.attention_leaves(arch, slot, p))
        out.update((base.moe_leaves if sparse else base.dense_leaves)(
            arch, slot, p))
    return dict(sorted(out.items()))


def logits_at(arch: dict, weights: dict, seq, rows, quant=None):
    def body(x, pos):
        for i in range(_periods(arch)):
            for slot, sparse in SLOTS:
                w = weights["blocks"][slot]
                x = base.attention_layer(arch, w["mixer"], i, x, pos, quant)
                x = base.mlp_layer(arch, w["mlp"], i, x, quant, sparse)
        return x
    return base.logits_at(arch, weights, seq, rows, quant, body=body)


def _halves(arch: dict):
    """The dense and the sparse half of the layers, as ``model``'s
    configurations."""
    sparse = dict(arch, num_hidden_layers=_periods(arch))
    dense = {k: v for k, v in sparse.items() if k != "num_experts"}
    return dense, sparse


def token_flops(arch: dict, ctx: int, logits: bool) -> float:
    dense, sparse = _halves(arch)
    return F.token_flops(dense, ctx, False) + F.token_flops(sparse, ctx,
                                                             logits)


def span_flops(arch: dict, pos0: int, n: int, logits: bool) -> float:
    dense, sparse = _halves(arch)
    return F.span_flops(dense, pos0, n, False) + F.span_flops(
        sparse, pos0, n, logits)


def memory(arch: dict, engine_stats: dict, held_blocks: int) -> dict:
    block = base.kv_block_bytes(arch, arch["num_hidden_layers"])
    return {"weights_bytes": base.weights_bytes(arch, layout(arch)),
            "kv_pool_bytes": engine_stats["total_blocks"] * block,
            "kv_live_peak_bytes": held_blocks * block}


def ragged_cost(arch, ctx, *args, **kw):
    _, nb, fl = base.ragged_cost(arch, ctx, *args, **kw)
    return "fixture_ragged", nb, fl


CALLS = {"ragged_paged_attention": ragged_cost,
         "paged_decode_attention": base.paged_decode_cost}
