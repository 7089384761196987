"""Model FLOPs and attention-call costs, frozen from the port's
``roofline/analytic.py`` (``_attn_flops``, ``_dense_mlp_flops``,
``_moe_flops``, the head term of ``step_flops``) and ``chip_smoke.py``'s
``ragged_cost`` and paged-decode byte count. Two changes from the
analytic terms: attention counts one token against its own context
(``ctx`` = its position + 1), and the MoE counts the rows of the experts a
token is routed to (top-k), not the capacity buffer.

``arch`` is a configuration file's dict (Hugging Face key names)."""

from __future__ import annotations


def _dims(arch: dict):
    d = arch["hidden_size"]
    hq = arch["num_attention_heads"]
    hkv = arch["num_key_value_heads"]
    hd = arch.get("head_dim") or d // hq
    return d, hq, hkv, hd


def token_flops(arch: dict, ctx: int, logits: bool) -> float:
    """Forward FLOPs of one token that attends ``ctx`` keys, over every
    layer, plus the head when ``logits``."""
    d, hq, hkv, hd = _dims(arch)
    proj = 2 * d * (hq * hd) + 2 * 2 * d * (hkv * hd) + 2 * (hq * hd) * d
    attn = 2 * 2 * ctx * hq * hd
    if arch.get("num_experts"):
        eff = arch["moe_intermediate_size"]
        mlp = 3 * 2 * arch["num_experts_per_tok"] * d * eff
        mlp += 2 * d * arch["num_experts"]                      # router
        mlp += 3 * 2 * d * arch.get("shared_expert_intermediate_size", 0)
    else:
        mlp = 3 * 2 * d * arch["intermediate_size"]
    total = arch["num_hidden_layers"] * (proj + attn + mlp)
    if logits:
        total += 2 * d * arch["vocab_size"]
    return float(total)


def span_flops(arch: dict, pos0: int, n: int, logits: bool) -> float:
    """FLOPs of ``n`` prompt tokens at positions [pos0, pos0 + n): the sum
    of ``token_flops`` over their contexts, the head once (the last)."""
    if n <= 0:
        return 0.0
    ctx_sum = n * pos0 + n * (n + 1) // 2
    d, hq, hkv, hd = _dims(arch)
    one = token_flops(arch, 0, False)
    attn = arch["num_hidden_layers"] * 2 * 2 * hq * hd * ctx_sum
    head = 2 * d * arch["vocab_size"] if logits else 0
    return float(n * one + attn + head)


def ragged_call_cost(arch: dict, t_rows: int, table_rows: int,
                     table_width: int, spans, kv_itemsize: int,
                     q_itemsize: int = 2):
    """(bytes, flops) of one ragged attention call: q read and the output
    written once (``t_rows`` rows, pads included, as the call takes them),
    the table, row and position vectors, and each table row's K/V up to
    the furthest position it attends, once; QK and PV over each real
    token's causal context. ``spans`` is [(pos0, n)] of the real tokens,
    one per table row they attend through."""
    d, hq, hkv, hd = _dims(arch)
    n_bytes = 2 * t_rows * hq * hd * q_itemsize
    n_bytes += table_rows * table_width * 4 + 2 * t_rows * 4
    n_bytes += sum(pos0 + n for pos0, n in spans) * 2 * hkv * hd \
        * kv_itemsize
    flops = sum(4 * hq * hd * (n * pos0 + n * (n + 1) // 2)
                for pos0, n in spans)
    return float(n_bytes), float(flops)


def decode_call_cost(arch: dict, kv_lens, table_width: int,
                     kv_itemsize: int, q_itemsize: int = 2):
    """(bytes, flops) of one paged decode call over ``len(kv_lens)`` rows:
    q read and the output written once, the table and ``kv_len``, and each
    row's K/V up to ``kv_len``, once."""
    d, hq, hkv, hd = _dims(arch)
    b = len(kv_lens)
    n_bytes = 2 * b * hq * hd * q_itemsize + b * table_width * 4 + b * 4
    n_bytes += sum(kv_lens) * 2 * hkv * hd * kv_itemsize
    flops = sum(4 * hq * hd * n for n in kv_lens)
    return float(n_bytes), float(flops)
