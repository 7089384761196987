"""mfu.serve: the model FLOPs of every token the window computed (prompt
tokens against their context, decode rows of live requests, the head
where logits are taken; routed experts as chosen, not the capacity
buffer), over the window's seconds, as a share of the card's 989 TFLOP/s
(bf16, dense)."""

from bench.frozen.peaks import BF16_FLOPS


def read(rec):
    if not rec.traced:
        return None
    fl = sum(f for t, f in rec.model_flops if rec.in_window(t))
    if fl <= 0:
        return None
    return 100.0 * fl / rec.window_s / BF16_FLOPS
