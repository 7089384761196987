"""output_tok_s: every output token emitted in the window over the
window's seconds."""


def read(rec):
    n = sum(1 for r in rec.requests for t in r.token_times
            if rec.in_window(t))
    return n / rec.window_s
