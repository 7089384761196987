"""output_tok_s.coldstart: every output token emitted in the window over
the window's seconds, in a cell of bursts that each reach a model scaled
to zero. The count of ``output_tok_s``, under a bound of its own: each
burst is served to its end before the next arrives, so the rate is
closed-loop, and a slower cold start or a slower host leaves less of the
window to decode."""


def read(rec):
    n = sum(1 for r in rec.requests for t in r.token_times
            if rec.in_window(t))
    return n / rec.window_s
