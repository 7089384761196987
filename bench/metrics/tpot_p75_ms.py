"""tpot_p75_ms: the 75th percentile, over requests finished in the window
with two tokens or more, of (last token - first token) / (tokens - 1)."""

from bench.frozen.stats import percentile


def read(rec):
    vals = []
    for r in rec.requests:
        if r.done_at is None or not r.done_at < rec.t_close \
                or len(r.token_times) < 2:
            continue
        vals.append(1e3 * (r.token_times[-1] - r.token_times[0])
                    / (len(r.token_times) - 1))
    return percentile(vals, 75) if vals else None
