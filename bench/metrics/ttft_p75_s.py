"""ttft_p75_s: the 75th percentile of time to first token over every
request that arrived in the window, timed from its scheduled arrival; a
request with no token by the window's close (or refused) counts at its
wait so far. The 75th, so that a window of some 60 arrivals has fifteen
beyond it."""

from bench.frozen.stats import percentile


def read(rec):
    waits = []
    for r in rec.requests:
        if not rec.in_window(r.arrival):
            continue
        first = r.token_times[0] if r.token_times else None
        end = first if first is not None and first < rec.t_close \
            else rec.t_close
        waits.append(end - r.arrival)
    return percentile(waits, 75) if waits else None
