"""cold_ttft_s: the mean, over every request that reached a model scaled
to zero in the window, of its first token's time minus its arrival
(Alg. 1's plan, the stage loads out of the store, the engine build, the
first step)."""

from bench.frozen.stats import mean


def read(rec):
    waits = []
    for r in rec.requests:
        if not (r.cold and rec.in_window(r.arrival)):
            continue
        end = r.token_times[0] if r.token_times else rec.t_close
        waits.append(end - r.arrival)
    return mean(waits) if waits else None
