"""engine_build_s.coldstart: the mean wall time of ``finish()`` less its
``materialize()`` time (the engine and its KV pool built) over the
window's cold starts."""

from bench.frozen.stats import mean


def read(rec):
    cold = [c for c in rec.cold if rec.in_window(c.t_arrival)
            and c.materialize_s > 0]
    if not cold:
        return None
    return mean(c.t_finish_end - c.t_begin_end - c.materialize_s
                for c in cold)
