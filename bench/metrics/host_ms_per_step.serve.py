"""host_ms_per_step.serve: the mean over the window's steps of the step's
wall time less the device-busy time inside it (the host's share of a
step: scheduling, dispatch, launches, sampling)."""

from bench.frozen.stats import mean
from bench.harness.trace import busy_in
from bench.metrics._common import window_steps


def read(rec):
    if not rec.traced:
        return None
    st = [s for s in window_steps(rec) if s.t1 <= rec.t_close]
    if not st:
        return None
    return mean(1e3 * ((s.t1 - s.t0) - busy_in(rec.busy, s.t0, s.t1))
                for s in st)
