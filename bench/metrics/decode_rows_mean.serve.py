"""decode_rows_mean.serve: the mean number of decode tokens (each token a
request emits after its first) a step, over the window's steps."""

from bench.frozen.stats import mean
from bench.metrics._common import window_steps


def read(rec):
    st = window_steps(rec)
    return mean(s.decode_events for s in st) if st else None
