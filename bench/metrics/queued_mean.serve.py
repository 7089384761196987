"""queued_mean.serve: the mean of ``StepOutput.num_queued`` (waiting and
preempted requests before admission) over the window's steps."""

from bench.frozen.stats import mean
from bench.metrics._common import window_steps


def read(rec):
    st = window_steps(rec)
    return mean(s.num_queued for s in st) if st else None
