"""queue_wait_ms.serve: the mean wait, in ms, of the requests submitted
in the window and given a slot before its close, from submit to the
scheduler's first plan that gives them one (the port's
``RequestMetrics.submit_t`` and ``admitted_t``; traced runs)."""

from bench.metrics._common import queue_wait_ms


def read(rec):
    return queue_wait_ms(rec, rec.admissions)
