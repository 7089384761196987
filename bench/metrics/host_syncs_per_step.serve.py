"""host_syncs_per_step.serve: the port's ``host_sync`` counter (each
upload through the card's stream, each read of logits or pages: a point
where the host waits for the card) over the window, per window step
(traced runs)."""

from bench.metrics._common import host_syncs_per_step


def read(rec):
    if not rec.counters:
        return None
    return host_syncs_per_step(rec, rec.counters)
