"""load_copy_gbps.coldstart: the port's ``load.bytes`` counter over the
window, in GB, over the seconds of its ``load.copy`` spans (each chunk
range's host -> card copy, and each stage's wait for the copy stream)
in the window's cold starts (traced runs)."""

from bench.metrics._common import load_copy_gbps


def read(rec):
    if not rec.port_spans:
        return None
    return load_copy_gbps(rec.port_spans, rec.counters)
