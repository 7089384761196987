"""load_gbps.coldstart: bytes materialised over the wall seconds of the
synchronised ``materialize()`` calls of the window's cold starts (the
memory tier's reads and the host -> card copies)."""


def read(rec):
    cold = [c for c in rec.cold if rec.in_window(c.t_arrival)
            and c.materialize_s > 0]
    if not cold:
        return None
    return sum(c.bytes for c in cold) / sum(c.materialize_s
                                            for c in cold) / 1e9
