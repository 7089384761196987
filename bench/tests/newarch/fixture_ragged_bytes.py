"""fixture_ragged_bytes: the bytes the window's ragged attention calls
need, as the fixture architecture costs them under its own family (a
test's metric, copied to ``bench/metrics/``)."""


def read(rec):
    nb = [b for t, fam, b, _ in rec.calls
          if fam == "fixture_ragged" and rec.in_window(t)]
    return sum(nb) if nb else None
