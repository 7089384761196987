"""setup_s: process start to the window's opening (loading, the weights,
warm-up, the ramp of a serving cell)."""


def read(rec):
    return rec.t_open - rec.t_start
