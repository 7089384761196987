"""sample_ms_per_step.serve: the mean ms a window step spends in the
port's ``engine.sample`` spans (reading the step's logits to the host:
the host's wait for the card's work; traced runs)."""

from bench.metrics._common import step_phase_ms


def read(rec):
    return step_phase_ms(rec, "engine.sample")
