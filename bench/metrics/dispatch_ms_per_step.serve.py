"""dispatch_ms_per_step.serve: the mean ms a window step spends in the
port's ``runner.forward`` spans (the host issuing every layer's launches
over the stage workers; traced runs)."""

from bench.metrics._common import step_phase_ms


def read(rec):
    return step_phase_ms(rec, "runner.forward")
