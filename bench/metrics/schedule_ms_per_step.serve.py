"""schedule_ms_per_step.serve: the mean ms a window step spends in the
port's ``engine.schedule`` span (the scheduler's plan, preemptions,
admissions; traced runs)."""

from bench.metrics._common import step_phase_ms


def read(rec):
    return step_phase_ms(rec, "engine.schedule")
