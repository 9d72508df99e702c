"""Host ms a step of the step and loop calls outside the replays: the
batch and hyperparameter checks, the copies and the loss's clone (the
program's `mr.step` and `mr.loop` spans less `mr.step.replay`)."""

from benchmark import program


def read(ctx):
    return program.step_prep_ms_per_step(program.span_table())
