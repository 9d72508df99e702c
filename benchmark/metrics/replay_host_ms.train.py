"""Host ms a step in the replay of the captured step's graphs (the
program's `mr.step.replay` span: the graph launches)."""

from benchmark import program


def read(ctx):
    return program.replay_ms_per_step(program.span_table())
