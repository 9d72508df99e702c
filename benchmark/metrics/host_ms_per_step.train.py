"""Host ms a step: the host clock over the window's step calls, divided
by the steps."""

from benchmark import readers


def read(ctx):
    return readers.host_ms_per_step(ctx)
