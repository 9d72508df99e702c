"""Device ms a render call of every operation that is no renderer kernel."""

from benchmark import readers


def read(ctx):
    return readers.glue_ms_per_step(ctx)
